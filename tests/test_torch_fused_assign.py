"""The port's fused candidate-set assignment against the JAX package's oracle
and its Pallas kernel (interpret mode), on the CPU, and a numpy model of the
Hopper kernel's tiled decomposition against both oracles.  The Hopper kernel
itself is held against the plain version on the card in
``test_torch_kernels_cuda.py``.

Tolerance: none.  ``site`` and ``admit`` are exact for integral sizes, and,
because the plain version adds in XLA's order, for non-integral sizes too.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.assign.fused import fused_assign_pallas  # noqa: E402
from repro.kernels.assign.fused import fused_assign_ref as jax_fused_ref  # noqa: E402
from repro_torch.kernels.assign import (  # noqa: E402
    assign_ref,
    fused_assign_ref,
    fused_topk_assign,
)
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

CASES = [
    # (N, E, K, block_n)
    (97, 7, 4, 32),      # tests/test_fused_assign.py's shape
    (97, 7, 4, 256),     # one ragged block
    (300, 12, 40, 64),   # K above a warp
    (33, 5, 1, 16),      # one candidate a row
]


def _random_case(seed, N=97, E=7, K=4, integral=True):
    """Candidate rows of sorted distinct site ids with sentinel ``E`` pads, as
    ``tests/test_fused_assign.py`` builds them."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(N, K)).astype(np.float32)
    cand = np.full((N, K), E, np.int32)
    for i in range(N):
        n = rng.integers(0, min(K, E) + 1)
        cand[i, :n] = np.sort(rng.choice(E, size=n, replace=False))
    if integral:
        sizes = rng.integers(1, 4, size=N).astype(np.float32)
        caps = rng.integers(0, 40, size=E).astype(np.float32)
    else:
        sizes = rng.lognormal(0.0, 1.0, size=N).astype(np.float32)
        caps = rng.uniform(0.0, 4.0 * N / E, size=E).astype(np.float32)
    return scores, cand, sizes, caps


def _both(case, block_n):
    want = jax_fused_ref(*(jnp.asarray(x) for x in case), block_n=block_n)
    got = fused_assign_ref(*(torch.from_numpy(x) for x in case), block_n=block_n)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("N,E,K,bn", CASES)
@pytest.mark.parametrize("seed", range(5))
def test_ref_matches_jax_ref_and_pallas(N, E, K, bn, seed):
    case = _random_case(seed, N, E, K)
    want, got = _both(case, bn)
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])
    s_k, a_k = fused_assign_pallas(*(jnp.asarray(x) for x in case), block_n=bn, interpret=True)
    np.testing.assert_array_equal(np.asarray(s_k), got[0])
    np.testing.assert_array_equal(np.asarray(a_k), got[1])
    assert got[0].dtype == np.int32 and got[1].dtype == np.bool_


@pytest.mark.parametrize("seed", range(4))
def test_non_integral_sizes_match_jax_ref(seed):
    """Sizes and caps off the integers: the in-block prefix sums and the
    block carry must add in XLA's order to give the same admissions."""
    case = _random_case(seed, N=1000, E=9, K=6, integral=False)
    want, got = _both(case, 256)
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])
    assert 0 < got[1].sum() < (got[0] >= 0).sum()  # capacity binds somewhere


def test_all_sentinel_rows_never_admit():
    scores, cand, sizes, caps = _random_case(0)
    cand[:] = caps.shape[0]
    site, admit = fused_topk_assign(*(torch.from_numpy(x) for x in (scores, cand, sizes, caps)))
    assert (site == -1).all() and not admit.any()
    want = jax_fused_ref(*(jnp.asarray(x) for x in (scores, cand, sizes, caps)))
    np.testing.assert_array_equal(np.asarray(want[0]), site.numpy())


def test_full_candidates_match_dense_assign():
    """cand = all feasible sites ascending: the fused pick and admission equal
    the port's dense k=1 ``assign_ref`` on the masked [N, E] matrix."""
    rng = np.random.default_rng(42)
    N, E = 64, 5
    dense = torch.from_numpy(rng.normal(size=(N, E)).astype(np.float32))
    feas = torch.from_numpy(rng.random((N, E)) < 0.7)
    sizes = torch.from_numpy(rng.integers(1, 3, size=N).astype(np.float32))
    caps = torch.from_numpy(rng.integers(2, 12, size=E).astype(np.float32))

    cand = torch.where(feas, torch.arange(E)[None, :], E).int().sort(-1).values
    scores_k = torch.where(cand < E, dense.gather(1, cand.clamp_max(E - 1).long()), -1e30)
    site, admit = fused_assign_ref(scores_k, cand, sizes, caps)

    idx, _, d_admit, _ = assign_ref(torch.where(feas, dense, -1e30), sizes, caps, k=1)
    ok = feas.any(-1)
    assert torch.equal(admit, d_admit[:, 0] & ok)
    assert torch.equal(site[ok], idx[ok, 0])
    assert (site[~ok] == -1).all()


def _tiled_fused(scores, cand, sizes, caps, tile_rows, scan_per=16):
    """A model in numpy of the card's decomposition (``csrc/fused.cu``).

    Picks: a row's slots go to G lanes (G the power of two covering K/4, at
    most 32), lane j holding slots 4 (j + G t) + c in rising order; each lane
    keeps its first maximum and a butterfly over the lanes keeps the larger
    score, the lower slot on ties.  Admission: tiles of ``tile_rows`` rows,
    cut into warps of 32 rows; a claim's in-warp prefix sums the sizes of the
    warp's earlier claims on its site, and the warps' per-site totals are
    scanned over the warps in row order; the tile totals go bin-major
    ``[E][n_tiles]``, and each site's are scanned over tiles in steps of
    ``32 * scan_per``: lane l adds tiles ``scan_per l ..`` in order, a warp
    scan joins the lanes, and a carry joins the steps."""
    N, K = scores.shape
    E = caps.shape[0]
    G = 1
    while G < -(-K // 4) and G < 32:
        G *= 2
    f32 = np.float32

    def before(a, b):  # (value, slot) pairs
        return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])

    site = np.full(N, -1, np.int32)
    bins = np.full(N, -1, np.int64)
    w = np.zeros(N, f32)
    for r in range(N):
        lanes = []
        for j in range(G):
            best = (-np.inf, 2**31 - 1, 0)
            for s in range(4 * j, K, 4 * G):
                for c in range(s, min(s + 4, K)):
                    v = scores[r, c] if cand[r, c] < E else f32(-1e30)
                    if before((v, c), best):
                        best = (v, c, cand[r, c])
            lanes.append(best)
        off = G // 2
        while off:
            lanes = [lanes[j ^ off] if before(lanes[j ^ off], lanes[j]) else lanes[j]
                     for j in range(G)]
            off //= 2
        v, _, c = lanes[0]
        if v > f32(-5e29):
            site[r], bins[r], w[r] = c, min(max(c, 0), E - 1), sizes[r]

    n_tiles = -(-N // tile_rows)
    totals = np.zeros((E, n_tiles), f32)
    local = np.full(N, np.nan, f32)
    for t in range(n_tiles):
        carry = np.zeros(E, f32)             # the earlier warps' totals, in warp order
        for w0 in range(t * tile_rows, min((t + 1) * tile_rows, N), 32):
            rows = range(w0, min(w0 + 32, (t + 1) * tile_rows, N))
            warp_tot = np.zeros(E, f32)
            for r in rows:
                if bins[r] >= 0:
                    excl = f32(0)
                    for p in rows:
                        if p < r and bins[p] == bins[r]:
                            excl = f32(excl + w[p])
                    local[r] = f32(carry[bins[r]] + excl)
                    warp_tot[bins[r]] = f32(excl + w[r])   # the last claim's wins
            carry = (carry + warp_tot).astype(f32)
        totals[:, t] = carry
    base = np.zeros_like(totals)
    for e in range(E):
        carry = f32(0)
        for t0 in range(0, n_tiles, 32 * scan_per):  # a step: lane l holds scan_per tiles
            step = np.zeros(32 * scan_per, f32)
            step[:min(32 * scan_per, n_tiles - t0)] = totals[e, t0:t0 + 32 * scan_per]
            chunks = step.reshape(32, scan_per)
            within = np.cumsum(chunks, axis=1, dtype=f32) - chunks   # exclusive in a lane
            lane_incl = np.cumsum(chunks.sum(axis=1, dtype=f32), dtype=f32)
            start = carry + np.concatenate([[f32(0)], lane_incl[:-1]]).astype(f32)
            out = (start[:, None] + within).reshape(-1)
            base[e, t0:t0 + 32 * scan_per] = out[:min(32 * scan_per, n_tiles - t0)]
            carry = f32(carry + lane_incl[-1])
    claim = ~np.isnan(local)
    pos = np.where(claim, base[bins.clip(0), np.arange(N) // tile_rows] + local, f32(0))
    admit = claim & (pos + sizes <= caps[bins.clip(0)] + f32(1e-6))
    return site, admit


@pytest.mark.parametrize("N,E,K,tile_rows,kind", [
    (1100, 12, 16, 32, "random"),    # the engine's K, 35 tiles
    (17000, 12, 4, 32, "random"),    # 532 tiles: two steps of the base scan
    (97, 7, 4, 32, "random"),        # tests/test_fused_assign.py's shape
    (300, 30, 48, 256, "random"),    # K % 4 == 0, 16 lanes a row
    (257, 9, 50, 64, "random"),      # K % 4 != 0 and K > 32
    (129, 9, 3, 32, "random"),       # K = 3: one lane a row, ragged last tile
    (100, 5, 1, 32, "random"),       # K = 1
    (96, 40, 8, 32, "one_site"),     # every row picks one site: the longest chain
    (160, 20, 8, 32, "sentinel_tile"),  # a whole tile of sentinel rows
    (300, 4, 150, 64, "random"),     # K > 128: a lane holds several groups of 4
])
def test_tiled_decomposition_model_matches_fused_ref(N, E, K, tile_rows, kind):
    scores, cand, sizes, caps = _random_case(N * 13 + E + K, N, E, K)
    if kind == "one_site":
        cand[:] = E
        cand[:, 0] = 3
    elif kind == "sentinel_tile":
        cand[tile_rows:2 * tile_rows] = E
    caps = (caps * N / (40 * E)).round().astype(np.float32)  # some sites fill, some do not
    if kind == "one_site":
        caps[3] = np.float32(sizes.sum() // 2)
    site, admit = _tiled_fused(scores, cand, sizes, caps, tile_rows)
    want = jax_fused_ref(*(jnp.asarray(x) for x in (scores, cand, sizes, caps)))
    np.testing.assert_array_equal(np.asarray(want[0]), site)
    np.testing.assert_array_equal(np.asarray(want[1]), admit)
    got = fused_assign_ref(*(torch.from_numpy(x) for x in (scores, cand, sizes, caps)))
    np.testing.assert_array_equal(got[0].numpy(), site)
    np.testing.assert_array_equal(got[1].numpy(), admit)
    assert 0 < admit.sum() < (site >= 0).sum()  # the caps bind
