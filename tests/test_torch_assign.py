"""The port's capacity assignment against the JAX package's oracle and its
Pallas kernel (interpret mode), on the CPU.  The Hopper kernel itself is held
against the plain version on the card in ``test_torch_kernels_cuda.py``.

Tolerances: ``idx``, ``admit`` and ``pos`` are exact (integral sizes make
every prefix sum exact in f32); ``gate`` is a softmax whose ``exp`` and sum
order differ between implementations: rtol 1e-5, atol 1e-6.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.assign.assign import assign_pallas  # noqa: E402
from repro.kernels.assign.ops import make_capacity_assign as jax_make_capacity_assign  # noqa: E402
from repro.kernels.assign.ref import assign_ref as jax_assign_ref  # noqa: E402
from repro_torch.kernels.assign import assign, assign_ref, make_capacity_assign  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

ASSIGN_CASES = [
    # (N, E, k, block_n)
    (64, 8, 1, 32),
    (128, 16, 2, 64),
    (256, 384, 8, 256),   # kimi-k2 router shape class
    (100, 50, 1, 256),    # jobs x sites, single block
    (33, 7, 3, 16),       # ragged tail
    (512, 32, 8, 128),    # granite router shape class
]


def _inputs(N, E, seed):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(N, E)).astype(np.float32)
    scores[rng.random((N, E)) < 0.1] = -1e30
    sizes = rng.choice([1.0, 2.0, 8.0], size=N).astype(np.float32)
    caps = rng.uniform(2, 40, size=E).astype(np.float32)
    return scores, sizes, caps


def _check(want, got):
    idx, gate, admit, pos = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(idx, got[0].cpu().numpy())
    np.testing.assert_allclose(gate, got[1].cpu().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(admit, got[2].cpu().numpy())
    np.testing.assert_array_equal(pos, got[3].cpu().numpy())


@pytest.mark.parametrize("N,E,k,bn", ASSIGN_CASES)
def test_ref_matches_jax_ref(N, E, k, bn):
    scores, sizes, caps = _inputs(N, E, N * 31 + E)
    want = jax_assign_ref(jnp.array(scores), jnp.array(sizes), jnp.array(caps), k=k, block_n=bn)
    got = assign_ref(torch.from_numpy(scores), torch.from_numpy(sizes), torch.from_numpy(caps),
                     k=k, block_n=bn)
    _check(want, got)


@pytest.mark.parametrize("N,E,k,bn", ASSIGN_CASES)
def test_ref_matches_pallas_interpret(N, E, k, bn):
    scores, sizes, caps = _inputs(N, E, N * 31 + E)
    want = assign_pallas(jnp.array(scores), jnp.array(sizes), jnp.array(caps),
                         k=k, block_n=bn, interpret=True)
    got = assign(torch.from_numpy(scores), torch.from_numpy(sizes), torch.from_numpy(caps),
                 k=k, block_n=bn)
    _check(want, got)


def test_capacity_assign_engine_combinator():
    from repro.core import make_sites as jax_make_sites
    from repro_torch.core import make_sites

    site_kw = dict(cores=[4, 2], speed=[10.0, 10.0], memory=[64.0, 64.0],
                   bw_in=[1e9, 1e9], bw_out=[1e9, 1e9])
    J = 6
    scores = np.zeros((J, 2), np.float32)
    scores[:, 0] = 1.0  # all prefer site 0 (4 cores)
    fn = make_capacity_assign(jobs_cores=torch.full((J,), 2, dtype=torch.int32))
    site, ok = fn(torch.from_numpy(scores), torch.ones(J, dtype=torch.bool),
                  torch.ones((J, 2), dtype=torch.bool), make_sites(**site_kw, device="cpu"))
    assert int(ok.sum()) == 2          # 2x 2-core jobs fit site 0
    assert (site[ok] == 0).all()
    jfn = jax_make_capacity_assign(jobs_cores=jnp.full((J,), 2, jnp.int32))
    jsite, jok = jfn(jnp.array(scores), jnp.ones((J,), bool), jnp.ones((J, 2), bool),
                     jax_make_sites(**site_kw))
    np.testing.assert_array_equal(np.asarray(jsite), site.numpy())
    np.testing.assert_array_equal(np.asarray(jok), ok.numpy())


def test_cuda_wrappers_import_and_refuse_cpu_tensors():
    from repro_torch.kernels.assign import assign_cuda
    from repro_torch.kernels.segment_sum import segment_sum_cuda

    assert assign_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        assign_cuda.assign_cuda(torch.zeros((4, 3)), torch.zeros(4), torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA"):
        segment_sum_cuda.segment_sum_cuda(torch.zeros(4), torch.zeros(4, dtype=torch.int32), 2)
    assert assign_cuda.launches == 0


def _tiled_admission(idx, sizes, caps, k, block_n, tile_rows):
    """A model in numpy of the card's admission decomposition
    (``csrc/assign.cu``): claims cut into tiles (``tile_rows`` rows of one
    slot within one row block, numbered in claim order), per-tile per-bin
    totals, an exclusive scan of those totals over tiles, and each claim's
    in-tile prefix in row order.  k = 1 takes claims in row order, so the
    card puts all rows in one block whatever ``block_n`` is."""
    N, E = idx.shape[0], caps.shape[0]
    block_rows = N if (k == 1 or block_n > N) else block_n
    tpb = -(-block_rows // tile_rows)
    n_blocks = -(-N // block_rows)
    totals = np.zeros((E, n_blocks * k * tpb), np.float32)
    local = np.zeros((N, k), np.float32)
    tile_of = np.zeros((N, k), np.int64)
    for blk in range(n_blocks):
        for t in range(tpb):
            r0 = blk * block_rows + t * tile_rows
            r1 = min(r0 + tile_rows, (blk + 1) * block_rows, N)
            for s in range(k):
                tile = (blk * k + s) * tpb + t
                run = np.zeros(E, np.float32)
                for r in range(r0, r1):
                    tile_of[r, s] = tile
                    b = idx[r, s]
                    if b >= 0:
                        local[r, s] = run[b]
                        run[b] += sizes[r]
                totals[:, tile] = run
    base = np.cumsum(totals, axis=1, dtype=np.float32) - totals
    pos = np.where(idx >= 0, base[idx.clip(0), tile_of] + local, np.float32(0.0))
    admit = (idx >= 0) & (pos + sizes[:, None] <= caps[idx.clip(0)] + np.float32(1e-6))
    return pos.astype(np.float32), admit


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("N,E,block_n,tile_rows", [
    (200, 12, 64, 16),     # several tiles a block
    (150, 9, 48, 32),      # block_n not a multiple of the tile, ragged last block
    (97, 30, 500, 16),     # block_n above N
    (300, 300, 256, 256),  # the card's tile size
])
def test_tiled_admission_model_matches_assign_ref(k, N, E, block_n, tile_rows):
    scores, sizes, caps = _inputs(N, E, N * 7 + E + k)
    caps = caps * (N * k / (4 * E))  # some bins fill, some do not
    want = jax_assign_ref(jnp.array(scores), jnp.array(sizes), jnp.array(caps), k=k,
                          block_n=block_n)
    idx = np.asarray(want[0])
    pos, admit = _tiled_admission(idx, sizes, caps, k, block_n, tile_rows)
    np.testing.assert_array_equal(np.asarray(want[3]), pos)
    np.testing.assert_array_equal(np.asarray(want[2]), admit)
    assert 0 < admit.sum() < (idx >= 0).sum()  # the caps bind
    got = assign_ref(torch.from_numpy(scores), torch.from_numpy(sizes), torch.from_numpy(caps),
                     k=k, block_n=block_n)
    np.testing.assert_array_equal(got[3].numpy(), pos)
    np.testing.assert_array_equal(got[2].numpy(), admit)
