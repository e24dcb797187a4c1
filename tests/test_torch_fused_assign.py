"""The port's fused candidate-set assignment against the JAX package's oracle
and its Pallas kernel (interpret mode), on the CPU.  The Hopper kernel itself
is held against the plain version on the card in
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
