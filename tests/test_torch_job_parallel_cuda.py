"""Job-parallel simulation on the card: the assign and fused kernels solved
in row blocks, each admitted behind the lower blocks' claims
(``block_admit``), against one call on all the rows; the fused kernel's
``pos`` output against its plain version; ``simulate_distributed`` on a
1-rank NCCL mesh against ``simulate`` on the card; and on two cards (a
spawned 2-rank NCCL mesh) every rank against one card.  Marked ``cuda``:
they skip where no GPU is present.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_job_parallel_cuda.py

Exact: idx, site, admit and pos; every array of every result.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.kernels.assign import (  # noqa: E402
    assign,
    block_admit,
    block_claims,
    fused_assign_ref,
    make_capacity_assign,
    make_fused_capacity_assign,
)
from repro_torch.kernels.assign import assign_cuda as assign_mod  # noqa: E402
from repro_torch.kernels.assign import fused_cuda as fused_mod  # noqa: E402
from repro_torch.kernels.assign.fused_cuda import fused_assign_cuda  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _problem(N, E, K, seed, device):
    """Dense scores ``[N, E]`` (30% of pairs and a quarter of the rows
    infeasible), candidate rows ``[N, K]`` of sorted site ids with sentinel
    pads, integral sizes and capacities that bind."""
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((N, E)).astype(np.float32)
    scores[rng.random((N, E)) < 0.3] = -1e30
    scores[rng.random(N) < 0.25] = -1e30
    cand = np.sort(rng.integers(0, E + 1, (N, K)), 1).astype(np.int32)
    sizes = rng.choice([1.0, 2.0, 8.0], N).astype(np.float32)
    caps = rng.integers(0, max(3 * N // E, 2), E).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (scores, cand, sizes, caps))


def _by_blocks(n, N, solve, sizes, caps):
    E = caps.shape[0]
    b = -(-N // n)
    base = torch.zeros(E, dtype=torch.int32, device=caps.device)
    sites, admits = [], []
    for r in range(n):
        rows = slice(r * b, min((r + 1) * b, N))
        site, pos = solve(rows)
        sites.append(site)
        admits.append(block_admit(site, pos, sizes[rows], caps, base))
        base = base + block_claims(site, sizes[rows], E)
    return torch.cat(sites), torch.cat(admits)


@pytest.mark.cuda
@pytest.mark.parametrize("N,E,n", [(20000, 300, 2), (20000, 300, 3), (5003, 50, 7)])
def test_assign_kernel_row_blocks_equal_one_call(cuda_device, N, E, n):
    scores, _, sizes, caps = _problem(N, E, 1, n, cuda_device)
    idx, _, admit, _ = assign(scores, sizes, caps, k=1)

    def solve(rows):
        i, _, _, pos = assign(scores[rows].contiguous(), sizes[rows].contiguous(), caps, k=1)
        return i[:, 0], pos[:, 0]

    site, adm = _by_blocks(n, N, solve, sizes, caps)
    assert torch.equal(site, idx[:, 0]) and torch.equal(adm, admit[:, 0])
    assert 0 < int(adm.sum()) < int((site >= 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("N,E,K,n", [(20000, 300, 16, 2), (20000, 300, 16, 3),
                                     (5003, 50, 3, 7)])
def test_fused_kernel_row_blocks_equal_one_call(cuda_device, N, E, K, n):
    scores, cand, sizes, caps = _problem(N, E, K, 10 + n, cuda_device)
    scores_k = scores[:, :K].contiguous()
    site_w, admit_w = fused_assign_cuda(scores_k, cand, sizes, caps)

    def solve(rows):
        s, _, pos = fused_assign_cuda(scores_k[rows].contiguous(), cand[rows].contiguous(),
                                      sizes[rows].contiguous(), caps, with_pos=True)
        return s, pos

    site, adm = _by_blocks(n, N, solve, sizes, caps)
    assert torch.equal(site, site_w) and torch.equal(adm, admit_w)
    assert 0 < int(adm.sum()) < int((site >= 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("L,N,E,K", [(None, 1, 7, 4), (None, 1000, 300, 16),
                                     (None, 33334, 300, 16), (None, 3000, 50, 3),
                                     (3, 2000, 50, 8)])
def test_fused_pos_equals_the_plain_version(cuda_device, L, N, E, K):
    if L is None:
        scores, cand, sizes, caps = _problem(N, E, K, N, cuda_device)
        args = (scores[:, :K].contiguous(), cand, sizes, caps)
    else:
        probs = [_problem(N, E, K, i, cuda_device) for i in range(L)]
        args = (torch.stack([p[0][:, :K] for p in probs]).contiguous(),
                *(torch.stack([p[i] for p in probs]).contiguous() for i in (1, 2, 3)))
    want = fused_assign_ref(*args, with_pos=True)
    got = fused_assign_cuda(*args, with_pos=True)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    plain = fused_assign_cuda(*args)
    assert torch.equal(plain[0], got[0]) and torch.equal(plain[1], got[1])


def _flat_equal(a, b):
    import torch_mesh_ranks as M

    fa, fb = M.flat(a), M.flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        torch.testing.assert_close(fa[k].cpu(), fb[k].cpu(), rtol=0, atol=0, equal_nan=True,
                                   msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_one_rank_nccl_mesh_equals_simulate(cuda_device, kind):
    """S = 50, J = 5000: ``simulate_distributed`` on a 1-rank NCCL mesh
    launches its kernel once a round with work, and equals ``simulate``."""
    sites = T.atlas_like_platform(50, seed=1, device=cuda_device)
    jobs = T.synthetic_panda_jobs(5000, seed=0, duration=3600.0, device=cuda_device)
    if kind == "dense":
        pol, kw = T.with_capacity_assign(T.get_policy("panda_dispatch"),
                                         make_capacity_assign(jobs.cores)), {}
    else:
        pol, kw = T.with_fused_assign(T.get_policy("data_locality"),
                                      make_fused_capacity_assign(jobs.cores)), {"topk": 8}
    want = T.simulate(jobs, sites, pol, T.PRNGKey(2), max_rounds=300, log_rows=16,
                      device=cuda_device, **kw)
    with D.local_mesh("cuda") as mesh:
        mod = assign_mod if kind == "dense" else fused_mod
        mod.launches = 0
        got = D.simulate_distributed(jobs, sites, pol, T.PRNGKey(2), mesh, max_rounds=300,
                                     log_rows=16, **kw)
        assert 0 < mod.launches <= int(got.rounds)
    _flat_equal(want, got)


@pytest.mark.cuda
def test_two_cards_equal_one_card(cuda_device, tmp_path):
    """The contended cases of ``torch_mesh_ranks.job_parallel_case`` over a
    spawned 2-rank NCCL mesh, one card a rank: every rank's result equals
    ``simulate`` on the padded jobs on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import torch_mesh_ranks as M

    kinds = ("dense", "fused")
    D.run_ranks(M.job_parallel_rank, 2, (str(tmp_path), kinds), device_type="cuda")
    for kind in kinds:
        jobs, sites, policy, kw = M.job_parallel_case(kind, cuda_device)
        want = M.flat(T.simulate(T.pad_jobs_capacity(jobs, jobs.capacity + jobs.capacity % 2),
                                 sites, policy, T.PRNGKey(3), device=cuda_device, **kw))
        for r in range(2):
            got = torch.load(tmp_path / kind / f"rank{r}.pt")
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                torch.testing.assert_close(got[k], v.cpu(), rtol=0, atol=0, equal_nan=True,
                                           msg=f"{kind} rank {r}: {k}")
