"""Scenario ensembles on the card: the lane-batched assignment kernel against
its plain version and against one unbatched launch a lane, and ensemble
lanes against solo runs on the card.  Marked ``cuda``: they skip where no
GPU is present.  This file imports no JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ensemble_cuda.py

Exact: idx, admit and pos of the kernel (gate rtol 1e-5, atol 1e-6, its
``__expf``); every array of every lane's result.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.core.rng import split  # noqa: E402
from repro_torch.kernels.assign import assign_ref, make_capacity_assign  # noqa: E402
from repro_torch.kernels.assign import assign_cuda as assign_mod  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _inputs(K, N, E, seed, device):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(K, N, E)).astype(np.float32)
    scores[rng.random((K, N, E)) < 0.1] = -1e30
    sizes = rng.choice([1.0, 2.0, 8.0], size=(K, N)).astype(np.float32)
    caps = (rng.uniform(2, 40, size=(K, E)) * max(N / E / 4, 1)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (scores, sizes, caps))


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,E,k,bn", [
    (1, 1000, 301, 1, 256),     # one lane: the unbatched kernel's shape, E % 4 != 0
    (3, 777, 64, 3, 100),       # ragged tiles and row blocks, k > 1
    (3, 300, 8, 1, 256),        # narrower than a tile
    (16, 5000, 300, 1, 256),    # 16 lanes, the last tile of each lane ragged
    (16, 2000, 40, 2, 300),
])
def test_lane_batched_assign_kernel(cuda_device, K, N, E, k, bn):
    scores, sizes, caps = _inputs(K, N, E, K * N + E, cuda_device)
    assign_mod.launches = 0
    got = assign_mod.assign_cuda(scores, sizes, caps, k=k, block_n=bn)
    torch.cuda.synchronize()
    assert assign_mod.launches == 1                       # one call for all K lanes
    want = assign_ref(scores, sizes, caps, k=k, block_n=bn)
    for name, w, g in zip(("idx", "admit", "pos"), (want[0], want[2], want[3]),
                          (got[0], got[2], got[3])):
        assert torch.equal(w, g), f"{name}: {int((w != g).sum())} entries differ"
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    for i in range(K):        # each lane equals its own unbatched launch, bit for bit
        one = assign_mod.assign_cuda(scores[i], sizes[i], caps[i], k=k, block_n=bn)
        for a, b in zip(one, got):
            assert torch.equal(a, b[i])


def _scenarios(device, sizes, S=50):
    sites = T.atlas_like_platform(S, seed=1, fail_rate=0.02, device=device)
    return [T.Scenario(T.synthetic_panda_jobs(n, seed=10 + i, duration=3600.0, device=device),
                       sites._replace(speed=sites.speed * (0.7 + 0.1 * i)))
            for i, n in enumerate(sizes)]


@pytest.mark.cuda
def test_lanes_equal_solo_runs_on_the_card(cuda_device):
    sizes = [60, 110, 85, 95]
    scens = _scenarios(cuda_device, sizes)
    stacked = T.stack_scenarios(scens)
    work = [0]
    capacity_assign = make_capacity_assign(stacked.jobs.cores)

    def counted(*args):
        work[0] += 1
        return capacity_assign(*args)

    pol = T.with_capacity_assign(T.get_policy("panda_dispatch"), counted)
    key = T.PRNGKey(3)
    assign_mod.launches = segsum_mod.launches = 0
    res = T.simulate_many(stacked, pol, key, log_rows=64, device=cuda_device)
    torch.cuda.synchronize()
    assert assign_mod.launches == work[0] > 0     # once a round with work, for all lanes
    assert segsum_mod.launches > 0
    assert len(set(res.rounds.tolist())) > 1      # lanes drained at different rounds
    keys = split(key.to(cuda_device), len(sizes))
    for i, s in enumerate(scens):
        jobs = T.pad_jobs_capacity(s.jobs, max(sizes))
        solo_pol = T.with_capacity_assign(T.get_policy("panda_dispatch"),
                                          make_capacity_assign(jobs.cores))
        solo = T.result_to_numpy(T.simulate(jobs, s.sites, solo_pol, keys[i], log_rows=64,
                                            device=cuda_device))
        lane = T.result_to_numpy(res)
        assert int(lane["rounds"][i]) == int(solo["rounds"])
        assert lane["makespan"][i] == solo["makespan"]
        for group in ("jobs", "sites", "log"):
            for name, v in solo[group].items():
                if isinstance(v, dict):
                    continue
                np.testing.assert_array_equal(lane[group][name][i], v,
                                              err_msg=f"lane {i} {group}.{name}")
