"""Scenario ensembles on the card: the lane-batched assignment and fused
kernels against their plain versions and against one unbatched launch a
lane, and ensemble lanes (dense, sparse, and with data, transfer queues and
faults) against solo runs on the card.  Marked ``cuda``: they skip where no
GPU is present.  This file imports no JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ensemble_cuda.py

Exact: idx, admit and pos of the assign kernel (gate rtol 1e-5, atol 1e-6,
its ``__expf``); site and admit of the fused kernel; every array of every
lane's result.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.core.rng import split  # noqa: E402
from repro_torch.kernels.assign import (  # noqa: E402
    assign_ref,
    fused_assign_ref,
    make_capacity_assign,
    make_fused_capacity_assign,
)
from repro_torch.kernels.assign import assign_cuda as assign_mod  # noqa: E402
from repro_torch.kernels.assign import fused_cuda as fused_mod  # noqa: E402
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


def _fused_inputs(K, N, E, Kc, seed, device):
    """K problems of candidate rows: sorted distinct site ids, each row with
    a random number of sentinel (``E``) pads; integral sizes."""
    g = torch.Generator(device=device).manual_seed(seed)
    scores = torch.randn((K, N, Kc), generator=g, device=device)
    cand = torch.rand((K, N, E), generator=g, device=device).argsort(-1)[..., :Kc]
    filled = torch.randint(0, Kc + 1, (K, N, 1), generator=g, device=device)
    cand = torch.where(torch.arange(Kc, device=device) < filled, cand, E)
    cand = cand.sort(-1).values.int()
    sizes = torch.where(torch.rand((K, N), generator=g, device=device) < 0.5, 1.0, 8.0)
    caps = (torch.rand((K, E), generator=g, device=device) * 38 + 2) * max(N / E, 1.0)
    return scores, cand.contiguous(), sizes, caps.floor()


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,E,Kc", [
    (1, 1000, 300, 16),       # one lane: the unbatched kernel's code
    (3, 777, 50, 8),          # ragged tiles
    (3, 300, 7, 4),           # narrower than a tile
    (3, 3000, 2000, 8),       # sites past the shared-memory table
    (16, 2000, 40, 3),        # no 16-byte loads
    (16, 5000, 300, 16),      # 16 lanes, the last tile of each lane ragged
])
def test_lane_batched_fused_kernel(cuda_device, K, N, E, Kc):
    args = _fused_inputs(K, N, E, Kc, K * N + E, cuda_device)
    fused_mod.launches = 0
    got = fused_mod.fused_assign_cuda(*args)
    torch.cuda.synchronize()
    assert fused_mod.launches == 1                        # one call for all K lanes
    want = fused_assign_ref(*args)
    for name, w, g in zip(("site", "admit"), want, got):
        assert torch.equal(w, g), f"{name}: {int((w != g).sum())} entries differ"
    assert bool(got[1].any()) and bool((~got[1]).any())
    for i in range(K):        # each lane equals its own unbatched launch, bit for bit
        one = fused_mod.fused_assign_cuda(*(a[i].contiguous() for a in args))
        for a, b in zip(one, got):
            assert torch.equal(a, b[i])


def _assert_lane_is_solo(res, i, solo):
    lane, solo = T.result_to_numpy(res), T.result_to_numpy(solo)
    assert int(lane["rounds"][i]) == int(solo["rounds"])
    assert lane["makespan"][i] == solo["makespan"]
    for group, values in solo.items():
        if not isinstance(values, dict):
            continue
        for name, v in values.items():
            if isinstance(v, dict):
                continue
            np.testing.assert_array_equal(lane[group][name][i], v,
                                          err_msg=f"lane {i} {group}.{name}")


@pytest.mark.cuda
def test_sparse_lanes_equal_solo_runs_on_the_card(cuda_device):
    sizes = [60, 110, 85, 95]
    scens = _scenarios(cuda_device, sizes)
    stacked = T.stack_scenarios(scens)
    work = [0]
    fused = make_fused_capacity_assign(stacked.jobs.cores)

    def counted(*args):
        work[0] += 1
        return fused(*args)

    pol = T.with_fused_assign(T.get_policy("data_locality"), counted)
    key = T.PRNGKey(3)
    fused_mod.launches = 0
    res = T.simulate_many(stacked, pol, key, topk=8, log_rows=64, device=cuda_device)
    torch.cuda.synchronize()
    assert fused_mod.launches == work[0] > 0      # once a round with work, for all lanes
    assert len(set(res.rounds.tolist())) > 1
    keys = split(key.to(cuda_device), len(sizes))
    for i, s in enumerate(scens):
        jobs = T.pad_jobs_capacity(s.jobs, max(sizes))
        solo_pol = T.with_fused_assign(T.get_policy("data_locality"),
                                       make_fused_capacity_assign(jobs.cores))
        solo = T.simulate(jobs, s.sites, solo_pol, keys[i], topk=8, log_rows=64,
                          device=cuda_device)
        _assert_lane_is_solo(res, i, solo)


@pytest.mark.cuda
def test_data_transfer_fault_lanes_equal_solo_runs_on_the_card(cuda_device):
    """Three lanes with their own catalogs, transfer queues and fault states
    (the JAX package's five-subsystem lane test without its calendars)."""
    S, D, dev = 4, 8, cuda_device
    sites = T.atlas_like_platform(S, seed=7, device=dev)
    net = T.uniform_network(S, bw=5e8, latency=0.05, device=dev)
    subs = (T.data_subsystem(T.get_data_policy("cache_on_read")), T.transfers_subsystem(),
            T.faults_subsystem(job_backoff=True, blacklist=True))
    scens, solo_kw = [], []
    for k in range(3):
        jobs = T.synthetic_panda_jobs(44, seed=30 + k, duration=600.0, n_datasets=D,
                                      device=dev)
        rep = T.make_replicas(T.zipf_dataset_sizes(D, seed=3 + k, mean_bytes=1e9),
                              np.full(S, 1e12), origin=np.zeros(D, np.int32), device=dev)
        ts = T.make_transfers(S, jobs, max_active=1 + k, device=dev)
        fl = T.make_faults(S, jobs, link_fail_p=0.15 + 0.1 * k, xfer_backoff=20.0,
                           job_backoff=30.0, walltime=5000.0 + 500.0 * k,
                           replica_loss=[(400.0 * (k + 1), 1 + k, (k + 1) % S)],
                           blacklist_threshold=0.7, blacklist_alpha=0.4,
                           blacklist_cooldown=400.0, device=dev)
        scens.append(T.Scenario(jobs, sites._replace(speed=sites.speed * (0.8 + 0.2 * k)),
                                {"data": (net, rep), "transfers": ts, "faults": fl}))
        solo_kw.append(dict(data_policy=T.get_data_policy("cache_on_read"), network=net,
                            replicas=rep, transfers=ts, faults=fl))
    pol = T.get_policy("least_loaded")
    key = T.PRNGKey(4)
    res = T.simulate_many(scens, pol, key, subsystems=subs, log_rows=32, device=dev)
    assert int(res.ext["faults"].n_xfer_fail.sum()) > 0
    keys = split(key.to(dev), 3)
    for i, s in enumerate(scens):
        solo = T.simulate(s.jobs, s.sites, pol, keys[i], log_rows=32, device=dev, **solo_kw[i])
        _assert_lane_is_solo(res, i, solo)


@pytest.mark.cuda
def test_lanes_over_two_cards_equal_one_card(cuda_device, tmp_path):
    """``simulate_many_sharded`` over a spawned 2-rank NCCL mesh, one card a
    rank, each rank with capacity dispatch for its own lanes: every rank's
    gathered result equals one ``simulate_many`` of all lanes on cuda:0
    (K = 3 pads rank 1's block with a repeat of lane 2)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import torch_mesh_ranks as M
    from repro_torch.core.distributed import run_ranks

    K = 3
    run_ranks(M.card_lanes_rank, 2, (str(tmp_path), K), device_type="cuda")
    stacked = T.stack_scenarios(M.card_lanes(K, cuda_device))
    want = M.flat(T.simulate_many(stacked, M.card_policy(stacked, list(range(K))),
                                  T.PRNGKey(3), max_rounds=300, device=cuda_device))
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            torch.testing.assert_close(got[k], v.cpu(), rtol=0, atol=0, equal_nan=True,
                                       msg=f"rank {r}: {k}")
