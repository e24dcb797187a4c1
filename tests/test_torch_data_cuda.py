"""Data movement and transfer queues on the card against the CPU.  Marked
``cuda``: they skip where no GPU is present.  This file imports no JAX, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_data_cuda.py

Exact: a small run with availability, workflow DAGs, the data subsystem
(``cache_on_read`` under storage pressure) and the transfer queues,
including the catalog, the transfer rings and the exports; the ``[L, Q]``
ring mechanics and ``link_shares`` at S = 300 (``S * S + 1 = 90001``
segments of the segment sum).
"""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
import repro_torch.core.network as TN  # noqa: E402
import repro_torch.core.replicas as TR  # noqa: E402
import repro_torch.core.transfers as TT  # noqa: E402
from repro_torch.core import events as TE  # noqa: E402
from repro_torch.kernels.assign import assign_cuda as assign_mod  # noqa: E402
from repro_torch.kernels.assign import make_capacity_assign  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod  # noqa: E402

S = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _run(device):
    scn = T.atlas_mc_workflows(40, seed=0, arrival_span=3600.0, device=device)
    sites = T.atlas_like_platform(S, seed=1, fail_rate=0.02, device=device)
    av = T.make_availability(S, [dict(site=s, start=800.0 + 600.0 * s, end=1100.0 + 600.0 * s,
                                      preempt=True) for s in range(S)], device=device)
    rep = T.scenario_replicas(scn, sites.memory.cpu().numpy() * 3e7, seed=1)
    policy = T.with_capacity_assign(T.get_policy("least_loaded"),
                                    make_capacity_assign(scn.jobs.cores))
    return T.simulate(scn.jobs, sites, policy, T.PRNGKey(0), availability=av,
                      workflow=scn.workflow, data_policy=T.get_data_policy("cache_on_read"),
                      network=T.atlas_like_network(S, seed=2, device=device), replicas=rep,
                      transfers=T.make_transfers(S, scn.jobs, max_active=1, queue_slots=8,
                                                 device=device),
                      log_rows=64, max_rounds=400, device=device)


@pytest.mark.cuda
def test_data_transfer_run_card_equals_cpu(cuda_device):
    assign_mod.launches = segsum_mod.launches = 0
    TR.evicting_calls = 0
    card = _run(cuda_device)
    torch.cuda.synchronize()
    assert assign_mod.launches > 0 and segsum_mod.launches > 0
    cpu = _run(torch.device("cpu"))
    a, b = T.result_to_numpy(card), T.result_to_numpy(cpu)
    assert a["rounds"] == b["rounds"] and a["makespan"] == b["makespan"]
    for group in ("jobs", "sites", "avail", "wf", "replicas", "transfers", "log"):
        for k, v in b[group].items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    np.testing.assert_array_equal(a[group][k][kk], vv, err_msg=f"{group}.{k}.{kk}")
            else:
                np.testing.assert_array_equal(a[group][k], v, err_msg=f"{group}.{k}")
    ts = cpu.ext["transfers"]
    assert int(ts.n_enq) > 0 and int(ts.n_done) > 0
    assert int(ts.n_enq) == int(ts.n_done) + int(ts.n_cancel) + int((ts.stat > 0).sum())
    assert TE.to_csv(TE.transfer_rows(card)) == TE.to_csv(TE.transfer_rows(cpu))
    texts = []
    for res in (card, cpu):
        buf = io.StringIO()
        TE.write_ml_dataset(res, buf, segment=50)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]


def _rings(device, S=300, J=100_000, Q=256, seed=0):
    """A transfer state at WLCG scale with queued and active transfers on a
    few hundred links, some rings full, and a round's enqueuers."""
    rng = np.random.default_rng(seed)
    ts = T.make_transfers(S, J, max_active=4, queue_slots=Q, device="cpu")
    L = S * S
    busy = rng.choice(L, 400, replace=False)
    qlen = np.zeros(L, np.int32)
    qlen[busy] = rng.integers(0, Q + 1, 400)
    qlen[busy[:20]] = Q
    head = rng.integers(0, Q, L).astype(np.int32)
    queue = np.full((L, Q), -1, np.int32)
    queue[busy] = rng.integers(0, J, (400, Q))
    stat = rng.integers(0, 3, J).astype(np.int32)
    active = np.zeros(L, np.int32)
    active[busy] = rng.integers(0, 5, 400)
    ts = ts._replace(queue=torch.from_numpy(queue), tickets=torch.from_numpy(queue.copy()),
                     qlen=torch.from_numpy(qlen), head=torch.from_numpy(head),
                     stat=torch.from_numpy(stat), active=torch.from_numpy(active),
                     ticket=torch.arange(J, dtype=torch.int32),
                     n_enq=torch.tensor(J, dtype=torch.int32))
    want = (rng.random(J) < 0.02) & (stat == 0)
    link = np.where(rng.random(J) < 0.5, busy[rng.integers(0, 400, J)],
                    rng.integers(0, L, J)).astype(np.int32)
    nbytes = rng.lognormal(np.log(2e10), 1.0, J).astype(np.float32)
    resid = rng.uniform(0, 1e4, J).astype(np.float32)
    cache = rng.random(J) < 0.5
    args = [torch.from_numpy(x) for x in (want, link, nbytes, resid, cache)]
    move = lambda x: x.to(device) if isinstance(x, torch.Tensor) else x  # noqa: E731
    return (TT.TransferState(*[move(x) for x in ts]), [a.to(device) for a in args])


@pytest.mark.cuda
def test_rings_and_link_shares_at_wlcg_scale(cuda_device):
    """``_enqueue`` and ``_admit`` on ``[90000, 256]`` rings, and
    ``link_shares`` over 90001 segments: the card equals the CPU."""
    clock = 4321.5
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        ts, args = _rings(dev)
        segsum_mod.launches = 0
        ts, depth = TT._enqueue(ts, *args, torch.tensor(clock, device=dev))
        ts = TT._admit(ts, torch.tensor(clock, device=dev))
        if dev.type == "cuda":
            assert segsum_mod.launches > 0
        net = T.atlas_like_network(300, seed=2, device=dev)
        g = torch.Generator().manual_seed(1)
        src = torch.randint(0, 40, (100_000,), generator=g, dtype=torch.int32).to(dev)
        dst = torch.randint(0, 40, (100_000,), generator=g, dtype=torch.int32).to(dev)
        active = (torch.rand(100_000, generator=g) < 0.5).to(dev)
        nbytes = (torch.rand(100_000, generator=g) * 1e10).to(dev)
        out[dev.type] = (T.convert.to_numpy(ts), depth.cpu().numpy(),
                         TN.link_shares(net, src, dst, active).cpu().numpy(),
                         [x.cpu().numpy() for x in T.shared_transfer_times(net, src, dst,
                                                                            nbytes, active)])
    card, cpu = out["cuda"], out["cpu"]
    for k, v in cpu[0].items():
        np.testing.assert_array_equal(card[0][k], v, err_msg=k)
    np.testing.assert_array_equal(card[1], cpu[1])
    np.testing.assert_array_equal(card[2], cpu[2])
    for x, y in zip(card[3], cpu[3]):
        np.testing.assert_array_equal(x, y)
    assert int(cpu[0]["n_overflow"]) > 0 and cpu[2].max() > 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(100_000,), (1024, 300), (33,), (7, 5)])
def test_sum_f32_card_equals_cpu(cuda_device, shape):
    """The f32 column and counter sums of the catalog and the transfer
    ledger: one segment-sum launch a level on the card, the same bits as the
    CPU's sequential windows."""
    from repro_torch.core.scan import sum_f32

    g = torch.Generator().manual_seed(sum(shape))
    x = torch.exp(torch.randn(shape, generator=g) * 3) * (torch.rand(shape, generator=g) < 0.6)
    segsum_mod.launches = 0
    card = sum_f32(x.to(cuda_device), 0).cpu()
    assert 0 < segsum_mod.launches <= 4
    assert torch.equal(card.view(torch.int32), sum_f32(x, 0).view(torch.int32))
