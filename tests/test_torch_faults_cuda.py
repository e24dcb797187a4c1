"""Fault injection on the card against the CPU.  Marked ``cuda``: they skip
where no GPU is present.  This file imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_faults_cuda.py

Exact: a small run with every subsystem and all four fault channels armed
(the catalog, the transfer rings, the fault state, the log and the fault
exports included), the blackhole-site scenario under dense capacity
dispatch and the fused kernel at ``topk=6``, and two runs of each agree; the
half-open probe scatter keeps the highest row when several probes start at
one site, and the walltime-kill sums are the segment-sum kernel's.
"""
import io
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
import repro_torch.core.faults as TF  # noqa: E402
from repro_torch.core import events as TE  # noqa: E402
from repro_torch.core.engine import _site_sum  # noqa: E402
from repro_torch.kernels.assign import assign_cuda as assign_mod  # noqa: E402
from repro_torch.kernels.assign import fused_cuda as fused_mod  # noqa: E402
from repro_torch.kernels.assign import make_capacity_assign, make_fused_capacity_assign  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod  # noqa: E402

S = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _same(a, b, what=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), what
        for k in b:
            _same(a[k], b[k], f"{what}.{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def _exports(res) -> dict:
    buf = io.StringIO()
    TE.write_ml_dataset(res, buf, segment=50)
    return dict(faults=TE.to_csv(TE.fault_rows(res)), ml=buf.getvalue(),
                transitions=TE.to_csv(TE.transition_rows(res)))


def _everything(device):
    """Availability, workflows, data, transfers and every fault channel."""
    scn = T.atlas_mc_workflows(40, seed=0, arrival_span=3600.0, device=device)
    sites = T.atlas_like_platform(S, seed=1, fail_rate=0.2, device=device)
    av = T.make_availability(S, [dict(site=s, start=800.0 + 600.0 * s, end=1100.0 + 600.0 * s,
                                      preempt=True) for s in range(S)], device=device)
    rep = T.scenario_replicas(scn, sites.memory.cpu().numpy() * 3e7, seed=1)
    D = rep.size.shape[0]
    faults = T.make_faults(S, scn.jobs, link_fail_p=T.lossy_links(S, p=0.2, hot=1, seed=3),
                           xfer_backoff=30.0, job_backoff=60.0, walltime=600.0,
                           replica_loss=T.replica_loss_calendar(D, S, horizon=20000.0,
                                                                rate=1 / 200.0, seed=4),
                           blacklist_threshold=0.4, blacklist_alpha=0.3,
                           blacklist_cooldown=600.0, device=device)
    policy = T.with_capacity_assign(T.get_policy("least_loaded"),
                                    make_capacity_assign(scn.jobs.cores))
    return T.simulate(scn.jobs, sites, policy, T.PRNGKey(0), availability=av,
                      workflow=scn.workflow, data_policy=T.get_data_policy("cache_on_read"),
                      network=T.atlas_like_network(S, seed=2, device=device), replicas=rep,
                      transfers=T.make_transfers(S, scn.jobs, max_active=1, queue_slots=8,
                                                 device=device),
                      faults=faults, max_retries=5, log_rows=64, max_rounds=600, device=device)


@pytest.mark.cuda
def test_every_channel_card_equals_cpu(cuda_device):
    assign_mod.launches = segsum_mod.launches = 0
    card = _everything(cuda_device)
    torch.cuda.synchronize()
    assert assign_mod.launches > 0 and segsum_mod.launches > 0
    again = _everything(cuda_device)
    cpu = _everything(torch.device("cpu"))
    a, b = T.result_to_numpy(card), T.result_to_numpy(cpu)
    _same(a, b, "run")
    _same(T.result_to_numpy(again), a, "again")
    fs, ts = cpu.ext["faults"], cpu.ext["transfers"]
    assert int(fs.n_kills) > 0 and int(fs.n_xfer_fail) > 0 and int(fs.n_bl_trips) > 0
    assert int(ts.n_enq) == (int(ts.n_done) + int(ts.n_cancel) + int(fs.n_xfer_fail)
                             + int((ts.stat > 0).sum()))
    assert all(T.catalog_invariants(card.replicas).values())
    assert _exports(card) == _exports(cpu)


def _blackhole(device, n_jobs=600, seed=7):
    """``bench_faults.py``'s blackhole-site scenario at 8 sites."""
    sites, _ = T.flaky_grid(S, n_flaky=1, seed=12, cores_range=(8, 8), speed_range=(10.0, 10.0),
                            device=device)
    rng = np.random.default_rng(seed)
    jobs = T.synthetic_panda_jobs(n_jobs, seed=seed, capacity=n_jobs + 3, device=device)
    jobs = jobs._replace(
        arrival=torch.as_tensor(np.pad(np.sort(rng.uniform(0.0, 2000.0, n_jobs)), (0, 3),
                                       constant_values=np.inf), dtype=torch.float32,
                                device=device),
        work=torch.as_tensor(np.pad(rng.lognormal(np.log(800.0), 0.6, n_jobs), (0, 3)),
                             dtype=torch.float32, device=device),
        cores=torch.ones((jobs.capacity,), dtype=torch.int32, device=device),
        memory=torch.full((jobs.capacity,), 2.0, device=device),
    )
    return jobs, sites


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_blackhole_card_equals_cpu(cuda_device, fused):
    out = {}
    for dev in (cuda_device, cuda_device, torch.device("cpu")):
        jobs, sites = _blackhole(dev)
        base = T.get_policy("least_loaded")
        policy = (T.with_fused_assign(base, make_fused_capacity_assign(jobs.cores)) if fused
                  else T.with_capacity_assign(base, make_capacity_assign(jobs.cores)))
        faults = T.make_faults(S, jobs, job_backoff=120.0, blacklist_threshold=0.6,
                               blacklist_alpha=0.5, blacklist_cooldown=150.0, device=dev)
        fused_mod.launches = assign_mod.launches = 0
        res = T.simulate(jobs, sites, policy, T.PRNGKey(1), faults=faults, max_retries=6,
                         log_rows=256, topk=6 if fused else None, device=dev)
        if dev.type == "cuda":
            assert (fused_mod.launches if fused else assign_mod.launches) > 0
        out.setdefault(dev.type, []).append((T.result_to_numpy(res), _exports(res)))
    (a, ea), (b, eb) = out["cuda"]
    (c, ec), = out["cpu"]
    _same(a, c, "card vs cpu")
    _same(b, a, "two card runs")
    assert ea == eb == ec
    assert c["faults"]["n_bl_trips"] > 0 and c["faults"]["n_probes"] > 0


@pytest.mark.cuda
def test_probe_scatter_and_kill_sums(cuda_device):
    """Many probes starting at one half-open site in one round keep the
    highest job row on every run; the kill sums are the CPU's row-order sums."""
    J = 5000
    rng = np.random.default_rng(0)
    started_np, site_np = rng.random(J) < 0.3, rng.integers(0, S, J)
    killed_np = rng.random(J) < 0.2
    mem_np = rng.lognormal(1.0, 1.0, J).astype(np.float32)
    want = np.array([-1, 7, -1, -1, -1, -1, -1, -1])
    for s in (0, 4, 5, 6):          # the half-open sites without a probe
        want[s] = np.flatnonzero(started_np & (site_np == s)).max()
    sums = {}
    for dev in (cuda_device, torch.device("cpu")):
        fs = T.make_faults(S, J, blacklist_threshold=0.5, device=dev)
        fs = fs._replace(bl_state=torch.tensor([2, 2, 0, 1, 2, 2, 2, 0], dtype=torch.int32,
                                               device=dev),
                         probe_job=torch.tensor([-1, 7, -1, -1, -1, -1, -1, -1],
                                                dtype=torch.int32, device=dev))
        sub = TF.faults_subsystem(fs)
        started = torch.as_tensor(started_np, device=dev)
        site_c = torch.as_tensor(site_np, device=dev)
        for _ in range(3):
            ctx = types.SimpleNamespace(ext={"faults": fs}, started=started, site_c=site_c,
                                        S=S, J=J, scratch={})
            sub.on_start(sub, ctx)
            np.testing.assert_array_equal(ctx.ext["faults"].probe_job.cpu().numpy(), want)
        killed = torch.as_tensor(killed_np, device=dev)
        mem = torch.as_tensor(mem_np, device=dev)
        kill_site = torch.where(killed, site_c.int(), S)
        segsum_mod.launches = 0
        runs = [_site_sum(torch.where(killed, mem, 0.0), kill_site, S).cpu().numpy()
                for _ in range(2)]
        np.testing.assert_array_equal(runs[0], runs[1])
        if dev.type == "cuda":
            assert segsum_mod.launches == 2
        sums[dev.type] = runs[0]
    np.testing.assert_array_equal(sums["cuda"], sums["cpu"])
