"""Data movement, transfer queues and faults in the port's ensembles
(``simulate_many`` lanes, ``simulate_ensemble``) against the JAX package's,
on the CPU.

The scenarios are the JAX package's own lane tests': availability,
workflows and data per lane (``test_ensemble_lanes.combo_scenarios``), plus
the transfer queues (``test_transfers.quad_scenarios``, flat, ragged and
bucketed), plus faults (``test_faults.quint_scenarios``).  Two tiers:
exact on ints, states and timestamps, ``rtol=1e-6`` on the f32 byte and
time accumulators.  Every lane also equals the port's own solo run of its
scenario, exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core.rng import PRNGKey, split  # noqa: E402
from repro_torch.kernels.assign import make_fused_capacity_assign  # noqa: E402
from test_data_movement import data_jobs, grid  # noqa: E402
from test_ensemble_lanes import combo_scenarios  # noqa: E402
from test_faults import quint_scenarios  # noqa: E402
from test_torch_ensemble import _flat, _lane  # noqa: E402
from test_transfers import quad_scenarios  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

ACCUMULATORS = {"bytes_moved", "disk_used", "site_disk", "site_net_in", "net_acc",
                "bytes_done", "bytes_enq", "bytes_cancel", "time_lost"}


def assert_close(want: dict, got: dict):
    """Every leaf of two flattened results: exact, or within ``rtol=1e-6``
    for the f32 accumulators; a mismatch names the leaf and its values."""
    assert sorted(want) == sorted(got), sorted(set(want) ^ set(got))
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert w.shape == g.shape, (k, w.shape, g.shape)
        if k.rsplit(".", 1)[-1] in ACCUMULATORS:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _np(state):
    if isinstance(state, tuple) and hasattr(state, "_asdict"):
        return {k: np.asarray(v) for k, v in state._asdict().items()}
    return tuple(_np(v) for v in state)


def to_port(scens):
    return [T.scenario_from_numpy(_np(s.jobs), _np(s.sites),
                                  {k: _np(v) for k, v in s.ext.items()}, device="cpu")
            for s in scens]


def port_subsystems(subs, data_policy="cache_on_read"):
    """The port's subsystem tuple for the JAX package's."""
    make = dict(availability=T.availability_subsystem, workflow=T.workflow_subsystem,
                transfers=T.transfers_subsystem)
    out = []
    for sub in subs:
        if sub.name == "data":
            out.append(T.data_subsystem(T.get_data_policy(data_policy)))
        elif sub.name == "faults":
            out.append(T.faults_subsystem(job_backoff=sub.config.job_backoff,
                                          blacklist=sub.config.blacklist))
        else:
            out.append(make[sub.name]())
    return tuple(out)


def solo_kw(ext: dict, data_policy="cache_on_read") -> dict:
    """``simulate``'s subsystem keywords for one lane's ``Scenario.ext``."""
    kw = {k: ext[k] for k in ("availability", "workflow", "transfers", "faults") if k in ext}
    if "data" in ext:
        kw.update(data_policy=T.get_data_policy(data_policy), network=ext["data"][0],
                  replicas=ext["data"][1])
    return kw


def assert_lanes_are_solo_runs(tscens, subs, policy, seed, res, lanes=None, **kw):
    """Lane ``i`` of ``res`` is the port's solo run of scenario ``i`` (jobs
    and job-shaped state padded to the ensemble's capacity) under
    ``split(PRNGKey(seed), K)[i]``, for every lane or the ``lanes`` given."""
    keys = split(PRNGKey(seed), len(tscens))
    cap = max(s.jobs.capacity for s in tscens)
    for i, s in enumerate(tscens):
        if lanes is not None and i not in lanes:
            continue
        ext = T.pad_ext_jobs(subs, s.ext, s.jobs.capacity, cap)
        solo = T.simulate(T.pad_jobs_capacity(s.jobs, cap), s.sites, policy, keys[i],
                          device="cpu", **solo_kw(ext), **kw)
        assert_close(_flat(solo), _lane(res, i))


def run_lanes(scens, subs, name, seed, **kw):
    rj = R.simulate_many(scens, R.get_policy(name), jax.random.PRNGKey(seed), subsystems=subs,
                         **kw)
    tscens, tsubs = to_port(scens), port_subsystems(subs)
    rt = T.simulate_many(tscens, T.get_policy(name), PRNGKey(seed), subsystems=tsubs,
                         device="cpu", **kw)
    assert_close(_flat(rj), _flat(rt))
    return tscens, tsubs, rt


@pytest.mark.parametrize("kw", [{}, dict(log_rows=16, monitor_every=3)], ids=["plain", "log"])
def test_availability_workflow_data_lanes(kw):
    scens, subs, _ = combo_scenarios()
    tscens, tsubs, rt = run_lanes(scens, subs, "critical_path_first", 4, **kw)
    assert int(rt.wf.n_produced.min()) > 0          # the DAGs materialize in every lane
    assert int(rt.replicas.n_transfers.min()) > 0   # and every lane reads over the WAN
    assert_lanes_are_solo_runs(tscens, tsubs, T.get_policy("critical_path_first"), 4, rt, **kw)


@pytest.mark.parametrize("layout", ["flat", "ragged", "bucketed"])
def test_transfer_lanes(layout):
    """``test_transfers.py``'s quad lanes; ragged lanes pad the transfer
    state through its ``pad_jobs`` hook, in one stack or bucket by bucket.
    As there, the ragged layout holds the most-padded lane (0) against its
    solo run; the bucketed run equals the ragged one."""
    sizes = None if layout == "flat" else [36, 52, 44]
    scens, subs, _ = quad_scenarios(sizes=sizes)
    name = "critical_path_first" if layout == "flat" else "panda_dispatch"
    if layout == "bucketed":
        tscens, tsubs = to_port(scens), port_subsystems(subs)
        sb = T.stack_scenarios(tscens, subsystems=tsubs, buckets=2)
        assert len(sb.buckets) == 2
        rt = T.simulate_many(sb, T.get_policy(name), PRNGKey(6), subsystems=tsubs,
                             device="cpu")
        flat = T.simulate_many(tscens, T.get_policy(name), PRNGKey(6), subsystems=tsubs,
                               device="cpu")
        assert_close(_flat(flat), _flat(rt))
    else:
        seed = 4 if layout == "flat" else 6
        tscens, tsubs, rt = run_lanes(scens, subs, name, seed)
        assert_lanes_are_solo_runs(tscens, tsubs, T.get_policy(name), seed, rt,
                                   lanes=None if layout == "flat" else (0,))
    assert int(rt.ext["transfers"].n_enq.min()) > 0   # every lane used its queues


def test_fault_lanes():
    """``test_faults.py``'s five-subsystem lanes: transfer failures with
    backoff, resubmission backoff, walltime kills, replica loss and the
    circuit breaker, each lane with its own fault state."""
    scens, subs, _ = quint_scenarios()
    tscens, tsubs, rt = run_lanes(scens, subs, "least_loaded", 4)
    fs = rt.ext["faults"]
    # every lane exercised the channels: failed transfers, kills, breaker probes
    for name in ("n_xfer_fail", "n_kills", "n_bl_trips", "n_probes"):
        assert int(getattr(fs, name).min()) > 0, name
    assert len(set(rt.rounds.tolist())) > 1            # the lanes froze at different rounds
    assert_lanes_are_solo_runs(tscens, tsubs, T.get_policy("least_loaded"), 4, rt)


def test_sparse_data_lanes():
    """``topk=`` with the data branch of the candidate index and the fused
    capacity assigner, on the combo lanes."""
    from repro.kernels.assign.ops import make_fused_capacity_assign as jax_make_fused

    scens, subs, _ = combo_scenarios()
    cores = scens[0].jobs.cores
    pj = R.with_fused_assign(R.get_policy("data_locality"),
                             jax_make_fused(cores, use_kernel=False))
    pt = T.with_fused_assign(T.get_policy("data_locality"),
                             make_fused_capacity_assign(torch.from_numpy(np.array(cores))))
    rj = R.simulate_many(scens, pj, jax.random.PRNGKey(2), subsystems=subs, topk=2)
    tscens, tsubs = to_port(scens), port_subsystems(subs)
    rt = T.simulate_many(tscens, pt, PRNGKey(2), subsystems=tsubs, device="cpu", topk=2)
    assert_close(_flat(rj), _flat(rt))
    assert_lanes_are_solo_runs(tscens, tsubs, pt, 2, rt, topk=2)


def _ensemble_inputs(kind):
    """``test_data_movement.py``'s ``simulate_ensemble`` workload, with one
    subsystem keyword set: JAX states and the port's."""
    jobs = data_jobs(32, n_datasets=6, seed=7)
    sites = grid(3)
    net = R.uniform_network(3, bw=1e9, latency=0.01)
    rep = R.make_replicas(R.zipf_dataset_sizes(6, seed=8, mean_bytes=2e9),
                          disk_capacity=np.full(3, 1e11), seed=9)
    kw_j, kw_t = {}, {}
    if kind in ("data_policy", "transfers", "faults"):
        kw_j = dict(data_policy=R.get_data_policy("cache_on_read"), network=net, replicas=rep)
        kw_t = dict(data_policy=T.get_data_policy("cache_on_read"),
                    network=T.network_from_numpy(_np(net), device="cpu"),
                    replicas=T.replicas_from_numpy(_np(rep), device="cpu"))
    if kind in ("transfers", "faults"):
        ts = R.make_transfers(3, jobs, max_active=2)
        kw_j["transfers"] = ts
        kw_t["transfers"] = T.transfers_from_numpy(_np(ts), device="cpu")
    if kind == "faults":
        fl = R.make_faults(3, jobs, link_fail_p=0.3, xfer_backoff=20.0, job_backoff=30.0,
                           walltime=900.0, blacklist_threshold=0.7, blacklist_alpha=0.4,
                           blacklist_cooldown=400.0)
        kw_j["faults"] = fl
        kw_t["faults"] = T.faults_from_numpy(_np(fl), device="cpu")
    if kind == "availability":
        av = R.make_availability(3, [dict(site=1, start=5.0, end=200.0, preempt=True)])
        kw_j["availability"] = av
        kw_t["availability"] = T.availability_from_numpy(_np(av), device="cpu")
    if kind == "workflow":
        jobs, wf = R.make_workflow(jobs, [(j - 1, j) for j in range(1, 32, 2)])
        kw_j["workflow"] = wf
        kw_t["workflow"] = T.workflow_from_numpy(_np(wf), device="cpu")
    return jobs, sites, kw_j, kw_t


@pytest.mark.parametrize("kind", ["availability", "workflow", "data_policy", "transfers",
                                  "faults"])
def test_simulate_ensemble_subsystem_keywords(kind):
    """``simulate_ensemble`` runs ``simulate``'s subsystem keywords in lanes,
    each state shared by every lane, as the JAX package's does."""
    jobs, sites, kw_j, kw_t = _ensemble_inputs(kind)
    speeds = (np.asarray(sites.speed)[None, :]
              * np.array([[0.5], [1.0], [2.0]], np.float32)).astype(np.float32)
    rj = R.simulate_ensemble(jobs, sites, R.get_policy("round_robin"), jax.random.PRNGKey(1),
                             speed_candidates=jnp.asarray(speeds), **kw_j)
    tj, ts = T.jobs_from_numpy(_np(jobs), device="cpu"), T.sites_from_numpy(_np(sites),
                                                                           device="cpu")
    rt = T.simulate_ensemble(tj, ts, T.get_policy("round_robin"), PRNGKey(1),
                             speed_candidates=torch.from_numpy(speeds), device="cpu", **kw_t)
    assert_close(_flat(rj), _flat(rt))
    if kind != "availability" and kind != "workflow":
        assert bool((rt.replicas.bytes_moved > 0).all())
    i = 2   # the fastest lane against its solo run
    solo = T.simulate(tj, ts._replace(speed=torch.from_numpy(speeds[i])),
                      T.get_policy("round_robin"), split(PRNGKey(1), 3)[i], device="cpu",
                      **kw_t)
    assert_close(_flat(solo), _lane(rt, i))
