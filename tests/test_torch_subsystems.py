"""Subsystem parity: the port's ``simulate`` with ``availability=``,
``workflow=`` and custom ``subsystems=`` against the JAX package's, on the
same seeded inputs, on the CPU.

Exact throughout: rounds, makespan, every job's state/site/retries and
timestamps, the site counters, ``n_preempted``, ``n_cancelled``, the
``site_avail`` log column and every builder's arrays.  With no data
subsystem these subsystems hold no float accumulators, so nothing needs a
tolerance.
"""
import json
from typing import NamedTuple

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro.core.availability as RA  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.engine import _site_sum as jax_site_sum  # noqa: E402
from repro.core.policies import with_capacity_assign as jax_with_capacity_assign  # noqa: E402
from repro.kernels.assign.ops import make_capacity_assign as jax_make_capacity_assign  # noqa: E402
from repro_torch.core import availability as TA  # noqa: E402
from repro_torch.core import rng as trng  # noqa: E402
from repro_torch.core.engine import _site_sum as torch_site_sum  # noqa: E402
from repro_torch.core.rng import PRNGKey  # noqa: E402
from repro_torch.kernels.assign import make_capacity_assign  # noqa: E402
from test_golden_trace import combo_kwargs, matrix_scenario  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

JOB_FIELDS = ("state", "site", "retries", "will_fail", "t_assign", "t_start", "t_finish",
              "preempted")
SITE_FIELDS = ("free_cores", "free_memory", "n_assigned", "n_finished", "n_failed")
LOG_FIELDS = ("time", "round_idx", "counts", "n_started", "n_completed", "site_free",
              "site_queued", "site_running", "cursor")


def _np_state(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _to_torch(jobs, sites, availability=None, workflow=None):
    out = dict(jobs=T.jobs_from_numpy(_np_state(jobs), device="cpu"),
               sites=T.sites_from_numpy(_np_state(sites), device="cpu"))
    if availability is not None:
        out["availability"] = T.availability_from_numpy(_np_state(availability), device="cpu")
    if workflow is not None:
        out["workflow"] = T.workflow_from_numpy(_np_state(workflow), device="cpu")
    return out


def _run_both(jobs, sites, pj, pt, seed, availability=None, workflow=None, **kw):
    rj = R.simulate(jobs, sites, pj, jax.random.PRNGKey(seed), availability=availability,
                    workflow=workflow, **kw)
    t = _to_torch(jobs, sites, availability, workflow)
    rt = T.simulate(t.pop("jobs"), t.pop("sites"), pt, PRNGKey(seed), device="cpu", **t, **kw)
    return rj, rt


def _assert_same_run(rj, rt, log=False):
    t = T.result_to_numpy(rt)
    assert int(rj.rounds) == int(t["rounds"])
    assert np.float32(rj.makespan) == t["makespan"]
    for f in JOB_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rj.jobs, f)), t["jobs"][f], err_msg=f)
    for f in SITE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rj.sites, f)), t["sites"][f], err_msg=f)
    assert (rj.avail is None) == (rt.avail is None) and (rj.wf is None) == (rt.wf is None)
    if rj.avail is not None:
        for f, a in _np_state(rj.avail).items():
            np.testing.assert_array_equal(a, t["avail"][f], err_msg=f"avail.{f}")
    if rj.wf is not None:
        for f, a in _np_state(rj.wf).items():
            np.testing.assert_array_equal(a, t["wf"][f], err_msg=f"wf.{f}")
    assert sorted(rj.ext) == sorted(rt.ext)
    if log:
        for f in LOG_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(rj.log, f)), t["log"][f], err_msg=f)
        assert sorted(rj.log.extra) == sorted(t["log"]["extra"])
        for k, a in rj.log.extra.items():
            np.testing.assert_array_equal(np.asarray(a), t["log"]["extra"][k], err_msg=k)
    return t


def _pols(name="panda_dispatch"):
    return R.get_policy(name), T.get_policy(name)


def test_golden_outage():
    """``tests/test_golden_trace.py``'s "outage" scenario: a preempting
    outage over site 3 (which carries the workload) and a brown-out on site
    2, with the event log and its ``site_avail`` column."""
    jobs = R.synthetic_panda_jobs(60, seed=11, duration=900.0)
    sites = R.atlas_like_platform(4, seed=12, fail_rate=0.05)
    av = R.make_availability(4, [dict(site=3, start=2000.0, end=20000.0, preempt=True),
                                 dict(site=2, start=500.0, end=5000.0, factor=0.5)])
    rj, rt = _run_both(jobs, sites, *_pols(), 0, availability=av, log_rows=64)
    _assert_same_run(rj, rt, log=True)
    assert int(rt.avail.n_preempted.sum()) > 0
    assert float(rt.log.extra["site_avail"].min()) == 0.0  # the outage was logged


@pytest.mark.parametrize("combo", ["plain", "avail", "wf", "avail+wf"])
def test_matrix_rows(combo):
    """The golden matrix's data-free rows, from ``matrix_scenario()``: a
    preempting outage, a brown-out and a drain window; pairwise DAG chains
    over half the jobs."""
    scn = matrix_scenario()
    jobs, kw = combo_kwargs(scn, False, "avail" in combo, "wf" in combo)
    rj, rt = _run_both(jobs, scn["sites"], *_pols(), 0, log_rows=32, monitor_every=2, **kw)
    _assert_same_run(rj, rt, log=True)


def _quantum_scenario():
    jobs = R.synthetic_panda_jobs(300, seed=21, duration=2000.0)
    sites = R.atlas_like_platform(6, seed=22, fail_rate=0.05)
    # short preempting outages every 6000 s on three of the six sites
    av = R.make_availability(6, [
        dict(site=s, start=t, end=t + 90.0, preempt=True)
        for s in (0, 2, 4) for t in np.arange(2000.0 + 700.0 * s, 60000.0, 6000.0)
    ] + [dict(site=1, start=1000.0, end=30000.0, factor=0.3)])
    return jobs, sites, av


def test_availability_at_quantum(monkeypatch):
    """At ``quantum > 0`` a round can jump past a window's start and a job's
    finish at once: the completion filter must preempt the job instead of
    completing it.  The filter is wrapped to show it fired."""
    jobs, sites, av = _quantum_scenario()
    removed = []
    real = TA._av_completion_filter

    def counting(sub, ctx, comp):
        out = real(sub, ctx, comp)
        removed.append(int((comp & ~out).sum()))
        return out

    monkeypatch.setattr(TA, "_av_completion_filter", counting)
    rj, rt = _run_both(jobs, sites, *_pols(), 3, availability=av, quantum=600.0)
    _assert_same_run(rj, rt)
    assert sum(removed) > 0, "the completion filter never held a job back"


def test_sparse_with_availability_and_workflow():
    """Sparse top-k with availability: the ``[1, S]`` availability mask is
    gathered at the candidates.  ``topk=S`` equals the dense run in the
    port, and ``topk=2`` equals the JAX package's ``topk=2``."""
    scn = matrix_scenario()
    jobs, kw = combo_kwargs(scn, False, True, True)
    t = _to_torch(jobs, scn["sites"], kw["availability"], kw["workflow"])
    pt = T.get_policy("panda_dispatch")
    dense = T.simulate(t["jobs"], t["sites"], pt, PRNGKey(0), availability=t["availability"],
                       workflow=t["workflow"], device="cpu")
    full = T.simulate(t["jobs"], t["sites"], pt, PRNGKey(0), availability=t["availability"],
                      workflow=t["workflow"], topk=4, device="cpu")
    a, b = T.result_to_numpy(dense), T.result_to_numpy(full)
    for f in JOB_FIELDS:
        np.testing.assert_array_equal(a["jobs"][f], b["jobs"][f], err_msg=f)
    assert a["rounds"] == b["rounds"] and a["makespan"] == b["makespan"]
    np.testing.assert_array_equal(a["avail"]["n_preempted"], b["avail"]["n_preempted"])
    rj, rt = _run_both(jobs, scn["sites"], *_pols(), 0, topk=2, **kw)
    _assert_same_run(rj, rt)


def test_capacity_dispatch_with_both():
    """Capacity dispatch (the assign kernel's path on the card) with both
    subsystems and the critical-path start order, on ATLAS-like 4-stage
    workflows: brown-out caps bind the start phase through ``start_cores``."""
    scn = R.atlas_mc_workflows(40, seed=0, arrival_span=3600.0)
    sites = R.atlas_like_platform(6, seed=1, fail_rate=0.02)
    fl = R.flaky_sites(6, np.arange(6), horizon=86400.0, mtbf=4 * 3600.0, mean_down=1800.0,
                       seed=2)
    rb = R.rolling_brownout(6, horizon=86400.0, factor=0.5)
    av = R.make_availability(6, _windows_of(fl) + _windows_of(rb))
    pj = jax_with_capacity_assign(R.get_policy("critical_path_first"),
                                  jax_make_capacity_assign(scn.jobs.cores))
    pt = T.with_capacity_assign(T.get_policy("critical_path_first"),
                                make_capacity_assign(torch.from_numpy(np.array(scn.jobs.cores))))
    rj, rt = _run_both(scn.jobs, sites, pj, pt, 0, availability=av, workflow=scn.workflow,
                       log_rows=16, max_rounds=600, max_retries=0)
    _assert_same_run(rj, rt, log=True)
    assert int(rt.avail.n_preempted.sum()) > 0
    assert int(rt.wf.n_cancelled) > 0  # a terminally failed parent cancelled its chain


def _windows_of(av):
    """Window dicts read back from a JAX-package ``AvailabilityState``."""
    start, end = np.asarray(av.win_start), np.asarray(av.win_end)
    factor, preempt = np.asarray(av.win_factor), np.asarray(av.win_preempt)
    return [dict(site=int(s), start=float(start[s, w]), end=float(end[s, w]),
                 factor=float(factor[s, w]), preempt=bool(preempt[s, w]))
            for s, w in zip(*np.nonzero(np.isfinite(start)))]


@pytest.mark.parametrize("name,salt", [("availability", 0), ("workflow", 3), ("scratch", 77)])
def test_round_ctx_subkey_bits(name, salt):
    key = jax.random.PRNGKey(5)
    for rnd in range(3):
        key, _ = jax.random.split(key)
        tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
        cj = R.RoundCtx(jobs=R.synthetic_panda_jobs(2, seed=0), sites=R.atlas_like_platform(2),
                        ext={}, clock_prev=0.0, max_retries=3, rng=key)
        ct = T.RoundCtx(jobs=T.synthetic_panda_jobs(2, seed=0, device="cpu"),
                        sites=T.atlas_like_platform(2, device="cpu"), ext={}, clock_prev=0.0,
                        max_retries=3, rng=tkey)
        np.testing.assert_array_equal(np.asarray(cj.subkey(name, salt)).astype(np.int64),
                                      ct.subkey(name, salt).numpy())
    with pytest.raises(ValueError, match="rng="):
        T.RoundCtx(jobs=ct.jobs, sites=ct.sites, ext={}, clock_prev=0.0,
                   max_retries=3).subkey(name)


# --------------------------------------------------------------------------
# a custom subsystem, modelled on examples/custom_subsystem.py, once per package
# --------------------------------------------------------------------------


class Scratch(NamedTuple):
    used: object      # f32[S]
    leaked: object    # f32[S]
    capacity: object  # f32[S]
    n_purges: object  # i32[]


LEAK, PERIOD = 0.5, 4 * 3600.0


def _jax_scratch():
    def event_times(sub, ctx):
        return (jnp.floor(ctx.clock_prev / PERIOD) + 1.0) * PERIOD

    def on_completions(sub, ctx):
        st = ctx.ext["scratch"]
        jobs = ctx.jobs
        comp_site = jnp.where(ctx.comp, jobs.site, ctx.S)
        scratch = jnp.where(ctx.comp, jobs.bytes_out, 0.0)
        freed = jax_site_sum(scratch * (1.0 - LEAK), comp_site, ctx.S)
        leak = jax_site_sum(scratch * LEAK, comp_site, ctx.S)
        used, leaked = st.used - freed, st.leaked + leak
        fired = jnp.floor(ctx.clock / PERIOD) > jnp.floor(ctx.clock_prev / PERIOD)
        ctx.ext["scratch"] = st._replace(
            used=jnp.where(fired, used - leaked, used), leaked=jnp.where(fired, 0.0, leaked),
            n_purges=st.n_purges + fired.astype(jnp.int32))

    def pre_assign(sub, ctx):
        st = ctx.ext["scratch"]
        ctx.feasible = ctx.feasible & (st.used < st.capacity)[None, :]

    def on_start(sub, ctx):
        st = ctx.ext["scratch"]
        u = jax.random.uniform(ctx.subkey("scratch"), (ctx.J,))
        dep = jax_site_sum(jnp.where(ctx.started, ctx.jobs.bytes_out * (0.5 + u), 0.0),
                           ctx.start_site, ctx.S)
        ctx.ext["scratch"] = st._replace(used=st.used + dep)

    def finalize(sub, st, jobs, sites, clock):
        return st, {}

    return R.make_subsystem(
        "scratch", event_times=event_times, on_completions=on_completions,
        pre_assign=pre_assign, on_start=on_start, finalize=finalize,
        log_spec=lambda sub, st, jobs, sites: {"site_scratch": st.used},
        log_columns=lambda sub, ctx, write: {"site_scratch": ctx.ext["scratch"].used},
    )


def _torch_scratch():
    def event_times(sub, ctx):
        return (torch.floor(ctx.clock_prev / PERIOD) + 1.0) * PERIOD

    def on_completions(sub, ctx):
        st = ctx.ext["scratch"]
        jobs = ctx.jobs
        comp_site = torch.where(ctx.comp, jobs.site, ctx.S)
        scratch = torch.where(ctx.comp, jobs.bytes_out, 0.0)
        freed = torch_site_sum(scratch * (1.0 - LEAK), comp_site, ctx.S)
        leak = torch_site_sum(scratch * LEAK, comp_site, ctx.S)
        used, leaked = st.used - freed, st.leaked + leak
        fired = torch.floor(ctx.clock / PERIOD) > torch.floor(ctx.clock_prev / PERIOD)
        ctx.ext["scratch"] = st._replace(
            used=torch.where(fired, used - leaked, used), leaked=torch.where(fired, 0.0, leaked),
            n_purges=st.n_purges + fired.int())

    def pre_assign(sub, ctx):
        st = ctx.ext["scratch"]
        ctx.feasible = ctx.feasible & (st.used < st.capacity)[None, :]

    def on_start(sub, ctx):
        st = ctx.ext["scratch"]
        u = trng.uniform(ctx.subkey("scratch"), (ctx.J,))
        dep = torch_site_sum(torch.where(ctx.started, ctx.jobs.bytes_out * (0.5 + u), 0.0),
                             ctx.start_site, ctx.S)
        ctx.ext["scratch"] = st._replace(used=st.used + dep)

    def finalize(sub, st, jobs, sites, clock):
        return st, {}

    return T.make_subsystem(
        "scratch", event_times=event_times, on_completions=on_completions,
        pre_assign=pre_assign, on_start=on_start, finalize=finalize,
        log_spec=lambda sub, st, jobs, sites: {"site_scratch": st.used},
        log_columns=lambda sub, ctx, write: {"site_scratch": ctx.ext["scratch"].used},
    )


def test_custom_subsystem():
    """A scratch-disk leak model (``examples/custom_subsystem.py``) with a
    subsystem key stream, beside availability: the same run, the same
    subsystem state and the same log column in both packages."""
    jobs = R.synthetic_panda_jobs(300, seed=0, duration=6 * 3600.0)
    sites = R.atlas_like_platform(4, seed=1)
    sj = Scratch(used=jnp.zeros(4, jnp.float32), leaked=jnp.zeros(4, jnp.float32),
                 capacity=jnp.full(4, 4e10, jnp.float32), n_purges=jnp.zeros((), jnp.int32))
    st = Scratch(**{k: torch.from_numpy(np.array(v)) for k, v in sj._asdict().items()})
    av = R.make_availability(4, [dict(site=0, start=5000.0, end=9000.0, preempt=True)])
    rj = R.simulate(jobs, sites, R.get_policy("panda_dispatch"), jax.random.PRNGKey(0),
                    availability=av, subsystems=((_jax_scratch(), sj),), log_rows=128)
    t = _to_torch(jobs, sites, av)
    rt = T.simulate(t["jobs"], t["sites"], T.get_policy("panda_dispatch"), PRNGKey(0),
                    availability=t["availability"], subsystems=((_torch_scratch(), st),),
                    log_rows=128, device="cpu")
    _assert_same_run(rj, rt, log=True)
    for f in Scratch._fields:
        np.testing.assert_array_equal(np.asarray(getattr(rj.ext["scratch"], f)),
                                      getattr(rt.ext["scratch"], f).numpy(), err_msg=f)
    assert int(rt.ext["scratch"].n_purges) > 0


def test_resolve_subsystems_rules():
    jobs = T.synthetic_panda_jobs(10, seed=0, device="cpu")
    sites = T.atlas_like_platform(3, seed=0, device="cpu")
    pol, key = T.get_policy("panda_dispatch"), PRNGKey(0)
    # the data subsystem needs both matrices and the catalog; the transfer
    # queues need the data subsystem (the JAX package's rules)
    net = T.uniform_network(3, device="cpu")
    rep = T.make_replicas(np.full(2, 1e9), np.full(3, 1e12), device="cpu")
    data = T.get_data_policy("cache_on_read")
    for kw in (dict(data_policy=data), dict(data_policy=data, network=net),
               dict(data_policy=data, replicas=rep)):
        with pytest.raises(ValueError, match="requires both network= and replicas="):
            T.simulate(jobs, sites, pol, key, device="cpu", **kw)
    for kw in (dict(), dict(network=net, replicas=rep)):
        with pytest.raises(ValueError, match="transfers= requires the data subsystem"):
            T.simulate(jobs, sites, pol, key, device="cpu",
                       transfers=T.make_transfers(3, 10, device="cpu"), **kw)
    # the canonical order: availability, workflow, data, transfers, faults,
    # then the caller's subsystems
    subs, ext = T.resolve_subsystems(
        subsystems=((T.make_subsystem("mine"), ()),),
        faults=T.make_faults(3, 10, job_backoff=60.0, device="cpu"),
        transfers=T.make_transfers(3, 10, device="cpu"),
        data_policy=data, network=net, replicas=rep, workflow=T.make_workflow(jobs, [])[1],
        availability=T.make_availability(3, device="cpu"), validate=False)
    assert [s.name for s in subs] == ["availability", "workflow", "data", "transfers", "faults",
                                      "mine"]
    assert subs[4].config.mutates_arrival and sorted(ext) == sorted(s.name for s in subs)
    subs, _ = T.resolve_subsystems(faults=T.make_faults(3, 10, device="cpu"),
                                   availability=T.make_availability(3, device="cpu"),
                                   jobs=jobs, sites=sites)
    assert [s.name for s in subs] == ["availability", "faults"]
    sub = T.make_subsystem("x")
    with pytest.raises(TypeError, match="pairs"):
        T.simulate(jobs, sites, pol, key, device="cpu", subsystems=(sub,))
    with pytest.raises(ValueError, match="duplicate"):
        T.simulate(jobs, sites, pol, key, device="cpu", subsystems=((sub, ()), (sub, ())))
    with pytest.raises(ValueError, match="availability has 4 sites"):
        T.simulate(jobs, sites, pol, key, device="cpu",
                   availability=T.make_availability(4, device="cpu"))
    _, wf = T.make_workflow(T.synthetic_panda_jobs(12, seed=0, device="cpu"), [(0, 1)])
    with pytest.raises(ValueError, match="workflow has 12 job rows"):
        T.simulate(jobs, sites, pol, key, device="cpu", workflow=wf)
    meta = T.make_availability(3, device="cpu")._replace(
        n_preempted=torch.zeros(3, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="availability.n_preempted lies on meta"):
        T.simulate(jobs, sites, pol, key, device="cpu", availability=meta)
    # pad_ext_jobs grows the parent matrix with parentless rows
    subs, ext = T.resolve_subsystems(workflow=wf, validate=False)
    grown = T.pad_ext_jobs(subs, ext, 12, 15)["workflow"].parents
    assert grown.shape == (15, 1) and bool((grown[12:] == -1).all())


def test_walltimes_and_queue_times():
    jobs = R.synthetic_panda_jobs(60, seed=11, duration=900.0)
    sites = R.atlas_like_platform(4, seed=12, fail_rate=0.05)
    rj, rt = _run_both(jobs, sites, *_pols(), 0, max_rounds=40)
    for fj, ft in ((R.walltimes, T.walltimes), (R.queue_times, T.queue_times)):
        np.testing.assert_array_equal(np.asarray(fj(rj)), ft(rt).numpy())


# --------------------------------------------------------------------------
# builders
# --------------------------------------------------------------------------


def _same_state(a, b, what):
    for f, x in _np_state(a).items():
        np.testing.assert_array_equal(x, getattr(b, f).numpy(), err_msg=f"{what}.{f}")


def test_availability_builders():
    cases = [
        ("maintenance_calendar", dict(horizon=30 * 86400.0), dict(n_sites=7)),
        ("maintenance_calendar", dict(horizon=20 * 86400.0, period=86400.0, stagger=False,
                                      sites=[1, 4], preempt=True), dict(n_sites=6)),
        ("flaky_sites", dict(horizon=86400.0, mtbf=4 * 3600.0, seed=2), dict(n_sites=9)),
        ("rolling_brownout", dict(horizon=86400.0, factor=0.25, start=600.0), dict(n_sites=5)),
        ("rolling_brownout", dict(horizon=86400.0, sites=[]), dict(n_sites=3)),
    ]
    for name, kw, sz in cases:
        args = (sz["n_sites"],) + ((np.arange(0, sz["n_sites"], 2),) if name == "flaky_sites"
                                   else ())
        _same_state(getattr(R, name)(*args, **kw), getattr(T, name)(*args, **kw, device="cpu"),
                    name)
    flaky = np.zeros(9, bool)
    flaky[[1, 2, 7]] = True
    _same_state(R.flaky_sites(9, flaky, horizon=86400.0, max_windows=12, seed=4),
                T.flaky_sites(9, flaky, horizon=86400.0, max_windows=12, seed=4, device="cpu"),
                "flaky_sites(mask)")
    tier = np.array([0, 0, 1, 1, 1, 2, 2, 2])
    for kw in (dict(seed=3), dict(seed=4, jitter=600.0, factor=0.5, preempt=False)):
        _same_state(R.sample_correlated_outages(8, tier, horizon=86400.0, **kw),
                    T.sample_correlated_outages(8, tier, horizon=86400.0, device="cpu", **kw),
                    "sample_correlated_outages")
    with pytest.raises(ValueError, match="tier must be"):
        T.sample_correlated_outages(3, [0, 1], horizon=1.0, device="cpu")
    spec = {"windows": [{"site": "b", "start": 10.0, "end": 20.0},
                        {"site": 2, "start": 5.0, "end": 50.0, "factor": 0.5, "preempt": True},
                        {"site": "b", "start": 1.0, "end": 3.0}]}
    names = ["a", "b", "c"]
    _same_state(R.load_availability(spec, names), T.load_availability(spec, names, device="cpu"),
                "load_availability")
    _same_state(R.load_availability(json.dumps(spec), names, n_sites=4),
                T.load_availability(json.dumps(spec), names, n_sites=4, device="cpu"),
                "load_availability(json)")
    with pytest.raises(ValueError, match="unknown site name"):
        T.load_availability({"windows": [{"site": "z", "start": 0, "end": 1}]}, names,
                            device="cpu")
    with pytest.raises(ValueError, match="names= or n_sites="):
        T.load_availability(spec, device="cpu")
    for bad, msg in (([(5, 0.0, 1.0)], "out of range"), ([(0, 2.0, 1.0)], "must be >"),
                     ([(0, 0.0, 1.0, 1.5)], "factor"), ([(0, 0, 1), (0, 2, 3)], "max_windows")):
        with pytest.raises(ValueError, match=msg):
            T.make_availability(2, bad, max_windows=1 if msg == "max_windows" else None,
                                device="cpu")


def test_availability_helpers():
    av = R.make_availability(3, [(0, 10.0, 20.0, 0.0, True), (0, 15.0, 30.0, 0.5),
                                 (1, 5.0, 8.0, 0.0, False), (2, 0.0, 100.0, 0.0, True)])
    tav = T.availability_from_numpy(_np_state(av), device="cpu")
    for t in (0.0, 5.0, 12.0, 15.0, 20.0, 29.0, 30.0, 200.0):
        tt = torch.tensor(t, dtype=torch.float32)
        np.testing.assert_array_equal(np.asarray(RA.active_windows(av, t)),
                                      TA.active_windows(tav, tt).numpy())
        np.testing.assert_array_equal(np.asarray(R.availability_factor(av, t)),
                                      T.availability_factor(tav, tt).numpy())
        np.testing.assert_array_equal(np.asarray(R.next_window_edge(av, t)),
                                      T.next_window_edge(tav, tt).numpy())
        np.testing.assert_array_equal(
            np.asarray(RA.preempting_sites(av, t, t + 7.0)),
            TA.preempting_sites(tav, tt, tt + 7.0).numpy())
    for horizon in (0.0, 25.0, 1000.0):
        np.testing.assert_array_equal(R.downtime_fraction(av, horizon),
                                      T.downtime_fraction(tav, horizon))


def test_make_workflow_and_errors():
    jobs = R.synthetic_panda_jobs(12, seed=1, capacity=15)
    tjobs = T.jobs_from_numpy(_np_state(jobs), device="cpu")
    edges = [(0, 2), (1, 2), (2, 3), (2, 4), (3, 5), (4, 5), (5, 6), (8, 9), (0, 2)]
    for kw in (dict(), dict(wf_id=np.arange(12) % 3, out_dataset=np.arange(12), max_parents=3)):
        jj, wj = R.make_workflow(jobs, edges, **kw)
        jt, wt = T.make_workflow(tjobs, edges, **kw)
        _same_state(jj, jt, "jobs")
        _same_state(wj, wt, "workflow")
    for bad, msg in (([(0, 12)], "outside"), ([(3, 3)], "self-edge"),
                     ([(0, 1), (1, 2), (2, 0)], "cycle")):
        with pytest.raises(ValueError, match=msg):
            T.make_workflow(tjobs, bad)
    with pytest.raises(ValueError, match="max_parents=1"):
        T.make_workflow(tjobs, [(0, 2), (1, 2)], max_parents=1)
    ready_j, dead_j = R.parent_status(wj.parents, jnp.asarray(np.arange(15) % 7, jnp.int32))
    ready_t, dead_t = T.parent_status(wt.parents, torch.arange(15, dtype=torch.int32) % 7)
    np.testing.assert_array_equal(np.asarray(ready_j), ready_t.numpy())
    np.testing.assert_array_equal(np.asarray(dead_j), dead_t.numpy())


@pytest.mark.parametrize("builder,args,kw", [
    ("chain_workflows", (7, 3), dict(seed=2, arrival_span=600.0, stage_work=[1.0, 2.0],
                                     stage_cores=[1, 8], priority=np.arange(21) % 3)),
    ("chain_workflows", (5,), dict(capacity=24)),
    ("atlas_mc_workflows", (9,), dict(seed=0, arrival_span=3600.0)),
    ("map_reduce_workflows", (4, 3), dict(seed=5, arrival_span=900.0)),
    ("map_reduce_workflows", (2, 5), dict(capacity=20)),
])
def test_workflow_scenario_builders(builder, args, kw):
    sj = getattr(R, builder)(*args, **kw)
    st = getattr(T, builder)(*args, **kw, device="cpu")
    _same_state(sj.jobs, st.jobs, "jobs")
    _same_state(sj.workflow, st.workflow, "workflow")
    for f in ("ds_sizes", "ds_origin", "ds_materialized"):
        np.testing.assert_array_equal(getattr(sj, f), getattr(st, f), err_msg=f)


def test_workflow_locality_policy():
    """``workflow_locality`` with the run's DAG: the parent-site bonus in the
    score and the critical-path start order, on a map-reduce scenario."""
    scn = R.map_reduce_workflows(6, 3, seed=1, arrival_span=600.0)
    sites = R.atlas_like_platform(5, seed=3, fail_rate=0.05)
    t = _to_torch(scn.jobs, sites, workflow=scn.workflow)
    pj = R.get_policy("workflow_locality", workflow=scn.workflow, w_local=50.0)
    pt = T.get_policy("workflow_locality", workflow=t["workflow"], w_local=50.0)
    rj, rt = _run_both(scn.jobs, sites, pj, pt, 2, workflow=scn.workflow)
    _assert_same_run(rj, rt)
    assert pt.name == pj.name
    # a capacity grown by padding pads the closed-over parent matrix too
    jobs_p = T.pad_jobs_capacity(t["jobs"], t["jobs"].capacity + 3)
    s = pt.score(jobs_p, t["sites"], (), torch.zeros(()), PRNGKey(0))
    assert s.shape == (jobs_p.capacity, 5)

