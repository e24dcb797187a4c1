"""Fault injection in the port (``core/faults.py``, the transfer-failure
branch of ``core/transfers.py``, the fault builders, ``load_faults`` and
the fault exports) against the JAX package's, on the same seeded inputs, on
the CPU.

Tolerances as ROADMAP's port rules set them: exact for ints, bools, states,
rounds and timestamps (``retry_at``, ``backoff_wait``, ``bl_until``, the
EWMA ``score`` included); ``rtol=1e-6`` for the f32 accumulators
``time_lost``, ``bytes_cancel`` and ``disk_used``.  The comparisons are
against what live ``repro`` outputs, never against the committed goldens.

Two cases exist for the traps the golden matrix cannot show: retries and
transfer attempts of at least 16, where XLA's ``exp2`` misses ``2^k`` and
``clock + base * 2^k`` is one fused multiply-add, and an EWMA at alpha = 0.3
(the matrix's 0.5 and the default 0.25 are powers of two).
"""
import io
import json
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro.core.events as RE  # noqa: E402
import repro.core.faults as RF  # noqa: E402
import repro.core.monitor as RM  # noqa: E402
import repro.core.platform as RP  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.events as TE  # noqa: E402
import repro_torch.core.faults as TF  # noqa: E402
import repro_torch.core.monitor as TM  # noqa: E402
import repro_torch.core.platform as TP  # noqa: E402
import repro_torch.core.transfers as TT  # noqa: E402
from repro_torch.core.rng import PRNGKey  # noqa: E402
from test_golden_trace import combo_kwargs, matrix_scenario  # noqa: E402
from test_torch_data import _check_group, _np_state, _pols, _port_kw, assert_same_run  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

FAULT_ACCUMULATORS = {"time_lost", "bytes_cancel", "disk_used"}
SITE_NAMES = ["CERN-PROD", "BNL-ATLAS", "TRIUMF", "RAL"]


def _to_port(state):
    return T.faults_from_numpy(_np_state(state), device="cpu")


def _run(jobs, sites, policy, seed, kw, **run_kw):
    """The same run in both packages; ``kw`` holds the JAX package's
    subsystem states (``faults`` included), carried to the port."""
    pj, pt = (R.get_policy(policy), T.get_policy(policy)) if isinstance(policy, str) else policy
    port_kw = _port_kw({k: v for k, v in kw.items() if k != "faults"})
    if "faults" in kw:
        port_kw["faults"] = _to_port(kw["faults"])
    rj = R.simulate(jobs, sites, pj, jax.random.PRNGKey(seed), **kw, **run_kw)
    rt = T.simulate(T.jobs_from_numpy(_np_state(jobs), device="cpu"),
                    T.sites_from_numpy(_np_state(sites), device="cpu"), pt, PRNGKey(seed),
                    device="cpu", **port_kw, **run_kw)
    return rj, rt


def assert_same_faults(rj, rt) -> dict:
    """The whole run (``assert_same_run``) and the fault state; the transfer
    ledger balances with the fault channel's failures."""
    t = assert_same_run(rj, rt)
    a = _np_state(rj.ext["faults"])
    b = t["faults"]
    assert sorted(a) == sorted(b)
    for k, x in a.items():
        if k in FAULT_ACCUMULATORS:
            np.testing.assert_allclose(b[k], x, rtol=1e-6, atol=0, err_msg=f"faults.{k}")
        else:
            np.testing.assert_array_equal(x, b[k], err_msg=f"faults.{k}")
    fs = rt.ext["faults"]
    if "transfers" in rt.ext:
        ts = rt.ext["transfers"]
        in_flight = int((ts.stat > TT.T_IDLE).sum())
        assert int(ts.n_enq) == (int(ts.n_done) + int(ts.n_cancel) + int(fs.n_xfer_fail)
                                 + in_flight)
    return {k: int(getattr(fs, k)) for k in ("n_xfer_fail", "n_xfer_retry", "n_xfer_exhaust",
                                             "n_kills", "n_lost_replicas", "n_bl_trips",
                                             "n_probes")}


# --------------------------------------------------------------------------
# XLA's exp2, the state builder, the subsystem's checks
# --------------------------------------------------------------------------


def test_exp2_table_is_xlas():
    """The port's table of ``2^k`` is XLA's ``exp2`` bit for bit, eager and
    under ``jit``, for k = 0..300 (inf from 128 on); it is not 2^k."""
    k = np.arange(301, dtype=np.int32)
    eager = np.asarray(jnp.exp2(jnp.asarray(k, jnp.float32)))
    jitted = np.asarray(jax.jit(lambda x: jnp.exp2(x.astype(jnp.float32)))(jnp.asarray(k)))
    port = TF.exp2_xla(torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(eager.view(np.int32), port.view(np.int32))
    np.testing.assert_array_equal(jitted.view(np.int32), port.view(np.int32))
    assert np.isinf(port[128:]).all() and np.isfinite(port[:128]).all()
    exact = np.ldexp(np.float32(1.0), k[:128]).astype(np.float32)
    assert (port[:128] != exact).sum() > 50     # k = 13, 15, ... miss 2^k
    assert (torch.exp2(torch.from_numpy(k[:128]).float()).numpy() == exact).all()


def test_make_faults_matches_the_jax_package():
    S, J = 4, 9
    mat = np.random.default_rng(0).uniform(0, 1, (S, S)).astype(np.float32)
    cases = [
        dict(),
        dict(link_fail_p=0.25, xfer_backoff=30.0, max_xfer_attempts=5, job_backoff=60.0,
             walltime=4000.0, blacklist_threshold=0.7, blacklist_alpha=0.3,
             blacklist_cooldown=900.0),
        dict(link_fail_p=mat, walltime=np.arange(J, dtype=np.float32) * 100.0),
        dict(link_fail_p={(0, 1): 0.5, (2, 3): 1.0},
             replica_loss=[(500.0, 3, 2), {"t": 100.0, "dataset": 1, "site": 0},
                           (100.0, 0, 3)]),
    ]
    for kw in cases:
        a, b = R.make_faults(S, J, **kw), T.make_faults(S, J, device="cpu", **kw)
        for f, x in _np_state(a).items():
            y = getattr(b, f).numpy()
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f"{kw}: {f}")
    sites = T.atlas_like_platform(S, seed=0, device="cpu")
    jobs = T.synthetic_panda_jobs(J, seed=0, device="cpu")
    assert T.make_faults(sites, jobs, device="cpu").attempt.shape == (J,)
    for kw, msg in ((dict(link_fail_p=np.zeros((3, 3))), "must be \\[S, S\\]"),
                    (dict(link_fail_p=1.5), "must lie in \\[0, 1\\]"),
                    (dict(walltime=np.ones(3)), "walltime must be scalar or shape"),
                    (dict(replica_loss=[(1.0, 0, 4)]), "replica_loss site 4 out of range")):
        with pytest.raises(ValueError, match=msg):
            R.make_faults(S, J, **kw)
        with pytest.raises(ValueError, match=msg):
            T.make_faults(S, J, device="cpu", **kw)


def test_subsystem_checks_flags_and_padding():
    jobs = T.synthetic_panda_jobs(10, seed=0, device="cpu")
    sites = T.atlas_like_platform(3, seed=0, device="cpu")
    pol, key = T.get_policy("panda_dispatch"), PRNGKey(0)
    with pytest.raises(ValueError, match="expected S\\*S = 9"):
        T.simulate(jobs, sites, pol, key, device="cpu", faults=T.make_faults(4, 10, device="cpu"))
    with pytest.raises(ValueError, match="walltime sized for 12 jobs"):
        T.simulate(jobs, sites, pol, key, device="cpu", faults=T.make_faults(3, 12, device="cpu"))
    # the flags come from one host read of the state, as the JAX package's
    for kw in (dict(), dict(job_backoff=60.0), dict(blacklist_threshold=0.5),
               dict(job_backoff=1.0, blacklist_threshold=1.0)):
        a = RF.faults_subsystem(R.make_faults(3, 10, **kw)).config
        b = TF.faults_subsystem(T.make_faults(3, 10, device="cpu", **kw)).config
        assert tuple(a) == tuple(b) and a.mutates_arrival == b.mutates_arrival
    assert TF.faults_subsystem(job_backoff=True).config == (True, False)
    # job_backoff moves arrivals: the engine drops its packed start-order key
    for backoff, packed in ((0.0, True), (60.0, False)):
        h = T.init_sim(jobs, sites, pol, key, device="cpu",
                       faults=T.make_faults(3, jobs, job_backoff=backoff, device="cpu"))
        assert ("~srank" in h.state.ext) == packed
    fj = R.make_faults(3, 5, walltime=10.0)
    sj, st = RF.faults_subsystem(fj), TF.faults_subsystem(_to_port(fj))
    pj, pt = sj.pad_jobs(sj, fj, 5, 8), st.pad_jobs(st, _to_port(fj), 5, 8)
    for f, x in _np_state(pj).items():
        np.testing.assert_array_equal(x, getattr(pt, f).numpy(), err_msg=f)
    subs, ext = T.resolve_subsystems(faults=_to_port(fj), validate=False)
    assert [s.name for s in subs] == ["faults"]
    assert T.pad_ext_jobs(subs, ext, 5, 8)["faults"].walltime.shape == (8,)


def test_default_state_is_inert():
    """A default ``make_faults`` state changes no result of the port (the
    log's own columns aside, which only the faults run has)."""
    scn = matrix_scenario()
    jobs, kw = combo_kwargs(scn, True, True, False)
    kw["transfers"] = R.make_transfers(4, jobs.capacity, max_active=2)
    jt = T.jobs_from_numpy(_np_state(jobs), device="cpu")
    st = T.sites_from_numpy(_np_state(scn["sites"]), device="cpu")
    pol = T.get_policy("panda_dispatch")
    off = T.simulate(jt, st, pol, PRNGKey(0), device="cpu", log_rows=32, **_port_kw(kw))
    on = T.simulate(jt, st, pol, PRNGKey(0), device="cpu", log_rows=32,
                    faults=T.make_faults(4, jt, device="cpu"), **_port_kw(kw))
    a, b = T.result_to_numpy(off), T.result_to_numpy(on)
    assert sorted(b["log"]["extra"]) == sorted([*a["log"]["extra"], "site_blacklist",
                                                "site_fault_score"])
    for name in b["log"]["extra"]:
        if name in a["log"]["extra"]:
            np.testing.assert_array_equal(a["log"]["extra"][name], b["log"]["extra"][name])
    b["log"]["extra"] = a["log"]["extra"]
    del b["faults"]
    _check_group(a, b, "run")
    assert int(on.ext["faults"].n_xfer_fail) == 0 and int(on.ext["faults"].n_kills) == 0


# --------------------------------------------------------------------------
# whole runs
# --------------------------------------------------------------------------


def _matrix_faults(jobs, **over):
    """The golden matrix's fault state: all four channels armed."""
    kw = dict(link_fail_p=0.3, xfer_backoff=120.0, max_xfer_attempts=3,
              job_backoff=60.0, walltime=4000.0,
              replica_loss=[(3000.0, 1, 1), (3000.0, 1, 2), (6000.0, 2, 3)],
              blacklist_threshold=0.5, blacklist_alpha=0.5, blacklist_cooldown=1800.0)
    kw.update(over)
    return R.make_faults(4, jobs.capacity, **kw)


MATRIX_ROWS = {
    "faults": (False, False, False),
    "avail+faults": (False, True, False),
    "data+tr+faults": (True, False, False),
    "data+tr+avail+wf+faults": (True, True, True),
}


@pytest.fixture(scope="module")
def matrix_runs():
    scn = matrix_scenario()
    out = {}
    for name, (data, avail, wf) in MATRIX_ROWS.items():
        jobs, kw = combo_kwargs(scn, data, avail, wf)
        if data:
            kw["transfers"] = R.make_transfers(4, jobs.capacity, max_active=2)
        kw["faults"] = _matrix_faults(jobs)
        out[name] = _run(jobs, scn["sites"], "panda_dispatch", 0, kw, log_rows=1024)
    return out


@pytest.mark.parametrize("row", list(MATRIX_ROWS))
def test_matrix_rows(matrix_runs, row):
    """The golden matrix's four fault rows, every round logged."""
    rj, rt = matrix_runs[row]
    counts = assert_same_faults(rj, rt)
    assert counts["n_kills"] > 0 and counts["n_bl_trips"] > 0
    if "data" in row:
        assert counts["n_xfer_fail"] > 0 and counts["n_lost_replicas"] > 0
        assert all(T.catalog_invariants(rt.replicas).values())


def test_deep_retries_and_alpha_0_3():
    """Retries up to 20 under job backoff and walltime kills, where XLA's
    ``exp2`` misses ``2^k`` and ``clock + 60 * 2^k`` is one FMA, and the
    breaker's EWMA at alpha = 0.3, where ``score + alpha * (frac - score)``
    is one FMA."""
    scn = matrix_scenario()
    jobs, kw = combo_kwargs(scn, False, False, False)
    sites = scn["sites"]._replace(fail_rate=jnp.full((4,), 0.6, jnp.float32))
    kw["faults"] = R.make_faults(4, jobs.capacity, job_backoff=60.0, walltime=4000.0,
                                 blacklist_threshold=0.5, blacklist_alpha=0.3,
                                 blacklist_cooldown=1800.0)
    rj, rt = _run(jobs, sites, "panda_dispatch", 0, kw, max_retries=20, log_rows=64)
    counts = assert_same_faults(rj, rt)
    assert int(rt.jobs.retries.max()) >= 16 and counts["n_bl_trips"] > 0


def test_deep_transfer_attempts():
    """30 dataset jobs whose transfers fail with p = 0.97, up to 24 attempts:
    the transfer backoff ``clock + 97.123 * 2^attempt`` past k = 13, where it
    is one fused multiply-add of XLA's inexact ``2^k``."""
    jobs = R.synthetic_panda_jobs(30, seed=5, duration=600.0, n_datasets=6)
    sites = R.atlas_like_platform(4, seed=12)
    rep = R.make_replicas(R.zipf_dataset_sizes(6, seed=3, mean_bytes=2e9),
                          disk_capacity=np.array([1e13, 6e9, 6e9, 6e9]),
                          origin=np.zeros(6, np.int32))
    kw = dict(data_policy=R.get_data_policy("cache_on_read"),
              network=R.uniform_network(4, bw=5e8, latency=0.05), replicas=rep,
              transfers=R.make_transfers(4, jobs.capacity, max_active=2),
              faults=R.make_faults(4, jobs.capacity, link_fail_p=0.97, xfer_backoff=97.123,
                                   max_xfer_attempts=24))
    rj, rt = _run(jobs, sites, "panda_dispatch", 0, kw, log_rows=64)
    counts = assert_same_faults(rj, rt)
    assert counts["n_xfer_exhaust"] > 0 and counts["n_xfer_retry"] > 0


def _blackhole(n_jobs=120, n_sites=4, seed=7):
    """``examples/chaos_day.py``'s blackhole-site scenario, built by the JAX
    package: homogeneous 8-core sites, one of them failing 90% of its jobs,
    trickle arrivals."""
    sites, flaky_idx = R.flaky_grid(n_sites, n_flaky=1, seed=12, cores_range=(8, 8),
                                    speed_range=(10.0, 10.0))
    rng = np.random.default_rng(seed)
    jobs = R.synthetic_panda_jobs(n_jobs, seed=seed, capacity=n_jobs + 3)
    jobs = jobs._replace(
        arrival=jnp.asarray(np.pad(np.sort(rng.uniform(0.0, 400.0, n_jobs)), (0, 3),
                                   constant_values=np.inf), jnp.float32),
        work=jnp.asarray(np.pad(rng.lognormal(np.log(800.0), 0.6, n_jobs), (0, 3)),
                         jnp.float32),
        cores=jnp.ones((jobs.capacity,), jnp.int32),
        memory=jnp.full((jobs.capacity,), 2.0),
    )
    return jobs, sites, flaky_idx


@pytest.mark.parametrize("topk", [None, 2])
def test_blackhole_site_recovery(topk):
    """``chaos_day.py``: ``least_loaded`` with resubmission backoff, with and
    without the circuit breaker (its cooldown cut to 150 s, as in
    ``tests/test_faults.py``, so that half-open probes fire); with ``topk=2``
    the breaker's ``[J, S]`` probe gate widens the sparse path's site mask."""
    jobs, sites, flaky_idx = _blackhole()
    runs = {}
    for bl in (False, True):
        kw = dict(job_backoff=120.0)
        if bl:
            kw.update(blacklist_threshold=0.6, blacklist_alpha=0.5, blacklist_cooldown=150.0)
        runs[bl] = _run(jobs, sites, "least_loaded", 1,
                        dict(faults=R.make_faults(4, jobs, **kw)), max_retries=6,
                        log_rows=4096, topk=topk)
        assert_same_faults(*runs[bl])
    on, off = runs[True][1], runs[False][1]
    fs = on.ext["faults"]
    assert int(fs.n_bl_trips) > 0 and int(fs.n_probes) > 0
    assert float(on.makespan) < float(off.makespan)
    bl = TM.blacklist_timeline(on)
    tripped = bl if topk else bl[:, int(flaky_idx[0])]   # dense: the flaky site trips
    assert (tripped == T.BL_TRIPPED).any()
    for name in ("fault_score_timeline", "blacklist_timeline"):
        np.testing.assert_array_equal(getattr(RM, name)(runs[True][0]), getattr(TM, name)(on))


# --------------------------------------------------------------------------
# builders, loaders, exports
# --------------------------------------------------------------------------


def test_fault_builders_match_the_jax_package():
    for kw in (dict(), dict(p=0.1, hot=2, seed=3), dict(hot=[0, 4], hot_p=0.5)):
        a, b = R.lossy_links(6, **kw), T.lossy_links(6, **kw)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rep_j = R.make_replicas(R.zipf_dataset_sizes(7, seed=1), np.full(5, 1e12))
    rep_t = T.replicas_from_numpy(_np_state(rep_j), device="cpu")
    for n, kw in ((7, dict(horizon=86400.0 * 3, seed=2)),
                  (rep_j, dict(horizon=3600.0, rate=1 / 600.0, sites=[1, 3]))):
        a = R.replica_loss_calendar(n, 5, **kw)
        b = T.replica_loss_calendar(rep_t if n is rep_j else n, 5, **kw)
        assert a and a == b
    for kw in (dict(), dict(n_flaky=3, seed=4, cores_range=(8, 8))):
        (sa, ia), (sb, ib) = R.flaky_grid(9, **kw), T.flaky_grid(9, device="cpu", **kw)
        np.testing.assert_array_equal(ia, ib)
        for f, x in _np_state(sa).items():
            np.testing.assert_array_equal(x, getattr(sb, f).numpy(), err_msg=f)


def test_load_platform_and_faults():
    infra = {"sites": [{"name": n, "cores": 100 * (i + 1), "speed": 9.5 + i,
                        "fail_rate": 0.01 * i} for i, n in enumerate(SITE_NAMES)]}
    net = {"links": [{"site": "TRIUMF", "bw_in_gbps": 40.0, "bw_out_gbps": 3.3,
                      "latency_ms": 37.0}]}
    exe = json.dumps({"max_rounds": 500, "policy": "least_loaded"})
    sa, na, ea = R.load_platform(infra, net, exe, capacity=6)
    sb, nb, eb = T.load_platform(json.dumps(infra), net, exe, capacity=6, device="cpu")
    assert na == nb and tuple(ea) == tuple(eb)
    for f, x in _np_state(sa).items():
        np.testing.assert_array_equal(x, getattr(sb, f).numpy(), err_msg=f)
    assert RP.dump_platform(sa, na) == TP.dump_platform(sb, nb)
    down = np.array([False, True, False, False, False, False])
    np.testing.assert_array_equal(np.asarray(R.deactivate_sites(sa, down).active),
                                  T.deactivate_sites(sb, down).active.numpy())
    spec = {
        "link_fail_p": {"default": 0.05, "links": [{"src": "CERN-PROD", "dst": "RAL", "p": 0.5},
                                                   {"src": 2, "dst": 1, "p": 0.9}]},
        "xfer_backoff": 45.0, "max_xfer_attempts": 4, "job_backoff": 30.0, "walltime": 7200.0,
        "replica_loss": [{"t": 100.0, "dataset": 3, "site": "TRIUMF"},
                         {"t": 50.0, "dataset": 1, "site": 0}],
        "blacklist": {"threshold": 0.6, "alpha": 0.3, "cooldown": 1200.0},
    }
    for s, kw in ((spec, dict(names=na, job_capacity=20)),
                  (json.dumps({"link_fail_p": 0.1}), dict(n_sites=6, job_capacity=20))):
        a, b = R.load_faults(s, **kw), T.load_faults(s, device="cpu", **kw)
        for f, x in _np_state(a).items():
            np.testing.assert_array_equal(x, getattr(b, f).numpy(), err_msg=f)
    for kw, msg in ((dict(job_capacity=3), "needs names= or n_sites="),
                    (dict(names=na), "needs job_capacity="),
                    (dict(names=na[:2], job_capacity=3), "unknown site name")):
        with pytest.raises(ValueError, match=msg):
            T.load_faults(spec, device="cpu", **kw)


@pytest.mark.parametrize("row", ["faults", "data+tr+avail+wf+faults"])
def test_fault_exports(matrix_runs, row):
    """``fault_rows`` (CSV and JSON, with and without site names),
    ``ml_dataset`` with its fault columns, ``write_ml_dataset`` at two
    segment sizes, the fault timelines and the rendered dashboard: byte for
    byte."""
    rj, rt = matrix_runs[row]
    for names in (None, SITE_NAMES):
        a, b = RE.fault_rows(rj, names), TE.fault_rows(rt, names)
        assert len(b) == 4 and TE.to_csv(b) == RE.to_csv(a) and TE.to_json(b) == RE.to_json(a)
    a, b = RE.ml_dataset(rj), TE.ml_dataset(rt)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert list(b["feature_names"][-3:]) == ["fault_backoff_wait", "fault_retries",
                                              "site_fault_score"]
    for segment in (7, 1000):
        fj, ft = io.StringIO(), io.StringIO()
        RE.write_ml_dataset(rj, fj, segment=segment)
        TE.write_ml_dataset(rt, ft, segment=segment)
        assert ft.getvalue() == fj.getvalue()
    for name in ("fault_score_timeline", "blacklist_timeline"):
        x, y = getattr(RM, name)(rj), getattr(TM, name)(rt)
        assert x.dtype == y.dtype and x.shape == y.shape and y.any(), name
        np.testing.assert_array_equal(x, y, err_msg=name)
    oj, ot = io.StringIO(), io.StringIO()
    RM.render_run(rj, SITE_NAMES, every=7, out=oj)
    TM.render_run(rt, SITE_NAMES, every=7, out=ot)
    assert ot.getvalue() == oj.getvalue()
    assert TE.fault_rows(types.SimpleNamespace(ext={})) == []
