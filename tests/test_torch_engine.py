"""Whole-run parity: the port's ``simulate`` against the JAX package's on the
same seeded inputs, on the CPU.

Exact on rounds, makespan, every job's state/site/retries/will_fail and
t_assign/t_start/t_finish, and the per-site counters and free capacity.
Metrics sums (means, utilization) add in another order: rtol 1e-6.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.policies import with_capacity_assign as jax_with_capacity_assign  # noqa: E402
from repro.kernels.assign.ops import make_capacity_assign as jax_make_capacity_assign  # noqa: E402
from repro_torch.core.rng import PRNGKey  # noqa: E402
from repro_torch.kernels.assign import make_capacity_assign  # noqa: E402

JOB_FIELDS = ("state", "site", "retries", "will_fail", "t_assign", "t_start", "t_finish")
SITE_FIELDS = ("free_cores", "free_memory", "n_assigned", "n_finished", "n_failed")
LOG_FIELDS = ("time", "round_idx", "counts", "n_started", "n_completed", "site_free",
              "site_queued", "site_running", "cursor")


def _np_state(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _scenario(n_jobs, job_seed, n_sites, site_seed, duration, fail_rate):
    jobs = R.synthetic_panda_jobs(n_jobs, seed=job_seed, duration=duration)
    sites = R.atlas_like_platform(n_sites, seed=site_seed, fail_rate=fail_rate)
    return jobs, sites


def _run_both(jobs, sites, jax_policy, torch_policy, seed, **kw):
    rj = R.simulate(jobs, sites, jax_policy, jax.random.PRNGKey(seed), **kw)
    tj = T.jobs_from_numpy(_np_state(jobs), device="cpu")
    ts = T.sites_from_numpy(_np_state(sites), device="cpu")
    rt = T.simulate(tj, ts, torch_policy, PRNGKey(seed), device="cpu", **kw)
    return rj, rt


def _assert_same_run(rj, rt):
    t = T.result_to_numpy(rt)
    assert int(rj.rounds) == int(t["rounds"])
    assert np.float32(rj.makespan) == t["makespan"]
    for f in JOB_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rj.jobs, f)), t["jobs"][f], err_msg=f)
    for f in SITE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rj.sites, f)), t["sites"][f], err_msg=f)
    return t


def test_golden_baseline():
    """``tests/test_golden_trace.py``'s baseline: 60 jobs seed 11, 4 sites seed
    12, fail_rate 0.05, panda_dispatch, PRNGKey(0)."""
    jobs = R.synthetic_panda_jobs(60, seed=11, duration=900.0)
    sites = R.atlas_like_platform(4, seed=12, fail_rate=0.05)
    rj, rt = _run_both(jobs, sites, R.get_policy("panda_dispatch"),
                       T.get_policy("panda_dispatch"), 0)
    _assert_same_run(rj, rt)
    assert int(np.asarray(rj.jobs.retries).sum()) > 0  # failures were drawn


@pytest.mark.parametrize("name", sorted(T.REGISTRY))
def test_registry_policy(name):
    jobs, sites = _scenario(80, 3, 6, 4, 2000.0, 0.1)
    rj, rt = _run_both(jobs, sites, R.get_policy(name), T.get_policy(name), 5)
    _assert_same_run(rj, rt)


@pytest.mark.parametrize("name", ["panda_dispatch", "least_loaded"])
def test_capacity_dispatch(name):
    jobs, sites = _scenario(80, 3, 6, 4, 2000.0, 0.1)
    pj = jax_with_capacity_assign(R.get_policy(name), jax_make_capacity_assign(jobs.cores))
    tcores = torch.from_numpy(np.array(jobs.cores))
    pt = T.with_capacity_assign(T.get_policy(name), make_capacity_assign(tcores))
    rj, rt = _run_both(jobs, sites, pj, pt, 5)
    _assert_same_run(rj, rt)


@pytest.mark.parametrize("name", ["panda_dispatch", "critical_path_first"])
def test_large_capacity_start_orders(name):
    """J=600 > 512: the JAX package lexsorts (rank policy) or takes the packed
    single-key order (rank-less policy) instead of ranking pairwise."""
    jobs, sites = _scenario(600, 21, 8, 22, 2000.0, 0.05)
    rj, rt = _run_both(jobs, sites, R.get_policy(name), T.get_policy(name), 1, max_rounds=400)
    _assert_same_run(rj, rt)
    assert int(rt.rounds) == 400


def test_event_log_ring():
    jobs, sites = _scenario(60, 11, 4, 12, 900.0, 0.05)
    rj, rt = _run_both(jobs, sites, R.get_policy("panda_dispatch"),
                       T.get_policy("panda_dispatch"), 0, log_rows=32, monitor_every=3)
    t = _assert_same_run(rj, rt)
    for f in LOG_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rj.log, f)), t["log"][f], err_msg=f)


def test_quantum_batches_events():
    """With ``quantum`` many jobs start in one round, so stage-in links are
    shared (``share > 1``) and the service-time arithmetic is exercised."""
    jobs, sites = _scenario(300, 21, 8, 22, 2000.0, 0.05)
    rj, rt = _run_both(jobs, sites, R.get_policy("panda_dispatch"),
                       T.get_policy("panda_dispatch"), 1, quantum=30.0)
    _assert_same_run(rj, rt)


def test_horizon_and_no_phase_skip():
    jobs, sites = _scenario(60, 11, 4, 12, 900.0, 0.05)
    rj, rt = _run_both(jobs, sites, R.get_policy("panda_dispatch"),
                       T.get_policy("panda_dispatch"), 0, horizon=5000.0, phase_skip=False,
                       max_retries=1)
    _assert_same_run(rj, rt)


def test_metrics_match():
    jobs, sites = _scenario(60, 11, 4, 12, 900.0, 0.05)
    rj, rt = _run_both(jobs, sites, R.get_policy("panda_dispatch"),
                       T.get_policy("panda_dispatch"), 0)
    mj, mt = R.metrics.compute_metrics(rj), T.compute_metrics(rt)
    for f in mj._fields:
        np.testing.assert_allclose(float(getattr(mt, f)), float(getattr(mj, f)), rtol=1e-6,
                                   err_msg=f)
    assert "makespan=" in T.summary_str(mt)


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        T.synthetic_panda_jobs(10, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        T.atlas_like_platform(3, seed=0)
    jobs = T.synthetic_panda_jobs(10, seed=0, device="cpu")
    sites = T.atlas_like_platform(3, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        T.simulate(jobs, sites, T.get_policy("panda_dispatch"), PRNGKey(0))


def test_builders_match_the_jax_package():
    for field, a in _np_state(R.synthetic_panda_jobs(500, seed=4, duration=3600.0)).items():
        b = getattr(T.synthetic_panda_jobs(500, seed=4, duration=3600.0, device="cpu"), field)
        np.testing.assert_array_equal(a, b.numpy(), err_msg=field)
    for field, a in _np_state(R.atlas_like_platform(30, seed=2, fail_rate=0.01)).items():
        b = getattr(T.atlas_like_platform(30, seed=2, fail_rate=0.01, device="cpu"), field)
        np.testing.assert_array_equal(a, b.numpy(), err_msg=field)


def test_padded_capacity_matches():
    """Inert padding rows (``pad_jobs_capacity``) leave the run unchanged, in
    both packages alike."""
    jobs, sites = _scenario(60, 11, 4, 12, 900.0, 0.05)
    padded = R.pad_jobs_capacity(jobs, 75)
    tpad = T.pad_jobs_capacity(T.jobs_from_numpy(_np_state(jobs), device="cpu"), 75)
    for field, a in _np_state(padded).items():
        np.testing.assert_array_equal(a, getattr(tpad, field).numpy(), err_msg=field)
    rj, rt = _run_both(padded, sites, R.get_policy("panda_dispatch"),
                       T.get_policy("panda_dispatch"), 0)
    _assert_same_run(rj, rt)


def test_allocation_plugin_and_register():
    """A user plugin built by subclassing, registered by name, in both packages."""

    def make(base, pkg):
        class SlowestFirst(base):
            name = "slowest_first"

            def assign_job(self, jobs, sites, state, clock, key):
                return -sites.speed[None, :] + 0.0 * jobs.work[:, None]

        pkg.register("slowest_first_test")(lambda: SlowestFirst().build())
        try:
            return pkg.get_policy("slowest_first_test")
        finally:
            del pkg.REGISTRY["slowest_first_test"]

    jobs, sites = _scenario(60, 11, 4, 12, 900.0, 0.05)
    pj = make(R.AllocationPlugin, R.policies)
    pt = make(T.AllocationPlugin, T.policies)
    rj, rt = _run_both(jobs, sites, pj, pt, 0)
    _assert_same_run(rj, rt)
