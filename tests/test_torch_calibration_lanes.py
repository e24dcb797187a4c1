"""The port's lane-batched population objective
(``calibration.make_population_objective``) on the CPU: one
``simulate_many`` call for K candidates equals a loop of solo
``engine_platform_objective`` calls (lane ``i`` under ``split(rng, K)[i]``)
and ``repro``'s ``make_population_objective`` on the same z, plainly and
with availability and the data subsystem, as ``tests/test_calibration_lanes.py``
holds the JAX package's.  ``distributed.simulate_population(mesh=None)`` is
``simulate_many``, and a mesh (1 rank in process, 2 spawned ranks for
``calibrate_platform``) gives the same lanes.

Exact: every lane's loss against the port's solo run; against ``repro``
rtol 1e-6 (the mape's sum).  The problems are ``repro``'s, carried across.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.calibration as RC  # noqa: E402
from repro.core.availability import make_availability as jax_make_availability  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.calibration as TC  # noqa: E402
from repro_torch.core.distributed import run_ranks, simulate_population  # noqa: E402

from test_torch_calibration import carry_platform  # noqa: E402
import torch_mesh_ranks as M  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

ROUNDS = 6000


@pytest.fixture(scope="module")
def data_problem():
    """``repro``'s 40-job, 3-site problem with WAN datasets, engine trace."""
    rp, _ = RC.make_synthetic_platform_problem(n_jobs=40, n_sites=3, seed=1, trace="engine",
                                               wan_frac=0.5)
    return rp


def _candidates(be, n, seed=0, scale=0.3):
    """n log-space candidates around the start, drawn by the JAX package."""
    noise = jax.random.normal(jax.random.PRNGKey(seed), (n, be.z0.shape[0]))
    return np.asarray(be.z0[None, :] + scale * noise)


def _solo_losses(problem, be, zs, rng, loss="mape"):
    """The port's solo runs with the lane keys, one pinned policy for all."""
    policy = TC.pinned_policy(problem.hist_site)
    keys = T.rng.split(rng, zs.shape[0])
    return torch.stack([
        TC.engine_platform_objective(problem, TC.decode_params(be.unravel(z), be.bounds), keys[i],
                                     loss=loss, max_rounds=ROUNDS, policy=policy)
        for i, z in enumerate(torch.from_numpy(zs))])


def _check(rp, include=TC.PARAM_FIELDS, loss="mape", n=4, seed=0, key=7, reference=True):
    tp = carry_platform(rp)
    br = RC.make_population_objective(rp, objective="engine", include=include, loss=loss,
                                      max_rounds=ROUNDS)
    bt = TC.make_population_objective(tp, objective="engine", include=include, loss=loss,
                                      max_rounds=ROUNDS)
    np.testing.assert_array_equal(bt.z0.numpy(), np.asarray(br.z0))
    zs = _candidates(br, n, seed)
    lanes = bt(torch.from_numpy(zs), T.PRNGKey(key))
    assert lanes.shape == (n,)
    assert torch.equal(lanes, _solo_losses(tp, bt, zs, T.PRNGKey(key), loss))
    if reference:
        want = np.asarray(br(jax.numpy.asarray(zs), jax.random.PRNGKey(key)))
        np.testing.assert_allclose(lanes.numpy(), want, rtol=1e-6)
    return bt


def test_lanes_equal_solo_loop_and_reference_plain():
    rp, _ = RC.make_synthetic_platform_problem(n_jobs=40, n_sites=3, seed=0, trace="engine",
                                               wan_frac=0.0, include=("speed", "overhead"))
    assert rp.data_policy is None
    bt = _check(rp, include=("speed", "overhead"))
    assert bt.trace_count() == 1   # one population build a call


def test_lanes_equal_solo_loop_and_reference_with_avail_and_data(data_problem):
    """The full ext pipeline: the outage calendar broadcast to every lane,
    each lane's candidate WAN matrix in the data slot."""
    rp = data_problem
    windows = [dict(site=0, start=50.0, end=400.0, factor=0.0, preempt=True),
               dict(site=1, start=200.0, end=900.0, factor=0.5, preempt=False)]
    rp = rp._replace(availability=jax_make_availability(3, windows))
    _check(rp, n=3, seed=5, key=11)


def test_quantile_loss_lanes(data_problem):
    """Lanes = solo under the quantile loss (the loss itself is held against
    the reference's in ``test_torch_calibration.py``)."""
    _check(data_problem, loss="quantile", n=3, seed=3, key=17, reference=False)


def test_closed_form_population_equals_scalar_objective(data_problem):
    rp = data_problem
    tp = carry_platform(rp)
    br = RC.make_population_objective(rp, objective="closed_form")
    bt = TC.make_population_objective(tp, objective="closed_form")
    zs = _candidates(br, 6, seed=2)
    lanes = bt(torch.from_numpy(zs))
    solo = torch.stack([TC.platform_objective(tp, TC.decode_params(bt.unravel(z), bt.bounds))
                        for z in torch.from_numpy(zs)])
    np.testing.assert_allclose(lanes.numpy(), solo.numpy(), rtol=1e-6)
    np.testing.assert_allclose(lanes.numpy(), np.asarray(br(jax.numpy.asarray(zs))), rtol=1e-6)
    assert bt.trace_count() == 1   # one call; the solo calls do not go through it


def test_simulate_population_is_simulate_many_and_refuses_a_mesh(tmp_path):
    """``simulate_population`` and the engine population objective give the
    same lanes with ``mesh=None`` (``simulate_many``) and on a 1-rank gloo
    mesh (``simulate_many_sharded``).  (A mesh was refused before the port
    had one; the name is kept.)"""
    sites = T.atlas_like_platform(4, seed=1, device="cpu")
    scens = [T.Scenario(T.synthetic_panda_jobs(30 + 5 * i, seed=i, duration=600.0, device="cpu"),
                        sites._replace(speed=sites.speed * (0.8 + 0.1 * i))) for i in range(3)]
    policy = T.get_policy("panda_dispatch")
    a = simulate_population(scens, policy, T.PRNGKey(3), max_rounds=400, device="cpu")
    b = T.simulate_many(scens, policy, T.PRNGKey(3), max_rounds=400, device="cpu")
    for f in a.jobs._fields:
        assert torch.equal(getattr(a.jobs, f), getattr(b.jobs, f)), f
    assert torch.equal(a.rounds, b.rounds)
    rp, _ = RC.make_synthetic_platform_problem(n_jobs=20, n_sites=3, seed=2, trace="engine",
                                               wan_frac=0.5)
    tp = carry_platform(rp)
    bt = TC.make_population_objective(tp, objective="engine", max_rounds=ROUNDS)
    noise = np.random.default_rng(4).standard_normal((3, bt.z0.shape[0])).astype(np.float32)
    zs = bt.z0[None] + 0.3 * torch.from_numpy(noise)
    with M.one_rank_mesh(tmp_path) as mesh:
        c = simulate_population(scens, policy, T.PRNGKey(3), mesh=mesh, max_rounds=400,
                                device="cpu")
        bm = TC.make_population_objective(tp, objective="engine", mesh=mesh, max_rounds=ROUNDS)
        lanes_mesh = bm(zs, T.PRNGKey(9))
    assert sorted(M.flat(a)) == sorted(M.flat(c))
    for k, v in M.flat(a).items():
        torch.testing.assert_close(M.flat(c)[k], v, rtol=0, atol=0, equal_nan=True, msg=k)
    assert torch.equal(lanes_mesh, bt(zs, T.PRNGKey(9)))


def test_calibrate_platform_over_two_ranks_equals_one_process(tmp_path):
    """SPSA on the engine objective over a spawned 2-rank gloo mesh: every
    rank scores the gathered population and takes the one-process steps."""
    TC_run = TC.calibrate_platform(M.calibration_problem(), **M.CALIBRATE_KW)
    run_ranks(M.calibrate_rank, 2, (str(tmp_path),), device_type="cpu")
    want = M.flat(TC_run)
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, equal_nan=True,
                                       msg=f"rank {r}: {k}")
    assert float(TC_run.err) <= float(TC_run.err0)
