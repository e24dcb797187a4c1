"""Scenario ensembles over a device mesh in the port
(``repro_torch.core.distributed``) against the JAX package's, on the CPU.

In process, a 1-rank gloo ``"cpu"`` mesh: ``simulate_many_sharded`` in
``scan``, ``vmap`` and ``auto`` equals ``repro``'s ``simulate_many_sharded``
on a 1-device JAX mesh, ``repro``'s ``simulate_many`` and the port's own
``simulate_many``, leaf for leaf, on same-shape lanes, buckets, the
availability + workflow + data combination of ``tests/test_ensemble_lanes.py``
and with the recorder.  ``repro``'s sharded entry point raises
``ShardingTypeError`` on buckets under jax 0.9.0 (ROADMAP Queue 3), so
buckets are held against ``repro``'s ``simulate_many`` of the same buckets.
Spawned 2- and 3-rank gloo meshes (``run_ranks``; the rank functions live in
``torch_mesh_ranks.py``, which imports no JAX) give every rank the
one-process result, padding included.  ``simulate_ensemble_distributed``
equals ``repro``'s ``simulate_ensemble`` and the solo runs.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.distributed import simulate_many_sharded as jax_sharded  # noqa: E402
from repro.core.telemetry import TraceRecorder as JaxRecorder  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core.engine import _tree_map  # noqa: E402
from repro_torch.core.rng import PRNGKey, split  # noqa: E402
from repro_torch.core.telemetry import TraceRecorder  # noqa: E402
from test_ensemble_lanes import combo_scenarios  # noqa: E402
from test_torch_ensemble import _assert_same, _flat, _lane, _np_state, ragged  # noqa: E402
from test_torch_ensemble_subsystems import assert_close, port_subsystems, to_port  # noqa: E402
import torch_mesh_ranks as M  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

MODES = ["scan", "vmap", "auto"]


@pytest.fixture
def mesh(tmp_path):
    """A 1-rank gloo mesh on the CPU, destroyed after the test."""
    with M.one_rank_mesh(tmp_path) as m:
        yield m


@pytest.fixture(scope="module")
def jax_mesh():
    return jax.make_mesh((1,), ("data",))


@pytest.mark.parametrize("mode", MODES)
def test_same_shape_lanes_equal_jax_and_simulate_many(mesh, jax_mesh, mode):
    scens, tscens = ragged([44, 44, 44])
    kw = dict(log_rows=8, monitor_every=2)
    jax_mode = "scan" if mode == "auto" else mode
    rj = jax_sharded(scens, R.get_policy("panda_dispatch"), jax.random.PRNGKey(2), jax_mesh,
                     lane_mode=jax_mode, **kw)
    rt = D.simulate_many_sharded(tscens, T.get_policy("panda_dispatch"), PRNGKey(2), mesh,
                                 lane_mode=mode, **kw)
    _assert_same(_flat(rj), _flat(rt))
    _assert_same(_flat(R.simulate_many(scens, R.get_policy("panda_dispatch"),
                                       jax.random.PRNGKey(2), **kw)), _flat(rt))
    _assert_same(_flat(T.simulate_many(tscens, T.get_policy("panda_dispatch"), PRNGKey(2),
                                       device="cpu", **kw)), _flat(rt))


@pytest.mark.parametrize("mode", ["scan", "vmap"])
def test_buckets_equal_jax_buckets_and_flat(mesh, mode):
    sizes = [40, 72, 46, 58, 33]
    scens, tscens = ragged(sizes)
    policy = T.get_policy("shortest_wait")
    sb = T.stack_scenarios(tscens, buckets=2)
    rt = D.simulate_many_sharded(sb, policy, PRNGKey(3), mesh, lane_mode=mode)
    rj = R.simulate_many(R.stack_scenarios(scens, buckets=2), R.get_policy("shortest_wait"),
                         jax.random.PRNGKey(3))
    _assert_same(_flat(rj), _flat(rt))
    flat = D.simulate_many_sharded(tscens, policy, PRNGKey(3), mesh, lane_mode=mode)
    _assert_same(_flat(flat), _flat(rt))


@pytest.mark.parametrize("mode", MODES)
def test_subsystem_combo_equals_jax(mesh, jax_mesh, mode):
    """Availability, workflow DAGs and data per lane (``combo_scenarios``);
    exact but for ``rtol=1e-6`` on the f32 byte accumulators."""
    scens, subs, _ = combo_scenarios()
    tscens, tsubs = to_port(scens), port_subsystems(subs)
    rj = jax_sharded(scens, R.get_policy("critical_path_first"), jax.random.PRNGKey(4),
                     jax_mesh, subsystems=subs, lane_mode="scan" if mode == "auto" else mode)
    rt = D.simulate_many_sharded(tscens, T.get_policy("critical_path_first"), PRNGKey(4), mesh,
                                 subsystems=tsubs, lane_mode=mode)
    assert_close(_flat(rj), _flat(rt))
    rm = T.simulate_many(tscens, T.get_policy("critical_path_first"), PRNGKey(4),
                         subsystems=tsubs, device="cpu")
    _assert_same(_flat(rm), _flat(rt))
    assert int(rt.wf.n_produced.min()) > 0


@pytest.mark.parametrize("bucketed", [False, True], ids=["flat", "buckets"])
def test_recorder_gauges_equal_jax(mesh, jax_mesh, bucketed):
    sizes = [40, 64, 52]
    scens, tscens = ragged(sizes)
    rec_j, rec_t = JaxRecorder(), TraceRecorder()
    # repro's sharded run raises on buckets (ROADMAP Queue 3), so its gauges
    # come from the flat run, which has the same lanes, padding and rounds
    jax_sharded(scens, R.get_policy("panda_dispatch"), jax.random.PRNGKey(2), jax_mesh,
                recorder=rec_j)
    arg = T.stack_scenarios(tscens, buckets=2) if bucketed else tscens
    D.simulate_many_sharded(arg, T.get_policy("panda_dispatch"), PRNGKey(2), mesh,
                            recorder=rec_t)
    want, got = rec_j.summary(), rec_t.summary()
    assert got["counters"] == want["counters"]
    assert got["notes"]["lane_mode"] == want["notes"]["lane_mode"] == "auto"
    assert set(got["spans"]) == ({"ensemble_run"} if bucketed else set(want["spans"]))
    if bucketed:
        assert got["notes"]["bucket_padding"] == R.stack_scenarios(scens,
                                                                   buckets=2).padding_stats()


@pytest.mark.parametrize("ranks,K,mode", [(2, 3, "scan"), (3, 4, "vmap"), (2, 4, "auto")])
def test_spawned_ranks_return_the_one_process_result(tmp_path, ranks, K, mode):
    """Every rank of a spawned gloo mesh returns the whole K-lane result,
    equal to one process's ``simulate_many``; K = 3 over 2 ranks and 4 over
    3 pad the last block with repeats of the last lane."""
    D.run_ranks(M.lanes_rank, ranks, (str(tmp_path), K, mode, 5), device_type="cpu")
    want = M.flat(T.simulate_many(M.ragged_lanes(K), T.get_policy("panda_dispatch"),
                                  PRNGKey(5), device="cpu", log_rows=8))
    for r in range(ranks):
        got = torch.load(tmp_path / f"rank{r}.pt")
        _assert_same({k: v.numpy() for k, v in want.items()},
                     {k: v.numpy() for k, v in got.items()})


def test_a_failing_rank_fails_every_rank(tmp_path):
    with pytest.raises(mp.ProcessRaisedException,
                       match="must match the attached|failed their lane block"):
        D.run_ranks(M.failing_rank, 2, (str(tmp_path),), device_type="cpu")


def test_ensemble_distributed_equals_jax_ensemble_and_solo(mesh):
    sites = R.atlas_like_platform(4, seed=1)
    jobs = R.synthetic_panda_jobs(50, seed=4, duration=600.0)
    cand = np.asarray(sites.speed)[None] * np.array([[0.7], [1.0], [1.3]], np.float32)
    rj = R.simulate_ensemble(jobs, sites, R.get_policy("panda_dispatch"),
                             jax.random.PRNGKey(6), speed_candidates=cand)
    tjobs, tsites = T.scenario_from_numpy(_np_state(jobs), _np_state(sites), device="cpu")[:2]
    tcand = torch.from_numpy(cand)
    rt = D.simulate_ensemble_distributed(tjobs, tsites, T.get_policy("panda_dispatch"),
                                         PRNGKey(6), tcand, mesh)
    _assert_same(_flat(rj), _flat(rt))
    keys = split(PRNGKey(6), 3)
    for i in range(3):
        solo = T.simulate(tjobs, tsites._replace(speed=tcand[i]), T.get_policy("panda_dispatch"),
                          keys[i], device="cpu")
        _assert_same(_flat(solo), _lane(rt, i))


def test_ensemble_distributed_refuses_an_uneven_split(tmp_path):
    with pytest.raises(mp.ProcessRaisedException, match="candidates 3 must divide over 2"):
        D.run_ranks(M.uneven_ensemble_rank, 2, (str(tmp_path),), device_type="cpu")


def test_bad_arguments_raise(mesh):
    _, tscens = ragged([30, 30])
    with pytest.raises(ValueError, match="lane_mode"):
        D.simulate_many_sharded(tscens, T.get_policy("panda_dispatch"), PRNGKey(0), mesh,
                                lane_mode="pmap")
    with pytest.raises(ValueError, match="no axis"):
        D.simulate_many_sharded(tscens, T.get_policy("panda_dispatch"), PRNGKey(0), mesh,
                                axis="model")
    with pytest.raises(ValueError, match="does not match the mesh"):
        D.simulate_many_sharded(tscens, T.get_policy("panda_dispatch"), PRNGKey(0), mesh,
                                device="cuda")


def test_scenarios_off_the_mesh_device_type_raise(mesh):
    """A gloo mesh refuses lanes that lie on another kind of device than the
    CPU (here ``meta``, standing for a card) instead of copying them over."""
    _, tscens = ragged([30, 30])
    stacked = T.stack_scenarios(tscens)
    elsewhere = _tree_map(lambda x: x.to("meta"), stacked)
    with pytest.raises(ValueError, match="scenarios.* lies on meta, the run on cpu"):
        D.simulate_many_sharded(elsewhere, T.get_policy("panda_dispatch"), PRNGKey(0), mesh)


def test_mesh_helpers_default_to_the_card(tmp_path, monkeypatch):
    """``local_mesh`` and ``run_ranks`` build a ``"cuda"`` mesh unless asked
    for the CPU, and raise where no card is visible, before any process
    group or rank starts, rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda' mesh needs a card"):
        with D.local_mesh():
            pass
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="'cuda' mesh needs a card"):
        D.run_ranks(M.lanes_rank, 2, (str(tmp_path), 2, "scan", 5))
    assert not list(tmp_path.iterdir())
