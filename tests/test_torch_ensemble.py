"""Scenario ensembles in the port (``simulate_many``, ``simulate_ensemble``,
``stack_scenarios``) against the JAX package's, on the CPU.

Every lane of the port's ``simulate_many`` equals the JAX package's lane and
the port's own solo ``simulate`` of the padded jobs under ``split(rng,
K)[i]``: exact on every array of the result (rounds, makespan, jobs, sites,
the log and its cursor, the subsystem states).  The lanes here drain at
different rounds, so the batched loop freezes finished lanes as ``vmap`` of
the JAX package's ``while_loop`` does.  The lane-batched plain assignment
and the lane-offset segment sum are held against their per-lane forms.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.availability import availability_subsystem as jax_av_subsystem  # noqa: E402
from repro.core.policies import with_capacity_assign as jax_with_capacity_assign  # noqa: E402
from repro.core.telemetry import lane_occupancy as jax_lane_occupancy  # noqa: E402
from repro.core.workflows import workflow_subsystem as jax_wf_subsystem  # noqa: E402
from repro.kernels.assign.assign import assign_pallas  # noqa: E402
from repro.kernels.assign.ops import make_capacity_assign as jax_make_capacity_assign  # noqa: E402
from repro_torch.core.rng import PRNGKey, split  # noqa: E402
from repro_torch.kernels.assign import assign_ref, make_capacity_assign  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401


def _np_state(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _flat(tree, prefix=""):
    """Every array leaf of a result (JAX or port) by its path, as numpy."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        items = tree._asdict().items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    elif tree is None:
        return {}
    else:
        x = tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
        return {prefix: x}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _lane(tree, i):
    return {k: v[i] for k, v in _flat(tree).items()}


def _assert_same(want: dict, got: dict):
    assert sorted(want) == sorted(got), (sorted(want), sorted(got))
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert w.shape == g.shape, (k, w.shape, g.shape)
        same = w == g
        if w.dtype.kind == "f":
            same |= np.isnan(w) & np.isnan(g)
        assert same.all(), f"{k}: {int((~same).sum())} of {same.size} differ"


def ragged(sizes, n_sites=4, seed0=10):
    """``tests/test_ensemble_lanes.py``'s ragged scenarios, JAX and port."""
    sites = R.atlas_like_platform(n_sites, seed=1)
    scens = [
        R.Scenario(R.synthetic_panda_jobs(n, seed=seed0 + i, duration=600.0),
                   sites._replace(speed=sites.speed * (0.7 + 0.1 * i)))
        for i, n in enumerate(sizes)
    ]
    return scens, [T.scenario_from_numpy(_np_state(s.jobs), _np_state(s.sites), device="cpu")
                   for s in scens]


def combo(K=3, n=44, n_sites=3):
    """Availability and workflow DAGs per lane (``tests/test_ensemble_lanes.py``'s
    combo without the data subsystem): K same-shape scenarios."""
    sites = R.atlas_like_platform(n_sites, seed=7)
    scens = []
    for k in range(K):
        jobs = R.synthetic_panda_jobs(n, seed=30 + k, duration=600.0)
        av = R.make_availability(n_sites, [
            dict(site=k % n_sites, start=100.0 * (k + 1), end=900.0, preempt=True),
            dict(site=(k + 1) % n_sites, start=50.0, end=400.0, factor=0.5),
        ])
        edges = [(j - 1, j) for j in range(1, n, 2)]
        jobs_wf, wf = R.make_workflow(jobs, edges)
        scens.append(R.Scenario(jobs_wf, sites._replace(speed=sites.speed * (0.8 + 0.2 * k)),
                                {"availability": av, "workflow": wf}))
    port = [T.scenario_from_numpy(_np_state(s.jobs), _np_state(s.sites),
                                  {k: _np_state(v) for k, v in s.ext.items()}, device="cpu")
            for s in scens]
    return scens, port


def _solo_lanes(tscens, policy, seed, res, cap, **kw):
    """Each lane of ``res`` equals the port's solo run of its padded jobs
    under ``split(PRNGKey(seed), K)[i]``."""
    keys = split(PRNGKey(seed), len(tscens))
    for i, s in enumerate(tscens):
        solo_kw = {}
        if s.ext:
            solo_kw = dict(availability=s.ext.get("availability"), workflow=s.ext.get("workflow"))
        solo = T.simulate(T.pad_jobs_capacity(s.jobs, cap), s.sites, policy, keys[i],
                          device="cpu", **solo_kw, **kw)
        _assert_same(_flat(solo), _lane(res, i))


@pytest.mark.parametrize("log", [False, True])
def test_ragged_lanes_equal_jax_and_solo(log):
    sizes = [40, 72, 46, 58]
    scens, tscens = ragged(sizes)
    kw = dict(log_rows=16, monitor_every=3) if log else {}
    rj = R.simulate_many(scens, R.get_policy("panda_dispatch"), jax.random.PRNGKey(2), **kw)
    rt = T.simulate_many(tscens, T.get_policy("panda_dispatch"), PRNGKey(2), device="cpu", **kw)
    _assert_same(_flat(rj), _flat(rt))
    assert len(set(rt.rounds.tolist())) == len(sizes)  # lanes froze at different rounds
    _solo_lanes(tscens, T.get_policy("panda_dispatch"), 2, rt, max(sizes), **kw)


def test_bucketed_equals_flat_and_jax():
    sizes = [40, 72, 46, 90, 58, 33, 61]
    scens, tscens = ragged(sizes)
    flat = T.simulate_many(tscens, T.get_policy("shortest_wait"), PRNGKey(3), device="cpu")
    sb = T.stack_scenarios(tscens, buckets=3)
    assert isinstance(sb, T.ScenarioBuckets)
    assert sorted(i for ix in sb.index for i in ix) == list(range(len(sizes)))
    assert sorted(s.jobs.capacity for s in sb.buckets)[0] < max(sizes)
    res = T.simulate_many(sb, T.get_policy("shortest_wait"), PRNGKey(3), device="cpu")
    _assert_same(_flat(flat), _flat(res))
    rj = R.simulate_many(R.stack_scenarios(scens, buckets=3), R.get_policy("shortest_wait"),
                         jax.random.PRNGKey(3))
    _assert_same(_flat(rj), _flat(res))
    keys = split(PRNGKey(3), len(sizes))
    solo = T.simulate(T.pad_jobs_capacity(tscens[4].jobs, max(sizes)), tscens[4].sites,
                      T.get_policy("shortest_wait"), keys[4], device="cpu")
    _assert_same(_flat(solo), _lane(res, 4))


@pytest.mark.parametrize("kw", [{}, dict(log_rows=32), dict(quantum=30.0)],
                         ids=["plain", "log", "quantum"])
def test_availability_workflow_lanes(kw):
    """With ``quantum > 0`` the availability completion filter bites (a
    preempting window opening before a job's finish)."""
    scens, tscens = combo()
    rj = R.simulate_many(scens, R.get_policy("critical_path_first"), jax.random.PRNGKey(4),
                         subsystems=(jax_av_subsystem(), jax_wf_subsystem()), **kw)
    subs = (T.availability_subsystem(), T.workflow_subsystem())
    rt = T.simulate_many(tscens, T.get_policy("critical_path_first"), PRNGKey(4),
                         subsystems=subs, device="cpu", **kw)
    _assert_same(_flat(rj), _flat(rt))
    assert int(rt.avail.n_preempted.sum()) > 0      # the outages preempted jobs
    _solo_lanes(tscens, T.get_policy("critical_path_first"), 4, rt, tscens[0].jobs.capacity, **kw)


def _noise_jax(sub, ctx):
    u = jax.random.uniform(ctx.subkey("noise"))
    v = jax.random.uniform(ctx.subkey("noise", salt=1))
    ctx.ext["noise"] = {"sum": ctx.ext["noise"]["sum"] + u, "sum2": ctx.ext["noise"]["sum2"] + v}


def _noise_port(sub, ctx):
    u = T.rng.uniform(ctx.subkey("noise"), ())
    v = T.rng.uniform(ctx.subkey("noise", salt=1), ())
    ctx.ext["noise"] = {"sum": ctx.ext["noise"]["sum"] + u, "sum2": ctx.ext["noise"]["sum2"] + v}


def test_subsystem_subkeys_per_lane():
    """``RoundCtx.subkey`` gives each lane its solo key stream."""
    scens, tscens = ragged([30, 44, 37])
    zero = np.float32(0.0)
    rj = R.simulate_many(
        [s._replace(ext={"noise": {"sum": jnp.float32(0), "sum2": jnp.float32(0)}}) for s in scens],
        R.get_policy("panda_dispatch"), jax.random.PRNGKey(8),
        subsystems=(R.make_subsystem("noise", on_completions=_noise_jax),))
    sub = T.make_subsystem("noise", on_completions=_noise_port)
    state = {"sum": torch.tensor(zero), "sum2": torch.tensor(zero)}
    rt = T.simulate_many([s._replace(ext={"noise": state}) for s in tscens],
                         T.get_policy("panda_dispatch"), PRNGKey(8), subsystems=(sub,),
                         device="cpu")
    _assert_same(_flat(rj), _flat(rt))
    keys = split(PRNGKey(8), len(tscens))
    solo = T.simulate(T.pad_jobs_capacity(tscens[2].jobs, 44), tscens[2].sites,
                      T.get_policy("panda_dispatch"), keys[2], subsystems=((sub, state),),
                      device="cpu")
    _assert_same(_flat(solo), _lane(rt, 2))


def test_workflow_lanes_pad_in_buckets():
    """Ragged workflow lanes: the parent matrix pads with the jobs, in
    ``stack_scenarios`` and in the bucketed merge."""
    scens, tscens = combo(K=3)
    short = [T.Scenario(T.jobs_from_numpy({k: v[:30] for k, v in _np_state(s.jobs).items()},
                                          device="cpu"),
                        s.sites,
                        {"availability": s.ext["availability"],
                         "workflow": s.ext["workflow"]._replace(
                             parents=s.ext["workflow"].parents[:30])})
             if i == 1 else s for i, s in enumerate(tscens)]
    subs = (T.availability_subsystem(), T.workflow_subsystem())
    pol = T.get_policy("panda_dispatch")
    flat = T.simulate_many(short, pol, PRNGKey(6), subsystems=subs, device="cpu")
    sb = T.stack_scenarios(short, subsystems=subs, buckets=2)
    _assert_same(_flat(flat), _flat(T.simulate_many(sb, pol, PRNGKey(6), subsystems=subs,
                                                    device="cpu")))
    assert flat.wf.parents.shape == (3, 44, tscens[0].ext["workflow"].parents.shape[-1])


@pytest.mark.parametrize("policy", ["panda_dispatch", "least_loaded"])
def test_phase_skip_off_equals_on(policy):
    scens, tscens = ragged([40, 64, 52])
    on = T.simulate_many(tscens, T.get_policy(policy), PRNGKey(2), device="cpu")
    off = T.simulate_many(tscens, T.get_policy(policy), PRNGKey(2), device="cpu",
                          phase_skip=False)
    _assert_same(_flat(on), _flat(off))
    rj = R.simulate_many(scens, R.get_policy(policy), jax.random.PRNGKey(2), phase_skip=False)
    _assert_same(_flat(rj), _flat(off))


@pytest.mark.parametrize("policy", ["random", "round_robin", "fastest_site", "data_locality"])
def test_policies_in_lanes(policy):
    """The random policy draws under each lane's own key; the others read
    per-lane site columns (round robin counts each lane's active sites)."""
    scens, tscens = ragged([30, 41, 36])
    rj = R.simulate_many(scens, R.get_policy(policy), jax.random.PRNGKey(7))
    rt = T.simulate_many(tscens, T.get_policy(policy), PRNGKey(7), device="cpu")
    _assert_same(_flat(rj), _flat(rt))


def test_capacity_dispatch_lanes():
    sizes = [40, 72, 46, 58]
    scens, tscens = ragged(sizes)
    cap = max(sizes)
    cores_j = R.pad_jobs_capacity(scens[1].jobs, cap).cores     # one [J] for every lane
    pj = jax_with_capacity_assign(R.get_policy("panda_dispatch"),
                                  jax_make_capacity_assign(cores_j, use_kernel=False))
    pt = T.with_capacity_assign(T.get_policy("panda_dispatch"),
                                make_capacity_assign(torch.from_numpy(np.array(cores_j))))
    rj = R.simulate_many(scens, pj, jax.random.PRNGKey(5))
    rt = T.simulate_many(tscens, pt, PRNGKey(5), device="cpu")
    _assert_same(_flat(rj), _flat(rt))
    # per-lane sizes [K, J]: each lane equals its solo run with its own cores
    stacked = T.stack_scenarios(tscens)
    calls = []

    def counted(assign_fn):
        def fn(scores, *args):
            calls.append(tuple(scores.shape))
            return assign_fn(scores, *args)
        return fn

    pk = T.with_capacity_assign(T.get_policy("panda_dispatch"),
                                counted(make_capacity_assign(stacked.jobs.cores)))
    res = T.simulate_many(stacked, pk, PRNGKey(5), device="cpu")
    assert calls and all(c[0] == len(sizes) for c in calls)   # one call for all lanes
    keys = split(PRNGKey(5), len(sizes))
    for i, s in enumerate(tscens):
        jobs = T.pad_jobs_capacity(s.jobs, cap)
        pol = T.with_capacity_assign(T.get_policy("panda_dispatch"),
                                     make_capacity_assign(jobs.cores))
        solo = T.simulate(jobs, s.sites, pol, keys[i], device="cpu")
        _assert_same(_flat(solo), _lane(res, i))


@pytest.mark.parametrize("K,N,E,k,bn", [(3, 300, 8, 1, 256), (3, 300, 8, 3, 64),
                                        (2, 70, 5, 2, 32)])
def test_batched_assign_ref_against_pallas(K, N, E, k, bn):
    rng = np.random.default_rng(K * N + E + k)
    scores = rng.normal(size=(K, N, E)).astype(np.float32)
    scores[rng.random((K, N, E)) < 0.2] = -1e30
    sizes = rng.choice([1.0, 2.0, 8.0], size=(K, N)).astype(np.float32)
    caps = rng.uniform(2, 40, size=(K, E)).astype(np.float32)
    want = jax.vmap(lambda s, z, c: assign_pallas(s, z, c, k=k, block_n=bn, interpret=True))(
        jnp.array(scores), jnp.array(sizes), jnp.array(caps))
    got = assign_ref(torch.from_numpy(scores), torch.from_numpy(sizes), torch.from_numpy(caps),
                     k=k, block_n=bn)
    for w, g, name in zip(want, got, ("idx", "gate", "admit", "pos")):
        w = np.asarray(w)
        assert w.shape == tuple(g.shape), name
        if name == "gate":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    for i in range(K):   # each lane is its own unbatched call, bit for bit
        solo = assign_ref(torch.from_numpy(scores[i]), torch.from_numpy(sizes[i]),
                          torch.from_numpy(caps[i]), k=k, block_n=bn)
        for s, g in zip(solo, got):
            assert torch.equal(s, g[i])


@pytest.mark.parametrize("dtype,F", [(torch.float32, None), (torch.int32, None),
                                     (torch.int32, 3)])
def test_lane_segment_sum_drops_padding_per_lane(dtype, F):
    """Lane ``l``'s padding id S must not land in lane ``l + 1``'s segment 0."""
    K, J, S = 4, 57, 6
    g = torch.Generator().manual_seed(3)
    seg = torch.randint(-2, S + 3, (K, J), generator=g, dtype=torch.int32)
    seg[:, ::5] = S                                   # the padding segment
    shape = (K, J) if F is None else (K, J, F)
    values = (torch.randn(shape, generator=g) if dtype == torch.float32
              else torch.randint(-50, 50, shape, generator=g, dtype=torch.int32))
    got = segment_sum(values, seg, S)
    for i in range(K):
        want = segment_sum(values[i], seg[i], S)
        assert torch.equal(got[i].view(torch.int32) if dtype == torch.float32 else got[i],
                           want.view(torch.int32) if dtype == torch.float32 else want)
    assert got.shape == ((K, S) if F is None else (K, S, F))


def test_simulate_ensemble_matches_jax():
    jobs = R.synthetic_panda_jobs(50, seed=3, duration=600.0)
    sites = R.atlas_like_platform(4, seed=2)
    speeds = np.stack([np.asarray(sites.speed) * f for f in (0.6, 1.0, 1.7)]).astype(np.float32)
    rj = R.simulate_ensemble(jobs, sites, R.get_policy("least_loaded"), jax.random.PRNGKey(9),
                             speed_candidates=jnp.asarray(speeds))
    rt = T.simulate_ensemble(T.jobs_from_numpy(_np_state(jobs), device="cpu"),
                             T.sites_from_numpy(_np_state(sites), device="cpu"),
                             T.get_policy("least_loaded"), PRNGKey(9),
                             speed_candidates=torch.from_numpy(speeds), device="cpu")
    _assert_same(_flat(rj), _flat(rt))


def test_padding_stats_and_lane_occupancy_match_jax():
    sizes = [40, 72, 46, 90, 58]
    scens, tscens = ragged(sizes)
    sbj, sbt = R.stack_scenarios(scens, buckets=2), T.stack_scenarios(tscens, buckets=2)
    assert sbt.padding_stats() == sbj.padding_stats()
    rj = R.simulate_many(sbj, R.get_policy("panda_dispatch"), jax.random.PRNGKey(1), log_rows=64)
    rt = T.simulate_many(sbt, T.get_policy("panda_dispatch"), PRNGKey(1), device="cpu",
                         log_rows=64)
    assert T.lane_occupancy(rt, sbt) == jax_lane_occupancy(rj, sbj)
    assert T.lane_occupancy(rt)["summary"]["n_lanes"] == len(sizes)


@pytest.mark.parametrize("kw", [dict(log_rows=8), dict(log_rows=8, monitor_every=3),
                                dict(max_rounds=20)], ids=["log", "monitor_every", "max_rounds"])
def test_segmented_lanes_equal_one_call(kw):
    """Lanes run in segments (``init_sim``, ``advance_sim(50)``,
    ``advance_sim(inf)``) equal one ``simulate_many`` call, each lane's solo
    segmented run and the JAX package's ``simulate_many``: a horizon freezes
    lanes mid-run, and each resumes at its own round and log slot."""
    sizes = [30, 41, 36]
    scens, tscens = ragged(sizes)
    pol = T.get_policy("panda_dispatch")
    keys = split(PRNGKey(1), len(sizes))
    stacked = T.stack_scenarios(tscens)
    h = T.advance_sim(T.init_sim(stacked.jobs, stacked.sites, pol, keys, device="cpu", **kw), 50.0)
    assert T.sim_active(h)
    seg = T.finish_sim(T.advance_sim(h))
    one = T.simulate_many(tscens, pol, PRNGKey(1), device="cpu", **kw)
    _assert_same(_flat(one), _flat(seg))
    rj = R.simulate_many(scens, R.get_policy("panda_dispatch"), jax.random.PRNGKey(1), **kw)
    _assert_same(_flat(rj), _flat(seg))
    for i, s in enumerate(tscens):
        hs = T.init_sim(T.pad_jobs_capacity(s.jobs, max(sizes)), s.sites, pol, keys[i],
                        device="cpu", **kw)
        _assert_same(_flat(T.finish_sim(T.advance_sim(T.advance_sim(hs, 50.0)))), _lane(seg, i))
    if "max_rounds" in kw:
        assert seg.rounds.tolist() == [20, 20, 20]


@pytest.mark.parametrize("name", ["availability", "workflow", "data_policy", "network",
                                  "replicas", "transfers", "faults"])
def test_simulate_many_refuses_subsystem_keywords(name):
    """As the JAX package's ``simulate_many`` does: lanes take their
    subsystem states through ``Scenario.ext``, flat and bucketed."""
    _, tscens = ragged([20, 24])
    pol = T.get_policy("panda_dispatch")
    with pytest.raises(TypeError, match=name):
        T.simulate_many(tscens, pol, PRNGKey(0), device="cpu", **{name: object()})
    with pytest.raises(TypeError, match=name):
        T.simulate_many(T.stack_scenarios(tscens, buckets=2), pol, PRNGKey(0), device="cpu",
                        **{name: object()})


def test_ensemble_misuse_raises():
    """What an ensemble still refuses: simulate's subsystem keywords, and
    ``Scenario.ext`` keys that do not match the ``subsystems`` tuple."""
    _, tscens = ragged([20, 24])
    pol = T.get_policy("panda_dispatch")
    with pytest.raises(TypeError, match="faults"):
        T.simulate_many(tscens, pol, PRNGKey(0), device="cpu", faults=None)
    with pytest.raises(ValueError, match="one-to-one"):
        T.simulate_many(tscens, pol, PRNGKey(0), subsystems=(T.availability_subsystem(),),
                        device="cpu")
    with pytest.raises(ValueError, match="one-to-one"):
        T.simulate_many([s._replace(ext={"faults": ()}) for s in tscens], pol, PRNGKey(0),
                        device="cpu")
