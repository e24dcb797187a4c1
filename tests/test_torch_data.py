"""Data movement in the port (``network``, ``replicas``, ``datapolicies``, the
data branch of the sparse candidate index and workflow output production)
against the JAX package's, on the same seeded inputs, on the CPU.

Two tiers, as ROADMAP's port rules set them: exact for ints, bools, states,
rounds and f32 timestamps (``last_access`` included); ``rtol=1e-6`` for the
f32 accumulators ``bytes_moved``, ``disk_used`` (and its log column
``site_disk``), ``site_net_in``, ``bytes_done``, ``bytes_enq`` and
``bytes_cancel``.  On these scenarios the accumulators also come out exact.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro.core.datapolicies as RD  # noqa: E402
import repro.core.replicas as RR  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.datapolicies as TD  # noqa: E402
import repro_torch.core.network as TN  # noqa: E402
import repro_torch.core.replicas as TR  # noqa: E402
from repro_torch.core.rng import PRNGKey  # noqa: E402
from test_golden_trace import combo_kwargs, matrix_scenario  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

ACCUMULATORS = {"bytes_moved", "disk_used", "site_disk", "site_net_in", "bytes_done",
                "bytes_enq", "bytes_cancel"}
LOG_FIELDS = ("time", "round_idx", "counts", "n_started", "n_completed", "site_free",
              "site_queued", "site_running", "cursor")


def _np_state(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _port_kw(kw: dict, policy_name: str = "cache_on_read") -> dict:
    """The JAX package's subsystem keyword states, carried to the port."""
    conv = dict(availability=T.availability_from_numpy, workflow=T.workflow_from_numpy,
                network=T.network_from_numpy, replicas=T.replicas_from_numpy,
                transfers=T.transfers_from_numpy)
    out = {}
    for k, v in kw.items():
        if k == "data_policy":
            out[k] = T.get_data_policy(policy_name) if isinstance(v, RD.DataPolicy) else v
        else:
            out[k] = conv[k](_np_state(v), device="cpu")
    return out


def _run_pair(jobs, sites, pj, pt, seed, kw, port_kw=None, **run_kw):
    rj = R.simulate(jobs, sites, pj, jax.random.PRNGKey(seed), **kw, **run_kw)
    rt = T.simulate(T.jobs_from_numpy(_np_state(jobs), device="cpu"),
                    T.sites_from_numpy(_np_state(sites), device="cpu"), pt, PRNGKey(seed),
                    device="cpu", **(port_kw if port_kw is not None else _port_kw(kw)),
                    **run_kw)
    return rj, rt


def _check(a, b, what: str):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    if what.rsplit(".", 1)[-1] in ACCUMULATORS:
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def _check_group(ja: dict, tb: dict, what: str):
    assert sorted(ja) == sorted(tb), what
    for k, a in ja.items():
        if isinstance(a, dict):
            _check_group(a, tb[k], f"{what}.{k}")
        else:
            _check(a, tb[k], f"{what}.{k}")


def _deep_np(value):
    if isinstance(value, tuple) and hasattr(value, "_asdict"):
        return {k: _deep_np(v) for k, v in value._asdict().items()}
    if isinstance(value, dict):
        return {k: _deep_np(v) for k, v in value.items()}
    return np.asarray(value)


def assert_same_run(rj, rt, log=True) -> dict:
    """Rounds, makespan, every job and site column, every subsystem state
    (catalog and transfer rings included) and, with ``log``, the event log
    and its subsystem columns."""
    t = T.result_to_numpy(rt)
    assert int(rj.rounds) == int(t["rounds"])
    assert np.float32(rj.makespan) == t["makespan"]
    _check_group(_np_state(rj.jobs), t["jobs"], "jobs")
    _check_group(_np_state(rj.sites), t["sites"], "sites")
    for name in ("avail", "wf", "replicas"):
        assert (getattr(rj, name) is None) == (getattr(rt, name) is None), name
        if getattr(rj, name) is not None:
            _check_group(_np_state(getattr(rj, name)), t[name], name)
    assert sorted(rj.ext) == sorted(rt.ext)
    if "data" in rj.ext:
        _check_group(_deep_np(rj.ext["data"]), _deep_np(rt.ext["data"]), "ext.data")
        _check_group({"s": _deep_np(rj.data_state)}, {"s": t["data_state"]}, "data_state")
    if "transfers" in rj.ext:
        _check_group(_np_state(rj.ext["transfers"]), t["transfers"], "transfers")
    if log:
        for f in LOG_FIELDS:
            _check(getattr(rj.log, f), t["log"][f], f"log.{f}")
        _check_group({k: np.asarray(v) for k, v in rj.log.extra.items()}, t["log"]["extra"],
                     "log.extra")
    return t


def _pols(name="panda_dispatch"):
    return R.get_policy(name), T.get_policy(name)


def _same_state(a, b, what):
    for f, x in _np_state(a).items():
        np.testing.assert_array_equal(x, getattr(b, f).numpy(), err_msg=f"{what}.{f}")


# --------------------------------------------------------------------------
# network
# --------------------------------------------------------------------------


def test_network_builders():
    rng = np.random.default_rng(0)
    bw = rng.uniform(1e8, 1e9, (5, 5))
    lat = rng.uniform(0.0, 0.1, (5, 5))
    up, down = rng.uniform(1e8, 1e9, 5), rng.uniform(1e8, 1e9, 5)
    site_lat = rng.uniform(0.0, 0.05, 5)
    tier = np.array([0, 1, 2, 1, 2, 3])
    cases = [
        ("matrix", R.matrix_network(bw, lat), T.matrix_network(bw, lat, device="cpu")),
        ("matrix(local)", R.matrix_network(bw, lat, local_bw=3e12, local_latency=0.001),
         T.matrix_network(bw, lat, local_bw=3e12, local_latency=0.001, device="cpu")),
        ("uniform", R.uniform_network(6), T.uniform_network(6, device="cpu")),
        ("uniform(bw,lat)", R.uniform_network(3, bw=5e8, latency=0.05),
         T.uniform_network(3, bw=5e8, latency=0.05, device="cpu")),
        ("star", R.star_network(up), T.star_network(up, device="cpu")),
        ("star(down,lat,hub)", R.star_network(up, down, site_lat, hub_latency=0.013),
         T.star_network(up, down, site_lat, hub_latency=0.013, device="cpu")),
        ("tiered", R.tiered_network(tier, [4e10, 1e10, 1.25e9]),
         T.tiered_network(tier, [4e10, 1e10, 1.25e9], device="cpu")),
        ("tiered(latency)", R.tiered_network(tier, [5e10, 1e9], tier_latency=0.021),
         T.tiered_network(tier, [5e10, 1e9], tier_latency=0.021, device="cpu")),
        ("atlas_like", R.atlas_like_network(30, seed=2), T.atlas_like_network(30, seed=2,
                                                                              device="cpu")),
        ("atlas_like(capacity)", R.atlas_like_network(7, seed=5, capacity=9),
         T.atlas_like_network(7, seed=5, capacity=9, device="cpu")),
    ]
    sj = R.atlas_like_platform(5, seed=3)
    st = T.sites_from_numpy(_np_state(sj), device="cpu")
    cases.append(("from_sites", R.network_from_sites(sj), T.network_from_sites(st)))
    new_bw = rng.uniform(1e7, 1e8, (5, 5))
    cases.append(("with_bandwidth", R.with_bandwidth(R.matrix_network(bw, lat), new_bw),
                  T.with_bandwidth(T.matrix_network(bw, lat, device="cpu"), new_bw)))
    for name, a, b in cases:
        _same_state(a, b, name)
        assert b.n_sites == a.n_sites
    with pytest.raises(ValueError, match="square"):
        T.matrix_network(bw[:, :4], lat[:, :4], device="cpu")
    with pytest.raises(ValueError, match="bandwidth shape"):
        T.with_bandwidth(T.uniform_network(5, device="cpu"), new_bw[:4, :4])


def test_link_caps_and_index():
    for args in ((4, 3, None), (3, 2, {(0, 1): 7, (2, 2): 0}), (2, 5, [[1, 2], [3, 4]])):
        np.testing.assert_array_equal(np.asarray(R.link_caps(*args)),
                                      T.link_caps(*args, device="cpu").numpy())
    with pytest.raises(ValueError, match="link cap matrix"):
        T.link_caps(3, 1, np.ones((2, 2)), device="cpu")
    src, dst = np.array([0, 2, 1, 3]), np.array([3, 1, 1, 0])
    np.testing.assert_array_equal(np.asarray(R.link_index(src, dst, 4)),
                                  T.link_index(torch.from_numpy(src), torch.from_numpy(dst),
                                               4).numpy())


@pytest.mark.parametrize("S,J", [(4, 60), (30, 2000)])
def test_link_shares_and_transfer_times(S, J):
    rng = np.random.default_rng(S)
    net = R.atlas_like_network(S, seed=1)
    tnet = T.network_from_numpy(_np_state(net), device="cpu")
    # few sites for many rows: links carry many flows
    src = rng.integers(0, min(S, 5), J).astype(np.int32)
    dst = rng.integers(0, min(S, 5), J).astype(np.int32)
    nbytes = rng.lognormal(np.log(2e9), 1.0, J).astype(np.float32)
    active = rng.random(J) < 0.6
    ts, td, tb, ta = (torch.from_numpy(x) for x in (src, dst, nbytes, active))
    share = R.network.link_shares(net, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(active))
    np.testing.assert_array_equal(np.asarray(share), TN.link_shares(tnet, ts, td, ta).numpy())
    assert float(np.asarray(share).max()) > 1.0
    for fj, ft in zip(jax.jit(R.shared_transfer_times)(net, src, dst, nbytes, active),
                      T.shared_transfer_times(tnet, ts, td, tb, ta)):
        np.testing.assert_array_equal(np.asarray(fj), ft.numpy())


# --------------------------------------------------------------------------
# the replica catalog
# --------------------------------------------------------------------------


def _catalog(D=40, S=5, seed=0, cap=6e10, placement=0.2):
    rng = np.random.default_rng(seed)
    sizes = R.zipf_dataset_sizes(D, seed=seed, mean_bytes=2e9)
    place = rng.random((D, S)) < placement
    rj = R.make_replicas(sizes, np.full(S, cap), placement=place, seed=seed)
    rt = T.make_replicas(sizes, np.full(S, cap), placement=place, seed=seed, device="cpu")
    return rj, rt


def test_make_replicas_and_sizes():
    for n, kw in ((12, {}), (300, dict(seed=4, mean_bytes=5e9, sigma=0.5))):
        np.testing.assert_array_equal(R.zipf_dataset_sizes(n, **kw),
                                      T.zipf_dataset_sizes(n, **kw))
    rj, rt = _catalog()
    _same_state(rj, rt, "make_replicas(placement)")
    sizes = R.zipf_dataset_sizes(20, seed=1)
    cap = np.array([4e11, 0.0, 2e11, 1e12])
    mat = np.arange(20) % 3 != 0
    for kw in (dict(seed=7), dict(origin=np.arange(20) % 4), dict(materialized=mat, seed=2)):
        _same_state(R.make_replicas(sizes, cap, **kw),
                    T.make_replicas(sizes, cap, device="cpu", **kw), f"make_replicas({kw})")
    assert TR.catalog_invariants(rt) == RR.catalog_invariants(rj)
    assert all(TR.catalog_invariants(rt).values())


def test_nearest_source_sentinels():
    """Unreachable sources (zero and NaN bandwidth, infinite latency) leave
    the argmin; rows with no reachable replica fall back to the origin."""
    D, S, J = 6, 4, 32
    rng = np.random.default_rng(3)
    sizes = R.zipf_dataset_sizes(D, seed=3, mean_bytes=2e9)
    place = np.zeros((D, S), bool)
    place[0, [1, 2, 3]] = True
    place[1, 2] = True
    place[2, [1, 3]] = True
    rj = R.make_replicas(sizes, np.full(S, 1e12), origin=np.array([0, 0, 0, 1, 2, 3]),
                         placement=place)
    bw = rng.uniform(1e8, 1e9, (S, S)).astype(np.float32)
    lat = rng.uniform(0.01, 0.1, (S, S)).astype(np.float32)
    bw[1, 0], bw[2, 0], lat[3, 0] = 0.0, np.nan, np.inf        # dst 0: only the origin
    bw[2, 1], bw[1, 1] = 2e9, 2e9                              # ties: first site wins
    lat[2, 1], lat[1, 1] = 0.05, 0.05
    net = R.matrix_network(bw, lat)
    net = net._replace(bw=net.bw.at[0, 2].set(jnp.nan))         # origin 0 unreachable at 2
    dataset = rng.integers(-1, D, J).astype(np.int32)
    dst = rng.integers(0, S, J).astype(np.int32)
    want = np.asarray(R.nearest_source(rj, net, dataset, dst))
    got = T.nearest_source(T.replicas_from_numpy(_np_state(rj), device="cpu"),
                           T.network_from_numpy(_np_state(net), device="cpu"),
                           torch.from_numpy(dataset), torch.from_numpy(dst)).numpy()
    np.testing.assert_array_equal(want, got)


def _want(D, S, seed, frac=0.3):
    return np.random.default_rng(seed + 100).random((D, S)) < frac


@pytest.mark.parametrize("case", ["fast", "evicting", "never_fits"])
def test_insert_mask_paths(case):
    """Both paths of ``insert_mask``: without pressure (the fast path), with
    LRU eviction (1 GB of room a site), and with a site where nothing is
    evictable (every replica there is wanted again) so its insertions never
    fit.  ``evicting_calls`` counts the evicting path."""
    rj, rt = _catalog(D=48, S=5, seed=2, cap=1e13, placement=0.3)
    # stagger the LRU clocks (and tie some) so the sort order matters
    la = np.where(np.asarray(rj.present),
                  np.random.default_rng(5).integers(0, 4, (48, 5)) * 10.0,
                  -np.inf).astype(np.float32)
    used = np.asarray(rj.disk_used)
    cap = np.full(5, 1e13, np.float32) if case == "fast" else (used + 1e9).astype(np.float32)
    want = _want(48, 5, 2, 0.15)
    if case == "never_fits":
        cap[3] = used[3]
        want[:, 3] |= np.asarray(rj.present)[:, 3]
    rj = rj._replace(last_access=jnp.asarray(la), disk_cap=jnp.asarray(cap))
    rt = rt._replace(last_access=torch.from_numpy(la), disk_cap=torch.from_numpy(cap))
    TR.evicting_calls = 0
    oj = RR.insert_mask(rj, jnp.asarray(want), 35.0)
    ot = TR.insert_mask(rt, torch.from_numpy(want), 35.0)
    _same_state(oj, ot, f"insert_mask({case})")
    assert TR.evicting_calls == (0 if case == "fast" else 1)
    inv = TR.catalog_invariants(ot)
    assert inv == RR.catalog_invariants(oj) and all(inv.values())
    if case != "fast":
        assert bool((~np.asarray(oj.present) & np.asarray(rj.present)).any()), "nothing evicted"
    if case == "never_fits":
        # site 3 skips its insertions and keeps its replicas
        np.testing.assert_array_equal(ot.present[:, 3].numpy(), rt.present[:, 3].numpy())


def test_insert_replicas_touch_and_materialize():
    """Row-wise insertion with repeated (dataset, site) rows, LRU touches, and
    two producers of one dataset in one call (the higher row sets the
    origin, as XLA's scatter does on the CPU)."""
    rj, rt = _catalog(D=10, S=4, seed=1, cap=1e13, placement=0.1)
    rng = np.random.default_rng(9)
    J = 40
    ds = rng.integers(-1, 10, J).astype(np.int32)
    site = rng.integers(-1, 4, J).astype(np.int32)
    mask = rng.random(J) < 0.5
    mask[:3], ds[:3], site[:3] = True, 4, 2             # one cell named three times
    args_j = (jnp.asarray(ds), jnp.asarray(site), jnp.asarray(mask))
    args_t = (torch.from_numpy(ds), torch.from_numpy(site), torch.from_numpy(mask))
    _same_state(RR.insert_replicas(rj, *args_j, 12.0), TR.insert_replicas(rt, *args_t, 12.0),
                "insert_replicas")
    _same_state(RR.touch(rj, *args_j, 7.5), TR.touch(rt, *args_t, 7.5), "touch")
    prod = np.zeros(J, bool)
    prod[[5, 11, 17]] = True
    ds2, site2 = ds.copy(), site.copy()
    ds2[[5, 11, 17]], site2[[5, 11, 17]] = 8, [3, 1, 0]
    mj = RR.materialize_outputs(rj, jnp.asarray(ds2), jnp.asarray(site2), jnp.asarray(prod), 3.0)
    mt = TR.materialize_outputs(rt, torch.from_numpy(ds2), torch.from_numpy(site2),
                                torch.from_numpy(prod), 3.0)
    _same_state(mj, mt, "materialize_outputs")
    assert int(mt.origin[8]) == 0 and bool(mt.present[8, [0, 1, 3]].all())


def test_pre_place_hot_init():
    """``pre_place_hot.init``: the hottest datasets by job count copied to
    the largest storage elements; a zero capacity sorts as one zero."""
    jobs = R.synthetic_panda_jobs(200, seed=4, n_datasets=30)
    sites = R.atlas_like_platform(6, seed=2)
    sizes = R.zipf_dataset_sizes(30, seed=1, mean_bytes=1e9)
    cap = np.array([4e10, 0.0, 9e10, 9e10, 2e10, 5e10])
    rj = R.make_replicas(sizes, cap, seed=1)
    rt = T.replicas_from_numpy(_np_state(rj), device="cpu")
    tj = T.jobs_from_numpy(_np_state(jobs), device="cpu")
    ts = T.sites_from_numpy(_np_state(sites), device="cpu")
    net = R.uniform_network(6)
    tnet = T.network_from_numpy(_np_state(net), device="cpu")
    for kw in (dict(), dict(hot_frac=0.3, n_copies=2)):
        pj, pt = R.get_data_policy("pre_place_hot", **kw), T.get_data_policy("pre_place_hot",
                                                                               **kw)
        assert pj.name == pt.name
        oj, _ = pj.init(jobs, sites, net, rj)
        ot, _ = pt.init(tj, ts, tnet, rt)
        _same_state(oj, ot, f"pre_place_hot({kw})")
        assert bool((ot.present.sum() > rt.present.sum()))


def test_data_policy_registry():
    assert sorted(TD.DATA_REGISTRY) == sorted(RD.DATA_REGISTRY)
    with pytest.raises(KeyError, match="unknown data policy"):
        T.get_data_policy("nope")

    @TD.register_data("scratch_remote")
    def scratch():
        return T.make_data_policy("scratch_remote")

    try:
        assert T.get_data_policy("scratch_remote").name == "scratch_remote"
    finally:
        del TD.DATA_REGISTRY["scratch_remote"]


# --------------------------------------------------------------------------
# whole runs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("combo", ["data", "data+avail", "data+wf", "data+avail+wf"])
def test_matrix_rows(combo):
    """The golden matrix's data rows from ``matrix_scenario()``:
    ``cache_on_read`` over a uniform WAN with 6 GB disks at three of four
    sites (LRU eviction), with a preempting outage, a brown-out and a drain
    window, and pairwise DAG chains whose parents materialize outputs."""
    scn = matrix_scenario()
    jobs, kw = combo_kwargs(scn, True, "avail" in combo, "wf" in combo)
    TR.evicting_calls = 0
    rj, rt = _run_pair(jobs, scn["sites"], *_pols(), 0, kw, log_rows=32, monitor_every=2)
    assert_same_run(rj, rt)
    assert int(rt.replicas.n_transfers) > 0 and int(rt.replicas.n_hits) > 0
    assert TR.evicting_calls > 0, "no storage pressure: the LRU path did not run"
    inv = TR.catalog_invariants(rt.replicas)
    assert inv == RR.catalog_invariants(rj.replicas)
    # produced outputs bypass the capacity check (materialize_outputs), so
    # only runs without the DAG keep every disk within its capacity
    assert all(v for k, v in inv.items() if k != "capacity_ok" or "wf" not in combo)
    if "wf" in combo:
        assert int(rt.wf.n_produced) > 0


@pytest.mark.parametrize("name", ["always_remote", "pre_place_hot"])
def test_other_policies(name):
    scn = matrix_scenario()
    jobs, kw = combo_kwargs(scn, True, True, False)
    kw["data_policy"] = R.get_data_policy(name)
    pkw = _port_kw(kw)
    pkw["data_policy"] = T.get_data_policy(name)
    rj, rt = _run_pair(jobs, scn["sites"], *_pols(), 1, kw, pkw, log_rows=16)
    assert_same_run(rj, rt)


def test_datasetless_jobs_keep_the_flat_link():
    """Jobs without a dataset stage over the flat site link: with the data
    subsystem attached they run exactly as without it, and as in JAX."""
    jobs = R.synthetic_panda_jobs(60, seed=11, duration=900.0)
    sites = R.atlas_like_platform(4, seed=12, fail_rate=0.05)
    scn = matrix_scenario()
    kw = dict(data_policy=scn["data_policy"], network=scn["network"], replicas=scn["replicas"])
    rj, rt = _run_pair(jobs, sites, *_pols(), 0, kw)
    assert_same_run(rj, rt, log=False)
    plain = T.simulate(T.jobs_from_numpy(_np_state(jobs), device="cpu"),
                       T.sites_from_numpy(_np_state(sites), device="cpu"),
                       T.get_policy("panda_dispatch"), PRNGKey(0), device="cpu")
    a, b = T.result_to_numpy(plain), T.result_to_numpy(rt)
    for f, x in a["jobs"].items():
        np.testing.assert_array_equal(x, b["jobs"][f], err_msg=f)
    assert int(rt.replicas.n_transfers) == 0 and int(rt.replicas.n_hits) == 0


class _JaxPlugin(RD.DataPlugin):
    """Reads from the origin, caches datasets over 2 GB, counts WAN reads."""

    name = "origin_big_cache"

    def get_resource_information(self, jobs, sites, network, replicas):
        return replicas, jnp.zeros((), jnp.int32)

    def select_source(self, jobs, sites, network, replicas, state, dst, clock):
        return replicas.origin[jnp.clip(jobs.dataset, 0, replicas.n_datasets - 1)]

    def should_cache(self, jobs, sites, network, replicas, state, dst, clock):
        return replicas.size[jnp.clip(jobs.dataset, 0, replicas.n_datasets - 1)] > 2e9

    def on_transfer(self, state, jobs, replicas, started, xfer, clock):
        return state + xfer.sum().astype(jnp.int32)

    def on_simulation_end(self, state, jobs, replicas, clock):
        return state * 10


class _TorchPlugin(TD.DataPlugin):
    name = "origin_big_cache"

    def get_resource_information(self, jobs, sites, network, replicas):
        return replicas, torch.zeros((), dtype=torch.int32)

    def select_source(self, jobs, sites, network, replicas, state, dst, clock):
        return replicas.origin[jobs.dataset.clamp(0, replicas.n_datasets - 1).long()]

    def should_cache(self, jobs, sites, network, replicas, state, dst, clock):
        return replicas.size[jobs.dataset.clamp(0, replicas.n_datasets - 1).long()] > 2e9

    def on_transfer(self, state, jobs, replicas, started, xfer, clock):
        return state + xfer.sum().int()

    def on_simulation_end(self, state, jobs, replicas, clock):
        return state * 10


def test_data_plugin_subclass():
    scn = matrix_scenario()
    jobs, kw = combo_kwargs(scn, True, False, True)
    kw["data_policy"] = _JaxPlugin().build()
    pkw = _port_kw(kw)
    pkw["data_policy"] = _TorchPlugin().build()
    rj, rt = _run_pair(jobs, scn["sites"], *_pols(), 2, kw, pkw, log_rows=16)
    assert_same_run(rj, rt)
    assert int(rt.data_state) > 0


@pytest.mark.parametrize("refresh", [0, 5])
def test_sparse_with_the_data_branch(refresh):
    """The data-locality branch of the candidate index, built at init and
    (``topk_refresh=5``) rebuilt from the current catalog every 5 rounds:
    ``topk=S`` equals the dense run in the port, and ``topk=2`` equals the
    JAX package's."""
    scn = matrix_scenario()
    jobs, kw = combo_kwargs(scn, True, True, True)
    pj, pt = _pols("data_locality")
    rj, rt = _run_pair(jobs, scn["sites"], pj, pt, 0, kw, topk=2, topk_refresh=refresh,
                       log_rows=16)
    assert_same_run(rj, rt)
    if refresh:
        return
    full = T.simulate(T.jobs_from_numpy(_np_state(jobs), device="cpu"),
                      T.sites_from_numpy(_np_state(scn["sites"]), device="cpu"), pt, PRNGKey(0),
                      device="cpu", topk=4, **_port_kw(kw))
    dense = T.simulate(T.jobs_from_numpy(_np_state(jobs), device="cpu"),
                       T.sites_from_numpy(_np_state(scn["sites"]), device="cpu"), pt, PRNGKey(0),
                       device="cpu", **_port_kw(kw))
    a, b = T.result_to_numpy(dense), T.result_to_numpy(full)
    assert a["rounds"] == b["rounds"]
    for group in ("jobs", "replicas"):
        for f, x in a[group].items():
            np.testing.assert_array_equal(x, b[group][f], err_msg=f"{group}.{f}")


def test_atlas_mc_workflows_with_scenario_replicas():
    """4-stage ATLAS MC chains whose intermediate datasets start absent:
    ``scenario_replicas`` builds the same catalog in both packages, and the
    run with ``cache_on_read``, capacity-bound disks and ``least_loaded``
    (which, unlike the data-aware policies, sends children away from their
    parents' outputs, so they stage in over the WAN) is the same."""
    sj = R.atlas_mc_workflows(12, seed=3, arrival_span=1800.0)
    st = T.atlas_mc_workflows(12, seed=3, arrival_span=1800.0, device="cpu")
    sites = R.atlas_like_platform(6, seed=4, fail_rate=0.05)
    disk = np.asarray(sites.memory) * 3e7
    rj_cat = R.scenario_replicas(sj, disk, seed=1)
    rt_cat = T.scenario_replicas(st, disk, seed=1)
    _same_state(rj_cat, rt_cat, "scenario_replicas")
    assert not bool(rt_cat.present.any(-1).all())    # some datasets start absent
    net = R.atlas_like_network(6, seed=2)
    kw = dict(data_policy=R.get_data_policy("cache_on_read"), network=net, replicas=rj_cat,
              workflow=sj.workflow)
    pkw = dict(data_policy=T.get_data_policy("cache_on_read"),
               network=T.network_from_numpy(_np_state(net), device="cpu"), replicas=rt_cat,
               workflow=st.workflow)
    rj, rt = _run_pair(sj.jobs, sites, *_pols("least_loaded"), 0, kw, pkw, log_rows=24)
    assert_same_run(rj, rt)
    assert int(rt.wf.n_produced) > 0 and int(rt.replicas.n_transfers) > 0


def test_data_entry_points_default_to_the_gpu():
    """The data and transfer builders, and a run with them, default to the
    card and raise without one; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a GPU")
    builders = [
        lambda: T.uniform_network(3),
        lambda: T.matrix_network(np.ones((2, 2)), np.zeros((2, 2))),
        lambda: T.star_network(np.ones(3)),
        lambda: T.tiered_network([0, 1], [1e9, 1e8]),
        lambda: T.atlas_like_network(4, seed=1),
        lambda: T.link_caps(3, 2),
        lambda: T.make_replicas(np.ones(2), np.ones(3)),
        lambda: T.make_transfers(3, 10),
    ]
    for build in builders:
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    jobs = T.synthetic_panda_jobs(10, seed=0, n_datasets=2, device="cpu")
    sites = T.atlas_like_platform(3, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        T.simulate(jobs, sites, T.get_policy("panda_dispatch"), PRNGKey(0),
                   data_policy=T.get_data_policy("cache_on_read"),
                   network=T.uniform_network(3, device="cpu"),
                   replicas=T.make_replicas(np.ones(2), np.ones(3), device="cpu"),
                   transfers=T.make_transfers(3, 10, device="cpu"))


def test_validate_workflow_data():
    jobs = T.synthetic_panda_jobs(4, seed=0, device="cpu")
    jobs = jobs._replace(dataset=torch.tensor([0, 1, -1, 1], dtype=torch.int32),
                         out_dataset=torch.tensor([-1, -1, 1, -1], dtype=torch.int32))
    rep = T.make_replicas(np.full(2, 1e9), np.full(3, 1e12), origin=np.array([0, -1]),
                          materialized=np.array([True, False]), device="cpu")
    _, wf = T.make_workflow(jobs, [(2, 3)])
    with pytest.raises(ValueError, match="no DAG ancestor"):
        T.validate_workflow_data(jobs, wf, rep)        # row 1 reads dataset 1 ungated
    jobs_ok = jobs._replace(dataset=torch.tensor([0, -1, -1, 1], dtype=torch.int32))
    T.validate_workflow_data(jobs_ok, wf, rep)
    with pytest.raises(ValueError, match="no job produces"):
        T.validate_workflow_data(jobs_ok._replace(out_dataset=torch.full((4,), -1,
                                                                         dtype=torch.int32)),
                                 wf, rep)
    with pytest.raises(ValueError, match="outside the 2-row catalog"):
        T.validate_workflow_data(jobs._replace(dataset=torch.tensor([5, -1, -1, -1],
                                                                    dtype=torch.int32)), wf, rep)
