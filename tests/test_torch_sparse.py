"""The port's sparse top-k path against the JAX package's, on the CPU: the
candidate index (``core/sparse.py``) and whole ``simulate(..., topk=)`` runs.

Exact on the candidate index, and on rounds, makespan, every job's outcome
and timestamps and the per-site counters of whole runs, at ``topk=S`` (which
also equals the dense run) and at ``topk < S`` (an approximation, but the
same one in both packages).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.kernels.assign.ops import (  # noqa: E402
    make_fused_capacity_assign as jax_make_fused_capacity_assign,
)
from repro_torch.core.rng import PRNGKey  # noqa: E402
from repro_torch.kernels.assign import make_capacity_assign, make_fused_capacity_assign  # noqa: E402
from test_torch_engine import _assert_same_run, _np_state, _run_both, _scenario  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401


def _to_torch(jobs, sites):
    return (T.jobs_from_numpy(_np_state(jobs), device="cpu"),
            T.sites_from_numpy(_np_state(sites), device="cpu"))


@pytest.fixture(scope="module")
def mid_run():
    """Jobs and sites 15 rounds into a run, so queue-dependent policies see
    queued and running work."""
    jobs, sites = _scenario(80, 3, 6, 4, 2000.0, 0.1)
    res = R.simulate(jobs, sites, R.get_policy("panda_dispatch"), jax.random.PRNGKey(2),
                     max_rounds=15)
    return res.jobs, res.sites


@pytest.mark.parametrize("name", sorted(T.REGISTRY))
def test_build_candidates_matches_jax(mid_run, name):
    jobs, sites = mid_run
    tj, ts = _to_torch(jobs, sites)
    pj, pt = R.get_policy(name), T.get_policy(name)
    S = sites.capacity
    for k in (1, 2, S):
        want = R.build_candidates(jobs, sites, pj, pj.init(jobs, sites), jnp.float32(30.0),
                                  jax.random.PRNGKey(9), {}, k)
        got = T.build_candidates(tj, ts, pt, pt.init(tj, ts), torch.tensor(30.0),
                                 PRNGKey(9), {}, k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=f"k={k}")


def _fixed_score_policies(table):
    """The same constant pre-rank in both packages."""
    pj = R.make_policy("fixed", lambda jobs, sites, state, clock, key: jnp.asarray(table))
    pt = T.make_policy("fixed", lambda jobs, sites, state, clock, key: torch.from_numpy(table))
    return pj, pt


def test_signed_zeros_ties_and_force_include():
    """``lax.top_k`` orders ``+0.0`` above ``-0.0`` and breaks ties to the
    lower index; the dense argmax ties the zeros.  Row 0 has its tie across
    slot k=2; in row 1 the top-1 slot (+0.0 at site 1) misses the first-max
    argmax (-0.0 at site 0), which is forced into the last slot; in row 2 the
    infeasible site 5 ends as a sentinel."""
    n, z = -0.0, 0.0
    table = np.array([
        [1.0, n, z, z, -1.0, n],
        [n, z, -1.0, -2.0, n, -3.0],
        [2.0, 2.0, n, z, 1.0, 5.0],
        [n, n, n, n, n, n],
    ], np.float32)
    jobs = R.synthetic_panda_jobs(4, seed=0, duration=60.0)
    sites = R.atlas_like_platform(6, seed=1)
    sites = sites._replace(active=sites.active.at[5].set(False))
    tj, ts = _to_torch(jobs, sites)
    pj, pt = _fixed_score_policies(table)
    for k in (1, 2, 3, 6):
        want = np.asarray(R.build_candidates(jobs, sites, pj, (), 0.0, jax.random.PRNGKey(0),
                                             {}, k))
        got = T.build_candidates(tj, ts, pt, (), torch.tensor(0.0), PRNGKey(0), {}, k).numpy()
        np.testing.assert_array_equal(want, got, err_msg=f"k={k}")
    k2 = T.build_candidates(tj, ts, pt, (), torch.tensor(0.0), PRNGKey(0), {}, 2).numpy()
    assert k2[0].tolist() == [0, 2]       # +0.0 at site 2 beats -0.0 at site 1
    k1 = T.build_candidates(tj, ts, pt, (), torch.tensor(0.0), PRNGKey(0), {}, 1).numpy()
    assert k1[1].tolist() == [0]          # the forced-in first-max argmax
    assert k1[2].tolist() == [0]          # site 5 (score 5.0) is inactive


def test_data_locality_candidates_match_jax():
    """The data branch of the candidate index: replica holders of a job's dataset and the
    nearest WAN source toward its pre-rank-best site rank first, equal to
    the JAX package's at every ``k``."""
    jobs = R.synthetic_panda_jobs(60, seed=0, duration=600.0, n_datasets=9)
    sites = R.atlas_like_platform(6, seed=1)
    rng = np.random.default_rng(4)
    rep = R.make_replicas(R.zipf_dataset_sizes(9, seed=1), np.full(6, 1e13),
                          placement=rng.random((9, 6)) < 0.3, seed=2)
    net = R.atlas_like_network(6, seed=3)
    ext_j = {"data": R.DataExt(network=net, replicas=rep, state=(),
                               net_acc=jnp.zeros(6, jnp.float32))}
    ext_t = {"data": T.DataExt(network=T.network_from_numpy(_np_state(net), device="cpu"),
                               replicas=T.replicas_from_numpy(_np_state(rep), device="cpu"),
                               state=(), net_acc=torch.zeros(6))}
    tj, ts = _to_torch(jobs, sites)
    pj, pt = R.get_policy("data_locality"), T.get_policy("data_locality")
    for k in (1, 2, 3, 6):
        want = np.asarray(R.build_candidates(jobs, sites, pj, (), 0.0, jax.random.PRNGKey(0),
                                             ext_j, k))
        got = T.build_candidates(tj, ts, pt, (), torch.tensor(0.0), PRNGKey(0), ext_t,
                                 k).numpy()
        np.testing.assert_array_equal(want, got, err_msg=f"k={k}")
    plain = T.build_candidates(tj, ts, pt, (), torch.tensor(0.0), PRNGKey(0), {}, 2).numpy()
    local = T.build_candidates(tj, ts, pt, (), torch.tensor(0.0), PRNGKey(0), ext_t, 2).numpy()
    assert (plain != local).any(), "the locality bonus changed no candidate"


def test_static_feasibility_and_bytes_model():
    jobs, sites = _scenario(50, 2, 7, 3, 600.0, 0.0)
    sites = sites._replace(active=sites.active.at[2].set(False),
                           cores=sites.cores.at[4].set(1))
    tj, ts = _to_torch(jobs, sites)
    want = np.asarray(R.static_feasibility(jobs, sites))
    np.testing.assert_array_equal(want, T.static_feasibility(tj, ts).numpy())
    assert not want.all() and want.any()
    for args in ((100_000, 300, 16), (10, 4, None), (50, 7, 9)):
        assert T.bytes_per_round(*args) == R.bytes_per_round(*args)


def _run_sparse(name, jobs, sites, seed, wrap=None, **kw):
    pj, pt = R.get_policy(name), T.get_policy(name)
    if wrap is not None:
        pj, pt = wrap(pj, pt)
    return _run_both(jobs, sites, pj, pt, seed, **kw)


def test_topk_full_equals_jax_and_dense():
    jobs, sites = _scenario(80, 3, 6, 4, 2000.0, 0.1)
    S = sites.capacity
    rj, rt = _run_sparse("panda_dispatch", jobs, sites, 5, topk=S)
    t = _assert_same_run(rj, rt)
    tj, ts = _to_torch(jobs, sites)
    dense = T.result_to_numpy(T.simulate(tj, ts, T.get_policy("panda_dispatch"), PRNGKey(5),
                                         device="cpu"))
    assert dense["rounds"] == t["rounds"] and dense["makespan"] == t["makespan"]
    for f, a in dense["jobs"].items():
        np.testing.assert_array_equal(a, t["jobs"][f], err_msg=f)


@pytest.mark.parametrize("topk,refresh", [(2, 0), (6, 7), (2, 5)])
def test_topk_and_refresh_match_jax(topk, refresh):
    jobs, sites = _scenario(80, 3, 6, 4, 2000.0, 0.1)
    rj, rt = _run_sparse("least_loaded", jobs, sites, 5, topk=topk, topk_refresh=refresh)
    _assert_same_run(rj, rt)


@pytest.mark.parametrize("topk", [6, 2])
def test_fused_capacity_assign_matches_jax(topk):
    jobs, sites = _scenario(80, 3, 6, 4, 2000.0, 0.1)
    cores = torch.from_numpy(np.array(jobs.cores))

    def wrap(pj, pt):
        return (R.with_fused_assign(pj, jax_make_fused_capacity_assign(jobs.cores)),
                T.with_fused_assign(pt, make_fused_capacity_assign(cores)))

    rj, rt = _run_sparse("panda_dispatch", jobs, sites, 5, wrap=wrap, topk=topk)
    t = _assert_same_run(rj, rt)
    if topk == sites.capacity:
        # the fused sparse path equals the dense capacity dispatch
        tj, ts = _to_torch(jobs, sites)
        dense = T.simulate(tj, ts, T.with_capacity_assign(T.get_policy("panda_dispatch"),
                                                          make_capacity_assign(cores)),
                           PRNGKey(5), device="cpu")
        d = T.result_to_numpy(dense)
        assert d["rounds"] == t["rounds"] and d["makespan"] == t["makespan"]
        for f, a in d["jobs"].items():
            np.testing.assert_array_equal(a, t["jobs"][f], err_msg=f)


@pytest.mark.parametrize("name", sorted(T.REGISTRY))
def test_registry_policy_topk(name):
    """Every policy at topk=3: the candidate score forms, ``random``'s
    dense-gather fallback and ``critical_path_first``'s rank."""
    jobs, sites = _scenario(80, 3, 6, 4, 2000.0, 0.1)
    rj, rt = _run_sparse(name, jobs, sites, 5, topk=3)
    _assert_same_run(rj, rt)
