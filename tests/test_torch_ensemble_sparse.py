"""Sparse top-k lanes in the port (``simulate_many(..., topk=)``) against the
JAX package's, on the CPU.

The lane form of the fused plain version equals ``jax.vmap`` of the
interpret-mode Pallas kernel bit for bit, and each of its lanes equals an
unbatched call.  Whole ensembles at ``topk=`` equal the JAX package's lane
for lane, exactly on every array.  A refresh round rebuilds every lane's
candidate index when *any* lane's own round is a multiple of
``topk_refresh`` (the JAX package's rule under ``vmap``), so a lane equals
its own solo run only where a rebuild changes nothing: at ``topk >= S`` or
without refresh.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.kernels.assign.fused import fused_assign_pallas  # noqa: E402
from repro.kernels.assign.ops import make_fused_capacity_assign as jax_make_fused  # noqa: E402
from repro_torch.core.rng import PRNGKey, split  # noqa: E402
from repro_torch.kernels.assign import (  # noqa: E402
    fused_assign_ref,
    make_capacity_assign,
    make_fused_capacity_assign,
)
from test_torch_ensemble import _assert_same, _flat, _lane, ragged  # noqa: E402
from test_torch_fused_assign import _random_case  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

SIZES = [30, 41, 36]


@pytest.mark.parametrize("K,N,E,Kc,bn", [(1, 97, 7, 4, 64), (3, 300, 7, 4, 256),
                                         (3, 97, 7, 4, 32), (3, 33, 5, 1, 16)])
def test_lane_fused_ref_against_vmapped_pallas(K, N, E, Kc, bn):
    cases = [_random_case(100 * K + i, N=N, E=E, K=Kc) for i in range(K)]
    stacked = [np.stack(col) for col in zip(*cases)]
    want = jax.vmap(lambda s, c, z, e: fused_assign_pallas(s, c, z, e, block_n=bn,
                                                           interpret=True))(
        *(jnp.asarray(x) for x in stacked))
    got = fused_assign_ref(*(torch.from_numpy(x) for x in stacked), block_n=bn)
    for w, g, name in zip(want, got, ("site", "admit")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert bool(got[1].any()) and bool((~got[1]).any())
    for i, case in enumerate(cases):   # each lane is its own unbatched call
        solo = fused_assign_ref(*(torch.from_numpy(x) for x in case), block_n=bn)
        for s, g in zip(solo, got):
            assert torch.equal(s, g[i])


def _solo_runs(tscens, policy, seed, res, **kw):
    keys = split(PRNGKey(seed), len(tscens))
    for i, s in enumerate(tscens):
        solo = T.simulate(T.pad_jobs_capacity(s.jobs, max(SIZES)), s.sites, policy, keys[i],
                          device="cpu", **kw)
        _assert_same(_flat(solo), _lane(res, i))


@pytest.mark.parametrize("topk,refresh", [(2, 3), (2, 0), (4, 3), (4, 0)])
def test_topk_lanes_match_jax(topk, refresh):
    """The lanes freeze at different rounds, and a frozen lane keeps its last
    round in the refresh rule.  ``topk = 4`` is every site."""
    scens, tscens = ragged(SIZES)
    kw = dict(topk=topk, topk_refresh=refresh)
    rj = R.simulate_many(scens, R.get_policy("least_loaded"), jax.random.PRNGKey(3), **kw)
    rt = T.simulate_many(tscens, T.get_policy("least_loaded"), PRNGKey(3), device="cpu", **kw)
    _assert_same(_flat(rj), _flat(rt))
    assert len(set(rt.rounds.tolist())) == len(SIZES)
    if topk >= tscens[0].sites.capacity or refresh == 0:
        _solo_runs(tscens, T.get_policy("least_loaded"), 3, rt, **kw)


@pytest.mark.parametrize("topk", [2, 4])
def test_fused_capacity_lanes(topk):
    """The fused capacity assigner makes one call a round for all lanes and
    equals the JAX package's oracle path lane for lane; at ``topk = S`` it
    equals the dense capacity dispatch."""
    scens, tscens = ragged(SIZES)
    cap = max(SIZES)
    cores_j = R.pad_jobs_capacity(scens[1].jobs, cap).cores     # one [J] for every lane
    cores_t = torch.from_numpy(np.array(cores_j))
    pj = R.with_fused_assign(R.get_policy("panda_dispatch"),
                             jax_make_fused(cores_j, use_kernel=False))
    calls = []
    fused = make_fused_capacity_assign(cores_t)

    def counted(scores_k, *args):
        calls.append(tuple(scores_k.shape))
        return fused(scores_k, *args)

    pt = T.with_fused_assign(T.get_policy("panda_dispatch"), counted)
    rj = R.simulate_many(scens, pj, jax.random.PRNGKey(5), topk=topk)
    rt = T.simulate_many(tscens, pt, PRNGKey(5), device="cpu", topk=topk)
    _assert_same(_flat(rj), _flat(rt))
    assert calls and all(c[0] == len(SIZES) for c in calls)   # one call for all lanes
    _solo_runs(tscens, T.with_fused_assign(T.get_policy("panda_dispatch"), fused), 5, rt,
               topk=topk)
    if topk == tscens[0].sites.capacity:
        dense = T.simulate_many(tscens, T.with_capacity_assign(
            T.get_policy("panda_dispatch"), make_capacity_assign(cores_t)), PRNGKey(5),
            device="cpu")
        _assert_same(_flat(dense), _flat(rt))


def test_lane_candidates_equal_solo_builds():
    """``build_candidates`` over ``[K, J, S]`` with per-lane keys: each lane's
    index is its own solo build, for a keyed policy too."""
    _, tscens = ragged(SIZES)
    st = T.stack_scenarios(tscens)
    keys = split(PRNGKey(9), len(SIZES))
    for name in ("random", "shortest_wait"):
        pol = T.get_policy(name)
        clock = torch.full((len(SIZES),), 30.0)
        got = T.build_candidates(st.jobs, st.sites, pol, (), clock, keys, {}, 2)
        assert got.shape == (len(SIZES), max(SIZES), 2)
        for i in range(len(SIZES)):
            jobs_i = T.pad_jobs_capacity(tscens[i].jobs, max(SIZES))
            want = T.build_candidates(jobs_i, tscens[i].sites, pol, (), torch.tensor(30.0),
                                      keys[i], {}, 2)
            assert torch.equal(want, got[i]), (name, i)
