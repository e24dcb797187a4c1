"""Job-parallel simulation in the port (``distributed.simulate_distributed``,
``lower_distributed``) against the JAX package, on the CPU.

On a 1-rank gloo mesh the port's ``simulate_distributed`` equals the JAX
package's ``simulate`` on the padded jobs (``repro.core.types.pad_jobs_capacity``;
the JAX package's own ``simulate_distributed`` raises ``ShardingTypeError``
under jax 0.9.0, ROADMAP Queue 3): its reference test's cases (``shortest_wait``
with and without an outage calendar, the 30-row chain DAG with
``cache_on_read`` under ``critical_path_first`` and ``workflow_locality``),
capacity dispatch and the fused assign at ``topk=``.  States, rounds,
per-site counters and timestamps exact; the f32 byte accumulators within
rtol 1e-6.  On spawned 2- and 3-rank gloo meshes every rank returns the
port's one-process ``simulate`` on the padded jobs bit for bit, with
capacity binding across a block boundary and a block of padding rows only.
The plain assignments solved in row blocks with the lower blocks' claims
as base (``block_admit``) equal the whole problem, and ``lower_distributed``
counts a round's two all-gathers on a fake 8-rank mesh.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.policies import with_capacity_assign as jax_with_capacity_assign  # noqa: E402
from repro.core.types import pad_jobs_capacity as jax_pad_jobs  # noqa: E402
from repro.kernels.assign.ops import make_capacity_assign as jax_make_capacity_assign  # noqa: E402
from repro.kernels.assign.ops import (  # noqa: E402
    make_fused_capacity_assign as jax_make_fused_capacity_assign,
)
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core.rng import PRNGKey  # noqa: E402
from repro_torch.kernels.assign import (  # noqa: E402
    assign_ref,
    block_admit,
    block_claims,
    fused_assign_ref,
    make_capacity_assign,
    make_fused_capacity_assign,
)
from test_torch_ensemble import _flat, _np_state  # noqa: E402
from test_torch_ensemble_subsystems import assert_close  # noqa: E402
import torch_mesh_ranks as M  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401


@pytest.fixture
def mesh(tmp_path):
    """A 1-rank gloo mesh on the CPU, destroyed after the test."""
    with M.one_rank_mesh(tmp_path) as m:
        yield m


def _carry(jobs, sites):
    return (T.jobs_from_numpy(_np_state(jobs), device="cpu"),
            T.sites_from_numpy(_np_state(sites), device="cpu"))


def _jax_padded(jobs, n: int = 1):
    """The JAX jobs padded as a job-parallel run over ``n`` ranks pads them."""
    return jax_pad_jobs(jobs, jobs.capacity + (-jobs.capacity) % n)


@pytest.mark.parametrize("outage", [False, True], ids=["plain", "availability"])
def test_shortest_wait_equals_jax(mesh, outage):
    jobs = R.synthetic_panda_jobs(64, seed=0, duration=600.0)
    sites = R.atlas_like_platform(4, seed=1)
    av = R.make_availability(4, [dict(site=0, start=50.0, end=5000.0, preempt=True)])
    kw_j = dict(availability=av) if outage else {}
    kw_t = dict(availability=T.availability_from_numpy(_np_state(av), device="cpu")) if outage \
        else {}
    rj = R.simulate(_jax_padded(jobs), sites, R.get_policy("shortest_wait"),
                    jax.random.PRNGKey(0), max_rounds=20_000, **kw_j)
    tj, ts = _carry(jobs, sites)
    rt = D.simulate_distributed(tj, ts, T.get_policy("shortest_wait"), PRNGKey(0), mesh,
                                max_rounds=20_000, **kw_t)
    assert_close(_flat(rj), _flat(rt))
    if outage:
        assert int(rt.avail.n_preempted.sum()) > 0


@pytest.mark.parametrize("name", ["critical_path_first", "workflow_locality"])
def test_workflow_dag_with_data_equals_jax(mesh, name):
    """The reference test's 30-row chain DAG with ``cache_on_read``, a
    uniform network and the scenario's replicas."""
    scn = R.chain_workflows(10, 3, seed=0, arrival_span=200.0)
    sites = R.make_sites(cores=[16, 8, 8], speed=[10.0, 8.0, 12.0], memory=[256.0] * 3,
                         bw_in=[1e9] * 3, bw_out=[1e9] * 3)
    net = R.uniform_network(3, bw=2e8, latency=0.02)
    rep = R.scenario_replicas(scn, disk_capacity=np.full(3, 1e12))
    pj = (R.get_policy(name, workflow=scn.workflow) if name == "workflow_locality"
          else R.get_policy(name))
    rj = R.simulate(_jax_padded(scn.jobs), sites, pj, jax.random.PRNGKey(0),
                    workflow=scn.workflow, data_policy=R.get_data_policy("cache_on_read"),
                    network=net, replicas=rep, max_rounds=20_000)
    tscn = T.scenario_from_numpy(_np_state(scn.jobs), _np_state(sites),
                                 {"workflow": _np_state(scn.workflow),
                                  "data": (_np_state(net), _np_state(rep))}, device="cpu")
    wf = tscn.ext["workflow"]
    pt = (T.get_policy(name, workflow=wf) if name == "workflow_locality" else T.get_policy(name))
    rt = D.simulate_distributed(tscn.jobs, tscn.sites, pt, PRNGKey(0), mesh, workflow=wf,
                                data_policy=T.get_data_policy("cache_on_read"),
                                network=tscn.ext["data"][0], replicas=tscn.ext["data"][1],
                                max_rounds=20_000)
    assert_close(_flat(rj), _flat(rt))
    assert (rt.jobs.state == T.DONE).all() and int(rt.wf.n_produced) == 30


def test_capacity_dispatch_equals_jax(mesh):
    jobs = R.synthetic_panda_jobs(80, seed=3, duration=2000.0)
    sites = R.atlas_like_platform(6, seed=4, fail_rate=0.1)
    pj = jax_with_capacity_assign(R.get_policy("panda_dispatch"),
                                  jax_make_capacity_assign(jobs.cores))
    rj = R.simulate(_jax_padded(jobs), sites, pj, jax.random.PRNGKey(5), log_rows=16)
    tj, ts = _carry(jobs, sites)
    pt = T.with_capacity_assign(T.get_policy("panda_dispatch"), make_capacity_assign(tj.cores))
    rt = D.simulate_distributed(tj, ts, pt, PRNGKey(5), mesh, log_rows=16)
    assert_close(_flat(rj), _flat(rt))


def test_fused_topk_equals_jax(mesh):
    jobs = R.synthetic_panda_jobs(80, seed=3, duration=2000.0)
    sites = R.atlas_like_platform(6, seed=4, fail_rate=0.1)
    pj = R.with_fused_assign(R.get_policy("data_locality"),
                             jax_make_fused_capacity_assign(jobs.cores))
    rj = R.simulate(_jax_padded(jobs), sites, pj, jax.random.PRNGKey(5), topk=2)
    tj, ts = _carry(jobs, sites)
    pt = T.with_fused_assign(T.get_policy("data_locality"), make_fused_capacity_assign(tj.cores))
    rt = D.simulate_distributed(tj, ts, pt, PRNGKey(5), mesh, topk=2)
    assert_close(_flat(rj), _flat(rt))


# --------------------------------------------------------------------------
# row blocks of the plain assignments, with the lower blocks' claims as base
# --------------------------------------------------------------------------


def _problem(N, E, seed):
    """Integral sizes (cores) and capacities that bind; a quarter of the rows
    has no feasible site."""
    rng = np.random.default_rng(seed)
    scores = torch.from_numpy(rng.standard_normal((N, E)).astype(np.float32))
    scores[torch.from_numpy(rng.random((N, E)) < 0.3)] = -1e30
    scores[torch.from_numpy(rng.random(N) < 0.25)] = -1e30
    sizes = torch.from_numpy(rng.choice([1.0, 2.0, 8.0], N).astype(np.float32))
    caps = torch.from_numpy(rng.integers(0, 3 * N // E, E).astype(np.float32))
    return scores, sizes, caps


def _blocks(N, n):
    b = -(-N // n)
    return [slice(r * b, min((r + 1) * b, N)) for r in range(n)]


def _by_blocks(n, N, solve, sizes, caps):
    """``(site, admit)`` of every row, each block solved alone and admitted
    behind the claims of the blocks before it."""
    E = caps.shape[0]
    base = torch.zeros(E, dtype=torch.int32)
    sites, admits = [], []
    for rows in _blocks(N, n):
        site, pos = solve(rows)
        sites.append(site)
        admits.append(block_admit(site, pos, sizes[rows], caps, base))
        base = base + block_claims(site, sizes[rows], E)
    return torch.cat(sites), torch.cat(admits)


@pytest.mark.parametrize("n", [2, 3, 7])
def test_assign_ref_row_blocks_equal_the_whole(n):
    scores, sizes, caps = _problem(500, 9, n)
    idx, _, admit, _ = assign_ref(scores, sizes, caps, k=1)

    def solve(rows):
        i, _, _, pos = assign_ref(scores[rows], sizes[rows], caps, k=1)
        return i[:, 0], pos[:, 0]

    site, adm = _by_blocks(n, 500, solve, sizes, caps)
    assert torch.equal(site, idx[:, 0]) and torch.equal(adm, admit[:, 0])
    assert 0 < int(adm.sum()) < int((site >= 0).sum())   # capacity binds


@pytest.mark.parametrize("n", [2, 3, 7])
def test_fused_ref_row_blocks_equal_the_whole(n):
    N, E, K = 500, 9, 3
    scores, sizes, caps = _problem(N, E, 10 + n)
    rng = np.random.default_rng(n)
    cand = torch.from_numpy(np.sort(rng.integers(0, E + 1, (N, K)), 1).astype(np.int32))
    scores_k = scores[:, :K].contiguous()
    site_w, admit_w = fused_assign_ref(scores_k, cand, sizes, caps)

    def solve(rows):
        s, _, pos = fused_assign_ref(scores_k[rows], cand[rows], sizes[rows], caps, with_pos=True)
        return s, pos

    site, adm = _by_blocks(n, N, solve, sizes, caps)
    assert torch.equal(site, site_w) and torch.equal(adm, admit_w)
    assert 0 < int(adm.sum()) < int((site >= 0).sum())


def test_fused_ref_pos_is_the_exclusive_per_site_prefix():
    N, E, K = 700, 11, 4
    scores, sizes, caps = _problem(N, E, 21)
    cand = torch.from_numpy(np.sort(np.random.default_rng(3).integers(0, E + 1, (N, K)),
                                    1).astype(np.int32))
    site, admit, pos = fused_assign_ref(scores[:, :K].contiguous(), cand, sizes, caps,
                                        block_n=64, with_pos=True)
    s2, a2 = fused_assign_ref(scores[:, :K].contiguous(), cand, sizes, caps, block_n=64)
    assert torch.equal(site, s2) and torch.equal(admit, a2)
    want = torch.zeros(N)
    used = torch.zeros(E)
    for i in range(N):
        s = int(site[i])
        if s >= 0:
            want[i] = used[s]
            used[s] += sizes[i]
    assert torch.equal(pos, want)
    assert torch.equal(admit, (site >= 0) & (pos + sizes <= caps[site.clamp_min(0).long()] + 1e-6))


# --------------------------------------------------------------------------
# spawned ranks, the dry run, bad arguments
# --------------------------------------------------------------------------


SPAWNED = {2: ("dense",), 3: ("fused", "padding")}   # ranks: the cases of one spawn


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The directory of each spawn's results, a spawn (~3 s) a rank count,
    started when a test first asks for it."""
    dirs = {}

    def results(ranks):
        if ranks not in dirs:
            dirs[ranks] = tmp_path_factory.mktemp(f"ranks{ranks}")
            D.run_ranks(M.job_parallel_rank, ranks, (str(dirs[ranks]), SPAWNED[ranks]),
                        device_type="cpu")
        return dirs[ranks]

    return results


@pytest.mark.parametrize("ranks,kind", [(r, k) for r, kinds in SPAWNED.items() for k in kinds])
def test_spawned_ranks_return_the_one_process_run(spawned, ranks, kind):
    """Every rank equals ``simulate`` on the padded jobs in one process.
    In the contended cases the first round admits only the first rows: the
    first row of rank 1's block would fit its site alone, and is refused
    for rank 0's claims.  Over 3 ranks 4 jobs pad to 6, so rank 2's block
    holds only padding rows."""
    out = spawned(ranks) / kind
    jobs, sites, policy, kw = M.job_parallel_case(kind)
    J_pad = jobs.capacity + (-jobs.capacity) % ranks
    padded = T.pad_jobs_capacity(jobs, J_pad)
    want = M.flat(T.simulate(padded, sites, policy, PRNGKey(3), device="cpu", **kw))
    for r in range(ranks):
        got = torch.load(out / f"rank{r}.pt")
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]) or bool(
                ((got[k] == want[k]) | (got[k].isnan() & want[k].isnan())).all()), k
    B = J_pad // ranks
    if kind == "padding":
        assert not bool(padded.valid[2 * B:].any())
    else:
        first = T.simulate(padded, sites, policy, PRNGKey(3), device="cpu",
                           **dict(kw, max_rounds=1))
        assigned = torch.isfinite(first.jobs.t_assign)
        assert bool(assigned[0]) and not bool(assigned[B])
        assert int(jobs.cores[B]) <= int(sites.cores.max())


def test_lower_distributed_counts_two_all_gathers_a_round():
    """The reference's 256 x 6 dry run on a fake 8-rank mesh: one round's
    collectives are the picks (``i32[256]``) and the claims (``i32[8, 6]``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import init_fake_world

    jobs = T.synthetic_panda_jobs(256, seed=0, duration=1800.0, device="cpu")
    sites = T.atlas_like_platform(6, seed=1, device="cpu")
    policy = T.with_capacity_assign(T.get_policy("shortest_wait"),
                                    make_capacity_assign(jobs.cores.to("meta")))
    init_fake_world(8)
    try:
        mesh = DeviceMesh("cpu", torch.arange(8), mesh_dim_names=("data",))
        rec = D.lower_distributed(jobs, sites, policy, mesh, max_rounds=500, log_rows=4)
    finally:
        dist.destroy_process_group()
    assert rec["ranks"] == 8 and rec["capacity"] == 256 and rec["block_rows"] == 32
    assert rec["ops"]["_c10d_functional::all_gather_into_tensor"] == 2
    assert rec["coll_breakdown"]["all-gather"] == 4 * 256 + 4 * 8 * 6
    assert {k for k, v in rec["coll_breakdown"].items() if v} == {"all-gather"}
    assert rec["flops"] > 0 and rec["bytes"] > 0 and math.isfinite(rec["peak_bytes"])


def test_lower_distributed_names_a_hook_that_reads_back(mesh):
    def on_start(sub, ctx):
        if int(ctx.started.sum()) > 0:   # a value deciding a host branch
            pass

    jobs = T.synthetic_panda_jobs(20, seed=0, device="cpu")
    sites = T.atlas_like_platform(3, seed=1, device="cpu")
    sub = T.make_subsystem("probe", on_start=on_start)
    with pytest.raises(RuntimeError, match="'probe' subsystem's on_start hook reads the device"):
        D.lower_distributed(jobs, sites, T.get_policy("panda_dispatch"), mesh,
                            subsystems=((sub, torch.zeros(1)),))


def test_bad_arguments_raise(mesh):
    jobs = T.synthetic_panda_jobs(20, seed=0, device="cpu")
    sites = T.atlas_like_platform(3, seed=1, device="cpu")
    policy = T.get_policy("panda_dispatch")
    with pytest.raises(ValueError, match="no axis"):
        D.simulate_distributed(jobs, sites, policy, PRNGKey(0), mesh, axis="model")
    with pytest.raises(ValueError, match="does not match the mesh"):
        D.simulate_distributed(jobs, sites, policy, PRNGKey(0), mesh, device="cuda")
    with pytest.raises(ValueError, match="jobs.* lies on meta, the run on cpu"):
        D.simulate_distributed(T.pad_jobs_capacity(jobs, 20)._replace(
            arrival=jobs.arrival.to("meta")), sites, policy, PRNGKey(0), mesh)
    assert list(D.job_block(10, mesh)) == list(range(10))
    from torch.distributed.tensor import Replicate

    jp, sp, kp = D.job_shardings(mesh, "data", jobs, sites)
    assert kp == (Replicate(),) and jp.cores == kp and sp.free_cores == kp
