"""Workflow DAG subsystem: dependency-gated jobs and workflow-aware
scheduling.

Multi-stage chains (evgen -> simul -> recon -> deriv) are the dominant ATLAS
production shape.  Job dependencies stay in the fixed-shape regime:

- ``WorkflowState`` carries a padded parent matrix ``i32[J, P]`` (-1 in
  unused slots).  Dependency logic is one ``[J, P]`` gather a round
  (``parent_status``): a job stays PENDING until all its parents are DONE
  (the dispatcher gate), and a terminally FAILED or CANCELLED parent
  cascade-cancels every descendant (one DAG level per round), counted in
  ``n_cancelled`` separately from machine failures.
- Per-job DAG metadata (``wf_id`` / ``n_parents`` / ``dag_depth`` /
  ``wf_crit``) lives in ``JobsState`` columns, so scheduling policies can be
  workflow-aware without new plumbing: ``critical_path_first`` ranks site
  queues by critical-path weight, ``workflow_locality`` steers children to
  the sites where their parents ran.
- Scenario builders (``chain_workflows``, ``map_reduce_workflows``,
  ``atlas_mc_workflows``) generate chains, fan-out/fan-in map-reduce, and
  the ATLAS-like 4-stage MC production, with the same numpy draws as the
  JAX package's builders.

With the data subsystem attached, a completing parent materializes its
output dataset into the replica catalog at the site it ran on, so its
children stage in from there (``scenario_replicas`` builds the catalog of a
scenario, ``validate_workflow_data`` checks a hand-built one).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import policies as _policies
from .replicas import ReplicaState, make_replicas, materialize_outputs
from .types import CANCELLED, DONE, FAILED, PENDING, JobsState, make_jobs, take


class WorkflowState(NamedTuple):
    """DAG state carried through the engine round loop.

    ``parents[j]`` holds the job-row indices job ``j`` depends on, padded
    with -1; static per-job metadata (depth, critical-path weight, workflow
    id, output dataset) lives in ``JobsState`` columns so policies see it.
    """

    parents: torch.Tensor      # i32[J, P] parent job rows, -1 = unused slot
    n_cancelled: torch.Tensor  # i32[] jobs cascade-cancelled so far
    n_produced: torch.Tensor   # i32[] output datasets materialized so far

    @property
    def capacity(self) -> int:
        return self.parents.shape[-2]

    @property
    def max_parents(self) -> int:
        return self.parents.shape[-1]


def parent_status(parents: torch.Tensor, job_state: torch.Tensor):
    """The per-round dependency gate: ``(ready, dead)`` bool[J] masks.

    ``ready[j]``: every parent of ``j`` is DONE (vacuously true for roots).
    ``dead[j]``: some parent is terminally FAILED or already CANCELLED, so
    the job must be cascade-cancelled.  A parent that merely failed an
    attempt and was resubmitted is neither, so the child stays gated.  With
    lanes (``parents [K, J, P]``, ``job_state [K, J]``) each lane reads its
    own jobs.
    """
    J = job_state.shape[-1]
    ps = take(job_state, parents.clamp(0, J - 1).long())  # [J, P]
    has = parents >= 0
    ready = (~has | (ps == DONE)).all(-1)
    dead = (has & ((ps == FAILED) | (ps == CANCELLED))).any(-1)
    return ready, dead


# --------------------------------------------------------------------------
# the workflow Subsystem: dependency gate and cascade-cancel as hooks
# --------------------------------------------------------------------------


def _wf_validate(sub, wf: WorkflowState, jobs, sites) -> None:
    J = jobs.capacity
    if wf.parents.shape[-2] != J:
        raise ValueError(
            f"workflow has {wf.parents.shape[-2]} job rows, workload has {J}"
        )


def _wf_arrival_gate(sub, ctx):
    # gated jobs wait for their last parent's completion; called once for the
    # clock min-reduction (pre-completion states) and once for arrivals
    # (post-completion states, so a child un-gated this round arrives now)
    ready, _ = parent_status(ctx.ext["workflow"].parents, ctx.jobs.state)
    return ready


def _wf_on_completions(sub, ctx):
    """Cascade-cancel (engine step 2c): a terminally dead parent cancels its
    PENDING descendants, one DAG level per round."""
    wf = ctx.ext["workflow"]
    jobs = ctx.jobs
    # a dead ancestor can only be seen from PENDING: children never leave
    # PENDING before all parents are DONE, and DONE is terminal
    _, dead = parent_status(wf.parents, jobs.state)
    cancel_now = (jobs.state == PENDING) & jobs.valid & dead
    ctx.jobs = jobs._replace(state=torch.where(cancel_now, CANCELLED, jobs.state))
    ctx.ext["workflow"] = wf._replace(n_cancelled=wf.n_cancelled + cancel_now.sum(-1).int())
    # a cancel round changed state: the cascade needs one round per DAG
    # level even when no timed event remains
    ctx.progressed = ctx.progressed | cancel_now.any(-1)


def _wf_on_start(sub, ctx):
    """Output production: completing parents materialize their output
    dataset at the site they ran on, before the data subsystem's source
    selection (it comes later in the tuple), so a child starting in the same
    round already stages in from the parent's site.  A no-op unless the data
    subsystem is attached: without a catalog there is nowhere to
    materialize into."""
    dext = ctx.ext.get("data")
    if dext is None:
        return
    jobs = ctx.jobs
    produced = ctx.done_now & (jobs.out_dataset >= 0)
    rep = materialize_outputs(dext.replicas, jobs.out_dataset, jobs.site.clamp(0, ctx.S - 1),
                              produced, ctx.clock)
    ctx.ext["data"] = dext._replace(replicas=rep)
    wf = ctx.ext["workflow"]
    ctx.ext["workflow"] = wf._replace(n_produced=wf.n_produced + produced.sum(-1).int())


def _wf_pad_jobs(sub, wf: WorkflowState, old_capacity: int, new_capacity: int):
    """Grow the parent matrix to a padded job capacity (padding rows are
    parentless, so they stay inert like the padded jobs themselves); a
    lane-stacked ``[K, J, P]`` matrix grows in every lane."""
    p = wf.parents
    fill = p.new_full(p.shape[:-2] + (new_capacity - p.shape[-2], p.shape[-1]), -1)
    return wf._replace(parents=torch.cat([p, fill], -2))


def _wf_finalize(sub, wf, jobs, sites, clock):
    return wf, {"wf": wf}


def workflow_subsystem():
    """The workflow DAG as an engine subsystem; its ext slot carries the
    ``WorkflowState`` (parent matrix and counters)."""
    from .subsystems import Subsystem

    return Subsystem(
        name="workflow",
        validate=_wf_validate,
        arrival_gate=_wf_arrival_gate,
        on_completions=_wf_on_completions,
        on_start=_wf_on_start,
        pad_jobs=_wf_pad_jobs,
        finalize=_wf_finalize,
    )


# --------------------------------------------------------------------------
# DAG construction
# --------------------------------------------------------------------------


def make_workflow(
    jobs: JobsState,
    edges,
    *,
    wf_id=None,
    out_dataset=None,
    max_parents: int | None = None,
) -> tuple[JobsState, WorkflowState]:
    """Attach a DAG to a workload: returns ``(jobs', WorkflowState)`` on the
    jobs' device.

    ``edges``: iterable of ``(parent_row, child_row)`` job-row index pairs
    (rows, not external job ids).  Host-side numpy computes the padded parent
    matrix, per-job depth (longest root path, by a Kahn toposort), and the
    critical-path weight ``wf_crit[j] = work[j] + max(wf_crit[child])``.
    ``wf_id`` defaults to weakly-connected-component labels (standalone jobs
    get their own id); ``out_dataset`` marks the dataset each job produces
    (-1 = none).  Raises on cycles, self-edges, and out-of-range rows.
    """
    device = jobs.arrival.device
    J = jobs.capacity
    valid = jobs.valid.cpu().numpy()
    n = int(valid.sum())
    edges = [(int(p), int(c)) for p, c in edges]
    for p, c in edges:
        if not (0 <= p < n and 0 <= c < n):
            raise ValueError(f"edge ({p}, {c}) outside the {n} valid job rows")
        if p == c:
            raise ValueError(f"self-edge on job row {p}")

    par: list[list[int]] = [[] for _ in range(n)]
    chl: list[list[int]] = [[] for _ in range(n)]
    for p, c in edges:
        if p not in par[c]:
            par[c].append(p)
            chl[p].append(c)

    # Kahn toposort: depth + cycle check
    depth = np.zeros(J, np.int32)
    indeg = np.array([len(ps) for ps in par])
    frontier = [j for j in range(n) if indeg[j] == 0]
    topo = []
    while frontier:
        j = frontier.pop()
        topo.append(j)
        for c in chl[j]:
            depth[c] = max(depth[c], depth[j] + 1)
            indeg[c] -= 1
            if indeg[c] == 0:
                frontier.append(c)
    if len(topo) != n:
        raise ValueError("workflow edges contain a cycle")

    # critical-path (upward-rank) weight in work units, reverse-topological
    work = jobs.work.cpu().numpy().astype(np.float64)
    crit = work[:J].copy()
    crit[~valid] = 0.0
    for j in reversed(topo):
        if chl[j]:
            crit[j] = work[j] + max(crit[c] for c in chl[j])

    if wf_id is None:
        # weakly-connected components over the DAG; standalone jobs included
        label = np.arange(n, dtype=np.int32)

        def find(a):
            while label[a] != a:
                label[a] = label[label[a]]
                a = label[a]
            return a

        for p, c in edges:
            ra, rb = find(p), find(c)
            if ra != rb:
                label[max(ra, rb)] = min(ra, rb)
        roots = np.array([find(j) for j in range(n)])
        _, wf_id = np.unique(roots, return_inverse=True)

    P = max_parents or max(1, max((len(ps) for ps in par), default=1))
    if any(len(ps) > P for ps in par):
        raise ValueError(f"a job has more than max_parents={P} parents")
    parents = np.full((J, P), -1, np.int32)
    for j, ps in enumerate(par):
        parents[j, : len(ps)] = sorted(ps)

    def pad_i(x, fill):
        x = np.asarray(x, np.int32)
        return torch.from_numpy(np.pad(x, (0, J - x.shape[0]), constant_values=fill)).to(device)

    jobs = jobs._replace(
        wf_id=pad_i(wf_id, -1),
        n_parents=pad_i([len(ps) for ps in par], 0),
        dag_depth=torch.from_numpy(depth).to(device),
        wf_crit=torch.from_numpy(crit.astype(np.float32)).to(device),
        out_dataset=jobs.out_dataset if out_dataset is None else pad_i(out_dataset, -1),
    )
    wf = WorkflowState(
        parents=torch.from_numpy(parents).to(device),
        n_cancelled=torch.zeros((), dtype=torch.int32, device=device),
        n_produced=torch.zeros((), dtype=torch.int32, device=device),
    )
    return jobs, wf


# --------------------------------------------------------------------------
# scenario builders (chains, map-reduce, ATLAS 4-stage MC production)
# --------------------------------------------------------------------------

# ATLAS-like 4-stage MC production: per-stage (work multiplier, cores,
# memory GB, output bytes as a multiple of the previous stage's output).
# evgen writes small EVNT files, simul inflates them into HITS (~20x), recon
# reduces HITS to AOD (~1/8), deriv skims AOD to DAOD (~1/10).
ATLAS_STAGES = ("evgen", "simul", "recon", "deriv")
ATLAS_WORK = (1.0, 8.0, 4.0, 1.0)
ATLAS_CORES = (1, 8, 8, 1)
ATLAS_MEMORY = (2.0, 16.0, 16.0, 4.0)
ATLAS_INFLATION = (1.0, 20.0, 0.125, 0.1)


class WorkflowScenario(NamedTuple):
    """A workload + DAG + the dataset universe its jobs will produce.

    ``ds_sizes[d]`` is the byte size of dataset ``d``; ``ds_origin``/
    ``ds_materialized`` describe the initial catalog (-1/False = the dataset
    does not exist yet; some job materializes it mid-run).  Feed them to
    ``scenario_replicas`` to build the matching ``ReplicaState``.
    """

    jobs: JobsState
    workflow: WorkflowState
    ds_sizes: np.ndarray        # f32[D]
    ds_origin: np.ndarray       # i32[D]
    ds_materialized: np.ndarray  # bool[D]


def scenario_replicas(scn: WorkflowScenario, disk_capacity, *, seed: int = 0) -> ReplicaState:
    """Replica catalog for a workflow scenario, on the scenario's device:
    intermediate datasets start absent and appear at their producer's site
    mid-run."""
    rep = make_replicas(
        scn.ds_sizes,
        disk_capacity,
        origin=scn.ds_origin,
        materialized=scn.ds_materialized,
        seed=seed,
        device=scn.jobs.arrival.device,
    )
    validate_workflow_data(scn.jobs, scn.workflow, rep)
    return rep


def validate_workflow_data(jobs: JobsState, workflow, replicas: ReplicaState) -> None:
    """Host-side check of a hand-built configuration: every catalogued input
    that starts *unmaterialized* (no replica anywhere, ``origin = -1``) must
    be produced by a DAG ancestor of the job that reads it; otherwise the
    dependency gate cannot guarantee the data exists when the job starts,
    and ``nearest_source``'s origin fallback would price the read from a
    clipped bogus site.  Raises ``ValueError`` on violations; the built-in
    scenario builders are safe by construction."""
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    present = host(replicas.present)
    origin = host(replicas.origin)
    unmat = ~present.any(axis=1) & (origin < 0)       # not readable at t=0
    dataset = host(jobs.dataset)
    out_ds = host(jobs.out_dataset)
    valid = host(jobs.valid)
    parents = None if workflow is None else host(workflow.parents)
    D = present.shape[0]
    for j in np.flatnonzero(valid & (dataset >= 0)):
        d = dataset[j]
        if d >= D:
            raise ValueError(f"job row {j} reads dataset {d} outside the {D}-row catalog")
        if not unmat[d]:
            continue
        producers = set(np.flatnonzero((out_ds == d) & valid))
        if parents is None or not producers:
            raise ValueError(
                f"job row {j} reads unmaterialized dataset {d} that no job produces"
            )
        ancestors, stack = set(), [int(j)]
        while stack:
            for p in parents[stack.pop()]:
                if p >= 0 and p not in ancestors:
                    ancestors.add(int(p))
                    stack.append(int(p))
        if not (producers & ancestors):
            raise ValueError(
                f"job row {j} reads unmaterialized dataset {d}, but no DAG ancestor "
                f"produces it (producers: {sorted(producers)}); the dependency gate "
                "cannot guarantee the data exists before the job starts"
            )


def _stage_tuple(x, n_stages, default):
    if x is None:
        x = default
    x = list(x)
    if len(x) < n_stages:  # cycle the trailing value
        x = x + [x[-1]] * (n_stages - len(x))
    return x[:n_stages]


def chain_workflows(
    n_chains: int,
    n_stages: int = 4,
    *,
    seed: int = 0,
    arrival_span: float = 0.0,
    base_work: float = 3600.0,
    stage_work=None,
    stage_cores=None,
    stage_memory=None,
    stage_out_bytes=None,
    input_bytes: float = 2e9,
    work_sigma: float = 0.3,
    priority=None,
    capacity: int | None = None,
    device="cuda",
) -> WorkflowScenario:
    """Linear production chains: ``n_chains`` independent chains of
    ``n_stages`` dependent jobs each.

    Stage 0 stages its external input over the flat site link (``bytes_in``,
    no catalogued dataset); every stage materializes an output dataset
    (dataset id == producing job row) that the next stage declares as its
    ``jobs.dataset``.  ``stage_*`` are per-stage lists (work multiplier on
    ``base_work``, cores, memory GB, output bytes).
    """
    rng = np.random.default_rng(seed)
    w_mult = _stage_tuple(stage_work, n_stages, (1.0,))
    cores = _stage_tuple(stage_cores, n_stages, (1,))
    mem = _stage_tuple(stage_memory, n_stages, (2.0,))
    out_b = _stage_tuple(stage_out_bytes, n_stages, (1e9,))

    n = n_chains * n_stages
    stage = np.tile(np.arange(n_stages), n_chains)
    chain = np.repeat(np.arange(n_chains), n_stages)
    submit = (np.sort(rng.uniform(0.0, max(arrival_span, 0.0), n_chains)) if arrival_span
              else np.zeros(n_chains))
    work = base_work * np.asarray(w_mult)[stage] * rng.lognormal(0.0, work_sigma, n)
    rows = np.arange(n)
    parent = rows - 1  # previous stage in the same chain (stage 0 has none)
    edges = [(int(parent[j]), int(j)) for j in rows if stage[j] > 0]

    jobs = make_jobs(
        job_id=rows,
        arrival=submit[chain],
        work=work,
        cores=np.asarray(cores)[stage],
        memory=np.asarray(mem)[stage],
        bytes_in=np.where(stage == 0, input_bytes, 1e6),
        bytes_out=np.asarray(out_b)[stage],
        priority=priority,
        dataset=np.where(stage > 0, parent, -1),
        capacity=capacity,
        device=device,
    )
    jobs, wf = make_workflow(jobs, edges, wf_id=chain, out_dataset=rows)
    return WorkflowScenario(
        jobs=jobs,
        workflow=wf,
        ds_sizes=np.asarray(out_b, np.float32)[stage],
        ds_origin=np.full(n, -1, np.int32),
        ds_materialized=np.zeros(n, bool),
    )


def atlas_mc_workflows(
    n_tasks: int,
    *,
    seed: int = 0,
    arrival_span: float = 0.0,
    base_work: float = 3600.0,
    evnt_bytes: float = 2e8,
    inflation=ATLAS_INFLATION,
    capacity: int | None = None,
    device="cuda",
) -> WorkflowScenario:
    """ATLAS-like 4-stage MC production (evgen -> simul -> recon -> deriv).

    Per-stage output sizes follow ``inflation`` multiplicatively from the
    evgen EVNT size: simul inflates ~20x into HITS, recon cuts to AOD,
    deriv skims to DAOD.
    """
    out_bytes, b = [], evnt_bytes
    for f in _stage_tuple(list(inflation), 4, (1.0,)):
        b = b * f
        out_bytes.append(b)
    return chain_workflows(
        n_tasks,
        4,
        seed=seed,
        arrival_span=arrival_span,
        base_work=base_work,
        stage_work=ATLAS_WORK,
        stage_cores=ATLAS_CORES,
        stage_memory=ATLAS_MEMORY,
        stage_out_bytes=out_bytes,
        capacity=capacity,
        device=device,
    )


def map_reduce_workflows(
    n_workflows: int,
    n_maps: int,
    *,
    seed: int = 0,
    arrival_span: float = 0.0,
    root_work: float = 1800.0,
    map_work: float = 3600.0,
    reduce_work: float = 900.0,
    root_out_bytes: float = 5e9,
    map_out_bytes: float = 5e8,
    work_sigma: float = 0.3,
    capacity: int | None = None,
    device="cuda",
) -> WorkflowScenario:
    """Fan-out/fan-in map-reduce: root -> ``n_maps`` mappers -> reducer.

    Every mapper declares the root's output as its input dataset (fan-out
    reads of one produced dataset); the reducer is gated on all mappers
    (fan-in) and stages the first mapper's partial as its catalogued input;
    the remaining partials ride in the reducer's flat ``bytes_in``.
    """
    rng = np.random.default_rng(seed)
    per = n_maps + 2
    n = n_workflows * per
    rows = np.arange(n)
    local = rows % per              # 0 = root, 1..n_maps = maps, n_maps+1 = reduce
    wf = rows // per
    is_root = local == 0
    is_red = local == per - 1
    root_row = wf * per
    submit = (np.sort(rng.uniform(0.0, max(arrival_span, 0.0), n_workflows)) if arrival_span
              else np.zeros(n_workflows))

    edges = []
    for w in range(n_workflows):
        r0 = w * per
        for m in range(1, n_maps + 1):
            edges.append((r0, r0 + m))
            edges.append((r0 + m, r0 + per - 1))

    work = np.where(is_root, root_work, np.where(is_red, reduce_work, map_work))
    work = work * rng.lognormal(0.0, work_sigma, n)
    jobs = make_jobs(
        job_id=rows,
        arrival=submit[wf],
        work=work,
        cores=np.ones(n, np.int32),
        memory=np.full(n, 2.0),
        bytes_in=np.where(is_root, root_out_bytes / 4,
                          np.where(is_red, (n_maps - 1) * map_out_bytes, 1e6)),
        bytes_out=np.where(is_root, root_out_bytes, map_out_bytes),
        dataset=np.where(is_root, -1, np.where(is_red, root_row + 1, root_row)).astype(np.int32),
        capacity=capacity,
        device=device,
    )
    jobs, wfs = make_workflow(jobs, edges, wf_id=wf, out_dataset=np.where(is_red, -1, rows))
    return WorkflowScenario(
        jobs=jobs,
        workflow=wfs,
        ds_sizes=np.where(is_root, root_out_bytes, map_out_bytes).astype(np.float32),
        ds_origin=np.full(n, -1, np.int32),
        ds_materialized=np.zeros(n, bool),
    )


# --------------------------------------------------------------------------
# workflow-aware scheduling policies (registered beside the built-in family)
# --------------------------------------------------------------------------


@_policies.register("workflow_locality")
def workflow_locality(
    workflow: WorkflowState | None = None,
    *,
    base: str = "panda_dispatch",
    w_local: float = 1e6,
    crit_rank: bool = True,
    **params,
) -> _policies.Policy:
    """Locality for DAG children: strongly prefer the sites where a job's
    parents ran, which is where their output datasets were materialized.

    Wraps ``base``'s site scores with a ``w_local`` bonus per resident
    parent; with ``crit_rank`` the site-queue start order follows
    critical-path weight too.  Pass the run's ``WorkflowState``; without one
    there is nothing to be local to, so the policy degrades to the base
    policy.  Like the JAX package's, it keeps the base policy's candidate
    score (``score_cand``), so the sparse path scores without the bonus.
    """
    pol = _policies.get_policy(base, **params)
    rank = _policies.crit_rank_fn if crit_rank else pol.rank
    if workflow is None:
        return pol._replace(name=f"workflow_locality[{pol.name}]", rank=rank)
    parents = workflow.parents
    base_score = pol.score

    def score(jobs, sites, state, clock, key):
        s = base_score(jobs, sites, state, clock, key)
        J, S = jobs.capacity, sites.capacity
        p = parents
        if p.shape[0] < J:  # padding grew the job capacity
            fill = torch.full((J - p.shape[0], p.shape[1]), -1, dtype=p.dtype, device=p.device)
            p = torch.cat([p, fill])
        psite = torch.where(p >= 0, jobs.site[p.clamp(0, J - 1).long()], -1)   # [J, P]
        iota = torch.arange(S, dtype=psite.dtype, device=psite.device)
        n_here = (psite[:, :, None] == iota[None, None, :]).sum(1, dtype=torch.int32)
        return s + w_local * n_here.float()

    return pol._replace(name=f"workflow_locality[{pol.name}]", score=score, rank=rank)
