"""Event-round engine: the dense solo simulator on PyTorch.

The JAX package runs the rounds inside a ``lax.while_loop``; here a Python
loop drives them and reads back two flags a round (whether to go on, and
whether the round has dispatch work; the data subsystem's cache insertion
reads a third, whether some storage element must evict).  Each round
advances the clock to the next event time and applies every transition that
fires at that instant as masked dense updates:

  round(t*):
    1. completions   — running jobs with t_finish <= t*  → DONE/FAILED/resubmit
    2. subsystems    — post-completion transitions (outage preemption,
                       DAG cascade-cancel) via ``on_completions`` hooks
    3. arrivals      — pending jobs with arrival  <= t*  → QUEUED at the server
    4. assignment    — the policy plugin scores QUEUED jobs against sites
                       (all of them, or a candidate index with ``topk``);
                       feasible best-site rows become ASSIGNED (site queue)
    5. starts        — per-site FIFO-with-capacity: sort ASSIGNED rows by
                       (site, -priority, -rank, arrival), start the per-site
                       prefix whose cumulative core/memory demand fits
    6. bookkeeping   — service times, failure sampling, counters, event log

Engine extensions are ``Subsystem`` hook bundles (``subsystems.py``) called at
the JAX engine's points of the round; a run without one runs none of its code.
``init_sim``/``advance_sim``/``finish_sim`` run the same loop in segments
(``simulate`` is one segment with its horizon), so a driver such as
``monitor.watch`` can take frames between them.

A job-parallel run (``distributed.simulate_distributed``) gives the loop a
``JobBlock``: where the policy's assigner splits rows (``splits_rows``), a
rank solves the dispatch problem for its block of rows only and the picks
are all-gathered; every other step runs on the whole replicated state.

The results equal the JAX package's bit for bit: the same key stream
(``rng``), the same float orders (``scan``), and sorts whose keys are a strict
total order, so any correct sort yields the one permutation.

Scenario ensembles (``simulate_many``) run K scenarios through the same round
body on states with a leading lane axis (``[K, J]``, ``[K, S]``, a ``[K]``
clock): reductions run over the last axis, site lookups per lane
(``types.take``), sorts along the last axis, and every per-site sum of all
lanes is one segment sum over ``K * S`` segments.  The loop runs while any
lane goes, as ``vmap`` of the JAX package's ``while_loop`` does: a lane whose
own condition fails keeps its state (every leaf selected back, its log rows
left alone), so each lane equals the solo run of its scenario.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from . import rng as _rng
from ..kernels.segment_sum import segment_sum
from .scan import cumsum_f32, fma_f32
from .sparse import CAND_SALT, build_candidates
from .subsystems import RoundCtx, resolve_subsystems
from .types import (
    ASSIGNED,
    DONE,
    FAILED,
    N_STATES,
    PENDING,
    QUEUED,
    RUNNING,
    EngineState,
    JobsState,
    SimResult,
    SiteState,
    make_log,
    pad_jobs_capacity,
    resolve_device,
    take,
)

INF = float("inf")


def compute_time(jobs: JobsState, sites: SiteState, site: torch.Tensor) -> torch.Tensor:
    """Amdahl-style compute term: ``work / (speed * c / (1 + gamma (c-1)))``.
    The denominator ``1 + gamma (c-1)`` is one fused multiply-add, as XLA
    computes it."""
    site = site.long()
    c = jobs.cores.float()
    speedup = c / fma_f32(take(sites.par_gamma, site), (c - 1.0).clamp_min(0.0), 1.0)
    return jobs.work / (take(sites.speed, site) * speedup.clamp_min(1e-9))


def stage_in_time(
    jobs: JobsState, sites: SiteState, site: torch.Tensor, share_in: torch.Tensor
) -> torch.Tensor:
    """Flat-link stage-in: site latency + ``bytes_in`` over the ingress link
    shared equally among the ``share_in`` jobs staging concurrently.

    ``bytes / (bw / share)`` is evaluated as ``(bytes * share) / bw``: XLA
    rewrites ``A / (B / C)`` to ``(A * C) / B``, and the bits follow it."""
    site = site.long()
    return take(sites.latency, site) + (jobs.bytes_in * share_in.clamp_min(1.0)) / take(
        sites.bw_in, site)


def service_time(
    jobs: JobsState, sites: SiteState, site: torch.Tensor, share_in: torch.Tensor,
    share_out: torch.Tensor,
) -> torch.Tensor:
    """Deterministic-at-start service time: latency + stage_in + compute +
    stage_out, with stage bandwidth shared among the jobs staging at once."""
    stage_out = (jobs.bytes_out * share_out.clamp_min(1.0)) / take(sites.bw_out, site.long())
    return (
        stage_in_time(jobs, sites, site, share_in)
        + compute_time(jobs, sites, site)
        + stage_out
    )


def _site_sum(values: torch.Tensor, site: torch.Tensor, num_sites: int) -> torch.Tensor:
    """Scatter per-job values (``[J]``, or features stacked as ``[J, F]``) onto
    their site; rows with ``site == num_sites`` (the padding segment for
    non-participating rows) are dropped.  Bool values count in int32; float
    sums add in job-index order.  With lanes (``[K, J]``) each lane sums
    onto its own sites, all in one segment sum."""
    if values.dtype == torch.bool:
        values = values.int()
    return segment_sum(values, site, num_sites)


_site_sum_stacked = _site_sum  # the JAX package's name for the [J, F] form


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort(keys)`` (last key most significant, ties by index) as
    chained stable sorts along the last axis; with lanes each lane sorts on
    its own, as if the lane were the most significant key.  Float keys gain
    ``+ 0.0`` so that -0.0 and 0.0 tie, as they do in JAX's comparator; a
    radix sort would order them."""
    perm = None
    for key in keys:
        if key.is_floating_point():
            key = key + 0.0
        k = key if perm is None else take(key, perm)
        step = torch.sort(k, dim=-1, stable=True).indices
        perm = step if perm is None else take(perm, step)
    return perm


def _start_order(sort_site, priority, rank_val, arrival) -> torch.Tensor:
    """Start-order permutation by (site, -priority, -rank, arrival, index).

    The JAX package ranks pairwise below J=512 and lexsorts above; the key is
    a strict total order, so both give this one permutation."""
    return _lexsort((arrival, -rank_val, -priority, sort_site))


def _start_order_packed(packed: torch.Tensor) -> torch.Tensor:
    """Start-order permutation from a single strict-total-order int64 key
    ``sort_site * J + srank`` (all keys distinct within a lane, so any sort
    gives the same permutation as ``_start_order``), lane by lane."""
    return torch.argsort(packed, dim=-1)


def _static_start_rank(jobs: JobsState) -> torch.Tensor:
    """``i64[..., J]``: rank of each job under ``(-priority, arrival,
    index)``, the run-constant suffix of the start-order key."""
    J = jobs.capacity
    perm = _lexsort((jobs.arrival, -jobs.priority))
    iota = torch.arange(J, device=perm.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(-1, perm, iota)


def _packed_order_ok(policy, J: int, S: int) -> bool:
    """Can this run use the packed single-key start order?  Needs a rank-less
    policy; the size limit is the JAX package's (its key is int32), kept so
    both packages take the same path."""
    return getattr(policy, "rank", None) is None and (S + 1) * J <= 2**31 - 1


def _segment_exclusive_base(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int):
    """For values sorted by seg_ids: per-element cumulative sum *within* its segment.

    The last segment's total never enters a base (``seg_base`` drops the last
    prefix sum), so it is not summed: in the engine that segment holds every
    non-candidate row, and a serial row-order sum over it would cost O(J).
    With lanes, every lane scans its own last axis."""
    if values.is_floating_point():
        def cumsum(x):
            return cumsum_f32(x, -1)
    else:
        def cumsum(x):
            return torch.cumsum(x, -1, dtype=x.dtype)
    total_cum = cumsum(values)
    seg_totals = segment_sum(values, seg_ids, num_segments - 1)
    zero = seg_totals.new_zeros(seg_totals.shape[:-1] + (1,))
    seg_cum = cumsum(torch.cat([seg_totals, zero], -1))
    seg_base = torch.cat([zero, seg_cum[..., :-1]], -1)
    return total_cum - take(seg_base, seg_ids.long())


def default_assign(scores, queued, feasible, sites=None, block=None):
    """Reference assignment: best feasible site per queued job (site-queue
    mode), ties to the lowest site.  Returns (site[J] int32 with -1 for
    unassigned, assigned_mask[J]).  Each row's pick is its own, so a
    job-parallel run's block (``block``) needs nothing more."""
    S = scores.shape[-1]
    masked = torch.where(feasible, scores, -INF)
    best_val = masked.amax(-1)
    iota = torch.arange(S, device=scores.device)
    best = torch.where(masked == best_val[..., None], iota, S).amin(-1).int()
    ok = queued & torch.isfinite(best_val)
    return torch.where(ok, best, -1), ok


default_assign.splits_rows = True


def default_assign_cand(scores_k, queued, feas_k, cand, sites=None, block=None):
    """Candidate-set analogue of ``default_assign``.

    ``scores_k``/``feas_k`` are ``[J, K]`` (an ensemble's ``[L, J, K]``) over
    the candidate index ``cand`` (clamped site ids, ascending per row).
    Because candidates are sorted ascending, the first-max slot is the lowest
    site id among score ties, the dense tie-break, so ``topk=S`` matches the
    dense path bit for bit."""
    K = scores_k.shape[-1]
    masked = torch.where(feas_k, scores_k, -INF)
    best_val = masked.amax(-1)
    iota = torch.arange(K, device=scores_k.device)
    best_c = torch.where(masked == best_val[..., None], iota, K).amin(-1)
    site = cand.gather(-1, best_c[..., None])[..., 0].int()
    ok = queued & torch.isfinite(best_val)
    return torch.where(ok, site, -1), ok


default_assign_cand.splits_rows = True


def _init_state(
    jobs0: JobsState, sites0: SiteState, policy, key, ext0: dict, subsystems: tuple,
    log_rows: int, topk: int | None = None,
) -> EngineState:
    """Build the round-loop carry: run the policy's and the subsystems' init
    hooks, build the sparse candidate index (``topk``), precompute the packed
    start-order key when allowed, allocate the frame ring buffer with the
    subsystems' log columns.  A batch of keys ``[K, 2]`` makes an ensemble
    of K lanes, whose states all lead with K."""
    device = jobs0.arrival.device
    lanes = tuple(key.shape[:-1])
    pstate0 = policy.init(jobs0, sites0)
    ext0 = dict(ext0)
    for sub in subsystems:
        if sub.init is not None:
            ext0[sub.name] = sub.init(sub, ext0[sub.name], jobs0, sites0)
    if topk is not None:
        # sparse-mode candidate index: "~" keys are engine-internal carry,
        # dropped from SimResult.ext in _finalize
        ext0["~cand"] = build_candidates(
            jobs0, sites0, policy, pstate0, torch.zeros((), dtype=torch.float32, device=device),
            _rng.fold_in(key, CAND_SALT), ext0, topk,
        )
    # the packed key assumes run-constant arrivals: a subsystem that pushes
    # arrivals back disables it
    mutates_arrival = any(getattr(sub.config, "mutates_arrival", False) for sub in subsystems)
    if not mutates_arrival and _packed_order_ok(policy, jobs0.capacity, sites0.capacity):
        ext0["~srank"] = _static_start_rank(jobs0)
    log_extra0 = {}
    for sub in subsystems:
        if sub.log_spec is not None:
            log_extra0.update(sub.log_spec(sub, ext0[sub.name], jobs0, sites0))
    log = make_log(log_rows, sites0.capacity, extra=log_extra0, device=device, lanes=lanes)
    # an ensemble counts each lane's own rounds and log rows on the device
    round0 = torch.zeros(lanes, dtype=torch.int32, device=device) if lanes else 0
    return EngineState(
        clock=torch.zeros(lanes, dtype=torch.float32, device=device),
        round=round0,
        jobs=jobs0,
        sites=sites0,
        rng=key,
        policy_state=pstate0,
        log=log._replace(cursor=round0.clone()) if lanes else log,
        halted=torch.zeros(lanes, dtype=torch.bool, device=device),
        ext=ext0,
    )


def _static_feasible(jobs: JobsState, sites: SiteState) -> torch.Tensor:
    """``bool[..., J, S]``: the job can ever fit the site."""
    return (
        sites.active[..., None, :]
        & (jobs.cores[..., :, None] <= sites.cores[..., None, :])
        & (jobs.memory[..., :, None] <= sites.memory[..., None, :])
    )


def _tree_map(fn, *trees):
    """``fn`` over the matching tensor leaves of states (NamedTuples, dicts,
    tuples, lists); other leaves (``None``, Python numbers) come from the
    first tree."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_tree_map(fn, *leaves) for leaves in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return first


def _freeze(go: torch.Tensor, new, old):
    """``torch.where(go, new, old)`` leaf by leaf over matching states, ``go
    [K]`` broadcast over each leaf's trailing axes: what ``vmap`` of a
    ``while_loop`` does to a lane whose condition failed.  Leaves the round
    did not replace stay as they are."""
    def pick(n, o):
        return n if n is o else torch.where(go.view(go.shape + (1,) * (n.dim() - 1)), n, o)

    return _tree_map(pick, new, old)


def _round_fns(
    policy,
    subsystems: tuple,
    *,
    max_rounds: int,
    log_rows: int,
    max_retries: int,
    monitor_every: int,
    quantum: float,
    phase_skip: bool,
    topk: int | None = None,
    topk_refresh: int = 0,
    job_block=None,
):
    """The round loop's ``(cond, body)`` pair for one configuration.  ``cond``
    reads one flag back from the device (an ensemble's reads whether any lane
    goes and whether all do, in one read).  ``job_block`` (a solo run's
    ``distributed.JobBlock``) makes the assignment phase solve this rank's
    rows only, when the policy's assigner splits rows."""

    def hooks(name):
        """``(subsystem, hook)`` pairs of one hook point, in tuple order."""
        return [(sub, getattr(sub, name)) for sub in subsystems if getattr(sub, name) is not None]

    gate_hooks, event_hooks = hooks("arrival_gate"), hooks("event_times")
    filter_hooks, completion_hooks = hooks("completion_filter"), hooks("on_completions")
    assign_hooks, start_hooks, log_hooks = hooks("pre_assign"), hooks("on_start"), hooks("log_columns")
    refresh = topk is not None and topk_refresh > 0
    assign_c = getattr(policy, "assign_cand", None) or default_assign_cand
    # the assigner in use solves rows on their own (plus a FIFO carry it
    # takes from the block): a job-parallel run gives it this rank's rows
    split = job_block is not None and getattr(
        policy.assign if topk is None else assign_c, "splits_rows", False)

    def gathered(pick, ok):
        """The block's picks (site, or -1) all-gathered into ``[J]``."""
        site = job_block.gather_picks(torch.where(ok, pick, -1).int())
        return site, site >= 0

    def cond(st: EngineState, horizon: float):
        """``(go, lanes_going, gates)``: would the loop run another round; in
        an ensemble where only some lanes go, the ``bool[K]`` mask of those
        (else None); and the round's two host gates ``(log, refresh)``: does
        some lane write the event log, and is the candidate index rebuilt.
        ``horizon`` is compared in float32 (``_f32``), as the JAX package
        compares it.  An ensemble reads all of it back in one read; each lane
        counts its own rounds, so ``max_rounds`` and ``monitor_every`` hold
        per lane, and a refresh round is one where *any* lane's own round
        (a frozen lane's last one included) is a multiple of
        ``topk_refresh``, the JAX package's rule under ``vmap``."""
        rnd = st.round
        solo = isinstance(rnd, int)
        if solo and rnd >= max_rounds:
            return False, None, None
        state = st.jobs.state
        active = (state == PENDING) | (state == QUEUED) | (state == ASSIGNED) | (state == RUNNING)
        go = ~st.halted & (active & st.jobs.valid).any(-1) & (st.clock <= horizon)
        if solo:
            gates = (log_rows > 0 and rnd % monitor_every == 0,
                     refresh and rnd % topk_refresh == 0)
            return bool(go), None, gates
        go = go & (rnd < max_rounds)
        off = go.new_zeros(())
        any_go, all_go, log_gate, rebuild = torch.stack([
            go.any(), go.all(),
            (go & (rnd % monitor_every == 0)).any() if log_rows > 0 else off,
            (rnd % topk_refresh == 0).any() if refresh else off,
        ]).tolist()
        return any_go, (None if all_go else go), (log_gate, rebuild)

    def body(st: EngineState, going: torch.Tensor | None, gates: tuple) -> EngineState:
        """One round.  ``going`` (an ensemble's ``bool[K]`` from ``cond``, or
        None when every lane goes) freezes the other lanes; ``gates`` are
        ``cond``'s ``(log, refresh)``."""
        log_gate, rebuild = gates
        S = st.sites.capacity
        J = st.jobs.capacity
        lane_dims = st.clock.dim()
        jobs, sites = st.jobs, st.sites
        key, k_fail, k_frac, k_policy = _rng.split(st.rng, 4).unbind(-2)
        # subsystem key streams fold off the round's carry key (RoundCtx.subkey)
        ctx = RoundCtx(jobs=jobs, sites=sites, ext=dict(st.ext), clock_prev=st.clock,
                       max_retries=max_retries, rng=st.rng)

        # ---- 1. advance the clock to the next event ------------------------
        arrivable = (jobs.state == PENDING) & jobs.valid
        for sub, fn in gate_hooks:
            # gated jobs are not an event source: their wake-up event is
            # whatever un-gates them (e.g. a DAG parent's completion)
            arrivable = arrivable & fn(sub, ctx)
        arr_t = torch.where(arrivable, jobs.arrival, INF)
        fin_t = torch.where(jobs.state == RUNNING, jobs.t_finish, INF)
        t_next = torch.minimum(arr_t.amin(-1), fin_t.amin(-1))
        for sub, fn in event_hooks:
            # subsystem event sources (outage window edges) join the
            # min-reduction so rounds land exactly on their boundaries
            t_next = torch.minimum(t_next, fn(sub, ctx))
        if quantum > 0.0:
            t_next = t_next + quantum
        clock = torch.where(torch.isfinite(t_next), torch.maximum(st.clock, t_next), st.clock)
        ctx.clock = clock
        clock_j = clock[..., None]   # broadcasts over the job axis

        # ---- 2. completions -------------------------------------------------
        comp = (jobs.state == RUNNING) & (jobs.t_finish <= clock_j)
        for sub, fn in filter_hooks:
            comp = fn(sub, ctx, comp)
        comp_site = torch.where(comp, jobs.site, S)  # padded segment for non-events
        freed_mem = _site_sum(torch.where(comp, jobs.memory, 0.0), comp_site, S)
        failed_now = comp & jobs.will_fail
        resubmit = failed_now & (jobs.retries < max_retries)
        perm_fail = failed_now & ~resubmit
        done_now = comp & ~jobs.will_fail
        # one stacked scatter for the three int per-site completion reductions
        comp_sums = _site_sum_stacked(
            torch.stack(
                [torch.where(comp, jobs.cores, 0), done_now.int(), failed_now.int()], dim=-1
            ),
            comp_site,
            S,
        )
        new_state = torch.where(done_now, DONE, jobs.state)
        new_state = torch.where(perm_fail, FAILED, new_state)
        new_state = torch.where(resubmit, QUEUED, new_state)  # PanDA-style resubmission
        jobs = jobs._replace(
            state=new_state,
            retries=jobs.retries + resubmit.int(),
            site=torch.where(resubmit, -1, jobs.site),
            t_finish=torch.where(resubmit, INF, jobs.t_finish),
        )
        sites = sites._replace(
            free_cores=sites.free_cores + comp_sums[..., 0],
            free_memory=sites.free_memory + freed_mem,
            n_finished=sites.n_finished + comp_sums[..., 1],
            n_failed=sites.n_failed + comp_sums[..., 2],
        )
        ctx.jobs, ctx.sites = jobs, sites
        ctx.comp, ctx.done_now, ctx.failed_now = comp, done_now, failed_now

        # ---- 2b. subsystem post-completion transitions -----------------------
        # (availability preemption and brown-out, workflow cascade-cancel)
        for sub, fn in completion_hooks:
            fn(sub, ctx)
        jobs, sites = ctx.jobs, ctx.sites

        # ---- 3. arrivals -----------------------------------------------------
        arrived = (jobs.state == PENDING) & (jobs.arrival <= clock_j) & jobs.valid
        for sub, fn in gate_hooks:
            # re-gate against post-completion states so a job un-gated this
            # round arrives (and can start) this round
            arrived = arrived & fn(sub, ctx)
        jobs = jobs._replace(state=torch.where(arrived, QUEUED, jobs.state))
        ctx.jobs, ctx.arrived = jobs, arrived

        # ---- 4+5. assignment & starts ----------------------------------------
        queued = jobs.state == QUEUED
        if rebuild:
            # periodic candidate rebuild: O(J*S), only on refresh rounds
            ctx.ext["~cand"] = build_candidates(
                jobs, sites, policy, st.policy_state, clock,
                _rng.fold_in(st.rng, CAND_SALT), ctx.ext, topk,
            )
        ctx.start_cores = sites.free_cores
        ctx.sites_serv = sites
        if assign_hooks:
            # the static fit is built here only when a hook composes with it;
            # otherwise inside _assign_and_start, which phase-skip rounds skip
            ctx.feasible = (
                _static_feasible(jobs, sites) if topk is None else sites.active[..., None, :]
            )
            for sub, fn in assign_hooks:
                fn(sub, ctx)
        pstate = st.policy_state
        rank_fn = getattr(policy, "rank", None)
        start_cores = ctx.start_cores

        def _assign_and_start(jobs, sites):
            """Phases 4 (policy assignment, the plugin hot spot) and 5
            (per-site FIFO-with-capacity starts).  With no QUEUED or ASSIGNED
            rows every update in here is a masked no-op, which is what makes
            the phase-skip guard below exact."""
            feasible = ctx.feasible
            rows = job_block.rows if split else None
            if topk is None:
                if feasible is None:
                    feasible = _static_feasible(
                        _tree_map(lambda x: x[rows], jobs) if split else jobs, sites)
                elif split and feasible.shape[-2] != 1:
                    feasible = feasible[rows]              # a hook's whole [J, S] mask
                scores = policy.score(jobs, sites, pstate, clock, k_policy)  # [J, S]
                if split:
                    site_pick, assigned_now = gathered(*policy.assign(
                        scores[rows], queued[rows], feasible, sites, block=job_block))
                else:
                    site_pick, assigned_now = policy.assign(scores, queued, feasible, sites)
            else:
                # the static core/memory fit lives in the candidate index;
                # per-round feasibility is a per-site [1, S] mask, or a
                # [J, S] one that a hook wrote
                if feasible is None:
                    feasible = sites.active[..., None, :]
                cand = ctx.ext["~cand"]                     # i32[J, K]
                cand_c = cand.clamp_max(S - 1).long()
                # re-check everything the dense mask carries, gathered at the
                # candidates: validity, per-round feasibility and the static
                # core/memory fit
                f_at = (
                    take(feasible[..., 0, :], cand_c) if feasible.shape[-2] == 1
                    else feasible.gather(-1, cand_c)
                )
                feas_k = (
                    (cand < S)
                    & f_at
                    & (jobs.cores[..., None] <= take(sites.cores, cand_c))
                    & (jobs.memory[..., None] <= take(sites.memory, cand_c))
                )
                score_c = getattr(policy, "score_cand", None)
                if score_c is not None:
                    scores_k = score_c(jobs, sites, pstate, clock, k_policy, cand_c)
                else:
                    # exact fallback: dense score + gather (no memory win)
                    scores_k = policy.score(jobs, sites, pstate, clock, k_policy)
                    scores_k = scores_k.gather(-1, cand_c)
                if split:
                    site_pick, assigned_now = gathered(*assign_c(
                        scores_k[rows], queued[rows], feas_k[rows], cand_c[rows], sites,
                        block=job_block))
                else:
                    site_pick, assigned_now = assign_c(scores_k, queued, feas_k, cand_c, sites)
            assigned_now = assigned_now & queued
            jobs = jobs._replace(
                state=torch.where(assigned_now, ASSIGNED, jobs.state),
                site=torch.where(assigned_now, site_pick.int(), jobs.site),
                t_assign=torch.where(assigned_now, clock_j, jobs.t_assign),
            )
            asg_site = torch.where(assigned_now, site_pick.int(), S)
            sites = sites._replace(n_assigned=sites.n_assigned + _site_sum(assigned_now, asg_site, S))

            in_queue = jobs.state == ASSIGNED
            sort_site = torch.where(in_queue, jobs.site, S)
            if "~srank" in st.ext:
                # packed fast path: one single-key sort, provably the same
                # permutation as the 5-key lexsort
                order = _start_order_packed(sort_site.long() * J + st.ext["~srank"])
            else:
                rank_val = (
                    torch.zeros(jobs.arrival.shape, dtype=torch.float32, device=clock.device)
                    if rank_fn is None else rank_fn(jobs, sites, pstate, clock)
                )
                order = _start_order(sort_site, jobs.priority, rank_val, jobs.arrival)
            site_s = take(sort_site, order)
            cand_s = take(in_queue, order)
            cores_s = torch.where(cand_s, take(jobs.cores, order), 0)
            mem_s = torch.where(cand_s, take(jobs.memory, order), 0.0)
            cum_cores = _segment_exclusive_base(cores_s, site_s, S + 1)
            cum_mem = _segment_exclusive_base(mem_s, site_s, S + 1)
            site_cl = site_s.clamp_max(S - 1).long()
            fits = (
                cand_s
                & (cum_cores <= take(start_cores, site_cl))
                & (cum_mem <= take(sites.free_memory, site_cl) + 1e-6)
                & (site_s < S)
            )
            started = torch.empty_like(fits).scatter_(-1, order, fits)
            return jobs, sites, started

        # phase-skip guard ("any lane" in an ensemble: lanes without work run
        # the phases as masked no-ops): completion-only rounds skip the score
        # matrix, the start-order sort and the segmented prefix sums entirely
        if phase_skip and not bool((queued | (jobs.state == ASSIGNED)).any()):
            started = torch.zeros(jobs.state.shape, dtype=torch.bool, device=clock.device)
        else:
            jobs, sites, started = _assign_and_start(jobs, sites)
        ctx.jobs, ctx.sites = jobs, sites

        start_site = torch.where(started, jobs.site, S)
        start_sums = _site_sum_stacked(
            torch.stack([torch.where(started, jobs.cores, 0), started.int()], dim=-1),
            start_site,
            S,
        )
        used_mem = _site_sum(torch.where(started, jobs.memory, 0.0), start_site, S)
        site_c = jobs.site.clamp_max(S - 1).long()
        share = take(start_sums[..., 1], site_c).float()

        # ---- 5b. service times + subsystem adjustments -----------------------
        ctx.started, ctx.site_c = started, site_c
        ctx.share, ctx.start_site = share, start_site
        ctx.t_serv = service_time(jobs, ctx.sites_serv, site_c, share, share)
        for sub, fn in start_hooks:
            fn(sub, ctx)
        jobs, t_serv = ctx.jobs, ctx.t_serv
        # both per-job draws hash the same counters: one threefry pass, two keys
        bits = _rng.random_bits(torch.stack([k_fail, k_frac], -2), (J,))
        u_fail = _rng.uniform_from_bits(bits[..., 0, :])
        # clip (not minimum): unassigned rows carry site == -1
        will_fail = started & (u_fail < take(sites.fail_rate, jobs.site.clamp(0, S - 1).long()))
        # a failing attempt dies partway through its service time
        frac = _rng.uniform_from_bits(bits[..., 1, :], minval=0.05, maxval=1.0)
        t_fin = clock_j + torch.where(will_fail, t_serv * frac, t_serv)

        jobs = jobs._replace(
            state=torch.where(started, RUNNING, jobs.state),
            t_start=torch.where(started, clock_j, jobs.t_start),
            t_finish=torch.where(started, t_fin, jobs.t_finish),
            will_fail=torch.where(started, will_fail, jobs.will_fail),
        )
        sites = sites._replace(
            free_cores=sites.free_cores - start_sums[..., 0],
            free_memory=sites.free_memory - used_mem,
        )
        ctx.jobs, ctx.sites = jobs, sites
        pstate = policy.on_step(pstate, jobs, sites, comp, started, clock)

        # ---- 6. halt detection & event log -----------------------------------
        n_started = started.sum(-1)
        n_completed = comp.sum(-1)
        # subsystem transitions (preemption, cascade rounds) count as progress
        # so halt detection gives the dispatcher a round to react to them
        progressed = (n_started > 0) | (n_completed > 0) | arrived.any(-1) | ctx.progressed
        halted = ~torch.isfinite(t_next) & ~progressed

        log = st.log
        if log_gate:
            # the ring is owned by the run's state: rows are written in place,
            # an ensemble's each at its lane's own slot, and only in the lanes
            # that go and whose own round is a sampling round
            if lane_dims:
                write = st.round % monitor_every == 0
                if going is not None:
                    write = write & going
                lane = torch.arange(write.shape[0], device=clock.device)
                slot = (log.cursor % log_rows).long()
            else:
                write, slot = True, log.cursor % log_rows

            def put(ring, value):
                if lane_dims:
                    row = ring[lane, slot]
                    ring[lane, slot] = torch.where(
                        write.view(write.shape + (1,) * (row.dim() - 1)), value, row)
                elif isinstance(value, torch.Tensor):
                    ring[slot].copy_(value)
                else:
                    ring[slot].fill_(value)

            states = torch.arange(N_STATES, device=clock.device)[:, None]
            put(log.time, clock)
            put(log.round_idx, st.round)
            put(log.counts,
                ((jobs.state[..., None, :] == states) & jobs.valid[..., None, :]).sum(-1).int())
            put(log.n_started, n_started.int())
            put(log.n_completed, n_completed.int())
            put(log.site_free, sites.free_cores)
            ones = torch.ones(jobs.state.shape, dtype=torch.int32, device=clock.device)
            put(log.site_queued, _site_sum(
                ones, torch.where(jobs.state == ASSIGNED, jobs.site, S), S))
            put(log.site_running, _site_sum(
                ones, torch.where(jobs.state == RUNNING, jobs.site, S), S))
            for sub, fn in log_hooks:
                for name, value in fn(sub, ctx, write).items():
                    put(log.extra[name], value)
            log = log._replace(cursor=log.cursor + (write.int() if lane_dims else 1))

        ext = ctx.ext
        if lane_dims:
            if going is not None:
                # the lanes whose own condition failed keep their state
                clock, halted, key = (_freeze(going, *pair) for pair in (
                    (clock, st.clock), (halted, st.halted), (key, st.rng)))
                jobs, sites = _freeze(going, jobs, st.jobs), _freeze(going, sites, st.sites)
                pstate = _freeze(going, pstate, st.policy_state)
                ext = _freeze(going, ext, st.ext)
        return EngineState(
            clock=clock,
            round=st.round + (1 if going is None else going.int()),
            jobs=jobs,
            sites=sites,
            rng=key,
            policy_state=pstate,
            log=log,
            halted=halted,
            ext=ext,
        )

    return cond, body


def _finalize(st: EngineState, policy, subsystems: tuple) -> SimResult:
    """End-of-run hooks (policy ``on_end``, subsystem ``finalize``) plus
    SimResult assembly; "~"-prefixed carries are engine-internal and dropped.
    An ensemble's rounds and log cursors are each lane's own."""
    pstate = policy.on_end(st.policy_state, st.jobs, st.sites, st.clock)
    ext = {k: v for k, v in st.ext.items() if not k.startswith("~")}
    result_fields = {}
    for sub in subsystems:
        if sub.finalize is not None:
            ext[sub.name], fields = sub.finalize(sub, ext[sub.name], st.jobs, st.sites, st.clock)
            result_fields.update(fields)
    rounds, log = st.round, st.log
    return SimResult(
        makespan=st.clock,
        rounds=rounds,
        jobs=st.jobs,
        sites=st.sites,
        log=log,
        policy_state=pstate,
        ext=ext,
        **result_fields,
    )


def _check_device(state, device: torch.device, what: str) -> None:
    """Every tensor in ``state`` (a tensor, or NamedTuples, dicts, tuples and
    lists of them) lies on ``device``."""
    if isinstance(state, torch.Tensor):
        if state.device.type != device.type or (
            device.index is not None and state.device.index != device.index
        ):
            raise ValueError(f"{what} lies on {state.device}, the run on {device}")
    elif isinstance(state, tuple) and hasattr(state, "_asdict"):
        for name, t in state._asdict().items():
            _check_device(t, device, f"{what}.{name}")
    elif isinstance(state, dict):
        for name, t in state.items():
            _check_device(t, device, f"{what}[{name!r}]")
    elif isinstance(state, (tuple, list)):
        for i, t in enumerate(state):
            _check_device(t, device, f"{what}[{i}]")


def simulate(
    jobs0: JobsState,
    sites0: SiteState,
    policy,
    rng: torch.Tensor,
    *,
    availability=None,
    workflow=None,
    subsystems=(),
    data_policy=None,
    network=None,
    replicas=None,
    transfers=None,
    faults=None,
    max_rounds: int = 100_000,
    horizon: float = float("inf"),
    log_rows: int = 0,
    max_retries: int = 3,
    monitor_every: int = 1,
    quantum: float = 0.0,
    phase_skip: bool = True,
    topk: int | None = None,
    topk_refresh: int = 0,
    recorder=None,
    device="cuda",
) -> SimResult:
    """Run the grid simulation to completion (or ``max_rounds``/``horizon``).

    ``jobs0``, ``sites0`` and the subsystem states must lie on ``device``
    (build them with the same ``device=``); the key moves there.
    ``device="cuda"`` raises without a GPU.

    ``phase_skip`` (default on) skips the assignment and start phases in
    rounds with no QUEUED/ASSIGNED rows, with identical results.  ``quantum``
    > 0 batches all events inside [t*, t* + quantum] into one round.
    ``log_rows`` > 0 keeps a ring of per-round snapshots, written every
    ``monitor_every`` rounds.

    ``topk`` switches assignment to the sparse candidate-set path
    (``core/sparse.py``): scores are evaluated over an ``i32[J, topk]``
    candidate-site index instead of the dense ``[J, S]`` matrix.  ``topk >= S``
    equals the dense path bit for bit; smaller ``topk`` restricts each job to
    its pre-ranked candidates.  The index is built once at init from the
    policy's pre-rank; ``topk_refresh=N`` rebuilds it every N rounds (0 =
    never).

    Subsystems:

    - ``availability=`` (an ``AvailabilityState`` downtime calendar): window
      edges become event rounds, full outages block assignment and starts
      and either preempt running jobs (back to QUEUED with a retry) or drain
      them, and brown-out windows scale a site's speed and usable cores.
    - ``workflow=`` (a ``WorkflowState`` DAG): a job stays PENDING until
      every parent is DONE, and a terminally failed parent cascade-cancels
      its descendants.
    - ``data_policy=`` (a ``DataPolicy``, with ``network=`` a
      ``NetworkState`` and ``replicas=`` a ``ReplicaState``) prices the
      stage-in of dataset jobs as a WAN read from the policy-selected
      replica over the shared link matrix (local replicas are free hits)
      and keeps the catalog; the policy may cache-on-read at the compute
      site, evicting LRU replicas under storage pressure.  Jobs with
      ``dataset == -1`` keep the flat per-site link.  With ``workflow=``,
      a completing parent materializes its ``out_dataset`` at its site.
    - ``transfers=`` (a ``TransferState``, needs ``data_policy=``) queues
      those WAN reads in per-link FIFO rings with an active-transfer cap:
      a staging job waits, RUNNING with ``t_finish = inf``, until its
      transfer lands.
    - ``faults=`` (a ``FaultState`` from ``make_faults``) adds fault
      injection and recovery: per-link transfer failures with
      exponential-backoff re-enqueue, resubmission backoff, walltime kills,
      a replica-loss calendar and a per-site circuit breaker.  The default
      state changes no result.
    - ``subsystems=((Subsystem, state0), ...)`` appends custom subsystems
      after the built-ins.

    ``SimResult.replicas`` and ``SimResult.data_state`` hold the data
    subsystem's final catalog and policy state.

    ``recorder`` (a ``telemetry.TraceRecorder``) times the call.  The port
    traces and compiles nothing per call, so the JAX package's spans mean
    here: ``dispatch``, the host's round loop (every launch and the
    device-to-host reads of each round; the first run in a process also
    builds or loads the CUDA kernels inside it); ``execute``, the device
    work still queued when the loop returns, up to
    ``torch.cuda.synchronize(device)`` (nothing to wait for on the CPU);
    ``trace_compile`` is never recorded and the note ``jit_cache_hit`` is
    always True.  It also records the rounds executed, the round budget,
    the early-exit rounds, the job and site counts and the subsystems.
    ``None`` (the default) adds no host sync; the results are the same
    either way.
    """
    handle = init_sim(
        jobs0, sites0, policy, rng, availability=availability, workflow=workflow,
        subsystems=subsystems, data_policy=data_policy, network=network, replicas=replicas,
        transfers=transfers, faults=faults, max_rounds=max_rounds, log_rows=log_rows,
        max_retries=max_retries, monitor_every=monitor_every, quantum=quantum,
        phase_skip=phase_skip, topk=topk, topk_refresh=topk_refresh, device=device,
    )
    return run_sim(handle, horizon, recorder)


def run_sim(handle: "SimHandle", horizon: float = float("inf"), recorder=None) -> SimResult:
    """``simulate``'s drive of a fresh handle: ``advance_sim`` to
    ``horizon``, then ``finish_sim``, timed by ``recorder`` when given (see
    ``simulate``)."""
    if recorder is None:
        return finish_sim(advance_sim(handle, horizon))
    n_jobs, n_sites = int(handle.state.jobs.valid.sum()), handle.state.sites.capacity
    t0 = time.perf_counter()
    handle = advance_sim(handle, horizon)
    recorder.record("dispatch", time.perf_counter() - t0)
    with recorder.span("execute"):
        res = finish_sim(handle)
        if res.makespan.is_cuda:
            torch.cuda.synchronize(res.makespan.device)
    rounds = int(res.rounds)
    recorder.gauge("rounds_executed", rounds)
    recorder.gauge("round_budget", handle.max_rounds)
    recorder.gauge("early_exit_rounds", max(handle.max_rounds - rounds, 0))
    recorder.gauge("n_jobs", n_jobs)
    recorder.gauge("n_sites", n_sites)
    recorder.note("jit_cache_hit", True)
    recorder.note("subsystems", [s.name for s in handle.subsystems])
    return res


# --------------------------------------------------------------------------
# segmented execution: pause and resume the round loop between frames
# --------------------------------------------------------------------------


def _f32(x: float) -> float:
    """``x`` rounded to float32 (inf stays inf)."""
    return float(torch.tensor(x, dtype=torch.float32))


class SimHandle(NamedTuple):
    """A paused simulation: the round loop's state and what it needs to
    resume.  ``init_sim`` makes one, ``advance_sim`` runs it on,
    ``finish_sim`` ends it; ``monitor.watch`` takes frames between
    segments."""

    state: EngineState
    policy: object
    subsystems: tuple
    statics: tuple  # (max_rounds, log_rows, max_retries, monitor_every, quantum,
    #                  phase_skip, topk, topk_refresh)
    job_block: object = None  # a job-parallel run's distributed.JobBlock

    @property
    def max_rounds(self) -> int:
        return self.statics[0]


def init_sim(
    jobs0: JobsState,
    sites0: SiteState,
    policy,
    rng: torch.Tensor,
    *,
    availability=None,
    workflow=None,
    subsystems=(),
    data_policy=None,
    network=None,
    replicas=None,
    transfers=None,
    faults=None,
    max_rounds: int = 100_000,
    log_rows: int = 0,
    max_retries: int = 3,
    monitor_every: int = 1,
    quantum: float = 0.0,
    phase_skip: bool = True,
    topk: int | None = None,
    topk_refresh: int = 0,
    device="cuda",
) -> SimHandle:
    """A resumable simulation: ``simulate``'s arguments less ``horizon``,
    which ``advance_sim`` takes a segment at a time.  States stacked with a
    leading K and a batch of keys ``rng [K, 2]`` make an ensemble of K lanes
    (what ``simulate_many`` runs)."""
    device = resolve_device(device)
    _check_device(jobs0, device, "jobs0")
    _check_device(sites0, device, "sites0")
    subs, ext0 = resolve_subsystems(
        availability=availability, workflow=workflow, subsystems=subsystems,
        data_policy=data_policy, network=network, replicas=replicas, transfers=transfers,
        faults=faults, jobs=jobs0, sites=sites0,
    )
    for name, state in ext0.items():
        _check_device(state, device, name)
    if topk is not None:
        topk = min(int(topk), sites0.capacity)  # k >= S is exactly dense
    st = _init_state(jobs0, sites0, policy, rng.to(device), ext0, subs, log_rows, topk)
    statics = (max_rounds, log_rows, max_retries, monitor_every, quantum, phase_skip,
               topk, topk_refresh)
    return SimHandle(state=st, policy=policy, subsystems=subs, statics=statics)


def advance_sim(handle: SimHandle, horizon: float = float("inf")) -> SimHandle:
    """Run rounds until the clock passes ``horizon`` (in float32) or the run
    drains.

    The loop checks the clock before each round, so resuming with a larger
    horizon continues the round sequence one ``simulate`` call would run:
    segmenting changes where the loop pauses, never what it computes."""
    (max_rounds, log_rows, max_retries, monitor_every, quantum, phase_skip,
     topk, topk_refresh) = handle.statics
    cond, body = _round_fns(
        handle.policy,
        tuple(handle.subsystems),
        max_rounds=max_rounds,
        log_rows=log_rows,
        max_retries=max_retries,
        monitor_every=monitor_every,
        quantum=quantum,
        phase_skip=phase_skip,
        topk=topk,
        topk_refresh=topk_refresh,
        job_block=handle.job_block,
    )
    horizon = _f32(horizon)
    st = handle.state
    while True:
        go, going, gates = cond(st, horizon)
        if not go:
            break
        st = body(st, going, gates)
    return handle._replace(state=st)


def sim_active(handle: SimHandle) -> bool:
    """On the host: would the round loop still run, given an open horizon?
    (In an ensemble: does any lane still go?)"""
    st = handle.state
    if isinstance(st.round, int) and st.round >= handle.max_rounds:
        return False
    state = st.jobs.state
    active = (state == PENDING) | (state == QUEUED) | (state == ASSIGNED) | (state == RUNNING)
    go = ~st.halted & (active & st.jobs.valid).any(-1) & (st.round < handle.max_rounds)
    return bool(go.any())


def finish_sim(handle: SimHandle) -> SimResult:
    """Run the end-of-run hooks on a drained or abandoned handle."""
    return _finalize(handle.state, handle.policy, tuple(handle.subsystems))


# --------------------------------------------------------------------------
# scenario ensembles: K scenarios, one batched round loop
# --------------------------------------------------------------------------

class Scenario(NamedTuple):
    """One point of a scenario ensemble: a workload, a platform and the
    per-scenario subsystem states (calendars, DAGs) keyed by subsystem
    name.  Feed a list of these to ``simulate_many``, or stack them first
    with ``stack_scenarios``."""

    jobs: JobsState
    sites: SiteState
    ext: dict | None = None


class ScenarioBuckets(NamedTuple):
    """A ragged ensemble grouped into a few padded shape buckets.

    ``buckets[b]`` is a stacked ``Scenario`` whose jobs are padded only to
    that bucket's largest capacity; ``index[b]`` holds each lane's position
    in the original scenario list, so results reassemble in the caller's
    order and lane ``i`` draws the key it would in one stack."""

    buckets: tuple  # tuple[Scenario], each stacked with leading K_b
    index: tuple    # tuple[tuple[int, ...]] original scenario positions

    @property
    def n_scenarios(self) -> int:
        return sum(len(ix) for ix in self.index)

    def padding_stats(self) -> dict:
        """The padding this bucketing pays: per bucket the capacity, lanes,
        used and padded job rows and the waste fraction, and a summary
        against one bucket (every lane padded to the largest capacity)."""
        rows = []
        total_rows = total_used = 0
        for b, (scn, ix) in enumerate(zip(self.buckets, self.index)):
            cap = scn.jobs.capacity
            lanes = len(ix)
            used = int(scn.jobs.valid.sum())
            dense = lanes * cap
            rows.append(dict(
                bucket=b, capacity=cap, lanes=lanes, used_rows=used,
                padded_rows=dense - used,
                waste_frac=float((dense - used) / dense) if dense else 0.0,
            ))
            total_rows += dense
            total_used += used
        cap_max = max(r["capacity"] for r in rows)
        flat_rows = self.n_scenarios * cap_max
        return dict(
            buckets=rows,
            summary=dict(
                n_buckets=len(rows),
                n_scenarios=self.n_scenarios,
                total_rows=total_rows,
                used_rows=total_used,
                waste_frac=float((total_rows - total_used) / total_rows) if total_rows else 0.0,
                flat_rows=flat_rows,
                flat_waste_frac=(
                    float((flat_rows - total_used) / flat_rows) if flat_rows else 0.0),
                saved_rows=flat_rows - total_rows,
            ),
        )


def stack_scenarios(scenarios, *, subsystems: tuple = (), buckets: int = 1):
    """Stack Scenarios into one with a leading K on every tensor.

    Ragged workloads are padded to the largest job capacity with inert rows
    (``pad_jobs_capacity``); job-shaped subsystem state (a workflow's parent
    matrix) pads alongside through each subsystem's ``pad_jobs`` hook when
    ``subsystems`` is given (``simulate_many`` passes its own).  Sites and
    the other subsystem state must already share shapes.

    ``buckets > 1`` returns a ``ScenarioBuckets``: the scenarios ordered by
    job capacity and split into up to ``buckets`` groups of similar size,
    each padded only to its own largest."""
    from .subsystems import pad_ext_jobs

    scenarios = list(scenarios)
    if not scenarios:
        raise ValueError("need at least one scenario")
    if buckets > 1:
        order = sorted(range(len(scenarios)), key=lambda i: scenarios[i].jobs.capacity)
        groups = [g for g in np.array_split(order, min(buckets, len(scenarios))) if len(g)]
        return ScenarioBuckets(
            buckets=tuple(stack_scenarios([scenarios[i] for i in g], subsystems=subsystems)
                          for g in groups),
            index=tuple(tuple(int(i) for i in g) for g in groups),
        )
    cap = max(s.jobs.capacity for s in scenarios)
    norm = [
        Scenario(pad_jobs_capacity(s.jobs, cap), s.sites,
                 pad_ext_jobs(subsystems, s.ext or {}, s.jobs.capacity, cap))
        for s in scenarios
    ]
    return _tree_map(lambda *xs: torch.stack(xs), *norm)


def _check_ensemble(scenarios: Scenario, subsystems: tuple) -> dict:
    """Check a stacked ensemble against its subsystem tuple (the subsystems'
    ``validate`` hooks run in ``init_sim``); returns ext."""
    ext = scenarios.ext or {}
    known = {sub.name for sub in subsystems}
    if set(ext) != known:
        raise ValueError(
            f"scenario ext keys {sorted(ext)} must match the attached "
            f"subsystems {sorted(known)} one-to-one")
    return ext


def _simulate_many_stacked(scenarios: Scenario, policy, keys: torch.Tensor, *,
                           subsystems: tuple = (), horizon: float = float("inf"),
                           **kw) -> SimResult:
    """The batched core: one round loop over the lanes of a stacked
    ensemble, lane ``i`` under ``keys[i]`` (a batch of keys makes
    ``init_sim`` build lanes; the subsystems' shape checks use negative
    axes, so the leading K is transparent to them)."""
    ext = _check_ensemble(scenarios, tuple(subsystems))
    handle = init_sim(scenarios.jobs, scenarios.sites, policy, keys,
                      subsystems=tuple((sub, ext[sub.name]) for sub in subsystems), **kw)
    return finish_sim(advance_sim(handle, horizon))


# legacy SimResult fields that alias a subsystem's ext slot; a bucketed merge
# re-pads ext, so the aliases must point at the padded state
_EXT_ALIASES = {"workflow": ("wf",), "availability": ("avail",)}


def _pad_result_to(res: SimResult, subsystems: tuple, capacity: int) -> SimResult:
    """Grow one bucket's SimResult to the ensemble-wide job capacity with
    inert rows (the rows one stack would have carried through the run)."""
    J_b = res.jobs.capacity
    repl = {"jobs": pad_jobs_capacity(res.jobs, capacity)}
    if J_b != capacity and res.ext:
        ext = dict(res.ext)
        for sub in subsystems:
            if sub.pad_jobs is not None and sub.name in ext:
                padded = sub.pad_jobs(sub, ext[sub.name], J_b, capacity)
                ext[sub.name] = padded
                for field in _EXT_ALIASES.get(sub.name, ()):
                    if getattr(res, field) is not None:
                        repl[field] = padded
        repl["ext"] = ext
    return res._replace(**repl)


def _run_buckets(sb: ScenarioBuckets, rng: torch.Tensor, runner, subsystems) -> SimResult:
    """Run a bucketed ensemble bucket by bucket through ``runner(stacked,
    keys)`` and reassemble one SimResult in the original scenario order.
    Lane ``i`` draws ``split(rng, K)[i]`` as it would in one stack."""
    keys = _rng.split(rng, sb.n_scenarios)
    cap = max(s.jobs.capacity for s in sb.buckets)
    results = [
        _pad_result_to(runner(scen, keys[torch.tensor(ix, device=keys.device)]), subsystems, cap)
        for scen, ix in zip(sb.buckets, sb.index)
    ]
    inv = torch.from_numpy(np.argsort(np.concatenate([np.asarray(ix) for ix in sb.index])))
    return _tree_map(lambda *xs: torch.cat(xs)[inv.to(xs[0].device)], *results)


def simulate_many(scenarios, policy, rng: torch.Tensor, *, subsystems: tuple = (),
                  device="cuda", **kw) -> SimResult:
    """Scenario ensembles: K scenarios through one batched round loop.

    ``scenarios`` is a list of ``Scenario``s (stacked here), a stacked
    ``Scenario`` whose tensors carry a leading K, or a ``ScenarioBuckets``
    from ``stack_scenarios(..., buckets=n)`` (run bucket by bucket, results
    in the original order).  ``subsystems`` is the tuple of ``Subsystem``
    bundles matching the keys of ``Scenario.ext`` (empty for plain runs):
    every built-in (availability, workflow, data with its ``(network,
    replicas)`` pair, transfers, faults) and custom ones.  ``simulate``'s
    subsystem keywords raise ``TypeError``, as in the JAX package.  ``kw``
    takes ``simulate``'s run options (``max_rounds``, ``horizon``,
    ``log_rows``, ``max_retries``, ``monitor_every``, ``quantum``,
    ``phase_skip``, ``topk``, ``topk_refresh``).

    Lane ``i`` runs under ``split(rng, K)[i]`` and equals the solo
    ``simulate`` of its scenario padded to the ensemble's job capacity, bit
    for bit; with ``topk < S`` and ``topk_refresh > 0`` it equals the JAX
    package's lane instead, since every lane rebuilds its candidates when
    any lane's own round is a refresh round.  The returned ``SimResult`` has
    a leading K on every tensor, ``rounds`` and ``log.cursor`` included.
    Every per-site sum of a round is one segment sum over all lanes, and a
    capacity assigner (``with_capacity_assign``, ``with_fused_assign``)
    makes one kernel call for all lanes."""
    # an ensemble takes its subsystem states through Scenario.ext, and
    # refuses simulate's subsystem keywords as the JAX package's does
    for name in ("availability", "workflow", "data_policy", "network", "replicas",
                 "transfers", "faults"):
        if name in kw:
            raise TypeError(
                f"simulate_many() got an unexpected keyword argument {name!r}: pass each "
                "lane's subsystem state in Scenario.ext with the matching subsystems= tuple")
    device = resolve_device(device)
    rng = rng.to(device)
    if isinstance(scenarios, ScenarioBuckets):
        def runner(scen, keys):
            return _simulate_many_stacked(scen, policy, keys, subsystems=subsystems,
                                          device=device, **kw)

        return _run_buckets(scenarios, rng, runner, subsystems)
    if not isinstance(scenarios, Scenario):
        scenarios = stack_scenarios(scenarios, subsystems=subsystems)
    K = scenarios.jobs.arrival.shape[0]
    return _simulate_many_stacked(scenarios, policy, _rng.split(rng, K),
                                  subsystems=subsystems, device=device, **kw)


def ensemble_scenario(jobs0: JobsState, sites0: SiteState, speed_candidates: torch.Tensor, *,
                      availability=None, workflow=None, data_policy=None, network=None,
                      replicas=None, transfers=None, faults=None, subsystems=()):
    """``(scenario, subsystems)``: one workload on K per-site speed vectors
    as a stacked K-lane ``Scenario``, every subsystem state (``simulate``'s
    keywords) copied to each lane."""
    subs, ext0 = resolve_subsystems(
        availability=availability, workflow=workflow, data_policy=data_policy, network=network,
        replicas=replicas, transfers=transfers, faults=faults, subsystems=subsystems,
        jobs=jobs0, sites=sites0)
    K = speed_candidates.shape[0]

    def lanes(x):
        return x.expand(K, *x.shape).clone()

    scn = Scenario(
        jobs=_tree_map(lanes, jobs0),
        sites=_tree_map(lanes, sites0)._replace(speed=speed_candidates.float()),
        ext=_tree_map(lanes, ext0),
    )
    return scn, subs


def simulate_ensemble(jobs0: JobsState, sites0: SiteState, policy, rng: torch.Tensor, *,
                      speed_candidates: torch.Tensor, availability=None, workflow=None,
                      data_policy=None, network=None, replicas=None, transfers=None,
                      faults=None, subsystems=(), device="cuda", **kw) -> SimResult:
    """One workload on K per-site speed vectors ``speed_candidates f32[K, S]``
    (the calibration inner loop): lane ``i`` is ``simulate`` on
    ``sites0._replace(speed=speed_candidates[i])`` under ``split(rng,
    K)[i]``.  The subsystem keywords are ``simulate``'s; each state is
    shared by every lane (copied to each); ``kw`` as for ``simulate_many``."""
    scn, subs = ensemble_scenario(
        jobs0, sites0, speed_candidates, availability=availability, workflow=workflow,
        data_policy=data_policy, network=network, replicas=replicas, transfers=transfers,
        faults=faults, subsystems=subsystems)
    return simulate_many(scn, policy, rng, subsystems=subs, device=device, **kw)


def walltimes(result: SimResult) -> torch.Tensor:
    """Per-job walltime (t_finish - t_start); inf for jobs that never ran."""
    return result.jobs.t_finish - result.jobs.t_start


def queue_times(result: SimResult) -> torch.Tensor:
    return result.jobs.t_start - result.jobs.arrival
