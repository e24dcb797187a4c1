"""Event-round engine: the dense solo simulator on PyTorch.

The JAX package runs the rounds inside a ``lax.while_loop``; here a Python
loop drives them and reads back two flags a round (whether to go on, and
whether the round has dispatch work).  Each round advances the clock to the
next event time and applies every transition that fires at that instant as
masked dense updates:

  round(t*):
    1. completions   — running jobs with t_finish <= t*  → DONE/FAILED/resubmit
    2. arrivals      — pending jobs with arrival  <= t*  → QUEUED at the server
    3. assignment    — the policy plugin scores QUEUED jobs against sites;
                       feasible best-site rows become ASSIGNED (site queue)
    4. starts        — per-site FIFO-with-capacity: sort ASSIGNED rows by
                       (site, -priority, -rank, arrival), start the per-site
                       prefix whose cumulative core/memory demand fits
    5. bookkeeping   — service times, failure sampling, counters, event log

The results equal the JAX package's bit for bit: the same key stream
(``rng``), the same float orders (``scan``), and sorts whose keys are a strict
total order, so any correct sort yields the one permutation.
"""
from __future__ import annotations

import torch

from . import rng as _rng
from ..kernels.segment_sum import segment_sum
from .scan import cumsum_f32, fma_f32
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
    resolve_device,
)

INF = float("inf")


def compute_time(jobs: JobsState, sites: SiteState, site: torch.Tensor) -> torch.Tensor:
    """Amdahl-style compute term: ``work / (speed * c / (1 + gamma (c-1)))``.
    The denominator ``1 + gamma (c-1)`` is one fused multiply-add, as XLA
    computes it."""
    site = site.long()
    c = jobs.cores.float()
    speedup = c / fma_f32(sites.par_gamma[site], (c - 1.0).clamp_min(0.0), 1.0)
    return jobs.work / (sites.speed[site] * speedup.clamp_min(1e-9))


def stage_in_time(
    jobs: JobsState, sites: SiteState, site: torch.Tensor, share_in: torch.Tensor
) -> torch.Tensor:
    """Flat-link stage-in: site latency + ``bytes_in`` over the ingress link
    shared equally among the ``share_in`` jobs staging concurrently.

    ``bytes / (bw / share)`` is evaluated as ``(bytes * share) / bw``: XLA
    rewrites ``A / (B / C)`` to ``(A * C) / B``, and the bits follow it."""
    site = site.long()
    return sites.latency[site] + (jobs.bytes_in * share_in.clamp_min(1.0)) / sites.bw_in[site]


def service_time(
    jobs: JobsState, sites: SiteState, site: torch.Tensor, share_in: torch.Tensor,
    share_out: torch.Tensor,
) -> torch.Tensor:
    """Deterministic-at-start service time: latency + stage_in + compute +
    stage_out, with stage bandwidth shared among the jobs staging at once."""
    stage_out = (jobs.bytes_out * share_out.clamp_min(1.0)) / sites.bw_out[site.long()]
    return (
        stage_in_time(jobs, sites, site, share_in)
        + compute_time(jobs, sites, site)
        + stage_out
    )


def _site_sum(values: torch.Tensor, site: torch.Tensor, num_sites: int) -> torch.Tensor:
    """Scatter per-job values (``[J]``, or features stacked as ``[J, F]``) onto
    their site; rows with ``site == num_sites`` (the padding segment for
    non-participating rows) are dropped.  Bool values count in int32; float
    sums add in job-index order."""
    if values.dtype == torch.bool:
        values = values.int()
    return segment_sum(values, site, num_sites)


_site_sum_stacked = _site_sum  # the JAX package's name for the [J, F] form


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort(keys)`` (last key most significant, ties by index) as
    chained stable sorts.  Float keys gain ``+ 0.0`` so that -0.0 and 0.0 tie,
    as they do in JAX's comparator; a radix sort would order them."""
    perm = None
    for key in keys:
        if key.is_floating_point():
            key = key + 0.0
        k = key if perm is None else key[perm]
        step = torch.sort(k, stable=True).indices
        perm = step if perm is None else perm[step]
    return perm


def _start_order(sort_site, priority, rank_val, arrival) -> torch.Tensor:
    """Start-order permutation by (site, -priority, -rank, arrival, index).

    The JAX package ranks pairwise below J=512 and lexsorts above; the key is
    a strict total order, so both give this one permutation."""
    return _lexsort((arrival, -rank_val, -priority, sort_site))


def _start_order_packed(packed: torch.Tensor) -> torch.Tensor:
    """Start-order permutation from a single strict-total-order int64 key
    ``sort_site * J + srank`` (all keys distinct, so any sort gives the same
    permutation as ``_start_order``)."""
    return torch.argsort(packed)


def _static_start_rank(jobs: JobsState) -> torch.Tensor:
    """``i64[J]``: rank of each job under ``(-priority, arrival, index)``, the
    run-constant suffix of the start-order key."""
    J = jobs.capacity
    perm = _lexsort((jobs.arrival, -jobs.priority))
    rank = torch.empty((J,), dtype=torch.int64, device=perm.device)
    rank[perm] = torch.arange(J, device=perm.device)
    return rank


def _packed_order_ok(policy, J: int, S: int) -> bool:
    """Can this run use the packed single-key start order?  Needs a rank-less
    policy; the size limit is the JAX package's (its key is int32), kept so
    both packages take the same path."""
    return getattr(policy, "rank", None) is None and (S + 1) * J <= 2**31 - 1


def _segment_exclusive_base(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int):
    """For values sorted by seg_ids: per-element cumulative sum *within* its segment.

    The last segment's total never enters a base (``seg_base`` drops the last
    prefix sum), so it is not summed: in the engine that segment holds every
    non-candidate row, and a serial row-order sum over it would cost O(J)."""
    if values.is_floating_point():
        cumsum = cumsum_f32
    else:
        def cumsum(x):
            return torch.cumsum(x, 0, dtype=x.dtype)
    total_cum = cumsum(values)
    seg_totals = segment_sum(values, seg_ids, num_segments - 1)
    seg_cum = cumsum(torch.cat([seg_totals, seg_totals.new_zeros((1,))]))
    seg_base = torch.cat([seg_cum.new_zeros((1,)), seg_cum[:-1]])
    return total_cum - seg_base[seg_ids.long()]


def default_assign(scores, queued, feasible, sites=None):
    """Reference assignment: best feasible site per queued job (site-queue
    mode), ties to the lowest site.  Returns (site[J] int32 with -1 for
    unassigned, assigned_mask[J])."""
    S = scores.shape[-1]
    masked = torch.where(feasible, scores, -INF)
    best_val = masked.amax(-1)
    iota = torch.arange(S, device=scores.device)
    best = torch.where(masked == best_val[:, None], iota, S).amin(-1).int()
    ok = queued & torch.isfinite(best_val)
    return torch.where(ok, best, -1), ok


def _init_state(jobs0: JobsState, sites0: SiteState, policy, key, log_rows: int) -> EngineState:
    """Build the round-loop carry: run the policy's init hook, allocate the
    frame ring buffer, precompute the packed start-order key when allowed."""
    device = jobs0.arrival.device
    ext0 = {}
    if _packed_order_ok(policy, jobs0.capacity, sites0.capacity):
        ext0["~srank"] = _static_start_rank(jobs0)
    return EngineState(
        clock=torch.zeros((), dtype=torch.float32, device=device),
        round=0,
        jobs=jobs0,
        sites=sites0,
        rng=key,
        policy_state=policy.init(jobs0, sites0),
        log=make_log(log_rows, sites0.capacity, device=device),
        halted=torch.zeros((), dtype=torch.bool, device=device),
        ext=ext0,
    )


def _round_fns(
    policy,
    *,
    max_rounds: int,
    log_rows: int,
    max_retries: int,
    monitor_every: int,
    quantum: float,
    phase_skip: bool,
):
    """The round loop's ``(cond, body)`` pair for one configuration.  ``cond``
    reads one flag back from the device."""

    def cond(st: EngineState, horizon) -> bool:
        if st.round >= max_rounds:
            return False
        state = st.jobs.state
        active = (state == PENDING) | (state == QUEUED) | (state == ASSIGNED) | (state == RUNNING)
        go = ~st.halted & (active & st.jobs.valid).any() & (st.clock <= horizon)
        return bool(go)

    def body(st: EngineState) -> EngineState:
        S = st.sites.capacity
        J = st.jobs.capacity
        jobs, sites = st.jobs, st.sites
        key, k_fail, k_frac, k_policy = _rng.split(st.rng, 4)

        # ---- 1. advance the clock to the next event ------------------------
        arrivable = (jobs.state == PENDING) & jobs.valid
        arr_t = torch.where(arrivable, jobs.arrival, INF)
        fin_t = torch.where(jobs.state == RUNNING, jobs.t_finish, INF)
        t_next = torch.minimum(arr_t.amin(), fin_t.amin())
        if quantum > 0.0:
            t_next = t_next + quantum
        clock = torch.where(torch.isfinite(t_next), torch.maximum(st.clock, t_next), st.clock)

        # ---- 2. completions -------------------------------------------------
        comp = (jobs.state == RUNNING) & (jobs.t_finish <= clock)
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
            free_cores=sites.free_cores + comp_sums[:, 0],
            free_memory=sites.free_memory + freed_mem,
            n_finished=sites.n_finished + comp_sums[:, 1],
            n_failed=sites.n_failed + comp_sums[:, 2],
        )

        # ---- 3. arrivals -----------------------------------------------------
        arrived = (jobs.state == PENDING) & (jobs.arrival <= clock) & jobs.valid
        jobs = jobs._replace(state=torch.where(arrived, QUEUED, jobs.state))

        # ---- 4+5. assignment & starts ----------------------------------------
        queued = jobs.state == QUEUED
        start_cores = sites.free_cores
        sites_serv = sites
        pstate = st.policy_state
        rank_fn = getattr(policy, "rank", None)

        def _assign_and_start(jobs, sites):
            """Phases 4 (policy assignment, the plugin hot spot) and 5
            (per-site FIFO-with-capacity starts).  With no QUEUED or ASSIGNED
            rows every update in here is a masked no-op, which is what makes
            the phase-skip guard below exact."""
            # static feasibility: job can ever fit the site
            feasible = (
                sites.active[None, :]
                & (jobs.cores[:, None] <= sites.cores[None, :])
                & (jobs.memory[:, None] <= sites.memory[None, :])
            )
            scores = policy.score(jobs, sites, pstate, clock, k_policy)  # [J, S]
            site_pick, assigned_now = policy.assign(scores, queued, feasible, sites)
            assigned_now = assigned_now & queued
            jobs = jobs._replace(
                state=torch.where(assigned_now, ASSIGNED, jobs.state),
                site=torch.where(assigned_now, site_pick.int(), jobs.site),
                t_assign=torch.where(assigned_now, clock, jobs.t_assign),
            )
            asg_site = torch.where(assigned_now, site_pick.int(), S)
            sites = sites._replace(n_assigned=sites.n_assigned + _site_sum(assigned_now, asg_site, S))

            cand = jobs.state == ASSIGNED
            sort_site = torch.where(cand, jobs.site, S)
            if "~srank" in st.ext:
                # packed fast path: one single-key sort, provably the same
                # permutation as the 5-key lexsort
                order = _start_order_packed(sort_site.long() * J + st.ext["~srank"])
            else:
                rank_val = (
                    torch.zeros((J,), dtype=torch.float32, device=clock.device)
                    if rank_fn is None else rank_fn(jobs, sites, pstate, clock)
                )
                order = _start_order(sort_site, jobs.priority, rank_val, jobs.arrival)
            site_s = sort_site[order]
            cand_s = cand[order]
            cores_s = torch.where(cand_s, jobs.cores[order], 0)
            mem_s = torch.where(cand_s, jobs.memory[order], 0.0)
            cum_cores = _segment_exclusive_base(cores_s, site_s, S + 1)
            cum_mem = _segment_exclusive_base(mem_s, site_s, S + 1)
            site_cl = site_s.clamp_max(S - 1).long()
            fits = (
                cand_s
                & (cum_cores <= start_cores[site_cl])
                & (cum_mem <= sites.free_memory[site_cl] + 1e-6)
                & (site_s < S)
            )
            started = torch.empty((J,), dtype=torch.bool, device=fits.device)
            started[order] = fits
            return jobs, sites, started

        if phase_skip and not bool((queued | (jobs.state == ASSIGNED)).any()):
            # phase-skip guard: completion-only rounds skip the score matrix,
            # the start-order sort and the segmented prefix sums entirely
            started = torch.zeros((J,), dtype=torch.bool, device=clock.device)
        else:
            jobs, sites, started = _assign_and_start(jobs, sites)

        start_site = torch.where(started, jobs.site, S)
        start_sums = _site_sum_stacked(
            torch.stack([torch.where(started, jobs.cores, 0), started.int()], dim=-1),
            start_site,
            S,
        )
        used_mem = _site_sum(torch.where(started, jobs.memory, 0.0), start_site, S)
        site_c = jobs.site.clamp_max(S - 1).long()
        share = start_sums[:, 1][site_c].float()

        # ---- 5b. service times, failure sampling -----------------------------
        t_serv = service_time(jobs, sites_serv, site_c, share, share)
        # both per-job draws hash the same counters: one threefry pass, two keys
        bits = _rng.random_bits(torch.stack([k_fail, k_frac]), (J,))
        u_fail = _rng.uniform_from_bits(bits[0])
        # clip (not minimum): unassigned rows carry site == -1
        will_fail = started & (u_fail < sites.fail_rate[jobs.site.clamp(0, S - 1).long()])
        # a failing attempt dies partway through its service time
        frac = _rng.uniform_from_bits(bits[1], minval=0.05, maxval=1.0)
        t_fin = clock + torch.where(will_fail, t_serv * frac, t_serv)

        jobs = jobs._replace(
            state=torch.where(started, RUNNING, jobs.state),
            t_start=torch.where(started, clock, jobs.t_start),
            t_finish=torch.where(started, t_fin, jobs.t_finish),
            will_fail=torch.where(started, will_fail, jobs.will_fail),
        )
        sites = sites._replace(
            free_cores=sites.free_cores - start_sums[:, 0],
            free_memory=sites.free_memory - used_mem,
        )
        pstate = policy.on_step(pstate, jobs, sites, comp, started, clock)

        # ---- 6. halt detection & event log -----------------------------------
        n_started = started.sum()
        n_completed = comp.sum()
        progressed = (n_started > 0) | (n_completed > 0) | arrived.any()
        halted = ~torch.isfinite(t_next) & ~progressed

        log = st.log
        if log_rows > 0 and st.round % monitor_every == 0:
            # the ring is owned by the run's state: rows are written in place
            slot = log.cursor % log_rows
            states = torch.arange(N_STATES, device=clock.device)[:, None]
            log.time[slot] = clock
            log.round_idx[slot] = st.round
            log.counts[slot] = ((jobs.state[None, :] == states) & jobs.valid).sum(-1).int()
            log.n_started[slot] = n_started.int()
            log.n_completed[slot] = n_completed.int()
            log.site_free[slot] = sites.free_cores
            ones = torch.ones((J,), dtype=torch.int32, device=clock.device)
            log.site_queued[slot] = _site_sum(
                ones, torch.where(jobs.state == ASSIGNED, jobs.site, S), S)
            log.site_running[slot] = _site_sum(
                ones, torch.where(jobs.state == RUNNING, jobs.site, S), S)
            log = log._replace(cursor=log.cursor + 1)

        return EngineState(
            clock=clock,
            round=st.round + 1,
            jobs=jobs,
            sites=sites,
            rng=key,
            policy_state=pstate,
            log=log,
            halted=halted,
            ext=st.ext,
        )

    return cond, body


def _finalize(st: EngineState, policy) -> SimResult:
    """End-of-run policy hook plus SimResult assembly; "~"-prefixed carries
    are engine-internal and dropped."""
    pstate = policy.on_end(st.policy_state, st.jobs, st.sites, st.clock)
    ext = {k: v for k, v in st.ext.items() if not k.startswith("~")}
    return SimResult(
        makespan=st.clock,
        rounds=st.round,
        jobs=st.jobs,
        sites=st.sites,
        log=st.log,
        policy_state=pstate,
        ext=ext,
    )


def _check_device(state, device: torch.device, what: str) -> None:
    for name, t in state._asdict().items():
        if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index
        ):
            raise ValueError(f"{what}.{name} lies on {t.device}, the run on {device}")


def simulate(
    jobs0: JobsState,
    sites0: SiteState,
    policy,
    rng: torch.Tensor,
    *,
    max_rounds: int = 100_000,
    horizon: float = float("inf"),
    log_rows: int = 0,
    max_retries: int = 3,
    monitor_every: int = 1,
    quantum: float = 0.0,
    phase_skip: bool = True,
    device="cuda",
) -> SimResult:
    """Run the grid simulation to completion (or ``max_rounds``/``horizon``).

    ``jobs0`` and ``sites0`` must lie on ``device`` (build them with the same
    ``device=``); the key moves there.  ``device="cuda"`` raises without a GPU.

    ``phase_skip`` (default on) skips the assignment and start phases in
    rounds with no QUEUED/ASSIGNED rows, with identical results.  ``quantum``
    > 0 batches all events inside [t*, t* + quantum] into one round.
    ``log_rows`` > 0 keeps a ring of per-round snapshots, written every
    ``monitor_every`` rounds.
    """
    device = resolve_device(device)
    _check_device(jobs0, device, "jobs0")
    _check_device(sites0, device, "sites0")
    st = _init_state(jobs0, sites0, policy, rng.to(device), log_rows)
    cond, body = _round_fns(
        policy,
        max_rounds=max_rounds,
        log_rows=log_rows,
        max_retries=max_retries,
        monitor_every=monitor_every,
        quantum=quantum,
        phase_skip=phase_skip,
    )
    while cond(st, horizon):
        st = body(st)
    return _finalize(st, policy)
