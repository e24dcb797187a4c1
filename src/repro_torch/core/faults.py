"""Fault injection and recovery: the chaos channels of the event engine.

The fifth built-in ``Subsystem``, hook for hook the JAX package's, with four
channels in one fixed-shape ``FaultState``:

1. **Transfer failures**: each in-flight FTS flow fails at its
   would-complete event with a per-link probability, drawn from the
   subsystem's own key stream (``ctx.subkey("faults")``).  A failed flow
   re-enqueues after ``xfer_backoff * 2^attempt`` seconds; past
   ``max_xfer_attempts`` the staging job fails its attempt and takes the
   engine's retry path.
2. **Resubmission backoff**: a job resubmitted after a failed attempt goes
   back to PENDING with ``arrival = clock + job_backoff * 2^(retries-1)``.
   A base of 0 (the default) turns the channel off statically; when on, it
   moves arrivals, so the engine drops its packed start-order key
   (``FaultsConfig.mutates_arrival``).
3. **Replica loss**: a calendar of ``(t, dataset, site)`` events drops
   non-origin replicas from the catalog; pinned origins never drop.
4. **Circuit breaker**: a per-site EWMA failure score trips the site out of
   assignment for a cooldown, then reopens half-open to exactly one probe
   job; the probe's success closes the breaker, its failure re-trips it.

Walltime kills ride along: a RUNNING job whose ``t_start + walltime`` has
passed is preempted and retried (or failed).  Every channel's next edge
joins the engine's clock min-reduction, so fault dynamics land on exact
event rounds.  A default ``make_faults`` state changes no result.

The bits follow XLA on the CPU:

- ``2^k`` is a table of XLA's ``exp2`` results (``_EXP2_BITS``): XLA
  computes ``exp(0.693147182 * k)``, which misses ``2^k`` at k = 13, 15, ...
  and overflows to ``inf`` from k = 128.  ``torch.exp2`` is exact, and
  ``torch.exp`` of the same product differs from XLA's at k = 32.
- XLA contracts ``clock + base * 2^k`` and the EWMA
  ``score + alpha * (frac - score)`` into fused multiply-adds (``fma_f32``).
- The float sums over jobs and over the catalog's datasets add in XLA's
  order (``scan.sum_f32``); the per-site kill sums go through the engine's
  ``_site_sum``, the segment-sum kernel on the card.
- Scatters that may name one cell twice are written so that the order
  cannot matter: the half-open probe keeps the highest job row, as XLA's
  scatter does, through ``scatter_reduce("amax")``; the loss hits fill one
  value.

In an ensemble every field leads with the lane axis (the run-constant
scalars become ``[K]``): the counters sum over the last axis, progress flags
are per lane (``.any(-1)``), lookups go lane by lane (``types.take``), and
the channel flags are one host read of the stacked state ("any lane"), the
JAX package's own rule.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rng as _rng
from .scan import fma_f32, sum_f32
from .types import ASSIGNED, FAILED, PENDING, QUEUED, RUNNING, per_lane, resolve_device, take

INF = float("inf")

# circuit-breaker states (per site)
BL_CLOSED, BL_TRIPPED, BL_HALF_OPEN = 0, 1, 2

# XLA's float32 exp2(k) on the CPU for k = 0..127, as bit patterns; from
# k = 128 on it is inf.  tests/test_torch_faults.py regenerates the table
# with jnp.exp2 and compares it bit for bit.
_EXP2_BITS = (
    0x3F800000, 0x40000000, 0x40800000, 0x41000000, 0x41800000, 0x42000000,
    0x42800000, 0x43000000, 0x43800000, 0x44000000, 0x44800000, 0x45000000,
    0x45800000, 0x46000004, 0x46800000, 0x46FFFFF8, 0x47800000, 0x48000004,
    0x48800000, 0x48FFFFF9, 0x49800000, 0x4A000004, 0x4A800000, 0x4AFFFFF9,
    0x4B800000, 0x4C000004, 0x4C800008, 0x4CFFFFF9, 0x4D800000, 0x4E000004,
    0x4E7FFFF1, 0x4EFFFFF9, 0x4F800001, 0x50000005, 0x50800009, 0x50FFFFF9,
    0x51800001, 0x52000005, 0x527FFFF1, 0x52FFFFF9, 0x53800001, 0x54000005,
    0x54800009, 0x54FFFFF9, 0x55800001, 0x56000005, 0x567FFFF1, 0x5700000D,
    0x57800001, 0x57FFFFEA, 0x58800009, 0x58FFFFFA, 0x59800011, 0x5A000005,
    0x5A7FFFF2, 0x5B00000D, 0x5B800001, 0x5BFFFFEA, 0x5C800009, 0x5CFFFFFA,
    0x5D7FFFE2, 0x5E000005, 0x5E7FFFF2, 0x5F00000D, 0x5F800001, 0x5FFFFFEA,
    0x60800009, 0x60FFFFFA, 0x61800011, 0x62000005, 0x627FFFF2, 0x6300000D,
    0x63800001, 0x63FFFFEA, 0x64800009, 0x64FFFFFA, 0x657FFFE2, 0x66000005,
    0x667FFFF2, 0x6700000D, 0x67800001, 0x67FFFFEB, 0x68800009, 0x68FFFFFB,
    0x69800011, 0x6A000005, 0x6A7FFFF3, 0x6B00000D, 0x6B800001, 0x6BFFFFEB,
    0x6C800009, 0x6CFFFFFB, 0x6D7FFFE3, 0x6DFFFFCB, 0x6E80001A, 0x6F00000E,
    0x6F800002, 0x6FFFFFEB, 0x707FFFD3, 0x7100001E, 0x71800012, 0x72000006,
    0x727FFFF3, 0x72FFFFDB, 0x73800022, 0x74000016, 0x7480000A, 0x74FFFFFB,
    0x757FFFE3, 0x75FFFFCB, 0x7680001A, 0x7700000E, 0x77800002, 0x77FFFFEC,
    0x787FFFD4, 0x7900001E, 0x79800012, 0x7A000006, 0x7A7FFFF4, 0x7AFFFFDC,
    0x7B7FFFC4, 0x7C000016, 0x7C80000A, 0x7CFFFFFC, 0x7D7FFFE4, 0x7DFFFFCC,
    0x7E80001A, 0x7F00000E,
    0x7F800000,  # inf: every k >= 128
)


_exp2_tables: dict = {}



def exp2_xla(k: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2(k.astype(float32))`` for whole ``k >= 0`` with XLA's bits
    on the CPU (``_EXP2_BITS``).  The table is copied to a device once."""
    table = _exp2_tables.get(k.device)
    if table is None:
        bits = np.array(_EXP2_BITS, np.uint32).view(np.float32)
        table = _exp2_tables[k.device] = torch.from_numpy(bits).to(k.device)
    return table[k.long().clamp(0, len(_EXP2_BITS) - 1)]


class FaultsConfig(NamedTuple):
    """Run-constant channel flags, read once from the initial state on the
    host by ``faults_subsystem`` so that channels that are off run no code.

    - ``job_backoff``: channel 2 moves ``jobs.arrival``, which the engine's
      packed start-order key assumes constant; the engine reads
      ``mutates_arrival`` and ranks with the general sort instead.
    - ``blacklist``: the circuit breaker widens the sparse path's ``[1, S]``
      site mask to a ``[J, S]`` probe gate; off when the threshold is inf.
    """

    job_backoff: bool = False
    blacklist: bool = False

    @property
    def mutates_arrival(self) -> bool:
        return self.job_backoff


class FaultState(NamedTuple):
    """The faults subsystem's ``EngineState.ext["faults"]`` slot.

    Link axis ``L = S * S`` (flattened directed links, as in
    ``TransferState``); job axis ``J``; site axis ``S``; loss-calendar axis
    ``E`` (inf-padded).
    """

    # channel 1: transfer failures and their backoff re-enqueue
    link_fail_p: torch.Tensor        # f32[L] per-link failure probability
    xfer_backoff: torch.Tensor       # f32[] backoff base (s); delay = base * 2^attempt
    max_xfer_attempts: torch.Tensor  # i32[] failures before the job attempt fails
    attempt: torch.Tensor            # i32[J] failures of the current stage-in
    retry_at: torch.Tensor           # f32[J] backoff wake time (inf = none pending)
    # channel 2: resubmission backoff (on iff base > 0, a static flag)
    job_backoff: torch.Tensor        # f32[] base (s); delay = base * 2^(retries-1)
    backoff_wait: torch.Tensor       # f32[J] cumulative scheduled backoff a job
    # walltime kills
    walltime: torch.Tensor           # f32[J] walltime limit a job (inf = none)
    # channel 3: replica-loss calendar (sorted by time)
    loss_t: torch.Tensor             # f32[E] event times (inf = padding)
    loss_d: torch.Tensor             # i32[E] dataset ids
    loss_s: torch.Tensor             # i32[E] site ids
    loss_done: torch.Tensor          # bool[E] already applied
    # channel 4: circuit breaker a site
    bl_threshold: torch.Tensor       # f32[] EWMA trip level (inf = off)
    bl_alpha: torch.Tensor           # f32[] EWMA smoothing factor
    bl_cooldown: torch.Tensor        # f32[] tripped -> half-open delay (s)
    score: torch.Tensor              # f32[S] EWMA failure fraction
    bl_state: torch.Tensor           # i32[S] BL_CLOSED / BL_TRIPPED / BL_HALF_OPEN
    bl_until: torch.Tensor           # f32[S] cooldown expiry (inf unless tripped)
    probe_job: torch.Tensor          # i32[S] half-open probe job row (-1 = none)
    seen_failed: torch.Tensor        # i32[S] sites.n_failed at the last scoring
    seen_done: torch.Tensor          # i32[S] sites.n_finished at the last scoring
    # counters (ledger: transfers.n_enq == n_done + n_cancel + n_xfer_fail + in flight)
    n_xfer_fail: torch.Tensor        # i32 injected transfer failures
    n_xfer_retry: torch.Tensor       # i32 backoff re-enqueues that fired
    n_xfer_exhaust: torch.Tensor     # i32 stage-ins that ran out of attempts
    n_kills: torch.Tensor            # i32 walltime kills
    n_lost_replicas: torch.Tensor    # i32 replicas dropped by loss events
    n_bl_trips: torch.Tensor         # i32 breaker trips (probe re-trips included)
    n_probes: torch.Tensor           # i32 half-open probe jobs admitted
    time_lost: torch.Tensor          # f32 wall seconds of failed or killed attempts


def make_faults(
    n_sites,
    job_capacity,
    *,
    link_fail_p=0.0,
    xfer_backoff: float = 60.0,
    max_xfer_attempts: int = 3,
    job_backoff: float = 0.0,
    walltime=None,
    replica_loss=(),
    blacklist_threshold: float | None = None,
    blacklist_alpha: float = 0.25,
    blacklist_cooldown: float = 3600.0,
    device="cuda",
) -> FaultState:
    """Build a fault state; every channel is off by default, and the default
    state changes no result against ``faults=None``.

    ``n_sites`` also takes a ``SiteState`` or ``NetworkState``,
    ``job_capacity`` a ``JobsState``.

    - ``link_fail_p``: a scalar, an ``[S, S]`` matrix or a ``{(src, dst): p}``
      mapping of per-link transfer failure probabilities in ``[0, 1]``.
    - ``xfer_backoff`` / ``max_xfer_attempts``: the transfer retry schedule
      (delay ``base * 2^attempt``; past the cap the job attempt fails).
    - ``job_backoff``: resubmission backoff base in seconds (0 = resubmit in
      the same round).
    - ``walltime``: seconds, scalar or per job ``[J]`` (None = no limit).
    - ``replica_loss``: ``(t, dataset, site)`` tuples, or dicts with those
      keys (``workload.replica_loss_calendar`` samples them).
    - ``blacklist_threshold``: the EWMA trip level in ``(0, 1]``; None turns
      the circuit breaker off.
    """
    device = resolve_device(device)
    S = getattr(n_sites, "n_sites", None) or getattr(n_sites, "capacity", None) or int(n_sites)
    J = getattr(job_capacity, "capacity", None) or int(job_capacity)
    L = S * S

    if isinstance(link_fail_p, dict):
        mat = np.zeros((S, S), np.float32)
        for (src, dst), p in link_fail_p.items():
            mat[int(src), int(dst)] = float(p)
        p_flat = mat.reshape(L)
    else:
        arr = np.asarray(link_fail_p, np.float32)
        if arr.ndim == 0:
            p_flat = np.full((L,), float(arr), np.float32)
        elif arr.shape == (S, S):
            p_flat = arr.reshape(L)
        else:
            raise ValueError(f"link_fail_p matrix must be [S, S] = [{S}, {S}], got {arr.shape}")
    if np.any((p_flat < 0) | (p_flat > 1)):
        raise ValueError("link_fail_p probabilities must lie in [0, 1]")

    if walltime is None:
        wt = np.full((J,), np.inf, np.float32)
    else:
        arr = np.asarray(walltime, np.float32)
        wt = np.full((J,), float(arr), np.float32) if arr.ndim == 0 else arr
        if wt.shape != (J,):
            raise ValueError(f"walltime must be scalar or shape ({J},), got {arr.shape}")

    events = []
    for ev in replica_loss:
        if isinstance(ev, dict):
            events.append((float(ev["t"]), int(ev["dataset"]), int(ev["site"])))
        else:
            t, d, s = ev
            events.append((float(t), int(d), int(s)))
    events.sort()
    E = max(len(events), 1)
    loss_t = np.full((E,), np.inf, np.float32)
    loss_d = np.full((E,), -1, np.int32)
    loss_s = np.full((E,), -1, np.int32)
    for i, (t, d, s) in enumerate(events):
        if not 0 <= s < S:
            raise ValueError(f"replica_loss site {s} out of range [0, {S})")
        loss_t[i], loss_d[i], loss_s[i] = t, d, s

    thresh = np.inf if blacklist_threshold is None else float(blacklist_threshold)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return FaultState(
        link_fail_p=f32(p_flat),
        xfer_backoff=f32(xfer_backoff),
        max_xfer_attempts=i32(max_xfer_attempts),
        attempt=i32(np.zeros(J)),
        retry_at=f32(np.full(J, np.inf)),
        job_backoff=f32(job_backoff),
        backoff_wait=f32(np.zeros(J)),
        walltime=f32(wt),
        loss_t=f32(loss_t),
        loss_d=i32(loss_d),
        loss_s=i32(loss_s),
        loss_done=torch.zeros((E,), dtype=torch.bool, device=device),
        bl_threshold=f32(thresh),
        bl_alpha=f32(blacklist_alpha),
        bl_cooldown=f32(blacklist_cooldown),
        score=f32(np.zeros(S)),
        bl_state=i32(np.zeros(S)),
        bl_until=f32(np.full(S, np.inf)),
        probe_job=i32(np.full(S, -1)),
        seen_failed=i32(np.zeros(S)),
        seen_done=i32(np.zeros(S)),
        n_xfer_fail=i32(0),
        n_xfer_retry=i32(0),
        n_xfer_exhaust=i32(0),
        n_kills=i32(0),
        n_lost_replicas=i32(0),
        n_bl_trips=i32(0),
        n_probes=i32(0),
        time_lost=f32(0.0),
    )


# --------------------------------------------------------------------------
# channel 1, called from transfers._tr_on_completions
# --------------------------------------------------------------------------


def inject_transfer_failures(ctx, ts, fin, jobs):
    """Fail would-complete flows with their link's probability; schedule
    the backoff retries or, past the attempt cap, fail the staging job's
    attempt.

    The transfer subsystem calls this before it releases ``fin`` rows, so a
    failed flow never prices ``t_finish``, lands a replica or counts as done.
    Returns ``(fin', xfail, jobs')``: the surviving release mask, the
    injected failures (the caller clears their rows and frees their link
    slots; each counts in ``n_xfer_fail``), and the jobs with exhausted
    attempts routed onto the engine's retry path."""
    fs: FaultState = ctx.ext["faults"]
    J, L = ctx.J, ctx.S * ctx.S
    clock_j = per_lane(ctx.clock)
    u = _rng.uniform(ctx.subkey("faults"), (J,))
    xfail = fin & (u < take(fs.link_fail_p, ts.link.clamp(0, L - 1).long()))
    nxt = fs.attempt + 1
    exhaust = xfail & (nxt >= per_lane(fs.max_xfer_attempts))
    retry = xfail & ~exhaust
    e = exp2_xla(fs.attempt)
    delay = per_lane(fs.xfer_backoff) * e
    ctx.ext["faults"] = fs._replace(
        attempt=torch.where(exhaust, 0, torch.where(retry, nxt, fs.attempt)),
        # clock + base * 2^attempt: one fused multiply-add in XLA
        retry_at=torch.where(retry, fma_f32(e, per_lane(fs.xfer_backoff), clock_j),
                             torch.where(exhaust, INF, fs.retry_at)),
        backoff_wait=fs.backoff_wait + torch.where(retry, delay, 0.0),
        n_xfer_fail=fs.n_xfer_fail + xfail.sum(-1).int(),
        n_xfer_exhaust=fs.n_xfer_exhaust + exhaust.sum(-1).int(),
    )
    # out of attempts: the job leaves the staging gate as a failing attempt,
    # which the next round's completion step retires through the resubmit path
    jobs = jobs._replace(
        will_fail=jobs.will_fail | exhaust,
        t_finish=torch.where(exhaust, clock_j, jobs.t_finish),
    )
    ctx.progressed = ctx.progressed | xfail.any(-1)
    return fin & ~xfail, xfail, jobs


# --------------------------------------------------------------------------
# subsystem hooks
# --------------------------------------------------------------------------


def _fl_init(sub, state0, jobs, sites):
    if jobs is not None and state0.attempt.shape[-1] != jobs.capacity:
        raise ValueError(
            f"FaultState sized for {state0.attempt.shape[-1]} jobs, got "
            f"capacity {jobs.capacity}; build with make_faults(S, jobs)")
    if sites is not None and state0.score.shape[-1] != sites.capacity:
        raise ValueError(
            f"FaultState sized for {state0.score.shape[-1]} sites, "
            f"got capacity {sites.capacity}")
    return state0


def _fl_validate(sub, state0, jobs, sites):
    if sites is not None:
        S = sites.capacity
        if state0.link_fail_p.shape[-1] != S * S:
            raise ValueError(
                f"FaultState has {state0.link_fail_p.shape[-1]} links, expected S*S = {S * S}")
    if jobs is not None and state0.walltime.shape[-1] != jobs.capacity:
        raise ValueError(
            f"FaultState.walltime sized for {state0.walltime.shape[-1]} jobs, "
            f"got capacity {jobs.capacity}")


def _fl_event_times(sub, ctx):
    """Backoff wake-ups, loss events, cooldown expiries and walltime
    deadlines join the round clock: fault dynamics are exact events."""
    fs: FaultState = ctx.ext["faults"]
    t = torch.minimum(fs.retry_at.amin(-1), fs.bl_until.amin(-1))
    t = torch.minimum(t, torch.where(fs.loss_done, INF, fs.loss_t).amin(-1))
    kill = torch.where(ctx.jobs.state == RUNNING, ctx.jobs.t_start + fs.walltime, INF)
    return torch.minimum(t, kill.amin(-1))


def _fl_on_completions(sub, ctx):
    """Engine step 2b (last of the built-ins): walltime kills, resubmission
    backoff, transfer-retry wake-ups, breaker scoring and transitions, and
    replica-loss events."""
    from .engine import _site_sum

    fs: FaultState = ctx.ext["faults"]
    cfg: FaultsConfig = sub.config or FaultsConfig()
    jobs, sites, S, J = ctx.jobs, ctx.sites, ctx.S, ctx.J
    clock = ctx.clock
    clock_j = per_lane(clock)   # over the job (or site) rows

    # ---- time lost to this round's failed attempts -----------------------
    lost = sum_f32(torch.where(ctx.failed_now, (clock_j - jobs.t_start).clamp_min(0.0), 0.0), -1)

    # ---- channel 2: resubmission backoff ----------------------------------
    # rows the engine just requeued (failed_now & QUEUED; availability
    # preemptions are not in failed_now) go back to PENDING with a later
    # arrival, which the engine's arrival min-reduction wakes
    if cfg.job_backoff:
        resub = ctx.failed_now & (jobs.state == QUEUED)
        e = exp2_xla((jobs.retries - 1).clamp_min(0))
        jobs = jobs._replace(
            state=torch.where(resub, PENDING, jobs.state),
            arrival=torch.where(resub, fma_f32(e, per_lane(fs.job_backoff), clock_j), jobs.arrival),
        )
        fs = fs._replace(
            backoff_wait=fs.backoff_wait + torch.where(resub, per_lane(fs.job_backoff) * e, 0.0))

    # ---- walltime kills ---------------------------------------------------
    # completions already retired t_finish <= clock, so a job finishing at
    # its deadline finishes; staging jobs (t_finish = inf) are killable too
    killed = (jobs.state == RUNNING) & (jobs.t_start + fs.walltime <= clock_j)
    kill_resub = killed & (jobs.retries < ctx.max_retries)
    kill_fail = killed & ~kill_resub
    kill_site = torch.where(killed, jobs.site, S)
    if cfg.job_backoff:
        ke = exp2_xla(jobs.retries)
        new_state = torch.where(kill_resub, PENDING,
                                torch.where(kill_fail, FAILED, jobs.state))
        new_arrival = torch.where(kill_resub, fma_f32(ke, per_lane(fs.job_backoff), clock_j),
                                  jobs.arrival)
        fs = fs._replace(
            backoff_wait=fs.backoff_wait + torch.where(kill_resub, per_lane(fs.job_backoff) * ke,
                                                       0.0))
    else:
        new_state = torch.where(kill_resub, QUEUED, torch.where(kill_fail, FAILED, jobs.state))
        new_arrival = jobs.arrival
    jobs = jobs._replace(
        state=new_state,
        arrival=new_arrival,
        retries=jobs.retries + kill_resub.int(),
        site=torch.where(kill_resub, -1, jobs.site),
        t_finish=torch.where(kill_resub, INF, torch.where(kill_fail, clock_j, jobs.t_finish)),
        preempted=jobs.preempted + killed.int(),
    )
    kill_sums = _site_sum(torch.where(killed, jobs.cores, 0), kill_site, S)
    sites = sites._replace(
        free_cores=sites.free_cores + kill_sums,
        free_memory=sites.free_memory
        + _site_sum(torch.where(killed, jobs.memory, 0.0), kill_site, S),
    )
    lost = lost + sum_f32(torch.where(killed, (clock_j - jobs.t_start).clamp_min(0.0), 0.0), -1)
    fs = fs._replace(
        n_kills=fs.n_kills + killed.sum(-1).int(),
        time_lost=fs.time_lost + lost,
    )
    ctx.progressed = ctx.progressed | killed.any(-1)

    # ---- channel 1: transfer retries and the killed jobs' cancels ---------
    if "transfers" in ctx.ext:
        from .transfers import T_ACTIVE, T_IDLE, _admit, _enqueue, _link_count, _reprice

        ts = ctx.ext["transfers"]
        dext = ctx.ext.get("data")
        L = S * S
        # a killed staging job abandons its flow now (the transfer
        # subsystem's own cancel sweep ran before this hook)
        tr = killed & (ts.stat > T_IDLE)
        ts = ts._replace(
            stat=torch.where(tr, T_IDLE, ts.stat),
            rem=torch.where(tr, 0.0, ts.rem),
            t_done=torch.where(tr, INF, ts.t_done),
            active=ts.active - _link_count(tr & (ts.stat == T_ACTIVE), ts.link.clamp(0, L - 1), L),
            n_cancel=ts.n_cancel + tr.sum(-1).int(),
            bytes_cancel=ts.bytes_cancel + sum_f32(torch.where(tr, jobs.xfer_bytes, 0.0), -1),
        )
        # a pending retry whose job left the staging gate (killed, preempted,
        # cancelled or exhausted) is dropped: its failure is on the ledger
        orphan = torch.isfinite(fs.retry_at) & (jobs.state != RUNNING)
        due = (fs.retry_at <= clock_j) & (jobs.state == RUNNING)
        # backoff over: the whole transfer restarts as a new ledger entry on
        # the same link (resid, cache and link survive in the transfer rows)
        ts, _ = _enqueue(ts, due, ts.link, jobs.xfer_bytes, ts.resid, ts.cache, clock)
        fs = fs._replace(
            retry_at=torch.where(due | orphan, INF, fs.retry_at),
            attempt=torch.where(orphan, 0, fs.attempt),
            n_xfer_retry=fs.n_xfer_retry + due.sum(-1).int(),
        )
        if dext is not None:
            ts = _admit(ts, clock)
            ts = _reprice(ts, dext.network.bw.flatten(-2), clock)
        ctx.ext["transfers"] = ts
        ctx.progressed = ctx.progressed | due.any(-1) | tr.any(-1)

    # ---- channel 4: breaker scoring and transitions -----------------------
    if cfg.blacklist:
        kills_per_site = _site_sum(killed.int(), kill_site, S)
        d_fail = (sites.n_failed - fs.seen_failed) + kills_per_site
        d_done = sites.n_finished - fs.seen_done
        n_ev = d_fail + d_done
        frac = d_fail.float() / n_ev.clamp_min(1).float()
        # score + alpha * (frac - score): one fused multiply-add in XLA
        score = torch.where(n_ev > 0, fma_f32(frac - fs.score, per_lane(fs.bl_alpha), fs.score),
                            fs.score)
        closed = fs.bl_state == BL_CLOSED
        tripped = fs.bl_state == BL_TRIPPED
        half = fs.bl_state == BL_HALF_OPEN
        trip = closed & (score >= per_lane(fs.bl_threshold))
        expire = tripped & (fs.bl_until <= clock_j)
        # half-open probe resolution (the states are disjoint, so the masks are)
        pj = fs.probe_job.clamp(0, J - 1).long()
        has = half & (fs.probe_job >= 0)
        p_succ = has & take(ctx.done_now, pj)
        p_fail = has & (take(ctx.failed_now, pj) | take(killed, pj))
        p_gone = has & ~p_succ & ~p_fail & (
            take(jobs.site, pj) != torch.arange(S, device=pj.device))
        retrip = trip | p_fail
        fs = fs._replace(
            score=torch.where(p_succ, 0.0, score),
            bl_state=torch.where(
                retrip, BL_TRIPPED,
                torch.where(expire, BL_HALF_OPEN, torch.where(p_succ, BL_CLOSED, fs.bl_state))),
            bl_until=torch.where(retrip, clock_j + per_lane(fs.bl_cooldown),
                                 torch.where(expire | p_succ, INF, fs.bl_until)),
            probe_job=torch.where(expire | p_succ | p_fail | p_gone, -1, fs.probe_job),
            seen_failed=sites.n_failed,
            seen_done=sites.n_finished,
            n_bl_trips=fs.n_bl_trips + retrip.sum(-1).int(),
        )
        # jobs queued at a newly tripped site bounce back to the server (no
        # attempt lost, no retry), so the half-open window admits the probe
        # and not a backlog
        bounce = (jobs.state == ASSIGNED) & take(trip, jobs.site.clamp(0, S - 1).long())
        jobs = jobs._replace(
            state=torch.where(bounce, QUEUED, jobs.state),
            site=torch.where(bounce, -1, jobs.site),
        )
        ctx.progressed = (ctx.progressed | retrip.any(-1) | expire.any(-1) | p_succ.any(-1)
                          | bounce.any(-1))

    # ---- channel 3: replica-loss calendar ---------------------------------
    due_loss = ~fs.loss_done & (fs.loss_t <= clock_j)
    dext = ctx.ext.get("data")
    if dext is not None:
        from .replicas import _col_bytes, _drop_fill

        rep = dext.replicas
        D = rep.size.shape[-1]
        cell = fs.loss_d.clamp(0, D - 1) * S + fs.loss_s.clamp(0, S - 1)
        hit = _drop_fill(D * S, cell, due_loss, True, torch.zeros_like(rep.present))
        org = rep.origin.clamp(0, S - 1)
        is_origin = ((torch.arange(S, device=org.device) == org[..., None])
                     & (rep.origin >= 0)[..., None])
        dropped = hit & rep.present & ~is_origin  # pinned origins never drop
        ctx.ext["data"] = dext._replace(
            replicas=rep._replace(
                present=rep.present & ~dropped,
                disk_used=rep.disk_used - _col_bytes(dropped, rep.size),
                last_access=torch.where(dropped, -INF, rep.last_access),
            )
        )
        fs = fs._replace(n_lost_replicas=fs.n_lost_replicas + dropped.sum((-2, -1)).int())
        ctx.progressed = ctx.progressed | due_loss.any(-1)
    fs = fs._replace(loss_done=fs.loss_done | due_loss)

    ctx.jobs = jobs
    ctx.sites = sites
    ctx.ext["faults"] = fs


def _fl_pre_assign(sub, ctx):
    """Take tripped sites out of feasibility (and their start budget to 0);
    gate a half-open site to a single probe candidate."""
    cfg: FaultsConfig = sub.config or FaultsConfig()
    if not cfg.blacklist:
        return
    fs: FaultState = ctx.ext["faults"]
    J = ctx.J
    tripped = fs.bl_state == BL_TRIPPED
    probe_ok = (fs.bl_state == BL_HALF_OPEN) & (fs.probe_job < 0)
    # the probe candidate is the lowest queued job row, the engine's
    # start-order tie-break, so the probe is deterministic
    idx = torch.arange(J, dtype=torch.int32, device=tripped.device)
    cand = torch.where(ctx.jobs.state == QUEUED, idx, J).amin(-1)
    # the [J, S] gate widens the sparse path's [1, S] site mask to a mask a
    # job; the engine's candidate gather takes either shape
    gate = (fs.bl_state == BL_CLOSED)[..., None, :] | (
        probe_ok[..., None, :] & (idx[:, None] == cand[..., None, None]))
    ctx.feasible = ctx.feasible & gate
    ctx.start_cores = torch.where(tripped, 0, ctx.start_cores)


def _fl_on_start(sub, ctx):
    """Register half-open probes; reset the transfer-attempt counters of jobs
    entering a new stage-in."""
    fs: FaultState = ctx.ext["faults"]
    cfg: FaultsConfig = sub.config or FaultsConfig()
    if cfg.blacklist:
        S, J = ctx.S, ctx.J
        half_free = (fs.bl_state == BL_HALF_OPEN) & (fs.probe_job < 0)
        ps = ctx.started & take(half_free, ctx.site_c)
        tgt = torch.where(ps, ctx.site_c, S)
        # probe_job.at[tgt].set(arange(J), mode="drop"): XLA keeps the
        # highest row where two probes start at one site in one round
        rows = torch.arange(J, device=tgt.device)
        last = torch.full((*tgt.shape[:-1], S + 1), -1, dtype=torch.int64,
                          device=tgt.device).scatter_reduce(
            -1, tgt, torch.where(ps, rows, -1), reduce="amax")[..., :S]
        fs = fs._replace(
            probe_job=torch.where(last >= 0, last.int(), fs.probe_job),
            n_probes=fs.n_probes + ps.sum(-1).int(),
        )
    sc = ctx.scratch.get("transfers")
    if sc is not None:
        xfer = sc["xfer"]
        fs = fs._replace(
            attempt=torch.where(xfer, 0, fs.attempt),
            retry_at=torch.where(xfer, INF, fs.retry_at),
        )
    ctx.ext["faults"] = fs


def _fl_log_spec(sub, fs: FaultState, jobs, sites):
    dev = fs.score.device
    return {
        "site_fault_score": torch.zeros(fs.score.shape, dtype=torch.float32, device=dev),
        "site_blacklist": torch.zeros(fs.score.shape, dtype=torch.int32, device=dev),
    }


def _fl_log_columns(sub, ctx, write):
    fs: FaultState = ctx.ext["faults"]
    return {"site_fault_score": fs.score, "site_blacklist": fs.bl_state}


def _fl_pad_jobs(sub, fs: FaultState, old_cap: int, new_cap: int) -> FaultState:
    n = new_cap - old_cap
    fills = {"attempt": 0, "retry_at": INF, "backoff_wait": 0.0, "walltime": INF}

    def pad(x, fill):
        return torch.cat([x, torch.full(x.shape[:-1] + (n,), fill, dtype=x.dtype,
                                        device=x.device)], -1)

    return fs._replace(**{k: pad(getattr(fs, k), v) for k, v in fills.items()})


def faults_subsystem(state0: FaultState | None = None, *, job_backoff=None, blacklist=None):
    """The fault-injection engine plugin; its initial state is a
    ``FaultState`` from ``make_faults``.

    The channel flags (``FaultsConfig``) come from one host read of
    ``state0`` when not given."""
    from .subsystems import Subsystem

    if state0 is not None:
        if job_backoff is None:
            job_backoff = bool((state0.job_backoff.cpu() > 0).any())
        if blacklist is None:
            blacklist = bool(torch.isfinite(state0.bl_threshold.cpu()).any())
    cfg = FaultsConfig(job_backoff=bool(job_backoff), blacklist=bool(blacklist))
    return Subsystem(
        name="faults",
        config=cfg,
        init=_fl_init,
        validate=_fl_validate,
        event_times=_fl_event_times,
        on_completions=_fl_on_completions,
        pre_assign=_fl_pre_assign,
        on_start=_fl_on_start,
        log_spec=_fl_log_spec,
        log_columns=_fl_log_columns,
        pad_jobs=_fl_pad_jobs,
    )
