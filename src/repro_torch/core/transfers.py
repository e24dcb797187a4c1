"""FTS-style transfer queues: queued, rate-limited WAN flows.

Without this subsystem the data subsystem prices every WAN stage-in at once:
the round that starts a dataset job folds ``shared_transfer_times`` into its
service time.  Real grids funnel copies through FTS channels with per-link
*active-transfer limits*, and queue wait and link contention decide data
access latency at scale.  This subsystem models that:

- Each directed link ``src -> dst`` (flattened id ``src * S + dst``) owns a
  fixed-shape FIFO ring of job ids (``i32[L, Q]``), an ``active`` counter
  and a ``cap`` (``max_active``).
- When a dataset job starts on a WAN read, the data subsystem *defers* the
  transfer here: the job enters a **staging gate**, RUNNING with
  ``t_finish = inf`` so it leaves the clock's min-reduction; its wake event
  is the transfer's completion, which ``event_times`` contributes.
- Link bandwidth splits equally among the *active* transfers on a link;
  the rest wait in FIFO order.  The active set only changes at rounds, so
  each flow's completion time is a closed form and byte progress integrates
  exactly.
- On completion the remaining compute (+ stage-out + WAN latency) is priced
  into ``t_finish``, cache-on-read replicas land at the destination, and the
  freed slot admits the next queued transfer.

Preempted staging jobs (availability outages) cancel with stamped tickets:
a cancelled queue entry becomes a tombstone that pops for free when it
reaches the head, and a ticket mismatch keeps a re-enqueued retry of the
same job apart from its stale entry.

The per-link counts are integer sums over ``L + 1`` segments (the port's
segment sum at ``S * S + 1 = 90001`` segments at S = 300), and the float
counters sum in XLA's order (``scan.sum_f32``).  The ring takes
``queue_slots`` entries a link; the default, the job capacity, can never
overflow but needs ``2 * S * S * J`` int32 (7.2e10 bytes at S = 300 and
J = 100000), so runs at that scale pass a smaller ``queue_slots`` and rely
on the overflow valve (``n_overflow``).

In an ensemble every field leads with the lane axis (rings ``[K, L, Q]``,
counters ``[K]``): ring reads and job lookups go lane by lane
(``types.take``), the per-link counts of all lanes are one integer segment
sum over ``K * L`` segments, and the counters sum over the last axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import rng as _rng
from .network import link_caps
from .scan import fma_f32, sum_f32
from .types import RUNNING, per_lane, resolve_device, take

INF = float("inf")

# per-transfer status (one slot per job row: a job has at most one in-flight
# transfer, its current stage-in attempt)
T_IDLE, T_QUEUED, T_ACTIVE = 0, 1, 2


class TransferState(NamedTuple):
    """The transfer subsystem's ``EngineState.ext["transfers"]`` slot.

    Link axis ``L = S * S`` over flattened directed links; ring axis ``Q``
    (queue slots a link); transfer axis = the job capacity ``J``.
    """

    # per-link FIFO rings
    queue: torch.Tensor    # i32[L, Q] job ids (-1 = empty slot)
    tickets: torch.Tensor  # i32[L, Q] enqueue ticket stamped into each slot
    head: torch.Tensor     # i32[L] ring read position
    qlen: torch.Tensor     # i32[L] occupied slots from head (tombstones included)
    active: torch.Tensor   # i32[L] transfers moving bytes
    cap: torch.Tensor      # i32[L] max_active a link (FTS channel limit)
    # per-transfer rows (indexed by job row)
    stat: torch.Tensor     # i32[J] T_IDLE / T_QUEUED / T_ACTIVE
    link: torch.Tensor     # i32[J] flattened link id (-1 = none)
    rem: torch.Tensor      # f32[J] remaining bytes
    t_done: torch.Tensor   # f32[J] completion time under the current share (inf
    #                        unless active): the subsystem's event_times source
    resid: torch.Tensor    # f32[J] post-staging service remainder (compute +
    #                        stage-out + WAN latency), priced into t_finish at release
    enq_t: torch.Tensor    # f32[J] enqueue clock
    act_t: torch.Tensor    # f32[J] activation clock
    ticket: torch.Tensor   # i32[J] current enqueue ticket (-1 = none)
    cache: torch.Tensor    # bool[J] materialize a replica at the dst on landing
    # conservation counters (every enqueue ends as done or cancelled)
    n_enq: torch.Tensor       # i32 transfers enqueued (also the ticket counter)
    n_done: torch.Tensor      # i32 transfers completed
    n_cancel: torch.Tensor    # i32 transfers cancelled (staging job preempted)
    n_overflow: torch.Tensor  # i32 ring-full enqueues admitted past the cap
    bytes_enq: torch.Tensor     # f32 bytes enqueued
    bytes_done: torch.Tensor    # f32 bytes of completed transfers (full size)
    bytes_cancel: torch.Tensor  # f32 bytes of cancelled transfers (full size)


def make_transfers(n_sites, job_capacity, *, max_active: int = 4, caps=None,
                   queue_slots: int | None = None, device="cuda") -> TransferState:
    """Build an empty transfer-queue state.

    ``n_sites`` also takes a ``NetworkState`` or ``SiteState``;
    ``job_capacity`` also takes a ``JobsState``.  ``max_active`` is the
    default per-link concurrency cap, refined by ``caps`` (a
    ``{(src, dst): cap}`` mapping or a full ``[S, S]`` matrix, see
    ``network.link_caps``).  ``queue_slots`` defaults to the job capacity,
    which can never overflow.
    """
    S = getattr(n_sites, "n_sites", None) or getattr(n_sites, "capacity", None) or int(n_sites)
    J = getattr(job_capacity, "capacity", None) or int(job_capacity)
    device = resolve_device(device)
    L = S * S
    Q = max(int(queue_slots) if queue_slots is not None else J, 1)

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=device)

    i32, f32 = torch.int32, torch.float32
    return TransferState(
        queue=full((L, Q), -1, i32),
        tickets=full((L, Q), -1, i32),
        head=full((L,), 0, i32),
        qlen=full((L,), 0, i32),
        active=full((L,), 0, i32),
        cap=link_caps(S, max_active, caps, device=device),
        stat=full((J,), T_IDLE, i32),
        link=full((J,), -1, i32),
        rem=full((J,), 0.0, f32),
        t_done=full((J,), INF, f32),
        resid=full((J,), 0.0, f32),
        enq_t=full((J,), 0.0, f32),
        act_t=full((J,), 0.0, f32),
        ticket=full((J,), -1, i32),
        cache=full((J,), False, torch.bool),
        n_enq=full((), 0, i32),
        n_done=full((), 0, i32),
        n_cancel=full((), 0, i32),
        n_overflow=full((), 0, i32),
        bytes_enq=full((), 0.0, f32),
        bytes_done=full((), 0.0, f32),
        bytes_cancel=full((), 0.0, f32),
    )


# --------------------------------------------------------------------------
# queue mechanics (fixed-shape [L, Q] / [J] masked algebra)
# --------------------------------------------------------------------------


def _link_count(mask: torch.Tensor, link: torch.Tensor, L: int) -> torch.Tensor:
    """Per-link count of the True rows -> i32[L] (an integer segment sum over
    the L links; the other rows go to the dropped padding segment)."""
    from .engine import _site_sum

    return _site_sum(mask, torch.where(mask, link, L), L)


def _enqueue(ts: TransferState, want, link, nbytes, resid, cache, clock):
    """Append the ``want`` rows to their links' FIFO rings.

    Same-round enqueuers on one link are ordered by job row, the engine's
    start-order tiebreak.  Returns ``(ts, depth)``, ``depth[J]`` the ring
    entries ahead of each enqueued row.

    Ring-full valve: a row whose link ring has no room (only possible with
    ``queue_slots`` below the job capacity) activates at once, past the
    cap, and ``n_overflow`` counts it.
    """
    from .engine import _segment_exclusive_base

    L, Q = ts.queue.shape[-2:]
    J = want.shape[-1]
    idx = torch.arange(J, dtype=torch.int32, device=want.device)
    lc = link.clamp(0, L - 1)
    seg = torch.where(want, lc, L)
    order = torch.sort(seg, dim=-1, stable=True).indices
    want_o = take(want, order).int()
    incl = _segment_exclusive_base(want_o, take(seg, order), L + 1)
    rank = torch.empty_like(incl).scatter_(-1, order, incl - want_o)
    lcl = lc.long()
    depth = take(ts.qlen, lcl) + rank            # entries ahead at enqueue time
    room = want & (depth < Q)
    slot = torch.remainder(take(ts.head, lcl) + depth, Q)
    # a unique ticket per enqueue: the running counter + the rank this round
    wi = want.int()
    tkt = ts.n_enq[..., None] + (torch.cumsum(wi, -1, dtype=torch.int32) - wi)
    # rows with room write distinct slots (of their lane's rings); the rest
    # go to a spare cell that is cut off (the JAX package's mode="drop")
    cells = ts.queue.numel()
    tgt = lcl * Q + slot
    if tgt.dim() > 1:
        tgt = tgt + torch.arange(0, cells, L * Q, device=tgt.device).view(*tgt.shape[:-1], 1)
    tgt = torch.where(room, tgt, cells)
    queue = torch.cat([ts.queue.reshape(-1), ts.queue.new_empty((1,))])
    queue[tgt] = idx.expand_as(tgt)
    tickets = torch.cat([ts.tickets.reshape(-1), ts.tickets.new_empty((1,))])
    tickets[tgt] = tkt
    ovf = want & ~room
    clock_j = per_lane(clock)
    return ts._replace(
        queue=queue[:cells].view(ts.queue.shape),
        tickets=tickets[:cells].view(ts.queue.shape),
        qlen=ts.qlen + _link_count(room, lc, L),
        active=ts.active + _link_count(ovf, lc, L),
        stat=torch.where(room, T_QUEUED, torch.where(ovf, T_ACTIVE, ts.stat)),
        link=torch.where(want, lc, ts.link),
        rem=torch.where(want, nbytes, ts.rem),
        resid=torch.where(want, resid, ts.resid),
        enq_t=torch.where(want, clock_j, ts.enq_t),
        act_t=torch.where(want, clock_j, ts.act_t),  # re-stamped on admission
        ticket=torch.where(want, tkt, ts.ticket),
        cache=torch.where(want, cache, ts.cache),
        n_enq=ts.n_enq + wi.sum(-1).int(),
        n_overflow=ts.n_overflow + ovf.sum(-1).int(),
        bytes_enq=ts.bytes_enq + sum_f32(torch.where(want, nbytes, 0.0), -1),
    ), depth


def _admit(ts: TransferState, clock) -> TransferState:
    """Pop each link's FIFO into its free ``cap - active`` slots.

    A ring entry is *live* iff the job it names is still T_QUEUED under the
    same ticket; stale entries (cancelled by preemption, perhaps re-enqueued
    under a new ticket) are tombstones and pop for free, even at zero
    budget, so they never wedge a queue.
    """
    from .replicas import _drop_fill

    Q = ts.queue.shape[-1]
    J = ts.stat.shape[-1]
    off = torch.arange(Q, dtype=torch.int32, device=ts.queue.device)
    pos = torch.remainder(ts.head[..., None] + off, Q).long()
    ent = ts.queue.gather(-1, pos)
    tkt = ts.tickets.gather(-1, pos)
    in_q = off < ts.qlen[..., None]
    ec = ent.clamp(0, J - 1).long()
    live = in_q & (ent >= 0) & (take(ts.stat, ec) == T_QUEUED) & (take(ts.ticket, ec) == tkt)
    vcum = torch.cumsum(live.int(), -1, dtype=torch.int32)
    budget = (ts.cap - ts.active).clamp_min(0)[..., None]
    popped = in_q & (vcum <= budget)  # a contiguous head prefix: tombstones ride along
    admit = popped & live
    # every admitted row is written True: repeats give one result
    go = _drop_fill(J, ec.flatten(-2), admit.flatten(-2), True, torch.zeros_like(ts.cache))
    n_pop = popped.sum(-1, dtype=torch.int32)
    return ts._replace(
        head=torch.remainder(ts.head + n_pop, Q),
        qlen=ts.qlen - n_pop,
        active=ts.active + admit.sum(-1, dtype=torch.int32),
        stat=torch.where(go, T_ACTIVE, ts.stat),
        act_t=torch.where(go, per_lane(clock), ts.act_t),
    )


def _rate(ts: TransferState, bw_flat: torch.Tensor) -> torch.Tensor:
    """Each flow's equal share of its link's bandwidth."""
    lc = ts.link.clamp(0, bw_flat.shape[-1] - 1).long()
    return take(bw_flat, lc) / take(ts.active, lc).clamp_min(1).float()


def _reprice(ts: TransferState, bw_flat: torch.Tensor, clock) -> TransferState:
    """Each active flow's completion time under the current equal-share
    split.  The active sets only change at rounds, so this is exact, and it
    is what ``event_times`` reads."""
    t_done = per_lane(clock) + ts.rem / _rate(ts, bw_flat).clamp_min(1e-9)
    return ts._replace(t_done=torch.where(ts.stat == T_ACTIVE, t_done, INF))


# --------------------------------------------------------------------------
# Subsystem hooks
# --------------------------------------------------------------------------


def _tr_init(sub, state0, jobs, sites):
    if jobs is not None and state0.stat.shape[-1] != jobs.capacity:
        raise ValueError(
            f"TransferState sized for {state0.stat.shape[-1]} jobs, got capacity "
            f"{jobs.capacity}; build with make_transfers(S, jobs)")
    if sites is not None and state0.cap.shape[-1] != sites.capacity ** 2:
        raise ValueError(
            f"TransferState has {state0.cap.shape[-1]} links, expected S*S = "
            f"{sites.capacity ** 2}")
    return state0


def _tr_event_times(sub, ctx):
    """Transfer completions join the round clock: the staging gate's wake."""
    return ctx.ext["transfers"].t_done.amin(-1)


def _tr_on_completions(sub, ctx):
    """Engine step 2b: integrate byte progress over the elapsed interval,
    release jobs whose transfer landed (pricing the post-staging remainder
    into ``t_finish``), cancel transfers whose staging job was preempted,
    then admit queued flows into the freed slots."""
    from .datapolicies import land_deferred

    ts: TransferState = ctx.ext["transfers"]
    dext = ctx.ext.get("data")
    if dext is None:
        return
    jobs, S, J = ctx.jobs, ctx.S, ctx.J
    L = S * S
    bw_flat = dext.network.bw.flatten(-2)
    lc = ts.link.clamp(0, L - 1)
    act = ts.stat == T_ACTIVE
    clock_j = per_lane(ctx.clock)

    # byte progress: the active set (and so each flow's share) was constant
    # over [clock_prev, clock].  XLA contracts rem - rate * dt into one
    # fused multiply-add
    dt = per_lane((ctx.clock - ctx.clock_prev).clamp_min(0.0))
    rem = torch.where(act, fma_f32(-_rate(ts, bw_flat), dt, ts.rem).clamp_min(0.0), ts.rem)

    # a staging job that availability moved out of RUNNING in this same hook
    # phase (availability runs first) abandons its transfer; its ring entry
    # becomes a tombstone
    staging = jobs.state == RUNNING
    fin = act & (ts.t_done <= clock_j) & staging
    cancel = (ts.stat > T_IDLE) & ~staging

    # fault injection (only with the faults subsystem): a would-complete
    # flow may fail with its link's probability before release; failed rows
    # clear like cancels but count on the fault ledger
    # (n_enq == n_done + n_cancel + faults.n_xfer_fail + in flight)
    xfail = None
    if "faults" in ctx.ext:
        from .faults import inject_transfer_failures

        fin, xfail, jobs = inject_transfer_failures(ctx, ts, fin, jobs)

    # release: price the post-staging remainder into t_finish.  The engine's
    # partial-failure fraction was consumed by the staging gate's inf, so a
    # failing attempt draws it again from the subsystem's own key stream
    frac = _rng.uniform(ctx.subkey("transfers"), (J,), minval=0.05, maxval=1.0)
    t_rest = torch.where(jobs.will_fail, ts.resid * frac, ts.resid)
    ctx.jobs = jobs._replace(
        t_finish=torch.where(fin, clock_j + t_rest, jobs.t_finish),
        xfer_time=torch.where(fin, clock_j - ts.act_t, jobs.xfer_time),
        xfer_wait=torch.where(fin, ts.act_t - ts.enq_t, jobs.xfer_wait),
    )
    # deferred landing: the replica and the WAN counters at the destination
    ctx.ext["data"] = land_deferred(dext, ctx.jobs, fin, ts.cache, ctx.clock, S)

    freed = fin | (cancel & act)
    clear = fin | cancel
    if xfail is not None:
        freed, clear = freed | xfail, clear | xfail
    ts = ts._replace(
        stat=torch.where(clear, T_IDLE, ts.stat),
        rem=torch.where(clear, 0.0, rem),
        t_done=torch.where(clear, INF, ts.t_done),
        active=ts.active - _link_count(freed, lc, L),
        n_done=ts.n_done + fin.sum(-1).int(),
        n_cancel=ts.n_cancel + cancel.sum(-1).int(),
        bytes_done=ts.bytes_done + sum_f32(torch.where(fin, jobs.xfer_bytes, 0.0), -1),
        bytes_cancel=ts.bytes_cancel + sum_f32(torch.where(cancel, jobs.xfer_bytes, 0.0), -1),
    )
    ts = _admit(ts, ctx.clock)
    ctx.ext["transfers"] = _reprice(ts, bw_flat, ctx.clock)
    ctx.progressed = ctx.progressed | fin.any(-1) | cancel.any(-1)


def _tr_on_start(sub, ctx):
    """Engine step 5b, after the data subsystem: divert this round's WAN
    reads (staged in ``ctx.scratch["transfers"]``) into the link queues and
    hold the jobs in the staging gate (``t_serv = inf``)."""
    ts: TransferState = ctx.ext["transfers"]
    dext = ctx.ext.get("data")
    if dext is None:
        return
    sc = ctx.scratch.get("transfers")
    if sc is not None:
        xfer = sc["xfer"]
        # the staging gate: an inf service time keeps t_finish = inf, out of
        # the clock's min-reduction until the transfer lands
        ctx.t_serv = torch.where(xfer, INF, ctx.t_serv)
        ts, depth = _enqueue(ts, xfer, sc["link"], sc["bytes"], sc["resid"], sc["cache"],
                             ctx.clock)
        ctx.jobs = ctx.jobs._replace(
            xfer_qdepth=torch.where(xfer, depth, ctx.jobs.xfer_qdepth),
            xfer_wait=torch.where(xfer, 0.0, ctx.jobs.xfer_wait),
        )
    # newly enqueued flows activate now if their link has a free slot: an
    # uncontended transfer must create its own wake event this same round
    ts = _admit(ts, ctx.clock)
    ctx.ext["transfers"] = _reprice(ts, dext.network.bw.flatten(-2), ctx.clock)


def _tr_log_spec(sub, ts: TransferState, jobs, sites):
    zeros = torch.zeros(ts.cap.shape, dtype=torch.int32, device=ts.cap.device)
    return {"link_active": zeros, "link_queued": zeros}


def _tr_log_columns(sub, ctx, write):
    ts: TransferState = ctx.ext["transfers"]
    L = ts.cap.shape[-1]
    queued = _link_count(ts.stat == T_QUEUED, ts.link.clamp(0, L - 1), L)
    return {"link_active": ts.active, "link_queued": queued}


def _tr_pad_jobs(sub, ts: TransferState, old_cap: int, new_cap: int) -> TransferState:
    n = new_cap - old_cap
    fills = {
        "stat": T_IDLE, "link": -1, "rem": 0.0, "t_done": INF, "resid": 0.0,
        "enq_t": 0.0, "act_t": 0.0, "ticket": -1, "cache": False,
    }

    def pad(x, fill):
        return torch.cat([x, torch.full(x.shape[:-1] + (n,), fill, dtype=x.dtype,
                                        device=x.device)], -1)

    out = ts._replace(**{k: pad(getattr(ts, k), v) for k, v in fills.items()})
    # default-sized rings (Q == the job capacity) grow with it, keeping the
    # no-overflow guarantee; explicit queue_slots are left alone (a pre-run
    # ring is empty, so widening never disturbs ring arithmetic)
    if ts.queue.shape[-1] == old_cap:
        out = out._replace(queue=pad(ts.queue, -1), tickets=pad(ts.tickets, -1))
    return out


def transfers_subsystem():
    """The transfer-queue engine plugin.  Its initial state is a
    ``TransferState`` from ``make_transfers``; it needs the data subsystem
    (which owns the network matrices and the replica catalog)."""
    from .subsystems import Subsystem

    return Subsystem(
        name="transfers",
        init=_tr_init,
        event_times=_tr_event_times,
        on_completions=_tr_on_completions,
        on_start=_tr_on_start,
        log_spec=_tr_log_spec,
        log_columns=_tr_log_columns,
        pad_jobs=_tr_pad_jobs,
    )
