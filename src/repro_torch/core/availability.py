"""Site availability dynamics: downtime, preemption, degradation.

Real grids are never fully up: sites take scheduled maintenance, suffer
outages, and run degraded ("brown-outs").  The JAX package models this as a
fixed-shape calendar of per-site windows, and so does the port:

- ``AvailabilityState`` holds ``f32[S, W]`` window start/end times padded
  with ``inf``, a per-window ``factor`` (0 = full outage, (0,1) = brown-out),
  and a per-window ``preempt`` flag (outage kills running jobs vs. drains).
- ``availability_factor`` reduces the windows covering a time ``t`` to one
  per-site multiplier (most severe window wins).
- ``next_window_edge`` makes window boundaries an event source: the engine's
  clock min-reduction includes the next edge, so rounds land exactly on
  window starts and ends.

Everything here is masked dense algebra over ``[S, W]``.  The subsystem's
three per-site sums a round (freed cores, freed memory, preemptions) go
through the engine's ``_site_sum``: the segment-sum kernel on the card.  In
an ensemble the calendar leads with the lane axis (``[K, S, W]``, times
``[K]``) and every lane reads its own.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .types import ASSIGNED, FAILED, QUEUED, RUNNING, resolve_device, take

INF = float("inf")


class AvailabilityState(NamedTuple):
    """Fixed-capacity per-site downtime/degradation calendar.

    Unused window slots have ``win_start = win_end = inf`` and never match.
    ``win_preempt`` only matters for full outages (``win_factor == 0``):
    True kills the site's running jobs at window entry (they return to
    QUEUED with a retry, PanDA-style), False drains them to completion.
    """

    win_start: torch.Tensor    # f32[S, W] window start times (inf = unused slot)
    win_end: torch.Tensor      # f32[S, W] window end times (exclusive)
    win_factor: torch.Tensor   # f32[S, W] capacity/speed multiplier inside the window
    win_preempt: torch.Tensor  # bool[S, W] outage preempts running jobs (vs drain)
    n_preempted: torch.Tensor  # i32[S] cumulative attempts preempted per site

    @property
    def n_sites(self) -> int:
        return self.win_start.shape[-2]

    @property
    def max_windows(self) -> int:
        return self.win_start.shape[-1]


def make_availability(
    n_sites: int, windows=(), *, max_windows: int | None = None, device="cuda"
) -> AvailabilityState:
    """Build an AvailabilityState from window specs.

    ``windows``: iterable of dicts (``site``, ``start``, ``end``,
    ``factor`` = 0.0, ``preempt`` = False) or tuples in that order.  Windows
    are grouped per site and padded to ``max_windows`` slots (default: the
    max per-site count, at least 1).
    """
    device = resolve_device(device)
    per_site: list[list[tuple]] = [[] for _ in range(n_sites)]
    for w in windows:
        if isinstance(w, dict):
            site = int(w["site"])
            row = (float(w["start"]), float(w["end"]),
                   float(w.get("factor", 0.0)), bool(w.get("preempt", False)))
        else:
            site = int(w[0])
            row = (float(w[1]), float(w[2]),
                   float(w[3]) if len(w) > 3 else 0.0,
                   bool(w[4]) if len(w) > 4 else False)
        if not 0 <= site < n_sites:
            raise ValueError(f"window site {site} out of range [0, {n_sites})")
        if not row[1] > row[0]:
            raise ValueError(f"window end {row[1]} must be > start {row[0]}")
        if not 0.0 <= row[2] <= 1.0:
            raise ValueError(f"window factor {row[2]} must be in [0, 1]")
        per_site[site].append(row)

    W = max_windows or max(1, max((len(p) for p in per_site), default=1))
    if any(len(p) > W for p in per_site):
        raise ValueError(f"a site has more than max_windows={W} windows")
    start = np.full((n_sites, W), np.inf, np.float32)
    end = np.full((n_sites, W), np.inf, np.float32)
    factor = np.ones((n_sites, W), np.float32)
    preempt = np.zeros((n_sites, W), bool)
    for s, rows in enumerate(per_site):
        for i, (t0, t1, f, p) in enumerate(sorted(rows)):
            start[s, i], end[s, i], factor[s, i], preempt[s, i] = t0, t1, f, p
    return AvailabilityState(
        win_start=torch.from_numpy(start).to(device),
        win_end=torch.from_numpy(end).to(device),
        win_factor=torch.from_numpy(factor).to(device),
        win_preempt=torch.from_numpy(preempt).to(device),
        n_preempted=torch.zeros((n_sites,), dtype=torch.int32, device=device),
    )


def active_windows(avail: AvailabilityState, t: torch.Tensor) -> torch.Tensor:
    """bool[S, W]: windows covering time ``t`` (half-open ``[start, end)``)."""
    t = t[..., None, None]
    return (avail.win_start <= t) & (t < avail.win_end)


def availability_factor(avail: AvailabilityState, t: torch.Tensor) -> torch.Tensor:
    """f32[S]: per-site capacity multiplier at time ``t``.

    1.0 outside any window; overlapping windows reduce to the most severe
    (minimum) factor: an outage inside a brown-out is still an outage.
    """
    f = torch.where(active_windows(avail, t), avail.win_factor, 1.0)
    return f.amin(-1)


def preempting_sites(avail: AvailabilityState, t0: torch.Tensor, t1: torch.Tensor) -> torch.Tensor:
    """bool[S]: sites with a ``preempt`` full-outage window overlapping
    ``(t0, t1]``.

    Interval (not instant) semantics so ``quantum > 0`` rounds, whose clock
    can jump past a short window entirely, still preempt the jobs that were
    running through it.  With ``t0`` the previous round's clock and ``t1``
    this round's, this is "active at t1" whenever rounds land on every edge
    (``quantum == 0``).
    """
    hit = (avail.win_start <= t1[..., None, None]) & (avail.win_end > t0[..., None, None])
    return (hit & avail.win_preempt & (avail.win_factor <= 0.0)).any(-1)


def next_window_edge(avail: AvailabilityState, t: torch.Tensor) -> torch.Tensor:
    """f32[]: the earliest window start/end strictly after ``t`` (inf if none)."""
    edges = torch.cat([avail.win_start.flatten(-2), avail.win_end.flatten(-2)], -1)
    return torch.where(edges > t[..., None], edges, INF).amin(-1)


def downtime_fraction(avail: AvailabilityState, horizon) -> np.ndarray:
    """f64[S]: fraction of ``[0, horizon]`` each site spends fully down.

    Numpy post-processing (ML features, reports).  Overlapping outage
    windows on one site are merged, so the result is the exact measure of
    the per-site downtime union.
    """
    horizon = float(horizon)
    S = int(avail.n_sites)
    if horizon <= 0:
        return np.zeros(S)
    start = np.clip(avail.win_start.cpu().numpy().astype(np.float64), 0.0, horizon)
    end = np.clip(avail.win_end.cpu().numpy().astype(np.float64), 0.0, horizon)
    down = (avail.win_factor.cpu().numpy() <= 0.0) & (end > start)
    out = np.zeros(S)
    for s in range(S):
        covered, edge = 0.0, -np.inf
        for a, b in sorted(zip(start[s][down[s]], end[s][down[s]])):
            covered += max(b - max(a, edge), 0.0)
            edge = max(edge, b)
        out[s] = covered / horizon
    return np.clip(out, 0.0, 1.0)


# --------------------------------------------------------------------------
# the availability Subsystem: its hooks on the round-loop protocol
# --------------------------------------------------------------------------


def _av_validate(sub, av: AvailabilityState, jobs, sites) -> None:
    S = sites.capacity
    if av.win_start.shape[-2] != S:
        raise ValueError(
            f"availability has {av.win_start.shape[-2]} sites, platform has {S}"
        )


def _av_event_times(sub, ctx):
    # window starts/ends are event sources: rounds land exactly on edges
    return next_window_edge(ctx.ext["availability"], ctx.clock_prev)


def _av_completion_filter(sub, ctx, comp):
    # a preempting outage opening before the job's finish kills it first;
    # only reachable when quantum > 0 jumps the clock past both the window
    # start and t_finish in one round (at quantum=0 rounds land on every
    # edge, so this mask is identically False).  The survivor stays RUNNING
    # and the on_completions hook preempts it.
    av = ctx.ext["availability"]
    jobs = ctx.jobs
    ksite = jobs.site.clamp(0, ctx.S - 1).long()
    ws = take(av.win_start, ksite, tail=1)                     # [J, W]
    wkill = take(av.win_preempt, ksite, tail=1) & (take(av.win_factor, ksite, tail=1) <= 0.0)
    killed_first = (
        wkill & (ws > ctx.clock_prev[..., None, None]) & (ws < jobs.t_finish[..., None])
    ).any(-1)
    return comp & ~killed_first


def _av_on_completions(sub, ctx):
    """Outage preemption and brown-out scaling (engine step 2b)."""
    from .engine import _site_sum

    av = ctx.ext["availability"]
    jobs, sites, S = ctx.jobs, ctx.sites, ctx.S
    factor = availability_factor(av, ctx.clock)     # f32[S]
    # brown-out: a factor-f window caps usable cores at floor(f*cores); a
    # site whose cap floors to 0 is a de facto outage, so the dispatcher
    # routes around it just like a factor-0 window
    eff_cap = torch.floor(sites.cores.float() * factor).int()
    ctx.scratch["availability"] = dict(factor=factor, eff_cap=eff_cap, avail_up=eff_cap > 0)
    # preempt: running jobs on a site whose preempting outage overlaps
    # (prev clock, clock] lose this attempt now (completions already retired
    # jobs whose t_finish <= clock, so a job finishing at the edge still
    # finishes)
    site_c0 = jobs.site.clamp(0, S - 1).long()
    preempting = take(preempting_sites(av, ctx.clock_prev, ctx.clock), site_c0)
    pre = (jobs.state == RUNNING) & preempting
    pre_resub = pre & (jobs.retries < ctx.max_retries)
    pre_fail = pre & ~pre_resub
    pre_site = torch.where(pre, jobs.site, S)
    # jobs still waiting in the dead site's queue bounce back to the server
    # (no attempt was lost, so no retry); drain windows leave the site queue
    # paused, as announced maintenance does
    bounce = (jobs.state == ASSIGNED) & preempting
    ctx.jobs = jobs._replace(
        state=torch.where(
            pre_resub | bounce, QUEUED, torch.where(pre_fail, FAILED, jobs.state)
        ),
        retries=jobs.retries + pre_resub.int(),
        site=torch.where(pre_resub | bounce, -1, jobs.site),
        t_finish=torch.where(pre_resub, INF,
                             torch.where(pre_fail, ctx.clock[..., None], jobs.t_finish)),
        preempted=jobs.preempted + pre.int(),
    )
    ctx.sites = sites._replace(
        free_cores=sites.free_cores + _site_sum(torch.where(pre, jobs.cores, 0), pre_site, S),
        free_memory=sites.free_memory + _site_sum(torch.where(pre, jobs.memory, 0.0), pre_site, S),
    )
    ctx.ext["availability"] = av._replace(
        n_preempted=av.n_preempted + _site_sum(pre, pre_site, S)
    )
    # a preemption round changed state: give the dispatcher one more round
    # to re-route the requeued jobs before halt detection
    ctx.progressed = ctx.progressed | pre.any(-1)


def _av_pre_assign(sub, ctx):
    sc = ctx.scratch["availability"]
    # the dispatcher routes around sites currently in a full outage
    ctx.feasible = ctx.feasible & sc["avail_up"][..., None, :]
    # starts only claim cores up to the brown-out cap net of busy ones, at
    # speed scaled by the window factor; a full outage admits no starts.
    # jnp.clip(x, 0, hi) is min(max(x, 0), hi), also when hi < 0
    sites = ctx.sites
    busy = sites.cores - sites.free_cores
    ctx.start_cores = torch.minimum((sc["eff_cap"] - busy).clamp_min(0), sites.free_cores)
    ctx.sites_serv = ctx.sites_serv._replace(
        speed=(ctx.sites_serv.speed * sc["factor"]).clamp_min(1e-9)
    )


def _av_log_spec(sub, av, jobs, sites):
    return {"site_avail": torch.ones(sites.cores.shape, dtype=torch.float32,
                                     device=sites.cores.device)}


def _av_log_columns(sub, ctx, write):
    return {"site_avail": ctx.scratch["availability"]["factor"]}


def _av_finalize(sub, av, jobs, sites, clock):
    return av, {"avail": av}


def availability_subsystem():
    """Availability dynamics as an engine subsystem; its ext slot carries
    the ``AvailabilityState`` calendar and preemption counters."""
    from .subsystems import Subsystem

    return Subsystem(
        name="availability",
        validate=_av_validate,
        event_times=_av_event_times,
        completion_filter=_av_completion_filter,
        on_completions=_av_on_completions,
        pre_assign=_av_pre_assign,
        log_spec=_av_log_spec,
        log_columns=_av_log_columns,
        finalize=_av_finalize,
    )


def sample_correlated_outages(
    n_sites: int,
    tier,
    *,
    horizon: float,
    events_per_tier: float = 2.0,
    mean_duration: float = 4 * 3600.0,
    p_follow: float = 0.7,
    factor: float = 0.0,
    preempt: bool = True,
    jitter: float = 0.0,
    seed: int = 0,
    max_windows: int | None = None,
    device="cuda",
) -> AvailabilityState:
    """Tier-correlated outage calendar (shared storage, power, or WAN cuts).

    For each tier, a Poisson number of tier events (mean ``events_per_tier``)
    uniform over ``[0, horizon]``; each event hits every site of that tier
    independently with probability ``p_follow``, with log-normal duration
    around ``mean_duration`` and per-site start jitter of up to ``jitter``
    seconds.  numpy's ``default_rng`` draws as the JAX package's builder
    does, so a seed gives the same windows.
    """
    tier = np.asarray(tier, np.int64)
    if tier.shape != (n_sites,):
        raise ValueError(f"tier must be shape ({n_sites},), got {tier.shape}")
    rng = np.random.default_rng(seed)
    windows = []
    for t_id in np.unique(tier):
        members = np.flatnonzero(tier == t_id)
        for _ in range(rng.poisson(events_per_tier)):
            t0 = rng.uniform(0.0, horizon)
            hit = members[rng.random(members.size) < p_follow]
            for s in hit:
                start = t0 + rng.uniform(0.0, jitter) if jitter > 0 else t0
                dur = rng.lognormal(np.log(mean_duration), 0.5)
                windows.append(dict(site=int(s), start=start, end=start + dur,
                                    factor=factor, preempt=preempt))
    return make_availability(n_sites, windows, max_windows=max_windows, device=device)
