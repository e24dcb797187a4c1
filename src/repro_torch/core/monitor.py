"""Monitoring (paper §4.3.3, Fig. 5), terminal edition: the run's event-log
ring rendered as ANSI dashboard frames, JSON frame streams any dashboard can
consume, and per-site timelines, from a finished ``SimResult``.

``watch`` monitors a run while it goes: it splits the run into time
segments (``engine.init_sim``/``advance_sim``) and takes a host-side frame
(``state_frame``) between them, so the round loop does no monitoring work
and the result equals one ``simulate`` call bit for bit.  Frames stream to
any ``telemetry.Sink``; ``follow_stream`` renders such a stream, and
``python -m repro_torch.monitor --follow run.ndjson`` tails one live from
another process.
"""
from __future__ import annotations

import json
import sys

import numpy as np

from .convert import to_numpy
from .events import log_frames
from .types import ASSIGNED, RUNNING, STATE_NAMES, SimResult

BAR = " ▁▂▃▄▅▆▇█"


def pressure_bar(used: int, total: int, width: int = 20) -> str:
    if total <= 0:
        return " " * width
    frac = min(max(used / total, 0.0), 1.0)
    full = int(frac * width)
    return "█" * full + "·" * (width - full)


def render_frame(
    frame: dict, sites_cores, site_names=None, max_sites: int = 24, disk_cap=None
) -> str:
    """One dashboard frame: global counts + per-site node pressure, plus
    storage-element and WAN-ingress pressure when the data subsystem is on."""
    c = frame["counts"]
    lines = [
        f"t={frame['time']:>12.1f}s  round={frame['round']:>7d}  "
        + "  ".join(f"{k}={c[k]}" for k in STATE_NAMES),
    ]
    free = np.asarray(frame["site_free"])
    queued = np.asarray(frame["site_queued"])
    running = np.asarray(frame["site_running"])
    total = to_numpy(sites_cores)
    disk = np.asarray(frame.get("site_disk", np.zeros_like(total, dtype=float)))
    net_in = np.asarray(frame.get("site_net_in", np.zeros_like(total, dtype=float)))
    avail = np.asarray(frame.get("site_avail", np.ones_like(total, dtype=float)))
    show_data = disk.any() or net_in.any() or disk_cap is not None
    order = np.argsort(-(total - free))[:max_sites]
    for s in order:
        if total[s] <= 0:
            continue
        name = site_names[s] if site_names else f"site{s:03d}"
        used = int(total[s] - free[s])
        line = (
            f"  {name:>12s} |{pressure_bar(used, int(total[s]))}| "
            f"{used:>6d}/{int(total[s]):<6d} cores  run={int(running[s]):>5d} queue={int(queued[s]):>5d}"
        )
        if avail[s] <= 0.0:
            line += "  DOWN"
        elif avail[s] < 1.0:
            line += f"  avail=x{avail[s]:.2f}"
        if show_data:
            cap = float(np.asarray(disk_cap)[s]) if disk_cap is not None else 0.0
            bar = pressure_bar(int(disk[s]), int(cap), width=8) if cap > 0 else " " * 8
            line += f"  disk|{bar}| {disk[s] / 1e12:>6.2f}TB  net_in={net_in[s] / 1e9:>7.2f}GB"
        lines.append(line)
    return "\n".join(lines)


def state_frame(handle) -> dict:
    """A dashboard frame of a paused ``SimHandle``, taken on the host
    between segments (never inside the round loop); the shape
    ``render_frame`` reads."""
    st = handle.state
    state = to_numpy(st.jobs.state)
    valid = to_numpy(st.jobs.valid)
    site = to_numpy(st.jobs.site)
    S = st.sites.capacity
    counts = {name: int(((state == s) & valid).sum()) for s, name in enumerate(STATE_NAMES)}

    def per_site(kind):
        m = (state == kind) & valid & (site >= 0)
        return np.bincount(site[m], minlength=S)[:S].tolist()

    return dict(
        round=int(st.round),
        time=float(st.clock),
        counts=counts,
        site_free=to_numpy(st.sites.free_cores).tolist(),
        site_queued=per_site(ASSIGNED),
        site_running=per_site(RUNNING),
    )


def watch(
    jobs0,
    sites0,
    policy,
    rng,
    *,
    frames: int = 24,
    horizon: float | None = None,
    segment: float | None = None,
    sink=None,
    site_names=None,
    render: bool = True,
    out=sys.stdout,
    recorder=None,
    max_segments: int = 10_000,
    **kw,
) -> SimResult:
    """Run a simulation while watching it.

    Splits the run into time segments (``segment`` seconds each, or
    ``horizon / frames``; without a horizon the width comes from the arrival
    span) and resumes the round loop between them.  The loop checks its
    horizon before each round, so every segment continues the round
    sequence of one ``simulate`` call and the result is the same bit for bit.

    After each segment a frame goes to ``sink`` (any ``telemetry.Sink``; an
    ``NDJSONSink`` makes the run tailable with ``python -m
    repro_torch.monitor --follow run.ndjson``) and, with ``render``, to
    ``out``.  The stream starts with a ``run_meta`` record (the sites' cores
    and names, what a renderer needs) and ends with an ``end`` record.  A
    ``telemetry.TraceRecorder`` times the segments; the other ``**kw``
    (``log_rows``, subsystems, ``device``, ...) go to the engine.
    """
    from .engine import advance_sim, finish_sim, init_sim, sim_active
    from .telemetry import maybe

    rec = maybe(recorder)
    with rec.span("watch_init"):
        handle = init_sim(jobs0, sites0, policy, rng, **kw)
    hz = None if horizon is None or not np.isfinite(horizon) else float(horizon)
    if segment is not None:
        dt = float(segment)
    elif hz is not None:
        dt = hz / max(frames, 1)
    else:
        arr = to_numpy(jobs0.arrival).astype(np.float64)
        fin = arr[np.isfinite(arr) & to_numpy(jobs0.valid)]
        est = 2.0 * float(fin.max()) if fin.size and fin.max() > 0 else float(frames)
        dt = est / max(frames, 1)
    dt = max(dt, 1e-9)

    cores = to_numpy(sites0.cores)
    if sink is not None:
        sink.emit(dict(type="run_meta", n_sites=sites0.capacity, sites_cores=cores.tolist(),
                       site_names=list(site_names) if site_names else None, horizon=hz))
    n_seg = 0
    t_edge = 0.0
    while sim_active(handle) and n_seg < max_segments:
        t_edge += dt
        at_end = hz is not None and t_edge >= hz
        with rec.span("watch_segment"):
            handle = advance_sim(handle, hz if at_end else t_edge)
        frame = state_frame(handle)
        if sink is not None:
            sink.emit({"type": "frame", **frame})
        if render:
            out.write(render_frame(frame, cores, site_names) + "\n\n")
        n_seg += 1
        if at_end:
            break
    if hz is None and sim_active(handle):
        # the segment budget ran out on an open-horizon run: drain to the end
        with rec.span("watch_segment"):
            handle = advance_sim(handle)
    with rec.span("watch_finalize"):
        res = finish_sim(handle)
    rec.gauge("watch_segments", n_seg)
    rec.gauge("rounds_executed", int(res.rounds))
    if sink is not None:
        sink.emit(dict(type="end", rounds=int(res.rounds), makespan=float(res.makespan),
                       segments=n_seg))
    return res


def follow_stream(
    source,
    *,
    follow: bool = False,
    every: int = 1,
    clear: bool = True,
    out=sys.stdout,
    poll_s: float = 0.2,
    timeout_s: float | None = None,
) -> int:
    """Render an NDJSON frame stream (as ``watch`` writes it) to a terminal;
    ``follow=True`` tails a file another process is still writing.  Returns
    the number of frames rendered."""
    from .telemetry import iter_ndjson

    cores = None
    names = None
    shown = i = 0
    for rec in iter_ndjson(source, follow=follow, poll_s=poll_s, timeout_s=timeout_s):
        t = rec.get("type")
        if t == "run_meta":
            cores = np.asarray(rec["sites_cores"])
            names = rec.get("site_names")
        elif t == "frame":
            if i % every == 0 and cores is not None:
                if clear:
                    out.write("\x1b[2J\x1b[H")
                out.write(render_frame(rec, cores, names) + "\n\n")
                shown += 1
            i += 1
        elif t == "end":
            out.write(f"end: rounds={rec.get('rounds')} makespan={rec.get('makespan')}\n")
            break
    return shown


def render_run(result: SimResult, site_names=None, every: int = 1, out=sys.stdout) -> None:
    frames = log_frames(result)
    cores = to_numpy(result.sites.cores)
    for i, frame in enumerate(frames):
        if i % every:
            continue
        out.write(render_frame(frame, cores, site_names) + "\n\n")


def frames_json(result: SimResult) -> str:
    """JSON frame stream for an external dashboard (the web-UI contract)."""
    return json.dumps(log_frames(result))


def utilization_timeline(result: SimResult) -> np.ndarray:
    """[T, S] core-utilization per logged frame — sparkline/heatmap feed."""
    frames = log_frames(result)
    cores = np.maximum(to_numpy(result.sites.cores).astype(np.float64), 1.0)
    rows = [(cores - np.asarray(f["site_free"], dtype=np.float64)) / cores for f in frames]
    return np.stack(rows) if rows else np.zeros((0, cores.size))


def extra_timeline(result: SimResult, column: str, default: float = 0.0) -> np.ndarray:
    """[T, S] per-frame values of a subsystem-declared log column
    (``EventLog.extra``, DESIGN.md §7); ``default`` fills frames from runs
    where the owning subsystem was not attached."""
    frames = log_frames(result)
    S = result.sites.capacity
    fallback = np.full((S,), default)
    rows = [np.asarray(f.get(column, fallback), dtype=np.float64) for f in frames]
    return np.stack(rows) if rows else np.zeros((0, S))


def storage_timeline(result: SimResult) -> np.ndarray:
    """[T, S] storage-element occupancy (bytes) per logged frame."""
    return extra_timeline(result, "site_disk")


def network_timeline(result: SimResult) -> np.ndarray:
    """[T, S] WAN bytes staged into each site per logged frame."""
    return extra_timeline(result, "site_net_in")


def _link_timeline(result: SimResult, column: str) -> np.ndarray:
    """[T, S, S] per-frame values of a transfer-queue link column — the
    flattened ``[S*S]`` log rows folded back onto the (src, dst) matrix.
    Frames from runs without the subsystem come back as zeros."""
    frames = log_frames(result)
    S = result.sites.capacity
    fallback = np.zeros((S * S,))
    rows = [np.asarray(f.get(column, fallback), dtype=np.float64) for f in frames]
    out = np.stack(rows) if rows else np.zeros((0, S * S))
    return out.reshape(-1, S, S)


def link_occupancy_timeline(result: SimResult) -> np.ndarray:
    """[T, S, S] active transfers per directed link per logged frame — the
    DESIGN.md §11 dashboard feed for FTS channel saturation (compare against
    the per-link caps)."""
    return _link_timeline(result, "link_active")


def transfer_queue_timeline(result: SimResult) -> np.ndarray:
    """[T, S, S] queued (waiting) transfers per directed link per logged
    frame — queue-depth build-up and drain on hot links."""
    return _link_timeline(result, "link_queued")


def availability_timeline(result: SimResult) -> np.ndarray:
    """[T, S] availability factor per logged frame (1 up, (0,1) degraded,
    0 down) — the DESIGN.md §5 dashboard feed for outage/brown-out studies."""
    return extra_timeline(result, "site_avail", default=1.0)


def fault_score_timeline(result: SimResult) -> np.ndarray:
    """[T, S] EWMA fault score per logged frame (DESIGN.md §13) — watch a
    flaky site's score climb toward the blacklist threshold."""
    return extra_timeline(result, "site_fault_score")


def blacklist_timeline(result: SimResult) -> np.ndarray:
    """[T, S] circuit-breaker state per logged frame (0 closed, 1 tripped,
    2 half-open) — the trip/cooldown/probe cycle as a step chart."""
    return extra_timeline(result, "site_blacklist")


def workflow_timeline(result: SimResult) -> tuple[np.ndarray, np.ndarray]:
    """Per-workflow stage-completion matrix (DESIGN.md §6 dashboard feed).

    Returns ``(wf_ids[W], t_done[W, Dmax+1])``: for each workflow and DAG
    depth level, the time the *last* job at that depth finished (``nan``
    where the level never fully finished — failed/cancelled levels stay
    nan).  Runs without a DAG return empty arrays.
    """
    from .types import DONE

    jobs = to_numpy(result.jobs.wf_id)
    valid = to_numpy(result.jobs.valid)
    sel = valid & (jobs >= 0)
    if not sel.any():
        return np.zeros((0,), np.int64), np.zeros((0, 0))
    depth = to_numpy(result.jobs.dag_depth)
    state = to_numpy(result.jobs.state)
    fin = to_numpy(result.jobs.t_finish).astype(np.float64)
    wf_ids = np.unique(jobs[sel])
    dmax = int(depth[sel].max())
    out = np.full((wf_ids.size, dmax + 1), np.nan)
    for i, w in enumerate(wf_ids):
        for d in range(dmax + 1):
            m = sel & (jobs == w) & (depth == d)
            if m.any() and (state[m] == DONE).all():
                out[i, d] = fin[m].max()
    return wf_ids, out


def render_workflows(result: SimResult, max_rows: int = 16, width: int = 48) -> str:
    """ASCII per-workflow gantt: one bar per workflow spanning submit ->
    last finish, with stage-completion ticks at each DAG depth."""
    wf_ids, t_done = workflow_timeline(result)
    if wf_ids.size == 0:
        return "(no workflows)"
    jobs = to_numpy(result.jobs.wf_id)
    valid = to_numpy(result.jobs.valid)
    arr = to_numpy(result.jobs.arrival).astype(np.float64)
    span = float(np.nanmax(t_done)) if np.isfinite(t_done).any() else 1.0
    span = max(span, 1e-9)
    lines = []
    for i, w in enumerate(wf_ids[:max_rows]):
        t0 = float(arr[valid & (jobs == w)].min())
        cells = [" "] * width
        a, b = int(t0 / span * (width - 1)), 0
        ends = t_done[i][np.isfinite(t_done[i])]
        if ends.size:
            b = int(ends.max() / span * (width - 1))
            for x in range(a, b + 1):
                cells[x] = "─"
            for td in ends:
                cells[int(td / span * (width - 1))] = "┃"
        done = np.isfinite(t_done[i]).all()
        lines.append(
            f"  wf{int(w):>4d} |{''.join(cells)}| "
            + (f"done @ {ends.max():>10.1f}s" if done and ends.size else "incomplete")
        )
    return "\n".join(lines)


def sparkline(values: np.ndarray, width: int = 60) -> str:
    if values.size == 0:
        return ""
    idx = np.linspace(0, values.size - 1, width).astype(int)
    v = values[idx]
    lo, hi = float(v.min()), float(v.max())
    span = (hi - lo) or 1.0
    chars = [BAR[int((x - lo) / span * (len(BAR) - 1))] for x in v]
    return "".join(chars) + f"  [{lo:.2f}..{hi:.2f}]"
