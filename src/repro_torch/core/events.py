"""Event-level dataset generation (paper §4.3.2, Table 1).

CGSim records every job state transition alongside concurrent site metrics so
the runs double as ML training data.  The engine keeps only the per-job
timestamps (they fully determine the transition stream); this module copies
a result to the host once (``state_to_np``) and expands it into
Table-1-style rows and ML feature matrices in numpy, with the JAX package's
code, so both packages export the same bytes from the same run.

``transfer_rows`` gives a row per stage-in of the data subsystem and
``fault_rows`` a row per site of the faults subsystem; ``ml_dataset`` gains
the transfer-queue columns when the transfer queues ran and the fault
columns when the faults subsystem ran.
"""
from __future__ import annotations

import csv
import io
import json

import numpy as np

from .convert import to_numpy
from .types import CANCELLED, DONE, FAILED, STATE_NAMES, SimResult

# transition kinds, in tie-break order at equal timestamps: completions free
# cores before same-instant assigns/starts consume them (engine round order)
K_FINISH, K_ASSIGN, K_START = 0, 1, 2
KIND_NAMES = {K_ASSIGN: "assigned", K_START: "running", K_FINISH: "finished"}


def iter_transitions(result: SimResult, site_names=None):
    """Yield job state-transition rows one at a time (Table 1 stream).

    The generator form of ``transition_rows``: the sort still needs one
    ``(time, kind, job, site)`` tuple per transition (3 per job), but rows —
    an order of magnitude wider — are materialized one at a time, so a
    sink-fed export never holds the whole table.
    """
    jobs = state_to_np(result.jobs)
    sites = state_to_np(result.sites)
    S = len(sites["cores"])
    name = lambda s: (site_names[s] if site_names else f"site{s}")

    evs = []
    J = len(jobs["arrival"])
    for j in range(J):
        if not jobs["valid"][j]:
            continue
        sid = int(jobs["site"][j])
        if np.isfinite(jobs["t_assign"][j]):
            evs.append((float(jobs["t_assign"][j]), K_ASSIGN, j, sid))
        if np.isfinite(jobs["t_start"][j]):
            evs.append((float(jobs["t_start"][j]), K_START, j, sid))
        if np.isfinite(jobs["t_finish"][j]):
            evs.append((float(jobs["t_finish"][j]), K_FINISH, j, sid))
    evs.sort(key=lambda e: (e[0], e[1], e[2]))

    free = sites["cores"].astype(np.int64).copy()
    queued = np.zeros(S, np.int64)   # in site queue, not yet running
    running = np.zeros(S, np.int64)
    finished = np.zeros(S, np.int64)
    for eid, (t, kind, j, sid) in enumerate(evs):
        if sid < 0:
            continue
        if kind == K_ASSIGN:
            queued[sid] += 1
        elif kind == K_START:
            queued[sid] -= 1
            running[sid] += 1
            free[sid] -= int(jobs["cores"][j])
        else:
            running[sid] -= 1
            free[sid] += int(jobs["cores"][j])
            finished[sid] += 1
        state = KIND_NAMES[kind]
        if kind == K_FINISH and jobs["state"][j] == FAILED:
            state = "failed"
        yield dict(
            event_id=eid,
            time=round(t, 3),
            job_id=int(jobs["job_id"][j]),
            state=state,
            site=name(sid),
            avail_cores=int(free[sid]),
            pending_jobs=int(queued[sid]),
            assigned_jobs=int(running[sid]),
            finished_jobs=int(finished[sid]),
        )


def transition_rows(result: SimResult, site_names=None) -> list[dict]:
    """Expand a SimResult into one row per job state transition (Table 1).

    Each row: event_id, time, job_id, state, site, site available cores,
    site pending (queued) jobs, site assigned (running) jobs, site finished.

    Note: for resubmitted jobs only the final attempt's timestamps survive in
    ``JobsState``, so the stream contains one assign/start/finish triplet per
    job (failed intermediate attempts are visible in ``sites.n_failed``).
    ``iter_transitions`` is the streaming (generator) form.
    """
    return list(iter_transitions(result, site_names))


def transfer_rows(result: SimResult, site_names=None) -> list[dict]:
    """One row per stage-in data movement (DESIGN.md §3): src/dst storage
    elements, bytes over the WAN (0 for a local cache hit), and duration.

    Only jobs that actually staged through the data subsystem produce rows
    (``xfer_src >= 0`` — a run without a DataPolicy records none); as with
    ``transition_rows``, resubmitted jobs keep their final attempt only.
    """
    jobs = state_to_np(result.jobs)
    name = lambda s: (site_names[s] if site_names else f"site{s}")
    rows = []
    order = np.argsort(jobs["t_start"], kind="stable")
    for j in order:
        if not jobs["valid"][j] or jobs["dataset"][j] < 0 or jobs["xfer_src"][j] < 0:
            continue
        if not np.isfinite(jobs["t_start"][j]) or jobs["site"][j] < 0:
            continue
        nbytes = float(jobs["xfer_bytes"][j])
        rows.append(
            dict(
                time=round(float(jobs["t_start"][j]), 3),
                job_id=int(jobs["job_id"][j]),
                dataset=int(jobs["dataset"][j]),
                src=name(int(jobs["xfer_src"][j])),
                dst=name(int(jobs["site"][j])),
                bytes=round(nbytes, 1),
                duration=round(float(jobs["xfer_time"][j]), 3),
                cache_hit=nbytes == 0.0,
                # transfer-queue columns (DESIGN.md §11): 0.0/-1 when the
                # subsystem is off, so schemas concatenate across runs
                queue_wait=round(float(jobs["xfer_wait"][j]), 3),
                queue_depth=int(jobs["xfer_qdepth"][j]),
            )
        )
    return rows


def job_rows(result: SimResult, site_names=None) -> list[dict]:
    """One row per valid job with a *stable* schema across engine features.

    The workflow columns (``n_parents``/``dag_depth``/``wf_id``) are emitted
    for every run — constant ``0``/``0``/``-1`` without a DAG — so exported
    datasets from plain and workflow runs concatenate cleanly (DESIGN.md §6).
    Non-finite timestamps export as ``None`` (JSON-safe).
    """
    jobs = state_to_np(result.jobs)
    name = lambda s: (site_names[s] if site_names else f"site{s}") if s >= 0 else None
    t = lambda x: round(float(x), 3) if np.isfinite(x) else None
    rows = []
    for j in range(len(jobs["arrival"])):
        if not jobs["valid"][j]:
            continue
        rows.append(
            dict(
                job_id=int(jobs["job_id"][j]),
                state=STATE_NAMES[int(jobs["state"][j])],
                site=name(int(jobs["site"][j])),
                arrival=t(jobs["arrival"][j]),
                t_start=t(jobs["t_start"][j]),
                t_finish=t(jobs["t_finish"][j]),
                cores=int(jobs["cores"][j]),
                work=float(jobs["work"][j]),
                retries=int(jobs["retries"][j]),
                dataset=int(jobs["dataset"][j]),
                n_parents=int(jobs["n_parents"][j]),
                dag_depth=int(jobs["dag_depth"][j]),
                wf_id=int(jobs["wf_id"][j]),
            )
        )
    return rows


def workflow_rows(result: SimResult) -> list[dict]:
    """One row per workflow (``wf_id`` group): job counts by outcome, DAG
    depth, submit time, and makespan — the per-workflow companion to the
    per-job stream (DESIGN.md §6).  Runs without a DAG produce no rows."""
    jobs = state_to_np(result.jobs)
    sel = jobs["valid"] & (jobs["wf_id"] >= 0)
    rows = []
    for w in np.unique(jobs["wf_id"][sel]):
        m = sel & (jobs["wf_id"] == w)
        state = jobs["state"][m]
        fin = jobs["t_finish"][m]
        fin = fin[np.isfinite(fin)]
        t0 = float(jobs["arrival"][m].min())
        done = bool((state == DONE).all())
        rows.append(
            dict(
                wf_id=int(w),
                n_jobs=int(m.sum()),
                n_done=int((state == DONE).sum()),
                n_failed=int((state == FAILED).sum()),
                n_cancelled=int((state == CANCELLED).sum()),
                dag_depth=int(jobs["dag_depth"][m].max()),
                t_submit=round(t0, 3),
                t_end=round(float(fin.max()), 3) if fin.size else None,
                makespan=round(float(fin.max()) - t0, 3) if (done and fin.size) else None,
                completed=done,
            )
        )
    return rows


def availability_rows(result: SimResult, site_names=None) -> list[dict]:
    """One row per availability window (DESIGN.md §5): the outage/brown-out
    calendar alongside how many running attempts each site's outages killed.

    Rows are time-ordered by window start.  ``n_preempted`` is the site's
    *cumulative* preemption counter (repeated on each of its rows); a run
    without an ``AvailabilityState`` produces no rows.
    """
    avail = getattr(result, "avail", None)
    if avail is None:
        return []
    start = to_numpy(avail.win_start)
    end = to_numpy(avail.win_end)
    factor = to_numpy(avail.win_factor)
    preempt = to_numpy(avail.win_preempt)
    n_pre = to_numpy(avail.n_preempted)
    name = lambda s: (site_names[s] if site_names else f"site{s}")
    rows = []
    for s, w in sorted(zip(*np.nonzero(np.isfinite(start))), key=lambda i: start[i]):
        f = float(factor[s, w])
        rows.append(
            dict(
                time=round(float(start[s, w]), 3),
                site=name(int(s)),
                kind="outage" if f <= 0.0 else "brownout",
                start=round(float(start[s, w]), 3),
                end=round(float(end[s, w]), 3) if np.isfinite(end[s, w]) else float("inf"),
                factor=f,
                preempt=bool(preempt[s, w]),
                n_preempted=int(n_pre[s]),
            )
        )
    return rows


_BL_NAMES = {0: "closed", 1: "tripped", 2: "half-open"}


def fault_rows(result: SimResult, site_names=None) -> list[dict]:
    """One row per site from the faults subsystem: the final EWMA failure
    score, the circuit breaker's state and the replica-loss events that hit
    the site, with the run-level fault counters repeated on each row (like
    ``availability_rows``' ``n_preempted``).  A run without ``faults=``
    produces no rows."""
    fs = (getattr(result, "ext", None) or {}).get("faults")
    if fs is None:
        return []
    score = to_numpy(fs.score)
    bl = to_numpy(fs.bl_state)
    loss_s = to_numpy(fs.loss_s)
    loss_done = to_numpy(fs.loss_done)
    name = lambda s: (site_names[s] if site_names else f"site{s}")
    rows = []
    for s in range(score.shape[-1]):
        rows.append(
            dict(
                site=name(s),
                fault_score=round(float(score[s]), 4),
                blacklist=_BL_NAMES.get(int(bl[s]), "?"),
                loss_events=int(((loss_s == s) & loss_done).sum()),
                n_kills=int(fs.n_kills),
                n_xfer_fail=int(fs.n_xfer_fail),
                n_bl_trips=int(fs.n_bl_trips),
                time_lost=round(float(fs.time_lost), 3),
            )
        )
    return rows


def to_csv(rows: list[dict]) -> str:
    if not rows:
        return ""
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=list(rows[0]))
    w.writeheader()
    w.writerows(rows)
    return buf.getvalue()


def to_json(rows: list[dict]) -> str:
    return json.dumps(rows)


def _ml_context(result: SimResult) -> dict:
    """Everything ``_ml_block`` needs that is *per-run*, not per-job-slice:
    the host-side column arrays, the per-site availability columns, and the
    feature-name schema.  Computed once so chunked export pays it once."""
    jobs = state_to_np(result.jobs)
    sites = state_to_np(result.sites)
    names = [
        "log_work", "cores", "memory_gb", "log_bytes_in", "log_bytes_out",
        "priority", "site_speed", "site_cores", "site_log_bw", "site_gamma",
        "site_fail_rate", "log_xfer_bytes", "xfer_time", "has_dataset",
        "n_parents", "dag_depth", "wf_id",
    ]
    ctx = dict(jobs=jobs, sites=sites, down_frac=None, site_pre=None, net_bw=None)
    avail = getattr(result, "avail", None)
    if avail is not None:
        from .availability import downtime_fraction

        ctx["down_frac"] = downtime_fraction(avail, float(result.makespan))
        ctx["site_pre"] = to_numpy(avail.n_preempted).astype(np.float64)
        names = names + ["n_preempted", "site_downtime_frac", "site_log_preempted"]
    ext = getattr(result, "ext", None) or {}
    if "transfers" in ext and "data" in ext:
        # transfer-queue features, appended only when the subsystem ran, so
        # the exports of other runs keep their bytes
        ctx["net_bw"] = to_numpy(ext["data"].network.bw).astype(np.float64)
        names = names + ["xfer_queue_wait", "xfer_queue_depth", "src_link_log_bw"]
    ctx["faults_bw"] = None
    if "faults" in ext:
        # fault features: the job's cumulative backoff wait and retries, and
        # its final site's EWMA failure score
        ctx["faults_bw"] = to_numpy(ext["faults"].backoff_wait).astype(np.float64)
        ctx["fault_score"] = to_numpy(ext["faults"].score).astype(np.float64)
        names = names + ["fault_backoff_wait", "fault_retries", "site_fault_score"]
    ctx["names"] = names
    return ctx


def _ml_block(ctx: dict, sl: slice = slice(None)) -> dict[str, np.ndarray]:
    """Features/labels for one job-axis slice.

    Every per-job column is elementwise (transforms and site gathers), so a
    slice computes values identical to the same rows of the full matrix —
    the invariant that makes ``write_ml_dataset`` byte-identical to
    ``ml_dataset`` at any segment size (tested)."""
    jobs = {k: v[sl] for k, v in ctx["jobs"].items()}
    sites = ctx["sites"]
    done = np.isin(jobs["state"], [DONE, FAILED]) & jobs["valid"]
    sid = np.clip(jobs["site"], 0, len(sites["cores"]) - 1)

    feats = np.stack(
        [
            np.log1p(jobs["work"]),
            jobs["cores"].astype(np.float64),
            jobs["memory"],
            np.log1p(jobs["bytes_in"]),
            np.log1p(jobs["bytes_out"]),
            jobs["priority"],
            sites["speed"][sid],
            sites["cores"][sid].astype(np.float64),
            np.log1p(sites["bw_in"][sid]),
            sites["par_gamma"][sid],
            sites["fail_rate"][sid],
            np.log1p(jobs["xfer_bytes"]),
            jobs["xfer_time"],
            (jobs["dataset"] >= 0).astype(np.float64),
            # workflow DAG features — constant 0/0/-1 without a workflow, so
            # the export schema is stable across plain and DAG runs
            jobs["n_parents"].astype(np.float64),
            jobs["dag_depth"].astype(np.float64),
            jobs["wf_id"].astype(np.float64),
        ],
        axis=-1,
    )[done]
    if ctx["down_frac"] is not None:
        extra = np.stack(
            [
                jobs["preempted"].astype(np.float64),
                ctx["down_frac"][sid],
                np.log1p(ctx["site_pre"][sid]),
            ],
            axis=-1,
        )[done]
        feats = np.concatenate([feats, extra], axis=-1)
    if ctx["net_bw"] is not None:
        src = jobs["xfer_src"]
        src_c = np.clip(src, 0, ctx["net_bw"].shape[0] - 1)
        extra = np.stack(
            [
                jobs["xfer_wait"],
                jobs["xfer_qdepth"].astype(np.float64),
                np.where(src >= 0, np.log1p(ctx["net_bw"][src_c, sid]), 0.0),
            ],
            axis=-1,
        )[done]
        feats = np.concatenate([feats, extra], axis=-1)
    if ctx["faults_bw"] is not None:
        extra = np.stack(
            [
                ctx["faults_bw"][sl],
                jobs["retries"].astype(np.float64),
                ctx["fault_score"][sid],
            ],
            axis=-1,
        )[done]
        feats = np.concatenate([feats, extra], axis=-1)
    wall = (jobs["t_finish"] - jobs["t_start"])[done]
    queue = (jobs["t_start"] - jobs["arrival"])[done]
    failed = (jobs["state"] == FAILED)[done]
    return dict(
        features=feats.astype(np.float32),
        walltime=wall.astype(np.float32),
        queue_time=queue.astype(np.float32),
        failed=failed,
        # identity labels (not features): which job ran where — what lets a
        # calibration trace join rows back to workload entries
        job_id=jobs["job_id"][done].astype(np.int32),
        site=sid[done].astype(np.int32),
    )


def ml_dataset(result: SimResult) -> dict[str, np.ndarray]:
    """Feature/label matrices for surrogate training (paper §1: "datasets
    suitable for modern machine learning approaches").

    Features (per finished/failed job): work, cores, memory, bytes_in/out,
    priority, site one-hot stats (speed, cores, bw, queue pressure at assign),
    plus data-movement columns (WAN bytes staged, stage-in duration, dataset
    presence) so surrogates can learn transfer-dominated walltimes.  Runs with
    an ``AvailabilityState`` append availability columns — the job's preempted
    attempts, its final site's downtime fraction and cumulative preemptions —
    so surrogates can learn outage-shaped walltime tails.  Workflow DAG
    columns (``n_parents``/``dag_depth``/``wf_id``) are always present
    (0/0/-1 without a DAG) so the schema is stable across run kinds.
    Labels: walltime, queue_time, failed.

    ``write_ml_dataset`` streams the same dataset to NDJSON in bounded-memory
    segments, row/byte-identical to this in-memory form.
    """
    ctx = _ml_context(result)
    block = _ml_block(ctx)
    block["feature_names"] = np.array(ctx["names"])
    return block


def write_ml_dataset(result: SimResult, target, *, segment: int = 0) -> int:
    """Stream the ``ml_dataset`` rows to NDJSON with bounded peak memory.

    ``target`` is a path or text file object.  ``segment`` is the number of
    *jobs* whose feature block is materialized at a time (0 = all at once);
    peak export memory is O(segment × n_features), not O(jobs), so WLCG-scale
    runs export without assembling the full matrix.  The emitted bytes are
    identical for every segment size: one ``ml_header`` line (schema +
    feature names), then one ``ml_row`` line per finished/failed job in job
    order.  Returns the number of data rows written.
    """
    ctx = _ml_context(result)
    J = len(ctx["jobs"]["arrival"])
    step = J if segment <= 0 else segment
    own = not hasattr(target, "write")
    f = open(target, "w") if own else target
    n = 0
    try:
        f.write(
            json.dumps(
                {"type": "ml_header", "feature_names": ctx["names"]},
                separators=(",", ":"),
            )
            + "\n"
        )
        for lo in range(0, J, step):
            block = _ml_block(ctx, slice(lo, min(lo + step, J)))
            for i in range(len(block["walltime"])):
                rec = {
                    "type": "ml_row",
                    "job_id": int(block["job_id"][i]),
                    "site": int(block["site"][i]),
                    "features": [float(x) for x in block["features"][i]],
                    "walltime": float(block["walltime"][i]),
                    "queue_time": float(block["queue_time"][i]),
                    "failed": bool(block["failed"][i]),
                }
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
                n += 1
    finally:
        if own:
            f.close()
    return n


def recorded_trace(result: SimResult) -> dict[str, np.ndarray]:
    """Extract the calibration ground-truth columns from one finished run.

    Per finished/failed job (in job order): ``job_id``, the ``site`` it ran
    at, its ``walltime``/``queue_time``, and the WAN stage-in it performed —
    replica source ``xfer_src`` (−1 = flat-link stage-in) and ``xfer_bytes``
    moved.  This is the row schema ``calibration.platform_problem_from_trace``
    consumes; ``ml_dataset`` rows carry the same ``job_id``/``site``/
    ``walltime`` labels, so an exported NDJSON dataset (``read_ml_trace``)
    works as a trace too.
    """
    jobs = state_to_np(result.jobs)
    done = np.isin(jobs["state"], [DONE, FAILED]) & jobs["valid"]
    S = len(to_numpy(result.sites.cores))
    return dict(
        job_id=jobs["job_id"][done].astype(np.int32),
        site=np.clip(jobs["site"], 0, S - 1)[done].astype(np.int32),
        walltime=(jobs["t_finish"] - jobs["t_start"])[done].astype(np.float32),
        queue_time=(jobs["t_start"] - jobs["arrival"])[done].astype(np.float32),
        xfer_src=jobs["xfer_src"][done].astype(np.int32),
        xfer_bytes=jobs["xfer_bytes"][done].astype(np.float32),
    )


def read_ml_trace(source) -> dict[str, np.ndarray]:
    """Load a ``write_ml_dataset`` NDJSON export back into trace arrays.

    Returns ``job_id``/``site``/``walltime``/``queue_time``/``failed``
    columns plus the feature matrix and names — the round trip that lets a
    recorded production trace on disk drive ``platform_problem_from_trace``.
    """
    own = not hasattr(source, "read")
    f = open(source) if own else source
    try:
        head = json.loads(f.readline())
        if head.get("type") != "ml_header":
            raise ValueError("not an ml NDJSON export (missing ml_header)")
        rows = [json.loads(line) for line in f if line.strip()]
    finally:
        if own:
            f.close()
    rows = [r for r in rows if r.get("type") == "ml_row"]
    return dict(
        feature_names=np.array(head["feature_names"]),
        features=np.array([r["features"] for r in rows], np.float32),
        job_id=np.array([r["job_id"] for r in rows], np.int32),
        site=np.array([r["site"] for r in rows], np.int32),
        walltime=np.array([r["walltime"] for r in rows], np.float32),
        queue_time=np.array([r["queue_time"] for r in rows], np.float32),
        failed=np.array([r["failed"] for r in rows], bool),
    )


def iter_frames(result: SimResult):
    """Yield per-round monitoring snapshots one at a time (generator form of
    ``log_frames`` — the rounds×sites table never materializes at once)."""
    log = state_to_np(result.log)
    extra = {k: to_numpy(v) for k, v in result.log.extra.items()}
    n = int(log["cursor"])
    rows = min(n, len(log["time"]))
    for i in range(rows):
        if log["round_idx"][i] < 0:
            continue
        yield dict(
            round=int(log["round_idx"][i]),
            time=float(log["time"][i]),
            counts={k: int(v) for k, v in zip(STATE_NAMES, log["counts"][i])},
            started=int(log["n_started"][i]),
            completed=int(log["n_completed"][i]),
            site_free=log["site_free"][i].tolist(),
            site_queued=log["site_queued"][i].tolist(),
            site_running=log["site_running"][i].tolist(),
            **{k: v[i].tolist() for k, v in extra.items()},
        )


def log_frames(result: SimResult) -> list[dict]:
    """Per-round monitoring snapshots captured in-sim (EventLog ring buffer).

    Core pressure columns are always present; subsystem-declared columns
    (``EventLog.extra``, DESIGN.md §7 — e.g. ``site_disk``/``site_net_in``
    from the data subsystem, ``site_avail`` from availability) appear under
    their declared names whenever the subsystem ran, so the export schema
    assembles itself from whatever was attached.  ``iter_frames`` is the
    streaming (generator) form."""
    return list(iter_frames(result))


# streaming row sources by record type: (generator, takes site_names?)
_STREAMS = {
    "transition": (iter_transitions, True),
    "frame": (iter_frames, False),
    "job": (job_rows, True),
    "transfer": (transfer_rows, True),
    "workflow": (workflow_rows, False),
    "availability": (availability_rows, True),
    "fault": (fault_rows, True),
}


def stream_rows(result: SimResult, sink, *, kinds=("transition",), site_names=None) -> int:
    """Push event rows to a sink (any object with ``emit(record)``, such as
    the JAX package's ``telemetry`` sinks), one record at a time.

    Each record is the corresponding ``*_rows`` dict plus a ``"type"`` tag
    (``transition``/``frame``/``job``/``transfer``/``workflow``/
    ``availability``) so heterogeneous kinds multiplex into one NDJSON
    stream — the chunked path named in ROADMAP's WLCG-scale item: export
    memory is per-row, not rounds×sites.  Returns the row count emitted.
    """
    n = 0
    for kind in kinds:
        if kind not in _STREAMS:
            raise ValueError(f"unknown stream kind {kind!r} (have {sorted(_STREAMS)})")
        gen, named = _STREAMS[kind]
        rows = gen(result, site_names) if named else gen(result)
        for row in rows:
            sink.emit({"type": kind, **row})
            n += 1
    return n


def state_to_np(tree) -> dict[str, np.ndarray]:
    """A state's columns (``JobsState``, ``SiteState``, ``EventLog``) as
    numpy arrays on the host; dict fields (the log's ``extra``) are left
    out."""
    return {k: to_numpy(v) for k, v in tree._asdict().items() if not isinstance(v, dict)}
