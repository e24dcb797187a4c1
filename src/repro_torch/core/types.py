"""Core state types for the PyTorch grid simulator.

The same fixed-capacity struct-of-arrays layout as the JAX package: every
column is one tensor over the job (or site) axis, with the same dtypes
(f32/i32/bool), so results compare column by column.  All tensors of one
state live on one device; the builders take it explicitly and default to the
GPU.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

INF = float("inf")

# --- job lifecycle states (CGSim: pending/assigned/running/finished/failed) ---
PENDING = 0   # not yet arrived at the main server
QUEUED = 1    # at the main server, awaiting a site assignment ("pending list")
ASSIGNED = 2  # placed in a site queue, awaiting free cores
RUNNING = 3   # executing on site cores
DONE = 4
FAILED = 5    # terminally failed (retries exhausted)
CANCELLED = 6  # cascade-cancelled: an ancestor in its workflow DAG failed
N_STATES = 7

STATE_NAMES = ("pending", "queued", "assigned", "running", "finished", "failed", "cancelled")


def resolve_device(device) -> torch.device:
    """The device a builder or run uses; a CUDA device without a GPU raises
    instead of quietly running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def take(x: torch.Tensor, idx: torch.Tensor, tail: int = 0) -> torch.Tensor:
    """``x[idx]`` along the axis before ``x``'s last ``tail`` axes, lane by
    lane: ``x [..., S, *T]`` at int64 ``idx [..., *I]`` gives
    ``[..., *I, *T]``, each lane of the leading axes looked up in its own
    ``x``; a negative index counts from the end, as in indexing.  Without
    lane axes it is plain indexing.

    A lookup whose gradient is asked for (calibration's closed form) adds
    the gradient back with the row-order segment sum, not with the atomics
    of indexing's backward, so it has the same bits on every run, on the
    card and on the CPU."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Take.apply(x, idx, tail)
    lead = x.dim() - 1 - tail
    if lead == 0:
        return x[idx]
    lanes, n = x.shape[:lead], x.shape[lead]
    idx = idx.remainder(n)
    if tail == 0 and idx.dim() == x.dim():
        return torch.gather(x, -1, idx)
    return x.reshape(-1, *x.shape[lead + 1:])[idx + _lane_offsets(lanes, n, idx.dim() - lead,
                                                                  x.device)]


def _lane_offsets(lanes, n: int, idx_axes: int, device) -> torch.Tensor:
    off = torch.arange(0, math.prod(lanes) * n, n, device=device)
    return off.view(*lanes, *([1] * idx_axes))


class _Take(torch.autograd.Function):
    """``take`` as one flat lookup, its backward a segment sum of the
    gradient rows onto the looked-up rows."""

    @staticmethod
    def forward(ctx, x, idx, tail):
        lead = x.dim() - 1 - tail
        n = x.shape[lead]
        flat = idx.remainder(n)
        if lead:
            flat = flat + _lane_offsets(x.shape[:lead], n, idx.dim() - lead, x.device)
        rows = x.reshape(-1, *x.shape[lead + 1:])
        ctx.save_for_backward(flat)
        ctx.shape = x.shape
        return rows[flat]

    @staticmethod
    def backward(ctx, g):
        from ..kernels.segment_sum import segment_sum

        (flat,) = ctx.saved_tensors
        tail = g.shape[flat.dim():]
        n_rows = math.prod(ctx.shape) // max(math.prod(tail), 1)
        rows = g.reshape(-1, *tail)
        if tail:
            rows = rows.reshape(rows.shape[0], -1)
        out = segment_sum(rows.contiguous(), flat.reshape(-1), n_rows)
        return out.reshape(ctx.shape), None, None


def per_lane(x, axes: int = 1):
    """A per-run value (the clock, a scalar of a subsystem's state)
    broadcast over ``axes`` trailing axes of a state: an ensemble's ``[K]``
    tensor becomes ``[K, 1, ...]``; a solo run's 0-d tensor or a Python
    number stays as it is."""
    if isinstance(x, torch.Tensor) and x.dim():
        return x.view(x.shape + (1,) * axes)
    return x


class JobsState(NamedTuple):
    """Struct-of-arrays over a fixed job capacity J (padded with inactive rows)."""

    job_id: torch.Tensor     # i32[J] external id (e.g. PanDA job id)
    arrival: torch.Tensor    # f32[J] seconds
    work: torch.Tensor       # f32[J] compute demand (HS23-normalised core-seconds)
    cores: torch.Tensor      # i32[J] cores required (1 or 8 for ATLAS single/multicore)
    memory: torch.Tensor     # f32[J] GB resident
    bytes_in: torch.Tensor   # f32[J] stage-in volume
    bytes_out: torch.Tensor  # f32[J] stage-out volume
    priority: torch.Tensor   # f32[J] higher starts first within a site queue
    state: torch.Tensor      # i32[J] lifecycle state
    site: torch.Tensor       # i32[J] assigned site, -1 if none
    t_assign: torch.Tensor   # f32[J] time assigned to a site (inf until set)
    t_start: torch.Tensor    # f32[J] time execution started
    t_finish: torch.Tensor   # f32[J] time execution finished/failed
    retries: torch.Tensor    # i32[J] resubmission count
    will_fail: torch.Tensor  # bool[J] sampled at start: this attempt fails
    valid: torch.Tensor      # bool[J] row is a real job (padding rows are False)
    dataset: torch.Tensor    # i32[J] input dataset id, -1 = no catalogued dataset
    xfer_src: torch.Tensor   # i32[J] replica site the last stage-in read from (-1 none)
    xfer_bytes: torch.Tensor  # f32[J] WAN bytes moved by the last stage-in (0 = cache hit)
    xfer_time: torch.Tensor  # f32[J] stage-in duration of the last attempt
    xfer_wait: torch.Tensor  # f32[J] transfer queue-wait of the last attempt
    xfer_qdepth: torch.Tensor  # i32[J] link-queue depth seen at enqueue (-1 = never enqueued)
    preempted: torch.Tensor  # i32[J] attempts cut short by site outages
    wf_id: torch.Tensor      # i32[J] workflow the job belongs to, -1 = standalone
    n_parents: torch.Tensor  # i32[J] number of DAG parents (0 = root / standalone)
    dag_depth: torch.Tensor  # i32[J] longest root->job path length (0 for roots)
    wf_crit: torch.Tensor    # f32[J] critical-path weight
    out_dataset: torch.Tensor  # i32[J] dataset this job materializes on completion, -1 = none

    @property
    def capacity(self) -> int:
        return self.arrival.shape[-1]


class SiteState(NamedTuple):
    """Struct-of-arrays over a fixed site capacity S."""

    cores: torch.Tensor        # i32[S] total cores
    speed: torch.Tensor        # f32[S] per-core work units / second
    memory: torch.Tensor       # f32[S] GB
    bw_in: torch.Tensor        # f32[S] ingress bandwidth bytes/s (shared by staging jobs)
    bw_out: torch.Tensor       # f32[S] egress bandwidth bytes/s
    latency: torch.Tensor      # f32[S] per-transfer latency seconds
    par_gamma: torch.Tensor    # f32[S] Amdahl contention: speedup = c / (1 + gamma*(c-1))
    fail_rate: torch.Tensor    # f32[S] per-attempt failure probability
    active: torch.Tensor       # bool[S] site exists / is up (elasticity + padding)
    free_cores: torch.Tensor   # i32[S]
    free_memory: torch.Tensor  # f32[S]
    n_assigned: torch.Tensor   # i32[S] cumulative jobs assigned
    n_finished: torch.Tensor   # i32[S] cumulative finished
    n_failed: torch.Tensor     # i32[S] cumulative failed attempts

    @property
    def capacity(self) -> int:
        return self.cores.shape[-1]


class EventLog(NamedTuple):
    """Fixed-shape ring buffer of per-round snapshots (CGSim Table 1 / dashboard
    feed): per-site pressure columns and global per-state tallies."""

    time: torch.Tensor          # f32[R]
    round_idx: torch.Tensor     # i32[R]
    counts: torch.Tensor        # i32[R, N_STATES]
    n_started: torch.Tensor     # i32[R] jobs started this round
    n_completed: torch.Tensor   # i32[R]
    site_free: torch.Tensor     # i32[R, S]
    site_queued: torch.Tensor   # i32[R, S] jobs sitting in each site queue
    site_running: torch.Tensor  # i32[R, S]
    extra: dict                 # {name: [R, ...]} subsystem-declared columns
    cursor: int                 # next write slot (wraps); the host loop owns it
                                # (an ensemble's is each lane's own, i32[K])

    @property
    def rows(self) -> int:
        return self.time.shape[-1]


class EngineState(NamedTuple):
    """The round-loop carry.  A solo run's ``round`` and log cursor are host
    integers: the loop runs in Python and decides on the host which rounds
    log.

    An ensemble of K lanes carries a leading K on every tensor (``clock``
    and ``halted`` are ``[K]``), and ``round`` and the log cursor are each
    lane's own, ``i32[K]``: a lane frozen by a horizon resumes at its own
    count, as ``vmap`` of the JAX package's ``while_loop`` counts."""

    clock: torch.Tensor        # f32[]
    round: int                 # i32[K] in an ensemble
    jobs: JobsState
    sites: SiteState
    rng: torch.Tensor          # threefry key, see rng.py
    policy_state: object       # policy-defined value
    log: EventLog
    halted: torch.Tensor       # bool[] no further progress possible
    ext: dict                  # {subsystem name: state}; "~"-prefixed keys are
                               # engine-internal carries ("~cand", "~srank")


class SimResult(NamedTuple):
    """A run's outcome; an ensemble's has a leading K on every tensor, with
    ``makespan`` f32[K], ``rounds`` i32[K] and ``log.cursor`` i32[K]."""

    makespan: torch.Tensor     # f32[] clock at termination
    rounds: int
    jobs: JobsState
    sites: SiteState
    log: EventLog
    policy_state: object
    replicas: object = None    # final replica catalog (None without a data policy)
    data_state: object = ()
    avail: object = None       # final AvailabilityState (None without availability)
    wf: object = None          # final WorkflowState (None without a workflow DAG)
    ext: object = None         # {name: final state} for every attached subsystem


def make_jobs(
    *,
    job_id,
    arrival,
    work,
    cores,
    memory,
    bytes_in,
    bytes_out,
    priority=None,
    dataset=None,
    wf_id=None,
    n_parents=None,
    dag_depth=None,
    wf_crit=None,
    out_dataset=None,
    capacity: int | None = None,
    device="cuda",
) -> JobsState:
    """Build a JobsState from per-job vectors, padding to ``capacity`` rows."""
    device = resolve_device(device)
    arrival = torch.as_tensor(arrival, dtype=torch.float32, device=device)
    n = arrival.shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < number of jobs {n}")

    def pad(x, dtype, fill=0):
        x = torch.as_tensor(x, dtype=dtype, device=device)
        return torch.cat([x, torch.full((cap - n,), fill, dtype=dtype, device=device)])

    def full(fill, dtype):
        return torch.full((cap,), fill, dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    zeros_f = torch.zeros((n,), dtype=f32)
    zeros_i = torch.zeros((n,), dtype=i32)
    minus1 = torch.full((n,), -1, dtype=i32)
    valid = torch.arange(cap, device=device) < n
    return JobsState(
        job_id=pad(job_id, i32, -1),
        arrival=pad(arrival, f32, INF),
        work=pad(work, f32),
        cores=pad(cores, i32, 1),
        memory=pad(memory, f32),
        bytes_in=pad(bytes_in, f32),
        bytes_out=pad(bytes_out, f32),
        priority=pad(zeros_f if priority is None else priority, f32),
        state=torch.where(valid, PENDING, DONE).to(i32),
        site=full(-1, i32),
        t_assign=full(INF, f32),
        t_start=full(INF, f32),
        t_finish=full(INF, f32),
        retries=full(0, i32),
        will_fail=full(False, torch.bool),
        valid=valid,
        dataset=pad(minus1 if dataset is None else dataset, i32, -1),
        xfer_src=full(-1, i32),
        xfer_bytes=full(0.0, f32),
        xfer_time=full(0.0, f32),
        xfer_wait=full(0.0, f32),
        xfer_qdepth=full(-1, i32),
        preempted=full(0, i32),
        wf_id=pad(minus1 if wf_id is None else wf_id, i32, -1),
        n_parents=pad(zeros_i if n_parents is None else n_parents, i32),
        dag_depth=pad(zeros_i if dag_depth is None else dag_depth, i32),
        wf_crit=pad(zeros_f if wf_crit is None else wf_crit, f32),
        out_dataset=pad(minus1 if out_dataset is None else out_dataset, i32, -1),
    )


# Per-column fill values for inert job padding rows (DONE/invalid, never
# arriving).  A padding row built from these is a fixed point of the engine,
# so padded and unpadded runs compare bit for bit.
JOB_PAD_FILLS = dict(
    job_id=-1, arrival=float("inf"), state=DONE, site=-1, t_assign=float("inf"),
    t_start=float("inf"), t_finish=float("inf"), valid=False, dataset=-1,
    xfer_src=-1, xfer_qdepth=-1, wf_id=-1, out_dataset=-1, cores=1,
)


def pad_jobs_capacity(jobs: JobsState, capacity: int) -> JobsState:
    """Grow a JobsState to ``capacity`` rows of inert padding (along the last
    axis, so a lane-stacked ``[K, J]`` state pads every lane)."""
    J = jobs.capacity
    if capacity == J:
        return jobs
    if capacity < J:
        raise ValueError(f"capacity {capacity} < current job capacity {J}")

    def pad(name, x):
        fill = torch.full(x.shape[:-1] + (capacity - J,), JOB_PAD_FILLS.get(name, 0),
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, fill], -1)

    return JobsState(**{k: pad(k, v) for k, v in jobs._asdict().items()})


def make_sites(
    *,
    cores,
    speed,
    memory,
    bw_in,
    bw_out,
    latency=None,
    par_gamma=None,
    fail_rate=None,
    capacity: int | None = None,
    device="cuda",
) -> SiteState:
    device = resolve_device(device)
    cores = torch.as_tensor(cores, dtype=torch.int32, device=device)
    n = cores.shape[0]
    cap = capacity or n

    def pad(x, dtype, fill=0):
        x = torch.as_tensor(x, dtype=dtype, device=device).broadcast_to((n,))
        return torch.cat([x, torch.full((cap - n,), fill, dtype=dtype, device=device)])

    f32 = torch.float32
    zeros = torch.zeros((n,), dtype=f32)
    cores_p = pad(cores, torch.int32)
    mem_p = pad(memory, f32)
    return SiteState(
        cores=cores_p,
        speed=pad(speed, f32, 1.0),
        memory=mem_p,
        bw_in=pad(bw_in, f32, 1.0),
        bw_out=pad(bw_out, f32, 1.0),
        latency=pad(zeros if latency is None else latency, f32),
        par_gamma=pad(zeros if par_gamma is None else par_gamma, f32),
        fail_rate=pad(zeros if fail_rate is None else fail_rate, f32),
        active=torch.arange(cap, device=device) < n,
        free_cores=cores_p.clone(),
        free_memory=mem_p.clone(),
        n_assigned=torch.zeros((cap,), dtype=torch.int32, device=device),
        n_finished=torch.zeros((cap,), dtype=torch.int32, device=device),
        n_failed=torch.zeros((cap,), dtype=torch.int32, device=device),
    )


def make_log(rows: int, n_sites: int, extra: dict | None = None, device="cuda",
             lanes: tuple = ()) -> EventLog:
    """Allocate the ring buffer (at least one row, as the JAX engine does).
    ``extra`` maps subsystem column names to their time-zero row values;
    unwritten rows keep that initial value.  ``lanes`` (an ensemble's
    ``(K,)``) leads every column, and each lane's ``extra`` values lead with
    it."""
    device = resolve_device(device)
    r = max(rows, 1)
    i32 = torch.int32
    n = len(lanes)
    extra = {k: torch.as_tensor(v, device=device) for k, v in (extra or {}).items()}

    def full(shape, fill, dtype):
        return torch.full((*lanes, r, *shape), fill, dtype=dtype, device=device)

    return EventLog(
        time=full((), float("nan"), torch.float32),
        round_idx=full((), -1, i32),
        counts=full((N_STATES,), 0, i32),
        n_started=full((), 0, i32),
        n_completed=full((), 0, i32),
        site_free=full((n_sites,), 0, i32),
        site_queued=full((n_sites,), 0, i32),
        site_running=full((n_sites,), 0, i32),
        extra={k: v.unsqueeze(n).expand(*v.shape[:n], r, *v.shape[n:]).clone()
               for k, v in extra.items()},
        cursor=0,
    )
