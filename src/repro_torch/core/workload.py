"""PanDA-shaped synthetic workloads, availability calendars and fault scenarios.

The same generators as the JAX package's ``workload`` module
(``synthetic_panda_jobs``, ``maintenance_calendar``, ``flaky_sites``,
``rolling_brownout``, ``lossy_links``, ``replica_loss_calendar``,
``flaky_grid``): numpy's ``default_rng`` draws every column, window and
event on the host, so a seed gives the same scenario bit for bit in both
packages.  ``from_records`` ingests job records (a list of dicts, a dict of
columns, CSV text or JSON text).
"""
from __future__ import annotations

import csv
import io
import json

import numpy as np
import torch

from .types import JobsState, make_jobs


def synthetic_panda_jobs(
    n_jobs: int,
    *,
    seed: int = 0,
    duration: float = 24 * 3600.0,
    multicore_frac: float = 0.5,
    mean_walltime_hours: float = 4.0,
    burstiness: float = 0.3,
    n_datasets: int | None = None,
    zipf_alpha: float = 1.2,
    capacity: int | None = None,
    device="cuda",
) -> JobsState:
    """ATLAS-production-shaped synthetic workload.

    work is calibrated so that on a speed-10 site a single-core job averages
    ``mean_walltime_hours``; multicore (8-core) jobs carry ~8x the work, as in
    ATLAS reconstruction/simulation task splits.  ``n_datasets`` assigns each
    job an input dataset with Zipf(``zipf_alpha``) popularity; None leaves
    ``dataset = -1``.
    """
    rng = np.random.default_rng(seed)
    dataset = None
    if n_datasets is not None:
        p = 1.0 / np.arange(1, n_datasets + 1) ** zipf_alpha
        dataset = rng.choice(n_datasets, size=n_jobs, p=p / p.sum()).astype(np.int32)
    multicore = rng.random(n_jobs) < multicore_frac
    cores = np.where(multicore, 8, 1).astype(np.int32)

    base_work = 10.0 * mean_walltime_hours * 3600.0  # work units at speed 10
    work = rng.lognormal(mean=np.log(base_work), sigma=0.8, size=n_jobs)
    work = work * np.where(multicore, 8.0, 1.0)

    # bursty arrivals: a Poisson process with a slow sinusoidal rate modulation
    gaps = rng.exponential(duration / max(n_jobs, 1), size=n_jobs)
    arrival = np.cumsum(gaps)
    arrival *= duration / max(arrival[-1], 1e-9)
    arrival += burstiness * duration / 20.0 * np.sin(arrival / duration * 12 * np.pi)
    arrival = np.clip(arrival, 0.0, None)
    arrival.sort()

    memory = np.where(multicore, 16.0, 2.0) * rng.uniform(0.8, 1.2, n_jobs)
    bytes_in = rng.lognormal(np.log(2e9), 1.0, n_jobs)   # ~GBs of input
    bytes_out = rng.lognormal(np.log(5e8), 1.0, n_jobs)
    priority = rng.choice([0.0, 1.0, 2.0], size=n_jobs, p=[0.7, 0.2, 0.1])

    return make_jobs(
        job_id=np.arange(n_jobs, dtype=np.int32),
        arrival=arrival,
        work=work,
        cores=cores,
        memory=memory,
        bytes_in=bytes_in,
        bytes_out=bytes_out,
        priority=priority,
        dataset=dataset,
        capacity=capacity,
        device=device,
    )


def maintenance_calendar(
    n_sites: int,
    *,
    horizon: float,
    period: float = 7 * 86400.0,
    duration: float = 4 * 3600.0,
    first: float | None = None,
    stagger: bool = True,
    sites=None,
    preempt: bool = False,
    device="cuda",
):
    """Scheduled-maintenance scenario: periodic full-outage windows per site.

    Each selected site goes down for ``duration`` every ``period`` seconds,
    starting at ``first`` (default one period in).  ``stagger`` offsets sites
    evenly across the period (rolling maintenance, so the grid never loses
    every site at once).  Drain semantics by default: maintenance is
    announced, queues pause, running jobs finish.
    """
    from .availability import make_availability

    chosen = range(n_sites) if sites is None else sites
    base = period if first is None else first
    windows = []
    for s in chosen:
        offset = (period * (s / max(n_sites, 1))) if stagger else 0.0
        t0 = base + offset
        while t0 < horizon:
            windows.append(dict(site=int(s), start=t0, end=t0 + duration, preempt=preempt))
            t0 += period
    return make_availability(n_sites, windows, device=device)


def flaky_sites(
    n_sites: int,
    flaky,
    *,
    horizon: float,
    mtbf: float = 12 * 3600.0,
    mean_down: float = 1800.0,
    seed: int = 0,
    preempt: bool = True,
    max_windows: int | None = None,
    device="cuda",
):
    """Flaky-T2 scenario: unannounced short outages that kill running jobs.

    Sites flagged in ``flaky`` (bool mask or index list) fail as a Poisson
    process with mean time between failures ``mtbf`` and log-normal repair
    time around ``mean_down``; jobs caught running are preempted and
    resubmitted (a retry).  numpy's ``default_rng`` draws as the JAX
    package's builder does, so a seed gives the same windows.
    """
    from .availability import make_availability

    mask = np.zeros(n_sites, bool)
    flaky = np.asarray(flaky)
    mask[flaky.astype(np.int64) if flaky.dtype != np.bool_ else flaky] = True
    rng = np.random.default_rng(seed)
    windows = []
    for s in np.flatnonzero(mask):
        t = float(rng.exponential(mtbf))
        while t < horizon:
            down = float(rng.lognormal(np.log(mean_down), 0.5))
            windows.append(dict(site=int(s), start=t, end=t + down, preempt=preempt))
            t += down + float(rng.exponential(mtbf))
    return make_availability(n_sites, windows, max_windows=max_windows, device=device)


def rolling_brownout(
    n_sites: int,
    *,
    horizon: float,
    factor: float = 0.5,
    duration: float | None = None,
    start: float = 0.0,
    sites=None,
    device="cuda",
):
    """Rolling brown-out: a degradation wave crosses the grid site by site.

    Each site in turn runs at ``factor`` of its speed and cores for one slot;
    slots tile ``[start, horizon]`` back to back (``duration`` overrides the
    slot length).
    """
    from .availability import make_availability

    chosen = list(range(n_sites) if sites is None else sites)
    if not chosen:
        return make_availability(n_sites, device=device)
    slot = duration if duration is not None else (horizon - start) / len(chosen)
    windows = [
        dict(site=int(s), start=start + i * slot, end=start + (i + 1) * slot, factor=factor)
        for i, s in enumerate(chosen)
    ]
    return make_availability(n_sites, windows, device=device)


# --------------------------------------------------------------------------
# fault-injection scenario builders
# --------------------------------------------------------------------------


def lossy_links(
    n_sites: int,
    *,
    p: float = 0.05,
    hot=None,
    hot_p: float = 0.3,
    seed: int = 0,
) -> np.ndarray:
    """Per-link transfer-failure probabilities for ``make_faults(link_fail_p=)``
    (numpy ``[S, S]``).

    Every WAN link (``src != dst``) fails with probability ``p``; links
    touching a ``hot`` site (an index list, or an int count of sites sampled
    with ``seed``) fail with ``hot_p``: a degraded storage endpoint that
    times out most third-party copies.  Local links never fail.
    """
    mat = np.full((n_sites, n_sites), float(p), np.float32)
    if hot is not None:
        if np.ndim(hot) == 0:
            rng = np.random.default_rng(seed)
            hot = rng.choice(n_sites, size=int(hot), replace=False)
        for s in np.asarray(hot, np.int64).ravel():
            mat[s, :] = hot_p
            mat[:, s] = hot_p
    np.fill_diagonal(mat, 0.0)
    return mat


def replica_loss_calendar(
    n_datasets,
    n_sites: int,
    *,
    horizon: float,
    rate: float = 1.0 / (24 * 3600.0),
    seed: int = 0,
    sites=None,
) -> list[tuple[float, int, int]]:
    """Sampled ``(t, dataset, site)`` loss events for ``make_faults(replica_loss=)``.

    Each candidate site loses a uniformly chosen dataset replica as a Poisson
    process of ``rate`` events a second: disk crashes and storage-element
    corruptions that send readers back to the origin over the WAN.
    ``n_datasets`` also takes a ``ReplicaState``.  Origin copies are immune
    when an event applies, so sampling the origin site is harmless.
    """
    sz = getattr(n_datasets, "size", None)
    D = sz.shape[-1] if getattr(sz, "ndim", 0) else int(n_datasets)
    rng = np.random.default_rng(seed)
    chosen = range(n_sites) if sites is None else sites
    events = []
    for s in chosen:
        t = float(rng.exponential(1.0 / rate))
        while t < horizon:
            events.append((t, int(rng.integers(0, D)), int(s)))
            t += float(rng.exponential(1.0 / rate))
    events.sort()
    return events


def flaky_grid(
    n_sites: int,
    *,
    n_flaky: int = 1,
    flaky_fail_rate: float = 0.9,
    base_fail_rate: float = 0.02,
    seed: int = 0,
    device="cuda",
    **platform_kw,
):
    """Flaky-grid platform: an ``atlas_like_platform`` whose ``n_flaky``
    sites fail almost every job they run (``flaky_fail_rate``) while the rest
    stay healthy, the scenario where the circuit breaker
    (``make_faults(blacklist_threshold=)``) pays off.  Returns ``(sites,
    flaky_idx)``, ``flaky_idx`` a numpy array."""
    from .platform import atlas_like_platform

    sites = atlas_like_platform(n_sites, seed=seed, fail_rate=base_fail_rate, device=device,
                                **platform_kw)
    rng = np.random.default_rng(seed + 1)
    flaky_idx = np.sort(rng.choice(n_sites, size=int(n_flaky), replace=False))
    fr = sites.fail_rate.cpu().numpy().copy()
    fr[flaky_idx] = flaky_fail_rate
    return sites._replace(fail_rate=torch.as_tensor(fr, device=sites.fail_rate.device)), flaky_idx


_FIELDS = ("job_id", "arrival", "work", "cores", "memory", "bytes_in", "bytes_out", "priority")


def from_records(records, *, capacity: int | None = None, device="cuda") -> JobsState:
    """Ingest job records: a list of dicts, a dict of columns, CSV text or
    JSON text (of either form).  Missing columns take ``make_jobs``'s
    defaults: ids 0..n-1, one core, 2 GB, no bytes, priority 0, no dataset."""
    if isinstance(records, str):
        text = records.lstrip()
        if text.startswith("[") or text.startswith("{"):
            records = json.loads(records)
        else:
            records = list(csv.DictReader(io.StringIO(records)))
    if isinstance(records, dict):  # dict of columns
        cols = {k: np.asarray(v) for k, v in records.items()}
    else:  # list of dicts
        cols = {k: np.array([float(r.get(k, 0) or 0) for r in records]) for k in _FIELDS}
    n = len(cols["arrival"])
    return make_jobs(
        job_id=cols.get("job_id", np.arange(n)).astype(np.int32),
        arrival=cols["arrival"],
        work=cols["work"],
        cores=cols.get("cores", np.ones(n)).astype(np.int32),
        memory=cols.get("memory", np.full(n, 2.0)),
        bytes_in=cols.get("bytes_in", np.zeros(n)),
        bytes_out=cols.get("bytes_out", np.zeros(n)),
        priority=cols.get("priority", np.zeros(n)),
        dataset=np.asarray(cols.get("dataset", np.full(n, -1))).astype(np.int32),
        capacity=capacity,
        device=device,
    )


def lm_job_records(cells: list[dict], *, jobs_per_cell: int = 8, seed: int = 0) -> dict:
    """Turn roofline-derived (arch x shape) cells into a grid workload: the
    LM workload layer's link into the simulator (feed the records to
    ``from_records``).

    Each cell dict carries ``flops`` per step and ``steps`` (default 100),
    and optionally ``cores`` (8), ``memory_gb`` (16), ``bytes_in`` (else
    ``bytes``, else 0) and ``bytes_out`` (1e9).  A job's work is its step
    FLOPs x steps in units of 1e12 FLOP (a speed-10 site does 10 TFLOP/s a
    core); arrivals are exponential gaps of mean 60 s from ``seed``.
    Returns a dict of numpy columns, as the JAX package's does."""
    rng = np.random.default_rng(seed)
    rows = {k: [] for k in _FIELDS}
    jid = 0
    t = 0.0
    for cell in cells:
        for _ in range(jobs_per_cell):
            steps = cell.get("steps", 100)
            rows["job_id"].append(jid)
            rows["arrival"].append(t)
            rows["work"].append(cell["flops"] * steps / 1e12)
            rows["cores"].append(int(cell.get("cores", 8)))
            rows["memory"].append(float(cell.get("memory_gb", 16.0)))
            rows["bytes_in"].append(float(cell.get("bytes_in", cell.get("bytes", 0.0))))
            rows["bytes_out"].append(float(cell.get("bytes_out", 1e9)))
            rows["priority"].append(1.0)
            jid += 1
            t += float(rng.exponential(60.0))
    return {k: np.asarray(v) for k, v in rows.items()}
