"""PanDA-shaped synthetic workloads and availability scenario calendars.

The same generators as the JAX package's ``workload`` module
(``synthetic_panda_jobs``, ``maintenance_calendar``, ``flaky_sites``,
``rolling_brownout``): numpy's ``default_rng`` draws every column and
window on the host, so a seed gives the same jobs and windows bit for bit
in both packages.
"""
from __future__ import annotations

import numpy as np

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
