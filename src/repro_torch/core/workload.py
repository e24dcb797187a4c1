"""PanDA-shaped synthetic workloads.

The same generator as the JAX package's ``workload.synthetic_panda_jobs``:
numpy's ``default_rng`` draws every column on the host, so a seed gives the
same jobs bit for bit in both packages.
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
