"""Operational metrics (paper §1: queue time, CPU efficiency, failure rate,
throughput) computed from a finished ``SimResult``.

The transfer and fault fields exist for the JAX package's layout; without
those subsystems they are 0, as there.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .types import DONE, FAILED, SimResult


class Metrics(NamedTuple):
    makespan: torch.Tensor
    n_done: torch.Tensor
    n_failed: torch.Tensor
    failure_rate: torch.Tensor
    mean_walltime: torch.Tensor
    mean_queue_time: torch.Tensor
    p95_queue_time: torch.Tensor
    throughput: torch.Tensor        # finished jobs / simulated second
    core_utilization: torch.Tensor  # busy core-seconds / (total cores x makespan)
    cpu_efficiency: torch.Tensor    # compute seconds / walltime seconds (I/O overhead)
    p50_queue_time: torch.Tensor
    p99_queue_time: torch.Tensor
    p50_walltime: torch.Tensor
    p95_walltime: torch.Tensor
    p99_walltime: torch.Tensor
    p50_xfer_wait: torch.Tensor
    p95_xfer_wait: torch.Tensor
    p99_xfer_wait: torch.Tensor
    p50_xfer_time: torch.Tensor
    p95_xfer_time: torch.Tensor
    p99_xfer_time: torch.Tensor
    time_lost_failures: torch.Tensor
    p50_retries: torch.Tensor
    p95_retries: torch.Tensor
    p99_retries: torch.Tensor
    p50_backoff_wait: torch.Tensor
    p95_backoff_wait: torch.Tensor
    p99_backoff_wait: torch.Tensor


def _masked_percentile(values: torch.Tensor, mask: torch.Tensor, n: torch.Tensor, q: float):
    """Percentile of ``values[mask]`` without dynamic shapes: masked-out rows
    sort to the front as ``-inf``, so the q-th valid element sits at a fixed
    offset from the tail (same truncation and clamp as the JAX package)."""
    cap = values.shape[-1]
    sorted_ = torch.sort(torch.where(mask, values, float("-inf"))).values
    idx = ((cap - n) + (q * n).int()).clamp(0, cap - 1)
    return sorted_[idx.long()].clamp_min(0.0)


def compute_metrics(result: SimResult) -> Metrics:
    jobs, sites = result.jobs, result.sites
    done = (jobs.state == DONE) & jobs.valid
    failed = (jobs.state == FAILED) & jobs.valid
    n_done = done.sum()
    n_failed = failed.sum()
    zero = torch.zeros((), dtype=torch.float32, device=n_done.device)

    wall = torch.where(done, jobs.t_finish - jobs.t_start, 0.0)
    queue = torch.where(done, jobs.t_start - jobs.arrival, 0.0)
    mean_wall = wall.sum() / n_done.clamp_min(1)
    mean_queue = queue.sum() / n_done.clamp_min(1)
    q_raw = jobs.t_start - jobs.arrival
    w_raw = jobs.t_finish - jobs.t_start

    busy = torch.where(done | failed, (jobs.t_finish - jobs.t_start) * jobs.cores, 0.0).sum()
    total_cores = torch.where(sites.active, sites.cores, 0).sum().float()
    makespan = result.makespan.clamp_min(1e-9)
    util = busy / (total_cores * makespan).clamp_min(1e-9)

    # share of walltime spent computing (vs staging) under the service model
    site = jobs.site.clamp(0, sites.capacity - 1).long()
    compute_t = torch.where(
        done, jobs.work / (sites.speed[site] * jobs.cores.float()).clamp_min(1e-9), 0.0
    )
    eff = compute_t.sum() / wall.sum().clamp_min(1e-9)

    # transfer tails over completed jobs whose last stage-in moved WAN bytes
    moved = done & (jobs.xfer_bytes > 0)
    n_moved = moved.sum()
    term = done | failed
    n_term = term.sum()
    retries_f = jobs.retries.float()

    return Metrics(
        makespan=result.makespan,
        n_done=n_done,
        n_failed=n_failed,
        failure_rate=n_failed / (n_done + n_failed).clamp_min(1),
        mean_walltime=mean_wall,
        mean_queue_time=mean_queue,
        p95_queue_time=_masked_percentile(q_raw, done, n_done, 0.95),
        throughput=n_done / makespan,
        core_utilization=util,
        cpu_efficiency=eff.clamp_max(1.0),
        p50_queue_time=_masked_percentile(q_raw, done, n_done, 0.50),
        p99_queue_time=_masked_percentile(q_raw, done, n_done, 0.99),
        p50_walltime=_masked_percentile(w_raw, done, n_done, 0.50),
        p95_walltime=_masked_percentile(w_raw, done, n_done, 0.95),
        p99_walltime=_masked_percentile(w_raw, done, n_done, 0.99),
        p50_xfer_wait=_masked_percentile(jobs.xfer_wait, moved, n_moved, 0.50),
        p95_xfer_wait=_masked_percentile(jobs.xfer_wait, moved, n_moved, 0.95),
        p99_xfer_wait=_masked_percentile(jobs.xfer_wait, moved, n_moved, 0.99),
        p50_xfer_time=_masked_percentile(jobs.xfer_time, moved, n_moved, 0.50),
        p95_xfer_time=_masked_percentile(jobs.xfer_time, moved, n_moved, 0.95),
        p99_xfer_time=_masked_percentile(jobs.xfer_time, moved, n_moved, 0.99),
        time_lost_failures=zero,
        p50_retries=_masked_percentile(retries_f, term, n_term, 0.50),
        p95_retries=_masked_percentile(retries_f, term, n_term, 0.95),
        p99_retries=_masked_percentile(retries_f, term, n_term, 0.99),
        p50_backoff_wait=zero,
        p95_backoff_wait=zero,
        p99_backoff_wait=zero,
    )


def summary_str(m: Metrics) -> str:
    return (
        f"makespan={float(m.makespan):.1f}s done={int(m.n_done)} failed={int(m.n_failed)} "
        f"fail_rate={float(m.failure_rate):.3f} mean_wall={float(m.mean_walltime):.1f}s "
        f"mean_queue={float(m.mean_queue_time):.1f}s "
        f"queue_p50/95/99={float(m.p50_queue_time):.1f}/{float(m.p95_queue_time):.1f}/"
        f"{float(m.p99_queue_time):.1f}s "
        f"wall_p50/95/99={float(m.p50_walltime):.1f}/{float(m.p95_walltime):.1f}/"
        f"{float(m.p99_walltime):.1f}s "
        f"throughput={float(m.throughput) * 3600.0:.1f} jobs/h "
        f"util={float(m.core_utilization):.3f} cpu_eff={float(m.cpu_efficiency):.3f} "
        f"xfer_wait_p50/95/99={float(m.p50_xfer_wait):.1f}/{float(m.p95_xfer_wait):.1f}/"
        f"{float(m.p99_xfer_wait):.1f}s "
        f"xfer_time_p50/95/99={float(m.p50_xfer_time):.1f}/{float(m.p95_xfer_time):.1f}/"
        f"{float(m.p99_xfer_time):.1f}s "
        f"time_lost={float(m.time_lost_failures):.1f}s "
        f"retries_p50/95/99={float(m.p50_retries):.0f}/{float(m.p95_retries):.0f}/"
        f"{float(m.p99_retries):.0f} "
        f"backoff_p50/95/99={float(m.p50_backoff_wait):.1f}/{float(m.p95_backoff_wait):.1f}/"
        f"{float(m.p99_backoff_wait):.1f}s"
    )
