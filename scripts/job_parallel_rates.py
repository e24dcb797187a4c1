#!/usr/bin/env python3
"""Time ``simulate`` against ``distributed.simulate_distributed`` on a
1-rank NCCL mesh, on one GPU, at ``chip_smoke.py``'s dense engine
configuration (S=300, J=100000, ``panda_dispatch`` + capacity dispatch,
300 rounds), in turns (simulate, job-parallel, job-parallel, simulate).

    PYTHONPATH=src:. python scripts/job_parallel_rates.py

It prints the first job-parallel call's time (NCCL sets its communicator up
at the first collective), the rounds/s of each run, the host and device
time of one ``i32[100000]`` all-gather (the functional collective the round
uses, ``torch.distributed.all_gather_into_tensor``, and a plain copy),
the job-parallel rate with the round's gathers replaced by those two, and
the kernels and device time a round and the host ops with the most host
time over 20 profiled rounds of each.  Needs a CUDA device.
"""
import sys
import time

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import chip_smoke as c
from repro_torch import core as T
from repro_torch.core import distributed as D

ROUNDS = 300
PROFILED = 20


def main() -> int:
    if not torch.cuda.is_available():
        print("job_parallel_rates: needs a CUDA device", file=sys.stderr)
        return 1
    c.phase_build()
    d = torch.device("cuda", 0)
    sites = T.atlas_like_platform(c.ENGINE_S, seed=1, device=d)
    jobs = T.synthetic_panda_jobs(c.ENGINE_J, seed=0, duration=6 * 3600.0, device=d)
    pol = c.jp_policy("dense", jobs.cores, [])

    def rate(fn, r=ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(r)
        torch.cuda.synchronize()
        return res.rounds / (time.perf_counter() - t0)

    def c10d_gather(x, n, group):
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    def copy_gather(x, n, group):
        return x.clone()

    print(f"[rates] card: {c.gpu_name_and_power()}")
    with D.local_mesh("cuda") as mesh:
        def sim(r):
            return T.simulate(jobs, sites, pol, T.PRNGKey(0), max_rounds=r, device=d)

        def sd(r):
            return D.simulate_distributed(jobs, sites, pol, T.PRNGKey(0), mesh, max_rounds=r)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sd(2)
        torch.cuda.synchronize()
        print(f"[rates] first simulate_distributed call (2 rounds, NCCL set-up): "
              f"{time.perf_counter() - t0:.3f}s")
        sim(5)
        for label, fn in (("simulate", sim), ("simulate_distributed", sd),
                          ("simulate_distributed", sd), ("simulate", sim)):
            print(f"[rates] {label}: {rate(fn):.2f} rounds/s")
        group = D._axis_group(mesh, "data")[0]
        x = torch.arange(c.ENGINE_J, dtype=torch.int32, device=d)
        real = D._all_gather
        for name, g in (("functional", real), ("c10d", c10d_gather), ("copy", copy_gather)):
            for _ in range(10):
                g(x, 1, group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                g(x, 1, group)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            print(f"[rates] gather {name}: host {t1 - t0:.4f} ms a call, with the sync "
                  f"{t2 - t0:.4f} ms a call (1000 calls)")
        try:
            for name, g in (("c10d", c10d_gather), ("copy", copy_gather)):
                D._all_gather = g
                print(f"[rates] simulate_distributed with the {name} gather: {rate(sd):.2f}, "
                      f"{rate(sd):.2f} rounds/s")
        finally:
            D._all_gather = real
        print(f"[rates] simulate again: {rate(sim):.2f}; simulate_distributed again: "
              f"{rate(sd):.2f} rounds/s")
        for label, fn in (("simulate", sim), ("simulate_distributed", sd)):
            fn(3)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn(PROFILED)
                torch.cuda.synchronize()
            ev = prof.key_averages()
            on_card = [e for e in ev if str(getattr(e, "device_type", "")).endswith("CUDA")]
            print(f"[rates] {label}: {sum(e.count for e in on_card) / PROFILED:.1f} kernels a "
                  f"round; device busy "
                  f"{sum(e.self_device_time_total for e in on_card) / 1e3 / PROFILED:.3f} ms a round")
            host = sorted((e for e in ev if e not in on_card),
                          key=lambda e: -e.self_cpu_time_total)[:12]
            for e in host:
                print(f"[rates]   {label} host {e.key[:70]:70s} {e.count / PROFILED:7.1f}x "
                      f"{e.self_cpu_time_total / 1e3 / PROFILED:8.3f} ms a round")
    return 0


if __name__ == "__main__":
    sys.exit(main())
