#!/usr/bin/env python3
"""``chip_smoke.py`` phase 24(d) on its own: the smoke's dense engine
configuration (S=300, J=100000, ``panda_dispatch`` + capacity dispatch,
300 rounds) through ``distributed.simulate_distributed`` on 2..N spawned
NCCL ranks, one card a rank, every rank's result held bit for bit against
``simulate`` on cuda:0.

    PYTHONPATH=src:. python scripts/job_parallel_cards.py

Prints ``simulate``'s rounds/s and peak memory on one card, then for each
rank count the rounds/s over the slowest rank's wall time and each rank's
peak memory (``chip_smoke.jp_scaling``; a rank warms up, waits at a
barrier, then runs timed).  Needs two or more CUDA devices.
"""
import json
import sys
import time

import torch

import chip_smoke as c
from repro_torch import core as T


def main() -> int:
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"job_parallel_cards: needs two or more CUDA devices, found {n_cards}",
              file=sys.stderr)
        return 1
    c.phase_build()
    print(f"[cards] {n_cards} x {c.gpu_name_and_power()}")
    d = torch.device("cuda", 0)
    sites = T.atlas_like_platform(c.ENGINE_S, seed=1, device=d)
    jobs = T.synthetic_panda_jobs(c.ENGINE_J, seed=0, duration=6 * 3600.0, device=d)
    pol = c.jp_policy("dense", jobs.cores, [])
    T.simulate(jobs, sites, pol, T.PRNGKey(0), max_rounds=c.MESH_WARMUP_ROUNDS, device=d)
    torch.cuda.synchronize(d)
    torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    res = T.simulate(jobs, sites, pol, T.PRNGKey(0), max_rounds=c.DENSE_FULL_ROUNDS, device=d)
    torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    want = c.snapshot_digest(c.snapshot(res))
    print(f"[cards] simulate on cuda:0, {res.rounds} rounds: {res.rounds / wall:.2f} rounds/s; "
          f"peak {torch.cuda.max_memory_allocated(d) / 1e9:.3f} GB")
    del res
    torch.cuda.empty_cache()
    rows = c.jp_scaling(want, n_cards)
    print(json.dumps({"job_parallel_cards": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
