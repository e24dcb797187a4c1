#!/usr/bin/env python3
"""Where the subsystem path's rounds go: chip_smoke.py's phase 9 scenario
(300 sites, 100000 jobs in 25000 4-stage ATLAS MC workflows, flaky-site
outages) run with its features added one at a time, on one GPU.

    python3 scripts/subsystem_cost.py [--rounds N]

Configurations, each with capacity dispatch (the assign kernel):

1. ``panda_dispatch``, no subsystem, no event log;
2. the same with the 256-row event log written every round;
3. ``critical_path_first`` (its rank turns off the packed start order);
4. with ``availability=`` (the flaky-site calendar);
5. with ``workflow=`` too: phase 9's configuration.

Each runs N rounds (default 1000) twice, in turns (1..5, then 5..1), and
100 rounds under ``torch.profiler``; the script reports rounds/s, kernels
a round, segment-sum launches a round and the device busy share, and writes them to ``chiprun_out/subsystem_cost.json``.
It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ("plain", "+log", "+crit_rank", "+availability", "+workflow")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=1000)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("subsystem_cost: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch import core as T
    from repro_torch.kernels.assign import make_capacity_assign
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[cost] {card}")
    scn, sites, av = chip_smoke.subsystem_scenario(device, chip_smoke.ENGINE_S,
                                                   chip_smoke.SUB_CHAINS)
    assign = make_capacity_assign(scn.jobs.cores)

    def run(config: str, rounds: int):
        i = CONFIGS.index(config)
        name = "critical_path_first" if i >= 2 else "panda_dispatch"
        policy = T.with_capacity_assign(T.get_policy(name), assign)
        return T.simulate(scn.jobs, sites, policy, T.PRNGKey(0), max_rounds=rounds,
                          log_rows=256 if i >= 1 else 0, availability=av if i >= 3 else None,
                          workflow=scn.workflow if i >= 4 else None, device=device)

    out = {c: dict(rounds_per_s=[]) for c in CONFIGS}
    for config in CONFIGS:  # warm the allocator and the kernels' first launches
        run(config, 50)
    for order in (CONFIGS, CONFIGS[::-1]):
        for config in order:
            segsum_mod.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(config, args.rounds)
            torch.cuda.synchronize()
            out[config]["rounds_per_s"].append(res.rounds / (time.perf_counter() - t0))
            out[config]["segment_sums_a_round"] = segsum_mod.launches / res.rounds
    for config in CONFIGS:
        run(config, 100)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(config, 100)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        out[config].update(kernels_a_round=sum(e.count for e in kernels) / 100,
                           busy_share=busy_ms / wall_ms)
    for config in CONFIGS:
        o = out[config]
        print(f"[cost] {config:>14s}: rounds/s {o['rounds_per_s'][0]:.2f} and "
              f"{o['rounds_per_s'][1]:.2f}; {o['kernels_a_round']:.1f} kernels a round, "
              f"{o['segment_sums_a_round']:.2f} segment sums a round, busy "
              f"{100 * o['busy_share']:.1f}%")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "subsystem_cost.json").write_text(
        json.dumps(dict(card=card, rounds=args.rounds, configs=out), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
