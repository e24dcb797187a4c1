"""Time ``chip_smoke.py`` phase 16(c)'s four CPU lanes in several checkouts,
alternating, each run in a process of its own.

    python scripts/xens_cpu_ab.py [--rounds 200] [--reps 2] ROOT [ROOT ...]

Each ROOT holds a ``chip_smoke.py`` and its ``src/repro_torch``.  The runs go
ROOT1 .. ROOTn, then the reverse, ``--reps`` times over (parent, change,
change, parent for two roots and one rep).  A run builds 16(c)'s lanes from
that ROOT's ``chip_smoke.py`` (S = 50, 3000 to 5000 jobs a lane in
workflows, flaky-site outages, ``critical_path_first`` with capacity
dispatch) on the CPU, and prints one JSON line: the wall seconds of
``simulate_many``, the process's CPU seconds over them, torch's thread
count, the load average before and after, the assignment calls, and each
lane's rounds and preemptions.  CPU seconds far below threads x wall mean
the process waited for cores.  No card is needed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r'''
import importlib.util, json, os, sys, time
root, rounds = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, os.path.join(root, "src"))
spec = importlib.util.spec_from_file_location("smoke", os.path.join(root, "chip_smoke.py"))
CS = importlib.util.module_from_spec(spec)
spec.loader.exec_module(CS)
import torch
from repro_torch import core as T

cpu = torch.device("cpu")
subs = (T.availability_subsystem(), T.workflow_subsystem())
stacked = T.stack_scenarios(CS.ensemble_subsystem_scenarios(cpu, CS.XENS_S, CS.XENS_CHAINS),
                            subsystems=subs)
inner = CS.lane_capacity_assign([stacked])
calls = [0]

def assign_fn(*args):
    calls[0] += 1
    return inner(*args)

policy = T.with_capacity_assign(T.get_policy("critical_path_first"), assign_fn)
load0 = os.getloadavg()[0]
c0, t0 = time.process_time(), time.perf_counter()
res = T.simulate_many(stacked, policy, T.PRNGKey(5), subsystems=subs, max_rounds=rounds,
                      log_rows=rounds, device=cpu)
wall, cpu_s = time.perf_counter() - t0, time.process_time() - c0
print(json.dumps(dict(root=root, wall_s=wall, cpu_s=cpu_s, threads=torch.get_num_threads(),
                      load_before=load0, load_after=os.getloadavg()[0], assign_calls=calls[0],
                      rounds=res.rounds.tolist(),
                      preempted=res.avail.n_preempted.sum(-1).tolist())))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args(argv)
    order = []
    for _ in range(args.reps):
        order += args.roots + args.roots[::-1]
    for root in order:
        res = subprocess.run([sys.executable, "-c", RUN, os.path.abspath(root), str(args.rounds)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
