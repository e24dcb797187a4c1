"""Hill-climbing command line: measure a cell under optimization variants and log
hypothesis -> change -> before -> after.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell qwen2.5-32b:prefill_32k \
        --variant 'qblock:attention_impl=qblock' --variant 'bigchunk:attn_chunk=2048'

Variants are ``name:key=val,key=val`` (ints/floats/bools/strs auto-coerced;
``mb=N`` sets microbatches, ``plan.key=val`` a CellPlan field).  Results
append to results/perf/<cell>.jsonl.
"""
from __future__ import annotations

import argparse
import json
import os

from .measure import measure_cell


def _coerce(v: str):
    if v in ("True", "true"):
        return True
    if v in ("False", "false"):
        return False
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def parse_variant(spec: str):
    name, _, kvs = spec.partition(":")
    overrides, plan_overrides, mb = {}, {}, None
    if kvs:
        for kv in kvs.split(","):
            k, _, v = kv.partition("=")
            if k == "mb":
                mb = int(v)
            elif k.startswith("plan."):
                plan_overrides[k[5:]] = _coerce(v)
            else:
                overrides[k] = _coerce(v)
    return name, overrides, plan_overrides, mb


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variant", action="append", default=[],
                    help="name:key=val,... ('baseline' runs plan defaults)")
    ap.add_argument("--out", default="results/perf")
    args = ap.parse_args()
    arch, _, shape = args.cell.partition(":")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{arch}__{shape}.jsonl")

    variants = [("baseline", {}, {}, None)] if not args.variant else [
        parse_variant(v) for v in args.variant
    ]
    for name, overrides, plan_overrides, mb in variants:
        try:
            rec = measure_cell(arch, shape, overrides=overrides, microbatches=mb,
                               plan_overrides=plan_overrides)
            rec["variant"] = name
            rec["overrides"] = {**overrides, **{f"plan.{k}": v for k, v in plan_overrides.items()}}
            if mb is not None:
                rec["microbatches"] = mb
        except Exception as e:  # noqa: BLE001
            rec = dict(arch=arch, shape=shape, variant=name, overrides=overrides,
                       ok=False, error=f"{type(e).__name__}: {e}")
            print("FAIL", name, rec["error"])
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
