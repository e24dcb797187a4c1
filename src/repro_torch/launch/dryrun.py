"""Multi-pod dry-run: trace every (architecture x input shape x mesh) cell's
step on meta ``DTensor``s over a fake 256- or 512-rank process group, count
it and record its roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun

The process owns the fake default process group (``mesh.init_fake_world``),
as the JAX package's dry-run owns its 512 forced host devices.  A record has
the JAX package's keys, with these differences: its ``lower_s`` and
``compile_s`` are one ``trace_s`` (the seconds the traced step took),
``peak_bytes_per_device`` is the counted peak (the arguments' local shards
plus the most the step's own results held at once, ``roofline.Counter``)
where the JAX package reads XLA's ``memory_analysis``, and
``memory_analysis`` itself has no counterpart and is left out.  A record
adds ``top_collectives`` (the largest by result shape) and ``donate``.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

import torch

from ..configs import ARCHS, SHAPES, get_skips, runnable_cells
from .measure import traced
from .mesh import make_production_mesh
from .roofline import analyze, model_flops_for_cell
from .specs import build_cell, input_specs, trace_mesh


def _local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree`` (a module, a
    dict, a tuple)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, torch.nn.Module):
        return sum(_local_bytes(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def run_cell(arch: str, shape: str, *, multi_pod: bool, verbose: bool = True) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    n_dev = mesh.size()
    cell = build_cell(arch, shape, mesh)
    tmesh = trace_mesh(mesh)
    fn, args, donate = input_specs(cell, tmesh)
    arg_bytes = _local_bytes(args)
    counts = traced(fn, args, tmesh, peak=True)
    if verbose:
        print(f"[{mesh_name}] {arch} x {shape}: traced in {counts['trace_s']:.1f}s")
    spec = SHAPES[shape]
    rf = analyze(
        arch=arch,
        shape=shape,
        mesh_name=mesh_name,
        n_devices=n_dev,
        counts=counts,
        model_flops_total=model_flops_for_cell(cell.cfg, spec, cell.kind),
        peak_bytes=arg_bytes + counts["peak_bytes"],
    )
    if verbose:
        print("  counts: flops/dev=%.3e bytes/dev=%.3e coll/dev=%.3e peak/dev=%.3e" % (
            rf.hlo_flops, rf.hlo_bytes, rf.coll_bytes, rf.peak_bytes_per_device))
        print("  terms: compute=%.4fs memory=%.4fs collective=%.4fs -> %s-bound, "
              "roofline_frac=%.3f" % (
                  rf.compute_s, rf.memory_s, rf.collective_s, rf.bottleneck,
                  rf.roofline_frac))
    out = json.loads(rf.to_json())
    out.update(
        trace_s=counts["trace_s"],
        top_collectives=counts["top_collectives"],
        microbatches=cell.microbatches,
        seq_shard=cell.cfg.seq_shard,
        kind=cell.kind,
        donate=list(donate),
        ok=True,
    )
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCHS) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="every runnable cell")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    if args.all:
        cells = runnable_cells()
    else:
        archs = [args.arch] if args.arch else list(ARCHS)
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [
            (a, s) for a in archs for s in shapes if s not in get_skips(a)
        ]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in cells:
        for multi in meshes:
            tag = f"{'2x16x16' if multi else '16x16'}__{arch}__{shape}".replace("/", "_")
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print("skip", tag)
                continue
            try:
                rec = run_cell(arch, shape, multi_pod=multi)
            except Exception as e:  # noqa: BLE001 - record and continue
                rec = dict(arch=arch, shape=shape, mesh="2x16x16" if multi else "16x16",
                           ok=False, error=f"{type(e).__name__}: {e}",
                           traceback=traceback.format_exc()[-4000:])
                failures.append(tag)
                print("FAIL", tag, rec["error"])
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    skipped = [(a, s, r) for a in ARCHS for s, r in get_skips(a).items()]
    with open(os.path.join(args.out, "skips.json"), "w") as f:
        json.dump([{"arch": a, "shape": s, "reason": r} for a, s, r in skipped], f, indent=1)
    print(f"done; {len(failures)} failures", failures if failures else "")


if __name__ == "__main__":
    main()
