"""Roofline measurement pass: per-device cost terms per cell.

The JAX package measures a compiled XLA program and has to correct two of
its artifacts (``cost_analysis`` counts a scanned body once; the CPU backend
upcasts bf16).  The port counts the program as it runs on meta tensors
(``roofline.Counter``): every layer and every microbatch's ops are seen, in
the dtypes the program has, so neither correction applies.  The method is
the JAX package's all the same, so the records compare:

  * trace the cell's program at two reduced depths L1 < L2 (layer units
    matched to the block pattern) on meta ``DTensor``s over the fake 16x16
    mesh, and extrapolate linearly to the full depth,
        cost(L) = fixed + (L / L1) * group;
  * for train cells the measured program is ``loss`` and its gradients on
    ONE microbatch; totals compose as MB x micro + optimizer (the AdamW
    update, or its 8-bit form, traced separately and counted exactly).

    PYTHONPATH=src python -m repro_torch.launch.measure --arch granite-moe-1b-a400m

Outputs one JSON per cell under results/roofline/.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import SHAPES, runnable_cells
from ..core.distributed import use_mesh
from ..models import build_model
from ..train.optimizer import (AdamWConfig, adamw_update, adamw_update_8bit, init_opt_state,
                               init_opt_state_8bit)
from .mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16, make_production_mesh
from .roofline import Counter, model_flops_for_cell
from .specs import Cell, batch_inputs, build_cell, cache_inputs, sharded_params, trace_mesh


def traced(fn, args, mesh, *, peak: bool = False) -> dict:
    """``fn(*args)`` on ``mesh`` under the counter (plain tensors read as
    replicated), -> its ``Counter.record()`` plus ``trace_s``."""
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.perf_counter()
    with use_mesh(mesh), implicit_replication(), Counter(peak=peak) as c:
        fn(*args)
    rec = c.record()
    rec["trace_s"] = time.perf_counter() - t0
    return rec


def _measure_program(fn, args, mesh) -> dict:
    rec = traced(fn, args, mesh)
    return {"flops": rec["flops"], "bytes": rec["bytes"], "coll": rec["coll_bytes"],
            "breakdown": rec["coll_breakdown"]}


def _depths(cfg) -> tuple[int, int, float]:
    """(L1, L2, groups_at_full_depth) in layer units matched to the pattern."""
    if cfg.family == "encdec":
        return 2, 4, cfg.n_layers  # n_enc = n_dec = L in reduced cfgs
    pat = len(cfg.block_pattern) if cfg.family == "hybrid" else 1
    return pat, 2 * pat, cfg.n_layers / pat


def _reduced(cfg, L: int):
    kw = dict(n_layers=L, scan_layers=False)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=L, n_dec_layers=L)
    return cfg.replace(**kw)


def _program_structs(cell: Cell, cfg_L, mesh):
    """The measured (single-microbatch / serve) program and its meta
    ``DTensor`` arguments on ``mesh``."""
    spec = SHAPES[cell.shape]
    model = build_model(cfg_L, device="meta")
    B, S = spec.global_batch, spec.seq_len

    if cell.kind == "train":
        b_micro = max(B // cell.microbatches, 1)
        params = sharded_params(model, mesh, trainable=True)

        def fn(params, batch):
            loss, _ = model.loss(params, batch)
            return loss, torch.autograd.grad(loss, list(params.parameters()))

        return fn, (params, batch_inputs(cfg_L, b_micro, S, mesh))
    params = sharded_params(model, mesh)
    if cell.kind == "prefill":
        cache = cache_inputs(model, cfg_L, B, S, mesh, cell.plan)
        return model.prefill, (params, batch_inputs(cfg_L, B, S, mesh), cache)
    cache_len = cell.plan.decode_cache_len or S
    cache = cache_inputs(model, cfg_L, B, cache_len, mesh, cell.plan, full=True)
    return model.decode, (params, batch_inputs(cfg_L, B, 1, mesh)["tokens"], cache)


def _optimizer_program(cell: Cell, mesh):
    """The optimizer update on the full model's meta ``DTensor``s."""
    opt_8bit = getattr(cell.plan, "opt_8bit", False)
    model = build_model(cell.cfg, device="meta")
    named = dict(sharded_params(model, mesh).named_parameters())
    grads = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()}
    state = (init_opt_state_8bit if opt_8bit else init_opt_state)(grads)
    if not opt_8bit:
        state = dict(state, m={n: torch.zeros_like(g) for n, g in grads.items()},
                     v={n: torch.zeros_like(g) for n, g in grads.items()})
    update = adamw_update_8bit if opt_8bit else adamw_update

    def opt_fn(params, grads, state):
        with torch.no_grad():
            return update(AdamWConfig(), params, grads, state)

    return opt_fn, (named, grads, state)


def measure_cell(arch: str, shape: str, *, verbose: bool = True,
                 overrides: dict | None = None, microbatches: int | None = None,
                 plan_overrides: dict | None = None) -> dict:
    """``overrides``: ModelConfig.replace kwargs applied on top of the cell
    plan (the hill-climb hook); ``microbatches`` overrides the plan's;
    ``plan_overrides``: CellPlan.replace kwargs (e.g. opt_8bit=True)."""
    import dataclasses

    mesh = make_production_mesh(multi_pod=False)
    cell = build_cell(arch, shape, mesh)
    if overrides:
        cell = cell._replace(cfg=cell.cfg.replace(**overrides))
    if plan_overrides:
        cell = cell._replace(plan=dataclasses.replace(cell.plan, **plan_overrides))
    if microbatches is not None:
        cell = cell._replace(microbatches=microbatches)
    cfg = cell.cfg
    tmesh = trace_mesh(mesh)
    L1, L2, n_groups = _depths(cfg)

    t0 = time.time()
    meas = {}
    for L in (L1, L2):
        cfg_L = _reduced(cfg, L)
        cell_L = cell._replace(cfg=cfg_L)
        fn, args = _program_structs(cell_L, cfg_L, tmesh)
        meas[L] = _measure_program(fn, args, tmesh)

    # linear extrapolation: cost(L) = fixed + (L/L1) * group
    out = {}
    for key in ("flops", "bytes", "coll"):
        group = (meas[L2][key] - meas[L1][key]) / (L2 / L1 - 1)  # per L1-sized group
        fixed = meas[L1][key] - group
        out[key] = fixed + group * (cfg.n_layers / L1)

    # optimizer program (train only): counted exactly
    opt = {"flops": 0.0, "bytes": 0.0, "coll": 0.0}
    if cell.kind == "train":
        opt_fn, opt_args = _optimizer_program(cell, tmesh)
        opt = _measure_program(opt_fn, opt_args, tmesh)
        for key in ("flops", "bytes", "coll"):
            out[key] = out[key] * cell.microbatches + opt[key]

    spec = SHAPES[shape]
    n_dev = mesh.size()
    model_flops_total = model_flops_for_cell(cfg, spec, cell.kind)
    compute_s = out["flops"] / PEAK_FLOPS_BF16
    memory_s = out["bytes"] / HBM_BW
    collective_s = out["coll"] / ICI_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step_s = max(terms.values())
    ideal_s = model_flops_total / n_dev / PEAK_FLOPS_BF16
    rec = dict(
        arch=arch,
        shape=shape,
        mesh="16x16",
        n_devices=n_dev,
        kind=cell.kind,
        microbatches=cell.microbatches,
        seq_shard=cfg.seq_shard,
        hlo_flops=out["flops"],
        hlo_bytes=out["bytes"],
        coll_bytes=out["coll"],
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops_total,
        useful_ratio=(model_flops_total / n_dev / out["flops"]) if out["flops"] else 0.0,
        step_s=step_s,
        roofline_frac=(ideal_s / step_s) if step_s else 0.0,
        opt_terms=opt,
        measure_depths=[L1, L2],
        measure_s=time.time() - t0,
        ok=True,
    )
    if verbose:
        print(
            f"[roofline] {arch} x {shape}: compute={compute_s:.4f}s memory={memory_s:.4f}s "
            f"collective={collective_s:.4f}s -> {bottleneck}-bound frac={rec['roofline_frac']:.3f} "
            f"useful={rec['useful_ratio']:.2f} ({rec['measure_s']:.0f}s)"
        )
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="results/roofline")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()
    cells = runnable_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    os.makedirs(args.out, exist_ok=True)
    for arch, shape in cells:
        path = os.path.join(args.out, f"{arch}__{shape}.json".replace("/", "_"))
        if args.skip_existing and os.path.exists(path):
            print("skip", arch, shape)
            continue
        try:
            rec = measure_cell(arch, shape)
        except Exception as e:  # noqa: BLE001
            rec = dict(arch=arch, shape=shape, ok=False,
                       error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
            print("FAIL", arch, shape, rec["error"])
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
