#!/usr/bin/env python3
"""Time the port's segment-sum, assignment and fused assignment kernels
against another checkout's, on one GPU, in turns (other, this, this, other).

    python3 scripts/compare_kernels.py --other DIR [--rounds N]
    python3 scripts/compare_kernels.py --other DIR --flash
    python3 scripts/compare_kernels.py --other DIR --route

``DIR`` is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive``); its ``src/repro_torch`` is
imported under another name and builds its kernels into its own ``build/``.
For each version and each input, the script checks the kernel against the
plain version (bit for bit, gate to rtol 1e-5), then reports the time of a
call between CUDA events (host launch work included), the device time of a
call and the kernels launched a call (``torch.profiler``: every kernel the
call runs, sorts included), with each kernel's device time, and for the
fused kernel the host time a call; it prints each version's ptxas
registers and spills of the fused and assign kernels.  Inputs are
those of ``chip_smoke.py``: the assignment at the engine shape (N=100000,
E=300, k=1), the fused candidate-set assignment at the sparse engine shape
(N=100000, K=16, E=300; site and admit bit for bit; a version whose
wrapper takes ``with_pos`` is also timed with its ``pos`` output, pos bit
for bit too) and the segment sum at
J=100000, S=300 on a uniform id mix and on one where 95% of rows carry the
padding id, f32 ``[J]`` and i32 ``[J, 3]``.  With ``--rounds N`` it also
runs N dense and N sparse rounds of the full-width engine scenario with
each version and reports rounds/s, and the kernels a round of each over
PROFILE_ROUNDS profiled rounds.  With ``--flash`` it compares the flash
attention kernels instead: the forward's output bit for bit between the two
versions on every route (``FLASH_SAME``; a route that either version runs on
another kernel is left out), then the forward's time at each family's
prefill attention (``FLASH_FWD``) and the backward's at phase 21(b)'s shapes
(``chip_smoke.FLASH_BWD_CASES``), a call between CUDA events and device
time split by kernel, in turns.  With ``--route`` it compares the MoE
router's kernels instead: ``moe_route`` at granite-moe's and kimi-k2's
prefill (``[32, 512, E]``) and decode (``[1, 4, E]``) routing shapes, k = 8,
on seeded logits that favour the later experts (idx/slot/keep exact and
combine within 1e-6 of each version's plain route first), the gate backward
at ``chip_smoke.GATE_BWD_CASES`` (within 1e-6 of each row's largest against
the plain version) and the assignment at the engine shape, each timed a
call between CUDA events and in device time split by kernel, in turns.
It writes its numbers to
``chiprun_out/compare_kernels.json`` and needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.abc
import importlib.machinery
import importlib.util
import inspect
import json
import pathlib
import re
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


# the custom-op namespace in a module's source: "repro_torch::op", the
# library's "repro_torch", torch.ops.repro_torch
OP_NAMESPACE = re.compile(r"""(?<=["'])repro_torch(?=::|["'])|(?<=torch\.ops\.)repro_torch""")


class RenamedOps(importlib.machinery.SourceFileLoader):
    """Loads a module of another checkout with its custom ops
    (``repro_torch::assign`` and its kin) in the namespace of the package's
    name: torch registers each op name once a process, and both versions
    define the same ones.  Compiled from the source every time, so no cached
    bytecode of the unrenamed module is read."""

    def get_code(self, fullname):
        text = OP_NAMESPACE.sub(fullname.split(".")[0], self.get_source(fullname))
        return compile(text, self.get_filename(fullname), "exec", dont_inherit=True)


class RenamedOpsFinder(importlib.abc.MetaPathFinder):
    """Finds the modules of the package ``prefix`` with ``RenamedOps``."""

    def __init__(self, prefix: str):
        self.prefix = prefix

    def find_spec(self, name, path, target=None):
        if not name.startswith(self.prefix + "."):
            return None
        spec = importlib.machinery.PathFinder.find_spec(name, path)
        if spec is not None and isinstance(spec.loader, importlib.machinery.SourceFileLoader):
            spec.loader = RenamedOps(spec.loader.name, spec.loader.path)
        return spec


def import_package(src: pathlib.Path, name: str):
    """Import the ``repro_torch`` package under ``src`` as module ``name``;
    under another name than ``repro_torch`` its custom ops take that name
    as their namespace (``RenamedOps``)."""
    init = src / "repro_torch" / "__init__.py"
    loader = None
    if name != "repro_torch":
        sys.meta_path.insert(0, RenamedOpsFinder(name))
        loader = RenamedOps(name, str(init))
    spec = importlib.util.spec_from_file_location(name, init, loader=loader,
                                                  submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_version(pkg_name: str):
    """The wrappers and plain versions of one imported package."""
    import importlib

    def sub(path):
        return importlib.import_module(f"{pkg_name}.{path}")

    return dict(
        build=sub("_build"),
        assign=sub("kernels.assign.assign_cuda").assign_cuda,
        assign_ref=sub("kernels.assign.ref").assign_ref,
        segsum=sub("kernels.segment_sum.segment_sum_cuda").segment_sum_cuda,
        segsum_ref=sub("kernels.segment_sum.ops").segment_sum_ref,
        fused=sub("kernels.assign.fused_cuda").fused_assign_cuda,
        fused_ref=sub("kernels.assign.fused_ref").fused_assign_ref,
        core=sub("core"),
        kernels_assign=sub("kernels.assign"),
        flash=sub("kernels.flash_attention.flash_attention_cuda"),
        flash_bwd=sub("kernels.flash_attention.flash_attention_bwd_cuda"),
        gate_bwd=sub("kernels.assign.gate_backward_cuda").gate_backward_cuda,
        gate_bwd_ref=sub("kernels.assign.ref").gate_backward_ref,
    )


# (label, arch, G, Tg): the MoE routes of chip_smoke.py's phase 18
ROUTES = [
    ("granite prefill", "granite-moe-1b-a400m", 32, 512),
    ("granite decode", "granite-moe-1b-a400m", 1, 4),
    ("kimi prefill", "kimi-k2-1t-a32b", 32, 512),
    ("kimi decode", "kimi-k2-1t-a32b", 1, 4),
]


def route_inputs(device) -> dict:
    """Seeded router logits [G, Tg, E] that favour the later experts (so the
    capacity binds), and each route's arguments."""
    import torch

    from chip_smoke import GATE_BWD_CASES
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_capacity

    out = {}
    for label, arch, G, Tg in ROUTES:
        cfg = get_config(arch)
        E = cfg.n_experts
        gen = torch.Generator(device=device).manual_seed(G + E + Tg)
        logits = torch.randn((G, Tg, E), generator=gen, device=device) * 0.5
        logits += torch.linspace(0.0, 1.0, E, device=device)
        out[label] = (logits, dict(k=cfg.top_k, capacity=moe_capacity(cfg, Tg),
                                   block_n=Tg if not cfg.scan_layers else 256))
    for label, G, T, E, k in GATE_BWD_CASES:
        gen = torch.Generator(device=device).manual_seed(E)
        scores = torch.randn((G, T, E), generator=gen, device=device)
        idx = torch.argsort(torch.rand((G, T, E), generator=gen, device=device), -1)[..., :k]
        dgate = torch.randn((G, T, k), generator=gen, device=device)
        out[f"gate backward {label}"] = (scores, idx.int().contiguous(), dgate)
    return out


def time_route(v: dict, label: str, inputs: dict, out: dict) -> None:
    import torch

    from chip_smoke import check, cuda_ms, row_error

    A = v["kernels_assign"]
    for name, _, G, Tg in ROUTES:
        logits, kw = inputs[name]
        got, want = A.moe_route(logits, **kw), A.moe_route_ref(logits, **kw)
        for i in (0, 2, 3):
            check(torch.equal(got[i], want[i]), f"{label}: {name} route differs from its plain one")
        err = float((got[1] - want[1]).abs().max())
        check(err <= 1e-6, f"{label}: {name} combine differs from its plain one by {err:.3e}")
        call = cuda_ms(lambda: A.moe_route(logits, **kw), iters=200)
        parts = {}
        dev, per_call = profile_call(lambda: A.moe_route(logits, **kw), iters=100, parts=parts)
        assign = {n: t for n, t in parts.items() if "assign_" in n}
        assign_ms = sum(assign.values())
        out.setdefault(f"route {name}", []).append(
            dict(version=label, cuda_ms=call, device_ms=dev, assign_device_ms=assign_ms,
                 kernels_per_call=per_call, parts=parts))
        print(f"[compare] {label} route {name} [{G}, {Tg}, {logits.shape[-1]}] k={kw['k']}: "
              f"{call:.4f} ms a moe_route call (CUDA events), assign kernels {assign_ms:.4f} ms "
              f"device time ({', '.join(f'{n} {t:.4f}' for n, t in assign.items())}), "
              f"{dev:.4f} ms device time in {per_call:g} kernels a call")
    for name in (n for n in inputs if n.startswith("gate backward")):
        scores, idx, dgate = inputs[name]
        got = v["gate_bwd"](scores, idx, dgate)
        err = row_error(got, v["gate_bwd_ref"](scores, idx, dgate))
        check(err <= 1e-6, f"{label}: {name} row error {err:.3e}")
        call = cuda_ms(lambda: v["gate_bwd"](scores, idx, dgate), iters=200)
        dev, per_call = profile_call(lambda: v["gate_bwd"](scores, idx, dgate), iters=100)
        out.setdefault(name, []).append(dict(version=label, cuda_ms=call, device_ms=dev,
                                             kernels_per_call=per_call, row_err=err))
        print(f"[compare] {label} {name} {list(scores.shape)} k={idx.shape[-1]}: {call:.4f} ms a "
              f"call (CUDA events), {dev:.4f} ms device time, {per_call:g} kernels a call, row "
              f"error {err:.2e}")


# (label, B, Hq, Hkv, S, Skv, D, causal, window, dtype): one case a forward
# route whose kernel both versions share (wgmma at D = 64 and 128, mma.sync,
# the f32 CUDA cores, bf16 at D = 192), ragged and right-aligned
FLASH_SAME = [
    ("wgmma D=64", 1, 4, 1, 700, 900, 64, True, 200, "bfloat16"),
    ("wgmma D=128", 2, 4, 2, 300, 1000, 128, True, 0, "bfloat16"),
    ("whisper encoder", 1, 12, 12, 1500, 1500, 64, False, 0, "bfloat16"),
    ("mma.sync D=96", 1, 2, 2, 100, 100, 96, False, 0, "bfloat16"),
    ("f32 D=128", 1, 4, 1, 384, 384, 128, True, 0, "float32"),
    ("bf16 D=192", 1, 4, 2, 130, 200, 192, True, 64, "bfloat16"),
]
# each family's prefill attention (phases 18 and 20): the forward's times
FLASH_FWD = [
    ("granite", 4, 16, 8, 4096, 4096, 64, True, 0),
    ("deepseek", 4, 32, 32, 4096, 4096, 128, True, 0),
    ("internvl2", 4, 48, 8, 4096, 4096, 128, True, 0),
    ("recurrentgemma", 4, 10, 1, 4096, 4096, 256, True, 2048),
]


def flash_forward(v: dict, q, k, v_, causal, window, lse=False):
    return v["flash"].flash_attention_cuda(q, k, v_, causal=causal, window=window,
                                           **({"return_lse": True} if lse else {}))


def flash_backward(v: dict, q, k, v_, o, lse, do, causal, window):
    """The version's backward: given the forward's log-sum-exp where its
    wrapper takes one, else without it."""
    import inspect

    fn = v["flash_bwd"].flash_attention_backward_cuda
    args = (q, k, v_, o, do, lse) if "lse" in inspect.signature(fn).parameters else \
        (q, k, v_, o, do)
    return fn(*args, causal=causal, window=window)


def flash_outputs(v: dict, device) -> dict:
    """The forward's output of each FLASH_SAME case, on the CPU."""
    from chip_smoke import flash_inputs

    out = {}
    for label, B, Hq, Hkv, S, Skv, D, causal, window, dtype in FLASH_SAME:
        q, k, v_ = flash_inputs(B, Hq, Hkv, S, Skv, D, dtype, B * 131 + S, device)
        out[label] = flash_forward(v, q, k, v_, causal, window).cpu()
    return out


def time_flash(v: dict, label: str, device, out: dict) -> None:
    import inspect

    import numpy as np
    import torch

    from chip_smoke import FLASH_BWD_CASES, cuda_ms, flash_inputs

    has_lse = "return_lse" in inspect.signature(v["flash"].flash_attention_cuda).parameters
    for name, B, Hq, Hkv, S, Skv, D, causal, window in FLASH_FWD:
        q, k, v_ = flash_inputs(B, Hq, Hkv, S, Skv, D, "bfloat16", 18 + D, device)
        call = cuda_ms(lambda: flash_forward(v, q, k, v_, causal, window), iters=10)
        parts = {}
        dev, per_call = profile_call(lambda: flash_forward(v, q, k, v_, causal, window), 10,
                                     parts)
        row = dict(version=label, cuda_ms=call, device_ms=dev, kernels_per_call=per_call,
                   parts=parts)
        if has_lse:   # the training forward: the same launch writes the log-sum-exp
            row["with_lse_cuda_ms"] = cuda_ms(
                lambda: flash_forward(v, q, k, v_, causal, window, lse=True), iters=10)
        out.setdefault(f"flash forward {name}", []).append(row)
        print(f"[compare] {label} flash forward {name} [{B}, {Hq}, {S}, {D}] on {Hkv} kv heads: "
              f"{call:.4f} ms a call (CUDA events), {dev:.4f} ms device time "
              f"({', '.join(f'{k} {t:.4f}' for k, t in parts.items())})"
              + (f", {row['with_lse_cuda_ms']:.4f} ms a call with the log-sum-exp"
                 if has_lse else ""))
        del q, k, v_
    for name, B, Hq, Hkv, S, Skv, D, causal, window in FLASH_BWD_CASES:
        q, k, v_ = flash_inputs(B, Hq, Hkv, S, Skv, D, "bfloat16", S + D, device)
        do = torch.from_numpy(np.random.default_rng(S + D + 1).standard_normal(
            tuple(q.shape), dtype=np.float32)).to(device=device, dtype=q.dtype)
        o, lse = (flash_forward(v, q, k, v_, causal, window, lse=True) if has_lse else
                  (flash_forward(v, q, k, v_, causal, window), None))

        def fn():
            return flash_backward(v, q, k, v_, o, lse, do, causal, window)
        call = cuda_ms(fn, iters=5)
        parts = {}
        dev, per_call = profile_call(fn, 3, parts)
        out.setdefault(f"flash backward {name}", []).append(
            dict(version=label, cuda_ms=call, device_ms=dev, kernels_per_call=per_call,
                 parts=parts))
        print(f"[compare] {label} flash backward {name} [{B}, {Hq}, {S}, {D}] on {Hkv} kv heads: "
              f"{call:.4f} ms a call (CUDA events), {dev:.4f} ms device time "
              f"({', '.join(f'{k} {t:.4f}' for k, t in parts.items())})")
        del q, k, v_, o, lse, do
        torch.cuda.empty_cache()


def profile_call(fn, iters: int, parts: dict | None = None) -> tuple[float, float]:
    """(device ms a call, kernels a call) over ``iters`` calls, from
    ``torch.profiler``: every kernel the calls ran.  ``parts``, when given,
    receives each kernel's device ms a call by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if parts is not None:
        for e in kernels:
            name = e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
            name = name.split("(")[0]
            parts[name] = parts.get(name, 0.0) + e.self_device_time_total / 1e3 / iters
    return busy / iters, sum(e.count for e in kernels) / iters


def host_ms(fn, iters: int) -> float:
    """Host milliseconds a call of ``fn``: the wrapper's Python and launch
    work, timed on the host over ``iters`` calls issued back to back."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def time_fused(v: dict, label: str, device, out: dict) -> None:
    import torch

    from chip_smoke import (ENGINE_J, ENGINE_K, ENGINE_S, PEAK_HBM_BYTES_PER_S, check, cuda_ms,
                            fused_inputs)

    args = fused_inputs(ENGINE_J, ENGINE_S, ENGINE_K, 0, device)
    want = v["fused_ref"](*args)
    got = v["fused"](*args)
    for w, g in zip(want, got):
        check(torch.equal(w, g), f"{label}: fused differs from the plain version")
    call = cuda_ms(lambda: v["fused"](*args), iters=200)
    host = host_ms(lambda: v["fused"](*args), iters=500)
    parts = {}
    dev, per_call = profile_call(lambda: v["fused"](*args), iters=100, parts=parts)
    N, K, E = ENGINE_J, ENGINE_K, ENGINE_S
    bound = (N * K * (4 + 4) + N * 4 + E * 4 + N * (4 + 1)) / PEAK_HBM_BYTES_PER_S * 1e3
    row = dict(version=label, cuda_ms=call, host_ms=host, device_ms=dev,
               kernels_per_call=per_call, parts=parts, bound_ms=bound)
    print(f"[compare] {label} fused N={N} K={K} E={E}: {call:.4f} ms a call (CUDA events), "
          f"{host:.4f} ms of host time a call, {dev:.4f} ms device time "
          f"({', '.join(f'{k} {t:.4f}' for k, t in parts.items())}), "
          f"{per_call:g} kernels a call; bound {bound:.4f} ms (bytes)")
    if "with_pos" in inspect.signature(v["fused"]).parameters:
        want = v["fused_ref"](*args, with_pos=True)
        got = v["fused"](*args, with_pos=True)
        for w, g in zip(want, got):
            check(torch.equal(w, g), f"{label}: fused with pos differs from the plain version")
        pos_call = cuda_ms(lambda: v["fused"](*args, with_pos=True), iters=200)
        pos_dev, _ = profile_call(lambda: v["fused"](*args, with_pos=True), iters=100)
        pos_bound = bound + N * 4 / PEAK_HBM_BYTES_PER_S * 1e3
        row.update(cuda_ms_pos=pos_call, device_ms_pos=pos_dev, bound_ms_pos=pos_bound)
        print(f"[compare] {label} fused with pos: {pos_call:.4f} ms a call (CUDA events), "
              f"{pos_dev:.4f} ms device time; bound {pos_bound:.4f} ms (bytes)")
    out.setdefault("fused", []).append(row)


def time_assign(v: dict, label: str, device, out: dict) -> None:
    import torch

    from chip_smoke import ENGINE_J, ENGINE_S, assign_inputs, check, cuda_ms

    scores, sizes, caps = assign_inputs(ENGINE_J, ENGINE_S, ENGINE_J * 31 + ENGINE_S, device)
    want = v["assign_ref"](scores, sizes, caps, k=1)
    got = v["assign"](scores, sizes, caps, k=1)
    for w, g in zip((want[0], want[2], want[3]), (got[0], got[2], got[3])):
        check(torch.equal(w, g), f"{label}: assign differs from the plain version")
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    call = cuda_ms(lambda: v["assign"](scores, sizes, caps, k=1), iters=200)
    dev, per_call = profile_call(lambda: v["assign"](scores, sizes, caps, k=1), iters=100)
    out.setdefault("assign", []).append(dict(version=label, cuda_ms=call, device_ms=dev,
                                             kernels_per_call=per_call))
    print(f"[compare] {label} assign N={ENGINE_J} E={ENGINE_S} k=1: {call:.4f} ms a call "
          f"(CUDA events), {dev:.4f} ms device time, {per_call:g} kernels a call")


def time_segsum(v: dict, label: str, device, out: dict) -> None:
    import torch

    from chip_smoke import ENGINE_J, ENGINE_S, check, cuda_ms, segsum_inputs

    for mix in ("uniform", "padding95"):
        f32, seg = (t.to(device) for t in segsum_inputs(mix, ENGINE_J, ENGINE_S, 1, "float32",
                                                         "int32", 1))
        i32, _ = segsum_inputs(mix, ENGINE_J, ENGINE_S, 3, "int32", "int32", 1)
        for name, vals in (("f32", f32), ("i32x3", i32.to(device))):
            want = v["segsum_ref"](vals.cpu(), seg.cpu(), ENGINE_S)
            got = v["segsum"](vals, seg, ENGINE_S).cpu()
            same = torch.equal(want.view(torch.int32) if name == "f32" else want,
                               got.view(torch.int32) if name == "f32" else got)
            check(same, f"{label}: segment_sum {mix} {name} differs from row order")
            call = cuda_ms(lambda: v["segsum"](vals, seg, ENGINE_S), iters=200)
            dev, per_call = profile_call(lambda: v["segsum"](vals, seg, ENGINE_S), iters=100)
            out.setdefault(f"segment_sum {mix} {name}", []).append(
                dict(version=label, cuda_ms=call, device_ms=dev, kernels_per_call=per_call))
            print(f"[compare] {label} segment_sum {mix} {name} J={ENGINE_J} S={ENGINE_S}: "
                  f"{call:.4f} ms a call (CUDA events), {dev:.4f} ms device time, "
                  f"{per_call:g} kernels a call")


def engine_rates(v: dict, label: str, rounds: int, device, out: dict) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import ENGINE_J, ENGINE_K, ENGINE_S, PROFILE_ROUNDS

    T, A = v["core"], v["kernels_assign"]
    sites = T.atlas_like_platform(ENGINE_S, seed=1, device=device)
    jobs = T.synthetic_panda_jobs(ENGINE_J, seed=0, duration=6 * 3600.0, device=device)
    runs = (
        ("dense", T.with_capacity_assign(T.get_policy("panda_dispatch"),
                                         A.make_capacity_assign(jobs.cores)), None),
        ("sparse", T.with_fused_assign(T.get_policy("data_locality"),
                                       A.make_fused_capacity_assign(jobs.cores)), ENGINE_K),
    )
    for name, policy, topk in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = T.simulate(jobs, sites, policy, T.PRNGKey(0), max_rounds=rounds, topk=topk,
                         device=device)
        torch.cuda.synchronize()
        rate = res.rounds / (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            T.simulate(jobs, sites, policy, T.PRNGKey(0), max_rounds=PROFILE_ROUNDS, topk=topk,
                       device=device)
            torch.cuda.synchronize()
        per_round = sum(e.count for e in prof.key_averages()
                        if str(getattr(e, "device_type", "")).endswith("CUDA")) / PROFILE_ROUNDS
        out.setdefault(f"{name} rounds/s", []).append(dict(version=label, rate=rate,
                                                           rounds=res.rounds,
                                                           kernels_per_round=per_round))
        print(f"[compare] {label} {name} engine: {res.rounds} rounds at {rate:.2f} rounds/s; "
              f"{per_round:.1f} kernels a round over {PROFILE_ROUNDS} profiled rounds")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=0,
                    help="engine rounds a run for the rounds/s comparison (0: none)")
    ap.add_argument("--flash", action="store_true",
                    help="compare the flash attention kernels instead of the engine's")
    ap.add_argument("--route", action="store_true",
                    help="compare the MoE router's kernels (routes, gate backward) and the "
                         "engine-shape assignment instead")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    from chip_smoke import gpu_name_and_power

    versions = {"other": load_version(import_package(args.other / "src", "other_repro_torch")
                                      .__name__),
                "this": load_version(import_package(ROOT / "src", "repro_torch").__name__)}
    sources = (["flash_attention", "flash_attention_bwd"] if args.flash else
               ["assign", "gate_backward"] if args.route else ["assign", "fused", "segment_sum"])
    for label, v in versions.items():
        print(f"[compare] {label} build seconds {v['build'].build(sources)}")
        for name in sources[:2]:               # ptxas registers and spills, kernel by kernel
            kernel = ""
            for line in v["build"].build_log(name).splitlines():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1]
                elif "registers" in line or "spill" in line:
                    print(f"[compare] {label} {name} {kernel}: "
                          f"{line.replace('ptxas info    :', '').strip()}")
    out: dict = {"card": gpu_name_and_power()}
    if args.flash:
        import torch

        same = {label: flash_outputs(v, device) for label, v in versions.items()}
        for case in same["this"]:
            equal = torch.equal(same["this"][case], same["other"][case])
            out.setdefault("flash forward bits equal", {})[case] = equal
            print(f"[compare] flash forward {case}: output bit for bit the other version's: "
                  f"{equal}")
        for label in ("other", "this", "this", "other"):
            time_flash(versions[label], label, device, out)
        args.rounds = 0
    if args.route:
        inputs = route_inputs(device)
        for label in ("other", "this", "this", "other"):
            time_route(versions[label], label, inputs, out)
            time_assign(versions[label], label, device, out)
        args.rounds = 0
    for label in ("other", "this", "this", "other") if not (args.flash or args.route) else ():
        for time_kernel in (time_fused, time_assign, time_segsum):
            time_kernel(versions[label], label, device, out)
    if args.rounds:
        for label in ("other", "this"):          # warm-up: first calls, allocator
            engine_rates(versions[label], f"{label} warm-up", 20, device, {})
        for label in ("other", "this", "this", "other"):
            engine_rates(versions[label], label, args.rounds, device, out)
    print(f"[compare] card: {out['card']}")
    dest = ROOT / "chiprun_out" / "compare_kernels.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
