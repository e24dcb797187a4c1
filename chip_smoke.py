#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when its
check does not hold:

1. build every CUDA source of the port for sm_90a (one nvcc per source, all
   started together) and print the build seconds and ptxas resource use;
2. hold every kernel against its plain PyTorch version on the card: the
   assignment kernel at the engine shape and at the kernel-test shapes
   (idx/admit/pos exact, gate rtol 1e-5 atol 1e-6), the segment sum on
   nine id mixes (bit for bit the CPU's row-order sums: uniform, 95%
   padding, one segment, out-of-range ids, signed zeros, F = 1..4, J = 0),
   the fused candidate-set assignment at the sparse engine shape (N=100000,
   K=16, E=300) and at the kernel-test shapes (site/admit exact); time each
   at its engine shape two ways, a call between CUDA events (host launch
   work included) and the kernels' device time from ``torch.profiler``,
   with the launches a call (the segment sum on a uniform id mix and on
   one where 95% of rows carry the padding id);
3. drive the dense path at WLCG scale: ``simulate`` on 300 sites and 100000
   jobs with ``panda_dispatch`` plus capacity dispatch, twice, with the
   launch counters set to 0 just before the first run; require every round
   with work to launch the assignment kernel once, and the two runs to agree
   bit for bit; print rounds/s and the assignment kernel's share of it;
4. drive the sparse top-k path at the same scale: ``data_locality`` with the
   fused capacity assigner and ``topk=16``, twice, counters set to 0 just
   before the first run; require every round with work to launch the fused
   kernel once and never call its plain version, and the two runs to agree
   bit for bit; print rounds/s (and the same policy's dense rate), the
   candidate build's seconds and the fused kernel's time per launch;
5. drain a 50-site, 5000-job scenario with failures to the end on the card
   and on the CPU, and require the same rounds, makespan, per-job outcomes
   and site counters;
6. on the same scenario, cut to its first SPARSE_DRAIN_ROUNDS rounds: the
   fused sparse path at ``topk=S`` must equal the dense capacity dispatch on
   the card, and ``topk=8`` on the card must equal ``topk=8`` on the CPU;
7. hold the flash-attention kernel against ``attention_ref`` on the card
   (max abs error 2e-5 in f32, 2e-2 in bf16) on ``tests/test_kernels.py``'s
   six shapes, a non-causal ragged one, a right-aligned one (Skv > S), one
   each for the mma.sync and bf16 CUDA-core paths, seven for the wgmma/TMA
   path (ragged tails, right-aligned q, a window, GQA 40/8, non-causal,
   D = 64) and the deepseek-7b prefill shape, where it is timed beside its
   plain version and ``scaled_dot_product_attention`` and the profiler must
   show ``flash_fwd_kernel_wgmma`` and no other flash kernel;
8. serve deepseek-7b at full width (bf16, random weights from seed 0):
   ``generate`` over 4 prompts of 4096 tokens with 32 new tokens, twice,
   launch counters set to 0 just before the first run; require 30 flash
   launches (one a layer, all of ``flash_fwd_kernel_wgmma`` in the profiled
   prefill), bit-identical tokens, and prefill logits within
   2e-2 of the largest logit of the same prefill through the plain
   ``chunked_attention``; print prefill and decode tokens/s and peak memory.

It prints one JSON line of per-kernel numbers, then the card's name and power
limit, then the result line ``{"ok": true, "device": {...}}``.  It needs the
repository's ``src/`` beside it and a CUDA device, and exits non-zero without
either.
"""
from __future__ import annotations

import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

PEAK_HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
PEAK_FP32_OPS_PER_S = 67e12      # H100 SXM, non-tensor-core float32
PEAK_BF16_OPS_PER_S = 989e12     # H100 SXM, dense bf16 tensor cores

ENGINE_J, ENGINE_S = 100_000, 300
ENGINE_K = 16                  # bench_wlcg_scale.py's top-k
FULL_MAX_ROUNDS = 2000
SPARSE_DRAIN_ROUNDS = 1000     # depth cut of phase 6 (the drain takes 10103)
ASSIGN_CASES = [  # (N, E, k, block_n)
    (ENGINE_J, ENGINE_S, 1, 256),   # the engine shape
    (64, 8, 1, 32),
    (33, 7, 3, 16),
    (512, 32, 8, 128),
    (256, 384, 8, 256),
    (1000, 301, 1, 256),            # E % 4 != 0: rows not 16-byte aligned
    (2000, 512, 8, 256),            # the widest MoE router, k = 8
    (600, 700, 2, 128),             # E above the 512 bins kept in registers
    (5000, 64, 4, 300),             # block_n dividing neither N nor the 256-row tile
]
JOB_FIELDS = ("state", "site", "retries", "will_fail", "t_assign", "t_start", "t_finish")
SITE_FIELDS = ("free_cores", "free_memory", "n_assigned", "n_finished", "n_failed")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median device milliseconds of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def device_ms(fn, kernel_names, iters: int, forbid=(), counts=None) -> dict:
    """Device milliseconds per call of ``fn`` for each named kernel, from
    ``torch.profiler`` over ``iters`` calls: the kernels' own time, without
    the host time between launches that CUDA events around a short call
    would include.  Fails if a kernel whose name holds one of ``forbid`` ran.
    ``counts``, when given, receives each named kernel's launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in kernel_names}
    seen = {name: 0 for name in kernel_names}
    for e in prof.key_averages():
        bad = [f for f in forbid if f in e.key]
        check(not bad, f"the profiled calls ran {e.key[:120]}")
        for name in kernel_names:
            if name in e.key and e.self_device_time_total > 0:
                out[name] += e.self_device_time_total / 1e3 / iters
                seen[name] += e.count
    check(all(v > 0 for v in out.values()), f"the profiler saw no device time for {out}")
    if counts is not None:
        counts.update({name: n / iters for name, n in seen.items()})
    return out


def kernel_label(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name:
    ``_ZN..22flash_fwd_kernel_wgmmaILi128EEEv..`` gives
    ``flash_fwd_kernel_wgmma<Li128>``."""
    rest, name = mangled[3:] if mangled.startswith("_ZN") else mangled[2:], mangled
    while (m := re.match(r"(\d+)", rest)):  # length-prefixed scopes, then the name
        n = int(m.group(1))
        name, rest = rest[len(m.group(1)):len(m.group(1)) + n], rest[len(m.group(1)) + n:]
    args = re.match(r"I(\w*?)EE", rest)
    return f"{name}<{args.group(1)}>" if args else name


def phase_build() -> None:
    from repro_torch import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"[build] {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"wall={time.perf_counter() - t0:.2f}s")
    for name in _build.SOURCES:
        kernel = ""
        for line in _build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = kernel_label(m.group(1))
            elif "registers" in line or "spill" in line:
                print(f"[build] {name} {kernel}: {line.replace('ptxas info    :', '').strip()}")


def assign_inputs(N, E, seed, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(N, E)).astype(np.float32)
    scores[rng.random((N, E)) < 0.1] = -1e30     # about 10% infeasible
    sizes = rng.choice([1.0, 8.0] if N == ENGINE_J else [1.0, 2.0, 8.0], size=N)
    caps = rng.uniform(2, 40, size=E) * (N / max(E, 1)) if N == ENGINE_J else \
        rng.uniform(2, 40, size=E)
    return (torch.from_numpy(scores).to(device),
            torch.from_numpy(sizes.astype(np.float32)).to(device),
            torch.from_numpy(caps.astype(np.float32)).to(device))


SEGSUM_CASES = [  # (id mix, J, S, F, dtype, id dtype)
    ("uniform", ENGINE_J, ENGINE_S, 1, "float32", "int32"),    # the engine shape
    ("uniform", ENGINE_J, ENGINE_S, 3, "int32", "int32"),      # stacked int columns
    ("padding95", ENGINE_J, ENGINE_S, 1, "float32", "int32"),
    ("padding95", ENGINE_J, ENGINE_S, 2, "int32", "int64"),
    ("one_segment", ENGINE_J, ENGINE_S, 1, "float32", "int32"),
    ("out_of_range", 10_007, 37, 4, "float32", "int64"),
    ("uniform", 100_003, 301, 4, "float32", "int32"),          # J not a multiple of the chunk
    ("uniform", 0, 5, 2, "float32", "int32"),                  # J = 0
    ("signed_zeros", 3000, 20, 3, "float32", "int32"),
]
ASSIGN_KERNELS = ("assign_rows_kernel", "assign_base_kernel", "assign_place_kernel")


def segsum_inputs(mix, J, S, F, dtype, id_dtype, seed):
    """Values ``[J]`` (F = 1) or ``[J, F]`` and ids on the CPU.  Id ``S`` is
    the padding segment; ``padding95`` gives it 95% of rows, ``one_segment``
    gives segment S // 2 99.9%, ``out_of_range`` draws ids in [-3S, 3S), and
    ``signed_zeros`` leaves segments 0, 4, ... empty and fills 1, 5, ... with
    -0.0 rows only (their sums are +0.0)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, S + 1, J)
    if mix == "padding95":
        ids = np.where(rng.random(J) < 0.95, S, ids)
    elif mix == "one_segment":
        ids = np.where(rng.random(J) < 0.999, S // 2, ids)
    elif mix == "out_of_range":
        ids = rng.integers(-3 * S, 3 * S, J)
    if dtype == "float32":
        v = rng.lognormal(1.0, 1.0, (J, F)).astype(np.float32)
        if mix == "signed_zeros":
            ids = np.where(ids % 4 == 0, S, ids)
            v[ids % 4 == 1] = -0.0
    else:
        v = rng.integers(-(2**20), 2**20, (J, F)).astype(np.int32)
    return (torch.from_numpy(v if F > 1 else v[:, 0].copy()),
            torch.from_numpy(ids).to(getattr(torch, id_dtype)))


def phase_kernels(device) -> dict:
    import torch

    from repro_torch.kernels.assign.assign_cuda import assign_cuda
    from repro_torch.kernels.assign.ref import assign_ref
    from repro_torch.kernels.segment_sum.ops import segment_sum_ref
    from repro_torch.kernels.segment_sum.segment_sum_cuda import segment_sum_cuda

    rows = {}
    gate_err = 0.0
    for N, E, k, bn in ASSIGN_CASES:
        scores, sizes, caps = assign_inputs(N, E, N * 31 + E, device)
        want = assign_ref(scores, sizes, caps, k=k, block_n=bn)
        got = assign_cuda(scores, sizes, caps, k=k, block_n=bn)
        torch.cuda.synchronize()
        for name, w, g in zip(("idx", "admit", "pos"), (want[0], want[2], want[3]),
                              (got[0], got[2], got[3])):
            bad = int((w != g).sum())
            check(bad == 0, f"assign {N}x{E} k={k} bn={bn}: {bad} {name} entries differ")
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
        err = float((got[1] - want[1]).abs().max()) if got[1].numel() else 0.0
        gate_err = max(gate_err, err)
        print(f"[kernels] assign N={N} E={E} k={k} block_n={bn}: idx/admit/pos exact, "
              f"gate max_abs_err={err:.3e}, admitted={int(got[2].sum())}")

    N, E = ENGINE_J, ENGINE_S
    scores, sizes, caps = assign_inputs(N, E, N * 31 + E, device)
    call_ms = cuda_ms(lambda: assign_cuda(scores, sizes, caps, k=1), iters=200)
    per_call = {}
    parts = device_ms(lambda: assign_cuda(scores, sizes, caps, k=1), ASSIGN_KERNELS, iters=200,
                      counts=per_call)
    ms = sum(parts.values())
    plain_ms = cuda_ms(lambda: assign_ref(scores, sizes, caps, k=1), iters=5)
    bytes_moved = N * E * 4 + N * 4 + E * 4 + N * (4 + 4 + 1 + 4)
    ops = N * E * 7          # mask, max, sub, exp, add, argmax compare and select
    bound_ms = max(bytes_moved / PEAK_HBM_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S) * 1e3
    print(f"[kernels] assign at the engine shape N={N} E={E} k=1: kernel {ms:.4f} ms of device "
          f"time ({', '.join(f'{k} {v:.4f}' for k, v in parts.items())}; launches a call "
          f"{json.dumps(per_call)}), {call_ms:.4f} ms a call between CUDA events; "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), "
          "library: no single PyTorch call computes this function")
    rows["assign"] = dict(
        name="assign", route="cuda", source="src/repro_torch/kernels/assign/csrc/assign.cu",
        replaces="src/repro/kernels/assign/assign.py:31", launches=None,
        max_abs_err=gate_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=None, cuda_ms=call_ms, device_ms=ms,
        kernels_per_call=sum(per_call.values()),
    )

    # the segment sum: bit for bit the CPU's row-order sums on the engine's
    # id mixes, then timed at the engine shape (J rows, S sites plus the
    # padding segment S) on a uniform mix and on one where 95% of rows pad
    err = 0.0
    for mix, J, S, F, dtype, id_dtype in SEGSUM_CASES:
        values, seg = segsum_inputs(mix, J, S, F, dtype, id_dtype, J + S + F)
        want = segment_sum_ref(values, seg, S)          # row-order sums on the CPU
        got = segment_sum_cuda(values.to(device), seg.to(device), S).cpu()
        bits = (lambda t: t.view(torch.int32)) if dtype == "float32" else (lambda t: t)
        bad = int((bits(want) != bits(got)).sum())
        check(bad == 0, f"segment_sum {mix} J={J} S={S} F={F} {dtype} {id_dtype}: {bad} sums "
                        "differ from row order")
        if mix == "uniform" and J == ENGINE_J:
            on_card = segment_sum_ref(values.to(device), seg.to(device), S).cpu()
            err = max(err, float((got.double() - on_card.double()).abs().max()))
    print(f"[kernels] segment_sum: {len(SEGSUM_CASES)} id mixes bit for bit the CPU's row-order "
          f"sums; max_abs_err of the card's index_add_ atomics against them {err:.3e}")
    timed = {}
    for mix in ("uniform", "padding95"):
        vals, seg_d = (t.to(device) for t in segsum_inputs(mix, ENGINE_J, ENGINE_S, 1,
                                                            "float32", "int32", 1))
        call = cuda_ms(lambda: segment_sum_cuda(vals, seg_d, ENGINE_S), iters=200)
        per_call = {}
        dev = device_ms(lambda: segment_sum_cuda(vals, seg_d, ENGINE_S), ("segment_sum_kernel",),
                        iters=200, counts=per_call)["segment_sum_kernel"]
        plain = cuda_ms(lambda: segment_sum_ref(vals, seg_d, ENGINE_S), iters=200)
        idx64 = seg_d.long()
        acc = torch.zeros(ENGINE_S + 1, device=device)
        library = cuda_ms(lambda: acc.index_add_(0, idx64, vals), iters=200)
        timed[mix] = dict(cuda_ms=call, device_ms=dev, plain_ms=plain, library_ms=library,
                          kernels_per_call=per_call["segment_sum_kernel"])
        print(f"[kernels] segment_sum {mix} J={ENGINE_J} S={ENGINE_S} f32: {call:.4f} ms a call "
              f"between CUDA events, {dev:.4f} ms device time, "
              f"{per_call['segment_sum_kernel']:g} launches a call; plain {plain:.4f} ms, "
              f"index_add_ {library:.4f} ms")
    bytes_moved = ENGINE_J * (4 + 4) + ENGINE_S * 4
    bound_ms = max(bytes_moved / PEAK_HBM_BYTES_PER_S, ENGINE_J / PEAK_FP32_OPS_PER_S) * 1e3
    print(f"[kernels] segment_sum bound {bound_ms:.6f} ms (bytes, {bytes_moved} B)")
    u = timed["uniform"]
    rows["segment_sum"] = dict(
        name="segment_sum", route="cuda",
        source="src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu",
        replaces="src/repro/core/engine.py:142", launches=None, max_abs_err=err,
        ms=u["device_ms"], plain_ms=u["plain_ms"], bound_ms=bound_ms, bound_by="bytes",
        library_ms=u["library_ms"], cuda_ms=u["cuda_ms"], device_ms=u["device_ms"],
        kernels_per_call=u["kernels_per_call"], padding95=timed["padding95"],
    )
    return rows


def fused_inputs(N, E, K, seed, device, sentinel_rows: bool = False):
    """Candidate rows of sorted distinct site ids, each with a random number
    of sentinel (``E``) pads; integral sizes; caps scaled as in
    ``assign_inputs``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(N, K)).astype(np.float32)
    cand = np.argsort(rng.random((N, E)), axis=1)[:, :K]
    filled = rng.integers(0, K + 1, N)
    cand = np.where(np.arange(K)[None, :] < filled[:, None], cand, E)
    if sentinel_rows:
        cand[rng.random(N) < 0.5] = E
    cand = np.sort(cand, axis=1).astype(np.int32)
    engine = N == ENGINE_J
    sizes = rng.choice([1.0, 8.0] if engine else [1.0, 2.0, 8.0], size=N)
    caps = rng.uniform(2, 40, size=E) * (N / E if engine else 1.0)
    return (torch.from_numpy(scores).to(device), torch.from_numpy(cand).to(device),
            torch.from_numpy(sizes.astype(np.float32)).to(device),
            torch.from_numpy(caps.astype(np.float32)).to(device))


FUSED_CASES = [  # (N, E, K, block_n, seed, sentinel_rows)
    (ENGINE_J, ENGINE_S, ENGINE_K, 256, 0, False),  # the engine shape
    *[(97, 7, 4, 32, seed, False) for seed in range(5)],
    (97, 7, 4, 32, 5, True),                        # half the rows all-sentinel
    (1000, 300, 48, 256, 6, False),                 # K above a warp
    (2048, 50, 50, 256, 7, False),                  # topk = S at the drain's S
]


def phase_fused_kernel(device) -> dict:
    import torch

    from repro_torch.kernels.assign.fused_cuda import fused_assign_cuda
    from repro_torch.kernels.assign.fused_ref import fused_assign_ref

    for N, E, K, bn, seed, sentinel_rows in FUSED_CASES:
        args = fused_inputs(N, E, K, seed, device, sentinel_rows)
        want = fused_assign_ref(*args, block_n=bn)
        got = fused_assign_cuda(*args)
        torch.cuda.synchronize()
        for name, w, g in zip(("site", "admit"), want, got):
            bad = int((w != g).sum())
            check(bad == 0, f"fused N={N} E={E} K={K} seed={seed}: {bad} {name} entries differ")
        print(f"[kernels] fused N={N} E={E} K={K} block_n={bn} seed={seed}"
              f"{' sentinel rows' if sentinel_rows else ''}: site/admit exact, "
              f"picked={int((got[0] >= 0).sum())}, admitted={int(got[1].sum())}")

    N, E, K = ENGINE_J, ENGINE_S, ENGINE_K
    args = fused_inputs(N, E, K, 0, device)
    call_ms = cuda_ms(lambda: fused_assign_cuda(*args), iters=200)
    parts = device_ms(lambda: fused_assign_cuda(*args),
                      ("fused_tile_kernel", "fused_scan_kernel", "fused_admit_kernel"), iters=200)
    ms = sum(parts.values())
    plain_ms = cuda_ms(lambda: fused_assign_ref(*args), iters=5)
    bytes_moved = N * K * (4 + 4) + N * 4 + E * 4 + N * (4 + 1)
    ops = N * K * 3          # validity test, select, compare per slot
    bound_ms = max(bytes_moved / PEAK_HBM_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S) * 1e3
    print(f"[kernels] fused at the engine shape N={N} K={K} E={E}: kernel {ms:.4f} ms of device "
          f"time ({', '.join(f'{k} {v:.4f}' for k, v in parts.items())}; {call_ms:.4f} ms a call "
          f"between CUDA events, host launch time included), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms (bytes, {bytes_moved} B), "
          "library: no single PyTorch call computes this function")
    return dict(
        name="fused_assign", route="cuda",
        source="src/repro_torch/kernels/assign/csrc/fused.cu",
        replaces="src/repro/kernels/assign/fused.py:38", launches=None, max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=None,
    )


FLASH_CASES = [  # (B, Hq, Hkv, S, Skv, D, causal, window, dtype)
    (1, 4, 4, 256, 256, 64, True, 0, "float32"),    # tests/test_kernels.py's six
    (2, 8, 2, 128, 128, 64, True, 0, "float32"),
    (1, 4, 1, 384, 384, 128, True, 0, "float32"),
    (1, 4, 2, 256, 256, 64, True, 64, "float32"),
    (1, 8, 8, 256, 256, 64, True, 0, "bfloat16"),
    (2, 4, 2, 200, 200, 64, True, 96, "bfloat16"),
    (1, 2, 2, 100, 100, 32, False, 0, "float32"),   # non-causal, ragged Skv
    (2, 4, 2, 100, 300, 64, True, 0, "float32"),    # q right-aligned, Skv > S
    (1, 2, 1, 70, 70, 16, True, 0, "bfloat16"),     # mma.sync path, smallest D
    (1, 2, 2, 100, 100, 96, False, 0, "bfloat16"),  # mma.sync path, non-causal ragged
    (1, 4, 2, 130, 200, 192, True, 64, "bfloat16"),  # bf16 on the CUDA-core path (D > 128)
    # the wgmma/TMA path: ragged 128-row tails, right-aligned q, tiles wholly
    # inside a window, qwen2.5-32b's GQA, no causality, D = 64
    (1, 4, 2, 1000, 1000, 128, True, 0, "bfloat16"),
    (2, 4, 2, 300, 1000, 128, True, 0, "bfloat16"),
    (1, 4, 4, 1024, 1024, 128, True, 256, "bfloat16"),
    (1, 40, 8, 2048, 2048, 128, True, 0, "bfloat16"),
    (2, 4, 2, 200, 200, 128, False, 0, "bfloat16"),
    (1, 4, 2, 1000, 1000, 64, True, 0, "bfloat16"),
    (1, 4, 1, 700, 900, 64, True, 200, "bfloat16"),
    (4, 32, 32, 4096, 4096, 128, True, 0, "bfloat16"),  # deepseek-7b prefill (phase 8)
]
FLASH_KERNEL = "flash_fwd_kernel_wgmma"  # the serving shape's kernel (profiler name)
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = "deepseek-7b", 4, 4096, 32


def flash_inputs(B, Hq, Hkv, S, Skv, D, dtype, seed, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    shapes = ((B, Hq, S, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))
    return tuple(torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
                 .to(device=device, dtype=getattr(torch, dtype)) for sh in shapes)


def attention_live_pairs(S, Skv, causal, window) -> int:
    """(query, key) pairs the mask keeps: the work the data needs."""
    import numpy as np

    pos = np.arange(S, dtype=np.int64) + (Skv - S)
    hi = np.minimum(pos, Skv - 1) if causal else np.full(S, Skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def phase_flash_kernel(device) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_cuda as flash_mod
    from repro_torch.kernels.flash_attention.flash_attention_cuda import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref

    worst = {}
    for B, Hq, Hkv, S, Skv, D, causal, window, dtype in FLASH_CASES:
        q, k, v = flash_inputs(B, Hq, Hkv, S, Skv, D, dtype, B * 131 + S, device)
        want = attention_ref(q, k, v, causal=causal, window=window)
        got = flash_attention_cuda(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"flash {B, Hq, Hkv, S, Skv, D}: dtype or shape differs from the plain version")
        check(err <= tol, f"flash {B, Hq, Hkv, S, Skv, D} causal={causal} window={window} "
                          f"{dtype}: max_abs_err {err:.3e} > {tol}")
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        print(f"[flash] B={B} Hq={Hq} Hkv={Hkv} S={S} Skv={Skv} D={D} causal={causal} "
              f"window={window} {dtype}: max_abs_err={err:.3e} (tol {tol})")
        del q, k, v, want, got

    B, Hq, Hkv, S, Skv, D, causal, window, dtype = FLASH_CASES[-1]
    q, k, v = flash_inputs(B, Hq, Hkv, S, Skv, D, dtype, 0, device)
    smem = flash_mod._lib().flash_attention_wgmma_smem_bytes(D)
    print(f"[flash] {FLASH_KERNEL} at D={D}: {smem} B of dynamic shared memory a CTA of 384 "
          "threads (one CTA an SM)")
    # the profiled launches must be the wgmma kernel, not the mma.sync or f32 one
    parts = device_ms(lambda: flash_attention_cuda(q, k, v, causal=causal), (FLASH_KERNEL,),
                      iters=10, forbid=("flash_fwd_kernel_mma", "flash_fwd_kernel<"))
    ms = parts[FLASH_KERNEL]
    call_ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=causal), iters=10)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=causal), iters=3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                         iters=10)
    ops = 4 * B * Hq * D * attention_live_pairs(S, Skv, causal, window)  # QK^T and PV, 2 per MAC
    bytes_moved = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = ops / PEAK_BF16_OPS_PER_S, bytes_moved / PEAK_HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[flash] at the deepseek-7b prefill shape B={B} H={Hq} S={S} D={D} causal {dtype}: "
          f"kernel {FLASH_KERNEL} {ms:.4f} ms of device time ({call_ms:.4f} ms a call between CUDA events), "
          f"{ops / ms / 1e9:.2f} TFLOP/s; plain {plain_ms:.4f} ms; "
          f"scaled_dot_product_attention {library_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}: {ops:.4e} FLOP at 989 TFLOP/s bf16, {bytes_moved} B at 3.35 TB/s)")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:26", launches=None,
        max_abs_err=max(worst.values()), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
    )


def phase_serve(device) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda as flash_mod
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import attention, build_model, param_count
    from repro_torch.kernels.flash_attention.ops import chunked_attention
    from repro_torch.serve.serve_step import generate

    cfg = get_config(SERVE_ARCH)
    ref_shape = SHAPES["prefill_32k"]
    B, S, new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    print(f"[serve] {cfg.name} at full width and depth ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}), random weights from torch.Generator seed 0; "
          f"{B} prompts of {S} seeded tokens and {new} new tokens: the prompt cut from "
          f"{ref_shape.name}'s {ref_shape.seq_len} tokens and the batch from "
          f"{ref_shape.global_batch}, to fit one card's memory and the smoke's time limit")
    model = build_model(cfg, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    print(f"[serve] {param_count(params)} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.2f}s")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(device)}

    marks = {"prefill": [], "decode": []}

    def timed(name, fn):
        def call(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            marks[name].append((start, end))
            return out
        return call

    timed_model = model._replace(prefill=timed("prefill", model.prefill),
                                 decode=timed("decode", model.decode))

    def no_plain_version(*args, **kw):
        raise SmokeFailure("the serving path ran a plain attention version on the card")

    plain = flash_ops.attention_ref, attention.chunked_attention, attention.qblock_attention
    flash_ops.attention_ref = attention.chunked_attention = attention.qblock_attention = \
        no_plain_version
    try:
        torch.cuda.reset_peak_memory_stats()
        flash_mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out1 = generate(timed_model, params, batch, max_new=new, cache_len=S + new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_mod.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        first = {name: len(m) for name, m in marks.items()}
        out2 = generate(timed_model, params, batch, max_new=new, cache_len=S + new)
        torch.cuda.synchronize()
    finally:
        flash_ops.attention_ref, attention.chunked_attention, attention.qblock_attention = plain
    # run 1 is the model's first call on the card (cuBLAS and module loading
    # included); run 2 repeats it warm
    for run, (lo, hi) in enumerate(((0, first["prefill"]), (first["prefill"], None)), 1):
        prefill_s = sum(a.elapsed_time(b) for a, b in marks["prefill"][lo:hi]) / 1e3
        dmarks = marks["decode"][:first["decode"]] if run == 1 else marks["decode"][first["decode"]:]
        decode_s = sum(a.elapsed_time(b) for a, b in dmarks) / 1e3
        steps = len(dmarks)
        print(f"[serve] generate run {run}" + (f": {wall:.3f}s wall;" if run == 1 else ":") +
              f" prefill {prefill_s:.4f}s = {B * S / prefill_s:.1f} tokens/s; decode {steps} "
              f"steps in {decode_s:.4f}s = {B * steps / decode_s:.1f} tokens/s "
              f"({1e3 * decode_s / max(steps, 1):.2f} ms a step)" +
              (f"; flash launches {launches}; peak memory {peak_gb:.2f} GB" if run == 1 else ""))
    check(launches == cfg.n_layers,
          f"the prefill launched the flash kernel {launches} times, not once a layer "
          f"({cfg.n_layers})")
    check(out1.shape == (B, new) and out1.dtype == torch.int32, f"tokens {tuple(out1.shape)}")
    check(bool(((out1 >= 0) & (out1 < cfg.vocab_size)).all()), "a token outside the vocabulary")
    check(torch.equal(out1, out2), "two generate runs on the card differ")
    print(f"[serve] second run bit-identical; first tokens of prompt 0: "
          f"{out1[0, :8].tolist()}")

    # the kernel path's prefill logits against the plain chunked attention's
    cache = model.init_cache(B, S + new)
    got, _ = model.prefill(params, batch, cache)
    flash_fn = attention.flash_attention
    attention.flash_attention = lambda q, k, v, **kw: chunked_attention(q, k, v, chunk=cfg.attn_chunk,
                                                                        **kw)
    try:
        want, _ = model.prefill(params, batch, cache)
    finally:
        attention.flash_attention = flash_fn
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "prefill logits not finite")
    diff, top = float((got - want).abs().max()), float(want.abs().max())
    print(f"[serve] prefill last-position logits, kernel vs plain chunked_attention: "
          f"max|d|={diff:.4e}, max|logits|={top:.4e}, ratio {diff / top:.3e} (limit 2e-2); "
          f"argmax agrees on {int((got.argmax(-1) == want.argmax(-1)).sum())}/{B}")
    check(diff <= 2e-2 * top, f"kernel-path logits differ from the plain path by {diff:.4e}")
    del cache
    profile_serve(model, params, batch, S + new, cfg.n_layers)
    return {"flash_attention": launches}


def profile_serve(model, params, batch, cache_len, n_layers: int) -> None:
    """Device busy share and the top kernels of one prefill and of 8 decode
    steps (``torch.profiler``); the prefill's flash launches must all be
    ``FLASH_KERNEL``, one a layer."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cache = model.init_cache(batch["tokens"].shape[0], cache_len)
    logits, cache = model.prefill(params, batch, cache)
    token = logits[:, -1].argmax(-1, keepdim=True).int()
    for label, run in (("prefill", lambda: model.prefill(params, batch, cache)),
                       ("decode x8", lambda: [model.decode(params, token, dict(cache, len=cache["len"]))
                                              for _ in range(8)])):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"[serve-profile] {label}: wall {wall_ms:.1f} ms (profiled), device busy "
              f"{busy:.1f} ms = {100 * busy / wall_ms:.1f}%, {sum(e.count for e in kernels)} kernels")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[serve-profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  "
                  f"{e.key[:90]}")
        flash = [e for e in kernels if "flash_fwd_kernel" in e.key]
        if label == "prefill":
            n = sum(e.count for e in flash)
            check(n == n_layers and all(FLASH_KERNEL in e.key for e in flash),
                  f"the profiled prefill ran {[(e.key[:60], e.count) for e in flash]}, not "
                  f"{n_layers} launches of {FLASH_KERNEL}")
            ms = sum(e.self_device_time_total for e in flash) / 1e3
            print(f"[serve-profile] prefill: {n} launches of {FLASH_KERNEL}, {ms:.3f} ms "
                  f"= {100 * ms / busy:.1f}% of the device time")


def snapshot(res) -> dict:
    from repro_torch.core import result_to_numpy

    out = result_to_numpy(res)
    return dict(rounds=int(out["rounds"]), makespan=out["makespan"],
                **{f"jobs.{f}": out["jobs"][f] for f in JOB_FIELDS},
                **{f"sites.{f}": out["sites"][f] for f in SITE_FIELDS})


def mismatches(a: dict, b: dict) -> dict:
    import numpy as np

    return {k: int(np.size(a[k]) if np.shape(a[k]) != np.shape(b[k])
                   else np.count_nonzero(np.asarray(a[k]) != np.asarray(b[k])))
            for k in a if not np.array_equal(a[k], b[k])}


def check_invariants(res, label: str) -> None:
    """Finite, well-shaped outputs that obey the engine's own bookkeeping."""
    import torch

    from repro_torch.core import RUNNING

    jobs, sites = res.jobs, res.sites
    check(bool(torch.isfinite(res.makespan)), f"{label}: makespan not finite")
    started = torch.isfinite(jobs.t_start)
    check(bool((jobs.t_finish[started] >= jobs.t_start[started]).all()),
          f"{label}: a job finishes before it starts")
    running_site = torch.where(jobs.state == RUNNING, jobs.site, sites.capacity)
    busy = torch.zeros(sites.capacity + 1, dtype=torch.int64, device=jobs.site.device)
    busy.index_add_(0, running_site.long(), jobs.cores.long())
    check(bool((sites.free_cores.long() + busy[:-1] == sites.cores.long()).all()),
          f"{label}: free + running cores differ from site cores")
    check(bool((sites.free_cores >= 0).all()), f"{label}: negative free cores")


def phase_full_width(device, max_rounds: int) -> dict:
    import torch

    from repro_torch import core as T
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import make_capacity_assign
    from repro_torch.kernels.assign import ops as assign_ops
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    sites = T.atlas_like_platform(ENGINE_S, seed=1, device=device)
    jobs = T.synthetic_panda_jobs(ENGINE_J, seed=0, duration=6 * 3600.0, device=device)
    work_rounds = [0]
    capacity_assign = make_capacity_assign(jobs.cores)

    def counted_assign(*args):
        work_rounds[0] += 1          # assign runs once per round with work
        return capacity_assign(*args)

    policy = T.with_capacity_assign(T.get_policy("panda_dispatch"), counted_assign)
    key = T.PRNGKey(0)

    def no_plain_version(*args, **kw):
        raise SmokeFailure("the main path called assign_ref on the card")

    plain = assign_ops.assign_ref
    assign_ops.assign_ref = no_plain_version
    try:
        assign_mod.launches = 0
        segsum_mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = T.simulate(jobs, sites, policy, key, max_rounds=max_rounds, device=device)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
    finally:
        assign_ops.assign_ref = plain
    launches = {"assign": assign_mod.launches, "segment_sum": segsum_mod.launches}
    rounds_with_work = work_rounds[0]
    print(f"[full] S={ENGINE_S} J={ENGINE_J} rounds={res.rounds} rounds_with_work="
          f"{rounds_with_work} launches={json.dumps(launches)} wall={wall1:.3f}s")
    check(launches["assign"] > 0, "the main path never launched the assign kernel")
    check(launches["assign"] == rounds_with_work,
          f"assign launches {launches['assign']} != rounds with work {rounds_with_work}")
    check(launches["segment_sum"] > 0, "the main path never launched the segment_sum kernel")
    check_invariants(res, "full")
    snap1 = snapshot(res)

    # second run: determinism, and the assign kernel's device time per launch
    timings = []
    real_assign = assign_ops.assign_cuda

    def timed_assign(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_assign(*args, **kw)
        end.record()
        timings.append((start, end))
        return out

    assign_ops.assign_cuda = timed_assign
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res2 = T.simulate(jobs, sites, policy, key, max_rounds=max_rounds, device=device)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    finally:
        assign_ops.assign_cuda = real_assign
    bad = mismatches(snap1, snapshot(res2))
    check(not bad, f"two runs on the card differ: {bad}")
    kernel_s = sum(s.elapsed_time(e) for s, e in timings) / 1e3
    print(f"[full] second run bit-identical; rounds/s first={res.rounds / wall1:.2f} "
          f"second={res2.rounds / wall2:.2f}; assign kernel {len(timings)} launches, "
          f"{kernel_s * 1e3:.3f} ms device time = {100 * kernel_s / wall2:.2f}% of the run's "
          f"wall time ({1e3 * kernel_s / max(len(timings), 1):.4f} ms/launch)")
    print(f"[full] {T.summary_str(T.compute_metrics(res))}")
    profile_rounds(lambda: T.simulate(jobs, sites, policy, key, max_rounds=100, device=device))
    return launches


def phase_sparse_full_width(device, max_rounds: int) -> dict:
    import torch

    from repro_torch import core as T
    from repro_torch.core.rng import fold_in
    from repro_torch.core.sparse import CAND_SALT
    from repro_torch.kernels.assign import assign_cuda as assign_mod
    from repro_torch.kernels.assign import fused_cuda as fused_mod
    from repro_torch.kernels.assign import make_capacity_assign, make_fused_capacity_assign
    from repro_torch.kernels.assign import ops as assign_ops
    from repro_torch.kernels.segment_sum import segment_sum_cuda as segsum_mod

    sites = T.atlas_like_platform(ENGINE_S, seed=1, device=device)
    jobs = T.synthetic_panda_jobs(ENGINE_J, seed=0, duration=6 * 3600.0, device=device)
    work_rounds = [0]
    fused_assign = make_fused_capacity_assign(jobs.cores)

    def counted_assign(*args):
        work_rounds[0] += 1          # assign_cand runs once per round with work
        return fused_assign(*args)

    policy = T.with_fused_assign(T.get_policy("data_locality"), counted_assign)
    key = T.PRNGKey(0)

    def no_plain_version(*args, **kw):
        raise SmokeFailure("the sparse path called a plain assignment version on the card")

    plain = assign_ops.fused_assign_ref, assign_ops.assign_ref
    assign_ops.fused_assign_ref = assign_ops.assign_ref = no_plain_version
    try:
        fused_mod.launches = 0
        assign_mod.launches = 0
        segsum_mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = T.simulate(jobs, sites, policy, key, max_rounds=max_rounds, topk=ENGINE_K,
                         device=device)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
    finally:
        assign_ops.fused_assign_ref, assign_ops.assign_ref = plain
    launches = {"fused_assign": fused_mod.launches, "assign": assign_mod.launches,
                "segment_sum": segsum_mod.launches}
    rounds_with_work = work_rounds[0]
    print(f"[sparse] S={ENGINE_S} J={ENGINE_J} topk={ENGINE_K} rounds={res.rounds} "
          f"rounds_with_work={rounds_with_work} launches={json.dumps(launches)} "
          f"wall={wall1:.3f}s")
    check(launches["fused_assign"] > 0, "the sparse path never launched the fused kernel")
    check(launches["fused_assign"] == rounds_with_work,
          f"fused launches {launches['fused_assign']} != rounds with work {rounds_with_work}")
    check(launches["assign"] == 0, "the sparse path launched the dense assign kernel")
    check(launches["segment_sum"] > 0, "the sparse path never launched the segment_sum kernel")
    check_invariants(res, "sparse")
    snap1 = snapshot(res)

    # the candidate build that init paid, alone
    clock0 = torch.zeros((), dtype=torch.float32, device=device)
    cand_key = fold_in(key, CAND_SALT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cand = T.build_candidates(jobs, sites, policy, (), clock0, cand_key, {}, ENGINE_K)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    full_rows = float((cand < ENGINE_S).all(-1).float().mean())
    print(f"[sparse] candidate build at init: {build_s:.4f} s for i32[{ENGINE_J}, {ENGINE_K}] "
          f"({100 * full_rows:.1f}% of rows hold {ENGINE_K} feasible sites)")

    # second run: determinism, and the fused kernel's device time per launch
    timings = []
    real_fused = assign_ops.fused_assign_cuda

    def timed_fused(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_fused(*args, **kw)
        end.record()
        timings.append((start, end))
        return out

    assign_ops.fused_assign_cuda = timed_fused
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res2 = T.simulate(jobs, sites, policy, key, max_rounds=max_rounds, topk=ENGINE_K,
                          device=device)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    finally:
        assign_ops.fused_assign_cuda = real_fused
    bad = mismatches(snap1, snapshot(res2))
    check(not bad, f"two sparse runs on the card differ: {bad}")
    kernel_s = sum(s.elapsed_time(e) for s, e in timings) / 1e3
    print(f"[sparse] second run bit-identical; rounds/s first={res.rounds / wall1:.2f} "
          f"second={res2.rounds / wall2:.2f}; fused kernel {len(timings)} launches, "
          f"{kernel_s * 1e3:.3f} ms device time = {100 * kernel_s / wall2:.2f}% of the run's "
          f"wall time ({1e3 * kernel_s / max(len(timings), 1):.4f} ms/launch)")
    print(f"[sparse] {T.summary_str(T.compute_metrics(res))}")

    # the same policy and depth through the dense path, for the rate
    dense_policy = T.with_capacity_assign(T.get_policy("data_locality"),
                                          make_capacity_assign(jobs.cores))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_d = T.simulate(jobs, sites, dense_policy, key, max_rounds=max_rounds, device=device)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    check_invariants(res_d, "sparse-vs-dense")
    first = {}
    for label, pol, k in (("sparse", policy, ENGINE_K), ("dense", dense_policy, None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.simulate(jobs, sites, pol, key, max_rounds=100, topk=k, device=device)
        torch.cuda.synchronize()
        first[label] = 100 / (time.perf_counter() - t0)
    print(f"[sparse] the same policy dense (capacity dispatch): rounds/s={res_d.rounds / wall_d:.2f}"
          f" over {res_d.rounds} rounds; first 100 rounds: sparse {first['sparse']:.2f}, "
          f"dense {first['dense']:.2f} rounds/s")
    profile_rounds(lambda: T.simulate(jobs, sites, policy, key, max_rounds=100, topk=ENGINE_K,
                                      device=device), "sparse")
    return launches


def profile_rounds(run, label: str = "profile") -> None:
    """Device busy share and the kernels that take the most device time over
    the first 100 rounds of a full-width run (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm the caching allocator and the profiler-free path first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms == 0.0:
        print(f"[{label}] the profiler saw no device time: busy share not measured")
        return
    sorts = sum(e.count for e in kernels if "DeviceRadixSortOnesweepKernel" in e.key)
    print(f"[{label}] 100 rounds: wall {wall_ms:.1f} ms (profiled), device busy "
          f"{device_ms:.1f} ms = {100 * device_ms / wall_ms:.1f}%, idle "
          f"{100 - 100 * device_ms / wall_ms:.1f}%, {sum(e.count for e in kernels)} kernels, "
          f"{sorts} of them DeviceRadixSortOnesweepKernel")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[{label}]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


def phase_drain(device) -> None:
    import torch

    from repro_torch import core as T
    from repro_torch.kernels.assign import make_capacity_assign

    snaps = {}
    threads = torch.get_num_threads()
    for dev in (device, torch.device("cpu")):
        sites = T.atlas_like_platform(50, seed=1, fail_rate=0.02, device=dev)
        jobs = T.synthetic_panda_jobs(5000, seed=0, device=dev)
        policy = T.with_capacity_assign(T.get_policy("panda_dispatch"),
                                        make_capacity_assign(jobs.cores))
        # at J=5000 every CPU op is small: one thread beats a pool (the
        # engine's results do not depend on the thread count)
        torch.set_num_threads(1 if dev.type == "cpu" else threads)
        t0 = time.perf_counter()
        try:
            res = T.simulate(jobs, sites, policy, T.PRNGKey(0), device=dev)
        finally:
            torch.set_num_threads(threads)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        active = int(((res.jobs.state <= T.RUNNING) & res.jobs.valid).sum())
        print(f"[drain] {dev.type}: rounds={res.rounds} makespan={float(res.makespan)!r} "
              f"active_left={active} wall={wall:.2f}s ({res.rounds / wall:.1f} rounds/s)")
        check(active == 0, f"{dev.type}: the drain left {active} active jobs")
        check_invariants(res, f"drain-{dev.type}")
        snaps[dev.type] = snapshot(res)
        print(f"[drain] {dev.type}: {T.summary_str(T.compute_metrics(res))}")
    bad = mismatches(snaps["cuda"], snaps["cpu"])
    print(f"[drain] card vs CPU mismatch counts: {json.dumps(bad)}")
    check(not bad, "the card's drain differs from the CPU's")


def phase_sparse_drain(device, max_rounds: int) -> None:
    """The drain scenario cut to ``max_rounds``: the fused sparse path at
    ``topk=S`` against the dense capacity dispatch on the card, and ``topk=8``
    on the card against the CPU."""
    import torch

    from repro_torch import core as T
    from repro_torch.kernels.assign import make_capacity_assign, make_fused_capacity_assign

    def scenario(dev):
        sites = T.atlas_like_platform(50, seed=1, fail_rate=0.02, device=dev)
        jobs = T.synthetic_panda_jobs(5000, seed=0, device=dev)
        return jobs, sites

    def run(dev, label, dense=False, topk=None):
        jobs, sites = scenario(dev)
        base = T.get_policy("panda_dispatch")
        policy = (T.with_capacity_assign(base, make_capacity_assign(jobs.cores)) if dense
                  else T.with_fused_assign(base, make_fused_capacity_assign(jobs.cores)))
        threads = torch.get_num_threads()
        torch.set_num_threads(1 if dev.type == "cpu" else threads)
        t0 = time.perf_counter()
        try:
            res = T.simulate(jobs, sites, policy, T.PRNGKey(0), max_rounds=max_rounds,
                             topk=topk, device=dev)
        finally:
            torch.set_num_threads(threads)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_invariants(res, f"sparse-drain {label}")
        print(f"[sparse-drain] {label}: rounds={res.rounds} makespan={float(res.makespan)!r} "
              f"retries={int(res.jobs.retries.sum())} n_failed={int(res.sites.n_failed.sum())} "
              f"wall={wall:.2f}s ({res.rounds / wall:.1f} rounds/s)")
        return snapshot(res)

    cpu = torch.device("cpu")
    dense = run(device, "card dense capacity", dense=True)
    full = run(device, "card fused topk=S", topk=50)
    bad = mismatches(dense, full)
    print(f"[sparse-drain] topk=S vs dense mismatch counts: {json.dumps(bad)}")
    check(not bad, "topk=S with the fused assigner differs from the dense capacity dispatch")
    card8 = run(device, "card fused topk=8", topk=8)
    cpu8 = run(cpu, "cpu fused topk=8", topk=8)
    bad = mismatches(card8, cpu8)
    print(f"[sparse-drain] topk=8 card vs CPU mismatch counts: {json.dumps(bad)}")
    check(not bad, "topk=8 on the card differs from the CPU")
    check(mismatches(card8, full), "topk=8 gave the topk=S run: the cut did not bind")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    phase_build()
    rows = phase_kernels(device)
    rows["fused_assign"] = phase_fused_kernel(device)
    rows["flash_attention"] = phase_flash_kernel(device)
    launches = phase_full_width(device, FULL_MAX_ROUNDS)
    sparse_launches = phase_sparse_full_width(device, FULL_MAX_ROUNDS)
    phase_drain(device)
    phase_sparse_drain(device, SPARSE_DRAIN_ROUNDS)
    serve_launches = phase_serve(device)
    for name, row in rows.items():
        row["launches"] = (sparse_launches[name] if name == "fused_assign" else
                           serve_launches[name] if name == "flash_attention" else launches[name])
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
