#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when its
check does not hold:

1. build every CUDA source of the port for sm_90a (one nvcc per source, all
   started together) and print the build seconds and ptxas resource use;
2. hold every kernel against its plain PyTorch version on the card: the
   assignment kernel at the engine shape and at the kernel-test shapes
   (idx/admit/pos exact, gate rtol 1e-5 atol 1e-6), the segment sum at the
   engine shape (exact against the plain version's row-order sums);
   time both at the engine shape with CUDA events;
3. drive the main path at WLCG scale: ``simulate`` on 300 sites and 100000
   jobs with ``panda_dispatch`` plus capacity dispatch, twice, with the
   launch counters set to 0 just before the first run; require every round
   with work to launch the assignment kernel once, and the two runs to agree
   bit for bit; print rounds/s and the assignment kernel's share of it;
4. drain a 50-site, 5000-job scenario with failures to the end on the card
   and on the CPU, and require the same rounds, makespan, per-job outcomes
   and site counters.

It prints one JSON line of per-kernel numbers, then the card's name and power
limit, then the result line ``{"ok": true, "device": {...}}``.  It needs the
repository's ``src/`` beside it and a CUDA device, and exits non-zero without
either.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

PEAK_HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
PEAK_FP32_OPS_PER_S = 67e12      # H100 SXM, non-tensor-core float32

ENGINE_J, ENGINE_S = 100_000, 300
FULL_MAX_ROUNDS = 2000
ASSIGN_CASES = [  # (N, E, k, block_n)
    (ENGINE_J, ENGINE_S, 1, 256),   # the engine shape
    (64, 8, 1, 32),
    (33, 7, 3, 16),
    (512, 32, 8, 128),
    (256, 384, 8, 256),
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


def phase_build() -> None:
    from repro_torch import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"[build] {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"wall={time.perf_counter() - t0:.2f}s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


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


def phase_kernels(device) -> dict:
    import numpy as np
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
    ms = cuda_ms(lambda: assign_cuda(scores, sizes, caps, k=1), iters=50)
    plain_ms = cuda_ms(lambda: assign_ref(scores, sizes, caps, k=1), iters=5)
    bytes_moved = N * E * 4 + N * 4 + E * 4 + N * (4 + 4 + 1 + 4)
    ops = N * E * 7          # mask, max, sub, exp, add, argmax compare and select
    bound_ms = max(bytes_moved / PEAK_HBM_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S) * 1e3
    print(f"[kernels] assign at the engine shape N={N} E={E} k=1: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), "
          "library: no single PyTorch call computes this function")
    rows["assign"] = dict(
        name="assign", route="cuda", source="src/repro_torch/kernels/assign/csrc/assign.cu",
        replaces="src/repro/kernels/assign/assign.py:31", launches=None,
        max_abs_err=gate_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=None,
    )

    # the segment sum at the engine shape: values of J rows over S sites plus
    # the padding segment S, float (memory) and stacked int (cores, counts)
    rng = np.random.default_rng(1)
    seg = torch.from_numpy(rng.integers(0, ENGINE_S + 1, ENGINE_J).astype(np.int32))
    err = 0.0
    for values in (torch.from_numpy(rng.uniform(1.6, 19.2, ENGINE_J).astype(np.float32)),
                   torch.from_numpy(rng.integers(0, 9, (ENGINE_J, 3)).astype(np.int32))):
        want = segment_sum_ref(values, seg, ENGINE_S)   # row-order sums on the CPU
        got = segment_sum_cuda(values.to(device), seg.to(device), ENGINE_S).cpu()
        bad = int((want != got).sum())
        check(bad == 0, f"segment_sum {values.dtype}: {bad} sums differ from row order")
        on_card = segment_sum_ref(values.to(device), seg.to(device), ENGINE_S).cpu()
        err = max(err, float((got.double() - on_card.double()).abs().max()))
    print(f"[kernels] segment_sum J={ENGINE_J} S={ENGINE_S}: f32 and 3 x i32 exact against "
          f"the CPU's row-order sums; max_abs_err against the card's atomics {err:.3e}")
    vals = torch.from_numpy(rng.uniform(1.6, 19.2, ENGINE_J).astype(np.float32)).to(device)
    seg_d = seg.to(device)
    ms = cuda_ms(lambda: segment_sum_cuda(vals, seg_d, ENGINE_S), iters=50)
    plain_ms = cuda_ms(lambda: segment_sum_ref(vals, seg_d, ENGINE_S), iters=50)
    idx64 = seg_d.long()
    acc = torch.zeros(ENGINE_S + 1, device=device)
    library_ms = cuda_ms(lambda: acc.index_add_(0, idx64, vals), iters=50)
    bytes_moved = ENGINE_J * (4 + 4) + ENGINE_S * 4
    bound_ms = max(bytes_moved / PEAK_HBM_BYTES_PER_S, ENGINE_J / PEAK_FP32_OPS_PER_S) * 1e3
    print(f"[kernels] segment_sum at the engine shape: wrapper (sort + kernel) {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, bound {bound_ms:.6f} ms")
    rows["segment_sum"] = dict(
        name="segment_sum", route="cuda",
        source="src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu",
        replaces="src/repro/core/engine.py:142", launches=None, max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
    )
    return rows


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


def profile_rounds(run) -> None:
    """Device busy share and the kernels that take the most device time over
    the first 100 rounds of the full-width run (``torch.profiler``)."""
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
        print("[profile] the profiler saw no device time: busy share not measured")
        return
    print(f"[profile] 100 rounds: wall {wall_ms:.1f} ms (profiled), device busy "
          f"{device_ms:.1f} ms = {100 * device_ms / wall_ms:.1f}%, idle "
          f"{100 - 100 * device_ms / wall_ms:.1f}%, {sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


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
    launches = phase_full_width(device, FULL_MAX_ROUNDS)
    phase_drain(device)
    for name, row in rows.items():
        row["launches"] = launches[name]
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
