#!/usr/bin/env python3
"""Time the port's segment-sum and assignment kernels against another
checkout's, on one GPU, in turns (other, this, this, other).

    python3 scripts/compare_kernels.py --other DIR [--rounds N]

``DIR`` is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive``); its ``src/repro_torch`` is
imported under another name and builds its kernels into its own ``build/``.
For each version and each input, the script checks the kernel against the
plain version (bit for bit, gate to rtol 1e-5), then reports the time of a
call between CUDA events (host launch work included), the device time of a
call and the kernels launched a call (``torch.profiler``: every kernel the
call runs, sorts included).  Inputs are those of ``chip_smoke.py``: the
assignment at the engine shape (N=100000, E=300, k=1) and the segment sum
at J=100000, S=300 on a uniform id mix and on one where 95% of rows carry
the padding id, f32 ``[J]`` and i32 ``[J, 3]``.  With ``--rounds N`` it also
runs N dense and N sparse rounds of the full-width engine scenario with
each version and reports rounds/s.  It writes its numbers to
``chiprun_out/compare_kernels.json`` and needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def import_package(src: pathlib.Path, name: str):
    """Import the ``repro_torch`` package under ``src`` as module ``name``."""
    init = src / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(name, init,
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
        core=sub("core"),
        kernels_assign=sub("kernels.assign"),
    )


def profile_call(fn, iters: int) -> tuple[float, float]:
    """(device ms a call, kernels a call) over ``iters`` calls, from
    ``torch.profiler``: every kernel the calls ran."""
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
    return busy / iters, sum(e.count for e in kernels) / iters


def time_kernels(v: dict, label: str, device, out: dict) -> None:
    import torch

    from chip_smoke import ENGINE_J, ENGINE_S, assign_inputs, check, cuda_ms, segsum_inputs

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

    from chip_smoke import ENGINE_J, ENGINE_K, ENGINE_S

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
        out.setdefault(f"{name} rounds/s", []).append(dict(version=label, rate=rate,
                                                           rounds=res.rounds))
        print(f"[compare] {label} {name} engine: {res.rounds} rounds at {rate:.2f} rounds/s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=0,
                    help="engine rounds a run for the rounds/s comparison (0: none)")
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
    for label, v in versions.items():
        print(f"[compare] {label} build seconds {v['build'].build(['assign', 'segment_sum'])}")
    out: dict = {"card": gpu_name_and_power()}
    for label in ("other", "this", "this", "other"):
        time_kernels(versions[label], label, device, out)
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
