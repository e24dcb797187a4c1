"""Time one decode step's attention against a KV cache whose positions are
split over N cards, as ``cache_shardings`` places a decode cell's cache on a
mesh, three ways:

- ``split``: ``decode_attention`` on the ``DTensor`` cache, which takes
  ``_decode_attention_split`` (each card attends to its own positions; an
  all-reduce of the row max and two of the sums combine them);
- ``gather``: the cache all-gathered (``full_tensor``) every step, then the
  one-card ``decode_attention`` (what a decode that ignores the placement
  pays);
- ``one_card``: the one-card ``decode_attention`` on the whole cache, held
  by one card (no collective; the reference for the values).

    python scripts/split_decode.py [--ranks 4] [--batch 8] [--len 32768]
                                   [--heads 32] [--head-dim 128] [--iters 20] [--cpu]

The defaults are deepseek-7b's ``decode_32k`` cell on a ``(1, 4)`` mesh: 8
sequences (128 over 16 data shards), 32 heads of 128, a full cache of 32768
positions in bf16, 8192 a card.  One process a card (NCCL), or with
``--cpu`` one a gloo rank in f32 at whatever size is given.  Each way is
timed between CUDA events (host clock on the CPU) over ``--iters`` steps
after a barrier and 3 warm steps; rank 0 prints one JSON line with the
median ms a step of each way, the largest gap of ``split`` and ``gather``
against ``one_card`` (relative to the largest output), and the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))


def _timed(fn, iters: int, cuda: bool):
    import torch
    import torch.distributed as dist

    for _ in range(3):
        out = fn()
    dist.barrier()
    times = []
    for _ in range(iters):
        if cuda:
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def rank_main(mesh, out_dir: str, B: int, L: int, H: int, D: int, iters: int) -> None:
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.flash_attention.ops import decode_attention

    cuda = mesh.device_type == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    dtype = torch.bfloat16 if cuda else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=dtype)
               for shape in ((B, H, 1, D), (B, H, L, D), (B, H, L, D)))
    kd = distribute_tensor(k, mesh, [Shard(2)])
    vd = distribute_tensor(v, mesh, [Shard(2)])
    qd = distribute_tensor(q, mesh, [Replicate()])
    ms, got = {}, {}
    ms["split"], o = _timed(lambda: decode_attention(qd, kd, vd, kv_len=L), iters, cuda)
    got["split"] = o.full_tensor()
    ms["gather"], got["gather"] = _timed(
        lambda: decode_attention(q, kd.full_tensor(), vd.full_tensor(), kv_len=L), iters, cuda)
    ms["one_card"], want = _timed(lambda: decode_attention(q, k, v, kv_len=L), iters, cuda)
    scale = float(want.float().abs().max())
    err = {way: float((o.float() - want.float()).abs().max()) / scale for way, o in got.items()}
    if torch.distributed.get_rank() == 0:
        rec = dict(ranks=mesh.size(), batch=B, len=L, heads=H, head_dim=D, dtype=str(dtype),
                   cache_bytes_a_card=2 * k.element_size() * B * H * (L // mesh.size()) * D,
                   ms=ms, rel_err=err)
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(rec, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--len", type=int, default=32768)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from repro_torch.core.distributed import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(rank_main, args.ranks, (tmp, args.batch, args.len, args.heads, args.head_dim,
                                          args.iters),
                  device_type="cpu" if args.cpu else "cuda", axis="model")
        with open(os.path.join(tmp, "result.json")) as f:
            rec = json.load(f)
    if not args.cpu:
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(rec))
    ok = all(e <= (2e-2 if not args.cpu else 1e-5) for e in rec["rel_err"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
