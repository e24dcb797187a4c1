"""Int8 gradient compression with error feedback, as the JAX package's
``train/compress.py`` computes it: each gradient plus the carried error is
quantized to int8 with one absmax scale a tensor, dequantized, and what the
round trip lost is carried into the next step.  This is the numerics of a
compressed all-reduce; on one card no collective runs.  XLA contracts the
carried error ``gf - q * scale`` into one fused multiply-add, and so does
the port (``core.scan.fma_f32``), so the error has the JAX package's bits.
"""
from __future__ import annotations

import torch

from ..core.scan import fma_f32


def init_error_state(params: dict) -> dict:
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in params.items()}


def _q8(x: torch.Tensor, amax: torch.Tensor):
    scale = torch.maximum(amax, torch.tensor(1e-12, device=x.device)) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads: dict, err_state: dict, groups: dict | None = None):
    """grads + carried error -> (int8-roundtripped f32 grads, new error).

    One scale a tensor, or a group's: ``groups`` (name -> key) puts tensors
    under one scale, as the JAX package's one leaf holds every layer of a
    kind (``train_step.leaf_groups``)."""
    gf = {name: g.float() + err_state[name] for name, g in grads.items()}
    key = (lambda name: name) if groups is None else groups.__getitem__
    amax: dict = {}
    for name, t in gf.items():
        m = t.abs().max()
        amax[key(name)] = m if key(name) not in amax else torch.maximum(amax[key(name)], m)
    deq, err = {}, {}
    for name, t in gf.items():
        q, scale = _q8(t, amax[key(name)])
        deq[name] = q.float() * scale
        err[name] = fma_f32(-q.float(), scale, t)
    return deq, err


def compression_ratio(params: dict, groups: dict | None = None) -> float:
    """Bytes saved on the cross-pod hop: bf16 (2 B) -> int8 (1 B) + a scale
    a tensor (or a group)."""
    total = sum(p.numel() for p in params.values())
    scales = len(params) if groups is None else len(set(groups.values()))
    return (2.0 * total) / (1.0 * total + 4.0 * scales)
