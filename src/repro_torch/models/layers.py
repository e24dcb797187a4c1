"""Shared primitive layers: norms, rotary embeddings, linear init.

Weights keep the JAX package's layout (``x @ w`` with ``w [d_in, d_out]``),
so they carry across unchanged.  Initial weights are drawn from an explicit
``torch.Generator`` with the reference's scales; the stream is not JAX's.
"""
from __future__ import annotations

import torch


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    out = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (out * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, scale: float | None = None,
               dtype=torch.float32) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return _normal(gen, (d_in, d_out), scale, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32) -> torch.Tensor:
    return _normal(gen, (vocab, d), 0.02, dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0) -> torch.Tensor:
    """x [..., S, D] with positions i32[S] or [B, S]; rotates the interleaved
    pairs (x[..., ::2], x[..., 1::2])."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions.float()[..., :, None] * inv[None, :]  # [.., S, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    # broadcast over head dims: x is [B, H, S, D]; ang is [S, D/2] or [B, S, D/2]
    while cos.dim() < x.dim():
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)
    return out.to(x.dtype)
