"""Shared primitive layers: norms (RMS and layer), rotary embeddings, linear init.

Weights keep the JAX package's layout (``x @ w`` with ``w [d_in, d_out]``),
so they carry across unchanged.  Initial weights are drawn from an explicit
``torch.Generator`` with the reference's scales; the stream is not JAX's.
"""
from __future__ import annotations

import torch


class MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: shapes and dtypes
    without storage, for tracing a full-size model (``build_model(cfg,
    device="meta")``)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


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


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with weight and bias, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


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


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (``F.softplus``
    returns ``x`` itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal 1-D convolution.  x [B, L, C], w [K, C] -> [B, L, C],
    summed in f32 (K shifted multiply-adds) and cast back to x's dtype."""
    K = w.shape[0]
    L = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, K - 1, 0)).float()
    wf = w.float()
    out = xp[:, 0:L] * wf[0]
    for j in range(1, K):
        out = out + xp[:, j:j + L] * wf[j]
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def causal_conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor | None = None):
    """One decode step.  x_t [B, C]; conv_state [B, K-1, C] (oldest first) ->
    (out [B, C], the next state [B, K-1, C])."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # [B, K, C]
    out = torch.einsum("bkc,kc->bc", window.float(), w.float())
    if b is not None:
        out = out + b.float()
    return out.to(x_t.dtype), window[:, 1:]
