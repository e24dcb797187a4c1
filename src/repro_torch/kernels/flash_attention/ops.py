"""Attention entry points.

``flash_attention`` runs the Hopper kernel for CUDA tensors and its plain
version ``attention_ref`` for CPU tensors; with grad mode on and an input
that requires grad it runs them as ``_FlashAttention``, whose backward is the
Hopper backward kernel for CUDA tensors (``flash_attention_backward``) and
its plain version ``attention_bwd_ref`` for CPU tensors.  ``chunked_attention`` and
``qblock_attention`` are the same online-softmax math in plain PyTorch, over
KV chunks (and q blocks with tile skipping); the models run them on the CPU.
``decode_attention`` is the one-token step against a KV cache.
"""
from __future__ import annotations

import torch

from .flash_attention_bwd_cuda import flash_attention_backward_cuda
from .flash_attention_cuda import flash_attention_cuda
from .ref import attention_bwd_ref, attention_ref


def _forward(q, k, v, causal, window, scale, return_lse=False):
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale,
                                    return_lse=return_lse)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                         return_lse=return_lse)


def flash_attention_backward(q, k, v, o, do, lse, *, causal=True, window=0, scale=None):
    """``(dq, dk, dv)`` of ``o, lse = flash_attention(q, k, v, ...)`` (the
    forward's output and log-sum-exp) given ``do``: the Hopper backward
    kernel for CUDA tensors, its plain version for CPU tensors."""
    if q.is_cuda:
        return flash_attention_backward_cuda(q, k, v, o, do, lse, causal=causal, window=window,
                                             scale=scale)
    return attention_bwd_ref(q, k, v, o, do, causal=causal, window=window, scale=scale, lse=lse)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, which also writes each row's log-sum-exp, and its
    backward kernel.  Saves q, k, v, the output and the log-sum-exp; the
    backward takes each row's softmax from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = _forward(q, k, v, causal, window, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.opts
        dq, dk, dv = flash_attention_backward(q, k, v, o, do, lse, causal=causal, window=window,
                                              scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """Causal / sliding-window GQA attention (see ref.py for semantics): the
    Hopper kernel for CUDA tensors, the plain version for CPU tensors.  With
    grad mode on and an input that requires grad, the backward kernel (or
    its plain version) gives the gradient; otherwise nothing is saved."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale)


def _online_softmax_step(carry, qf, kci, vci, mask, G):
    """One KV chunk of the online softmax: ``carry`` is (m, l, acc) in f32."""
    m, l, acc = carry
    kg = kci.repeat_interleave(G, dim=1).float()
    vg = vci.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhsd,bhtd->bhst", qf, kg)
    s = s.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new).masked_fill(~mask, 0.0)
    alpha = torch.exp(m - m_new)
    return (m_new, l * alpha + p.sum(-1, keepdim=True),
            acc * alpha + torch.einsum("bhst,bhtd->bhsd", p, vg))


def _kv_mask(q_pos, kv_pos, causal, window):
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    return mask


def chunked_attention(q, k, v, *, causal=True, window=0, scale=None, chunk=512):
    """Online-softmax attention over KV chunks of ``chunk`` positions.

    q [B,Hq,S,D], k/v [B,Hkv,Skv,D] (Skv >= S, q right-aligned).  Peak live
    logits are [B,Hq,S,chunk], bounded whatever Skv is.
    """
    B, Hq, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale_ = scale if scale is not None else D ** -0.5
    qf = q.float() * scale_
    q_pos = torch.arange(S, device=q.device) + (Skv - S)
    carry = (torch.full((B, Hq, S, 1), -1e30, device=q.device),
             torch.zeros((B, Hq, S, 1), device=q.device),
             torch.zeros((B, Hq, S, D), device=q.device))
    for c0 in range(0, Skv, chunk):
        kv_pos = torch.arange(c0, min(c0 + chunk, Skv), device=q.device)
        mask = _kv_mask(q_pos, kv_pos, causal, window)
        carry = _online_softmax_step(carry, qf, k[:, :, c0:c0 + chunk], v[:, :, c0:c0 + chunk],
                                     mask, G)
    _, l, acc = carry
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def qblock_attention(q, k, v, *, causal=True, window=0, scale=None, chunk=512, q_block=1024):
    """Two-level flash schedule: an outer loop over q blocks, an inner
    online-softmax loop over KV chunks, skipping chunks wholly in the future
    (causal) or behind the window."""
    B, Hq, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale_ = scale if scale is not None else D ** -0.5
    nk = -(-Skv // chunk)
    off = Skv - S  # q right-aligned
    tiles = []
    for q0 in range(0, S, q_block):
        q_blk = q[:, :, q0:q0 + q_block]
        rows = q_blk.shape[2]
        q_lo = q0 + off
        q_pos = q_lo + torch.arange(q_block, device=q.device)[:rows]
        qf = q_blk.float() * scale_
        carry = (torch.full((B, Hq, rows, 1), -1e30, device=q.device),
                 torch.zeros((B, Hq, rows, 1), device=q.device),
                 torch.zeros((B, Hq, rows, D), device=q.device))
        q_hi = q_lo + q_block - 1
        ik_hi = min(q_hi // chunk + 1, nk) if causal else nk
        ik_lo = max((q_lo - window + 1) // chunk, 0) if window > 0 else 0
        for ik in range(ik_lo, ik_hi):
            c0 = ik * chunk
            kv_pos = torch.arange(c0, min(c0 + chunk, Skv), device=q.device)
            mask = _kv_mask(q_pos, kv_pos, causal, window)
            carry = _online_softmax_step(carry, qf, k[:, :, c0:c0 + chunk],
                                         v[:, :, c0:c0 + chunk], mask, G)
        _, l, acc = carry
        tiles.append((acc / l.clamp_min(1e-30)).to(q.dtype))
    return torch.cat(tiles, dim=2)


def decode_attention(q, k, v, *, window=0, kv_len=None, scale=None):
    """Single-token decode: q [B,Hq,1,D] against a [B,Hkv,Skv,D] cache.

    ``kv_len`` (i32[B] or scalar) masks the still-empty tail of the cache;
    ``window`` restricts to the last ``window`` live positions.
    """
    _, Hq, _, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale_ = scale if scale is not None else D ** -0.5
    kg = k.repeat_interleave(G, dim=1).float()
    vg = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhsd,bhtd->bhst", q.float() * scale_, kg)  # [B,Hq,1,Skv]
    if kv_len is not None:
        pos = torch.arange(Skv, device=q.device)[None, None, None, :]
        kl = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1, 1, 1)
        live = pos < kl
        if window > 0:
            live &= pos >= kl - window
        s = s.masked_fill(~live, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vg).to(q.dtype)
