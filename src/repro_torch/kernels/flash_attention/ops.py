"""Attention entry points.

``flash_attention`` runs the Hopper kernel for CUDA tensors and its plain
version ``attention_ref`` for CPU tensors; with grad mode on and an input
that requires grad it runs them as ``_FlashAttention``, whose backward is the
Hopper backward kernel for CUDA tensors (``flash_attention_backward``) and
its plain version ``attention_bwd_ref`` for CPU tensors.  ``chunked_attention`` and
``qblock_attention`` are the same online-softmax math in plain PyTorch, over
KV chunks (and q blocks with tile skipping); the models run them on the CPU.
``decode_attention`` is the one-token step against a KV cache.

The forward and the backward are the custom ops ``repro_torch::flash_fwd``
and ``repro_torch::flash_bwd``: a CUDA implementation that launches the
kernel, a CPU one that is the plain version, a fake one for meta and fake
tensors, and a FLOP formula (``flash_flops``) that
``torch.utils.flop_counter`` reads, so a counter sees the kernel's work on
any device.  Registering them builds nothing: the library is built at the
first launch.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from .flash_attention_bwd_cuda import flash_attention_backward_cuda
from .flash_attention_cuda import flash_attention_cuda
from .ref import _acc_dtype, attention_bwd_ref, attention_ref


def attention_live_pairs(S: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the work the data needs."""
    pos = np.arange(S, dtype=np.int64) + (Skv - S)
    hi = np.minimum(pos, Skv - 1) if causal else np.full(S, Skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_flops(q_shape, k_shape, causal: bool, window: int, backward: bool = False) -> int:
    """The flash kernel's FLOPs: ``QK^T`` and ``PV`` over the live pairs, 2
    a multiply-add, ``4 B Hq D pairs``; the backward recomputes ``S`` and
    forms ``dP``, ``dQ``, ``dK`` and ``dV``, 2.5 times that."""
    B, Hq, S, D = q_shape
    fwd = 4 * B * Hq * D * attention_live_pairs(S, k_shape[2], causal, window)
    return fwd * 5 // 2 if backward else fwd


_lib = torch.library.Library("repro_torch", "FRAGMENT")
_lib.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, int window, float? scale, "
            "bool return_lse) -> (Tensor, Tensor)")
_lib.define("flash_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor do, Tensor lse, "
            "bool causal, int window, float? scale) -> (Tensor, Tensor, Tensor)")


def _no_lse(q):
    """The log-sum-exp output when none is asked for: ``[B, Hq, 0]``."""
    return q.new_empty((*q.shape[:2], 0), dtype=torch.float32)


@torch.library.impl(_lib, "flash_fwd", "CUDA")
def _flash_fwd_cuda(q, k, v, causal, window, scale, return_lse):
    out = flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale,
                               return_lse=return_lse)
    return out if return_lse else (out, _no_lse(q))


@torch.library.impl(_lib, "flash_fwd", "CPU")
def _flash_fwd_cpu(q, k, v, causal, window, scale, return_lse):
    out = attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                        return_lse=return_lse)
    return out if return_lse else (out, _no_lse(q))


@torch.library.register_fake("repro_torch::flash_fwd", lib=_lib)
def _flash_fwd_fake(q, k, v, causal, window, scale, return_lse):
    B, Hq, S, D = q.shape
    lse = q.new_empty((B, Hq, S), dtype=_acc_dtype(q)) if return_lse else _no_lse(q)
    return torch.empty_like(q, memory_format=torch.contiguous_format), lse


@torch.library.impl(_lib, "flash_bwd", "CUDA")
def _flash_bwd_cuda(q, k, v, o, do, lse, causal, window, scale):
    return flash_attention_backward_cuda(q, k, v, o, do, lse, causal=causal, window=window,
                                         scale=scale)


@torch.library.impl(_lib, "flash_bwd", "CPU")
def _flash_bwd_cpu(q, k, v, o, do, lse, causal, window, scale):
    return attention_bwd_ref(q, k, v, o, do, causal=causal, window=window, scale=scale, lse=lse)


@torch.library.register_fake("repro_torch::flash_bwd", lib=_lib)
def _flash_bwd_fake(q, k, v, o, do, lse, causal, window, scale):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q, k, v))


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_fwd_flop(q, k, v, causal, window, *args, out_shape=None, **kwargs) -> int:
    return flash_flops(q, k, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _flash_bwd_flop(q, k, v, o, do, lse, causal, window, *args, out_shape=None, **kwargs) -> int:
    return flash_flops(q, k, causal, window, backward=True)


def _forward(q, k, v, causal, window, scale, return_lse=False):
    o, lse = torch.ops.repro_torch.flash_fwd(q, k, v, causal, window, scale, return_lse)
    return (o, lse) if return_lse else o


def flash_attention_backward(q, k, v, o, do, lse, *, causal=True, window=0, scale=None):
    """``(dq, dk, dv)`` of ``o, lse = flash_attention(q, k, v, ...)`` (the
    forward's output and log-sum-exp) given ``do``: the Hopper backward
    kernel for CUDA tensors, its plain version for CPU tensors."""
    return torch.ops.repro_torch.flash_bwd(q, k, v, o, do, lse, causal, window, scale)


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
        if hasattr(do, "redistribute") and do.placements != o.placements:
            # on a mesh: the output's gradient split as the output is (its
            # heads), so that the kernel runs on each rank's own heads
            do = do.redistribute(o.device_mesh, o.placements)
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
    ``window`` restricts to the last ``window`` live positions.  A cache
    whose positions are split over a mesh dimension (``DTensor``s placed by
    ``cache_shardings``) takes ``_decode_attention_split``.
    """
    if _positions_split(k) is not None:
        return _decode_attention_split(q, k, v, window=window, kv_len=kv_len, scale=scale)
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


def _positions_split(t) -> int | None:
    """The mesh dimension a ``DTensor`` cache's positions (dim 2) are split
    over, or None (a plain tensor, or positions whole)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return None
    return next((i for i, pl in enumerate(t.placements) if pl.is_shard(2)), None)


def _decode_attention_split(q, k, v, *, window, kv_len, scale):
    """``decode_attention`` against a cache whose positions are split over a
    mesh dimension, without gathering it (flash-decoding's split, the
    partition XLA gives the same softmax over a split axis): each rank
    attends to its own positions in f32 (each row's max, sum and weighted
    values), and the ranks' parts are combined by an all-reduce of the max
    and two of the sums over that dimension.  The queries and the output
    keep their batch split and are whole over that dimension."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = k.device_mesh
    m_dim = _positions_split(k)
    cache_pl = list(k.placements)
    act_pl = [pl if pl.is_shard(0) else Replicate() for pl in cache_pl]
    act_pl[m_dim] = Replicate()
    group = (mesh, m_dim)

    def attend(ql, kc, vc):
        D = ql.shape[-1]
        G = ql.shape[1] // kc.shape[1]
        Lr = kc.shape[2]
        scale_ = scale if scale is not None else D ** -0.5
        s = torch.einsum("bhsd,bhtd->bhst", ql.float() * scale_,
                         kc.repeat_interleave(G, dim=1).float())
        if kv_len is not None:
            pos = mesh.get_local_rank(m_dim) * Lr + torch.arange(Lr, device=ql.device)
            kl = torch.as_tensor(kv_len, device=ql.device).reshape(-1, 1, 1, 1)
            live = pos < kl
            if window > 0:
                live &= pos >= kl - window
            s = s.masked_fill(~live, float("-inf"))
        m = funcol.all_reduce(s.amax(-1, keepdim=True), "max", group)
        pr = torch.exp(s - m)
        den = funcol.all_reduce(pr.sum(-1, keepdim=True), "sum", group)
        acc = funcol.all_reduce(torch.einsum("bhst,bhtd->bhsd", pr,
                                             vc.repeat_interleave(G, dim=1).float()), "sum", group)
        return (acc / den).to(ql.dtype)

    return local_map(attend, out_placements=act_pl, in_placements=(act_pl, cache_pl, cache_pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)
