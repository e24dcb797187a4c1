"""GQA attention block: full-sequence forward, prefill (cache fill), decode,
and the encoder-decoder's bidirectional and cross attention.

Prefill, forward, encoder and cross attention run the hand-written flash
kernel for CUDA tensors (``causal=False`` for the encoder and the
cross-attention, whose Sq may be 1 against Skv frames) and the plain
``chunked_attention``/``qblock_attention`` for CPU tensors.  Unlike the JAX
package, the KV cache is written in place.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.flash_attention.ops import (
    chunked_attention,
    decode_attention,
    flash_attention,
    qblock_attention,
)
from .config import ModelConfig
from .layers import apply_rope, dense_init


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype) -> nn.ParameterDict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": dense_init(gen, d, hq * dh, dtype=dtype),
        "wk": dense_init(gen, d, hkv * dh, dtype=dtype),
        "wv": dense_init(gen, d, hkv * dh, dtype=dtype),
        "wo": dense_init(gen, hq * dh, d, scale=(hq * dh) ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                         dtype=dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in p.items()})


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig):
    """x [B, S, d] -> q [B, Hq, S, dh], k/v [B, Hkv, S, dh] (transposed views)."""
    B, S, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.view(B, S, cfg.n_heads, cfg.d_head).transpose(1, 2)
    k = k.view(B, S, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    v = v.view(B, S, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    return q, k, v


def _causal_attn(q, k, v, cfg: ModelConfig):
    if q.is_cuda:
        return flash_attention(q, k, v, causal=True, window=cfg.window)
    if cfg.attention_impl == "qblock":
        return qblock_attention(q, k, v, causal=True, window=cfg.window, chunk=cfg.attn_chunk,
                                q_block=cfg.attn_q_block)
    return chunked_attention(q, k, v, causal=True, window=cfg.window, chunk=cfg.attn_chunk)


def _full_attn(q, k, v, cfg: ModelConfig):
    """Attention without a mask: every query sees every key."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=False)
    return chunked_attention(q, k, v, causal=False, window=0, chunk=cfg.attn_chunk)


def _merge_heads(o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, _, S, _ = o.shape
    return o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.d_head)


def attention_train(p, x: torch.Tensor, cfg: ModelConfig, *, positions=None,
                    rope: bool = True) -> torch.Tensor:
    """Full-sequence causal (optionally windowed) attention, forward only."""
    S = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    if rope:
        pos = positions if positions is not None else torch.arange(S, device=x.device)
        q = apply_rope(q, pos, theta=cfg.rope_theta)
        k = apply_rope(k, pos, theta=cfg.rope_theta)
    return _merge_heads(_causal_attn(q, k, v, cfg), cfg) @ p["wo"]


def attention_bidir(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Encoder self-attention (whisper encoder): no mask, no rope."""
    q, k, v = _project_qkv(p, x, cfg)
    return _merge_heads(_full_attn(q, k, v, cfg), cfg) @ p["wo"]


def cross_attention(p, x: torch.Tensor, kv, cfg: ModelConfig) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (a ``[B, Hkv, T,
    dh]`` pair), no mask: x [B, S, d] with S the prompt or one decode token."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.view(B, S, cfg.n_heads, cfg.d_head).transpose(1, 2)
    k, v = kv
    return _merge_heads(_full_attn(q, k, v, cfg), cfg) @ p["wo"]


def encode_cross_kv(p, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder states' cross-attention K/V, each ``[B, Hkv, T, dh]``."""
    B, T, _ = enc_out.shape
    k, v = enc_out @ p["wk"], enc_out @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return (k.view(B, T, cfg.n_kv_heads, cfg.d_head).transpose(1, 2),
            v.view(B, T, cfg.n_kv_heads, cfg.d_head).transpose(1, 2))


# ------------------------------------------------------------- serving -----


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> dict:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(p, x: torch.Tensor, cfg: ModelConfig, cache: dict, *, start: int = 0,
                      rope: bool = True):
    """Run causal attention over a prompt chunk and write its K/V into
    ``cache`` at positions ``start ..`` in place.

    A rolling cache (no longer than the window, see ``attention_decode``)
    keeps position ``t`` in slot ``t % L``; a chunk longer than the buffer
    leaves its last ``L`` positions there, every one the next token's window
    needs.  (Where the chunk fits, the slots are the reference's.)"""
    S = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    if rope:
        pos = start + torch.arange(S, device=x.device)
        q = apply_rope(q, pos, theta=cfg.rope_theta)
        k = apply_rope(k, pos, theta=cfg.rope_theta)
    o = _causal_attn(q, k, v, cfg)
    L = cache["k"].shape[2]
    if cfg.window > 0 and L <= cfg.window and start + S > L:
        keep = min(S, L)
        slots = (start + S - keep + torch.arange(keep, device=x.device)) % L
        cache["k"][:, :, slots] = k[:, :, S - keep:]
        cache["v"][:, :, slots] = v[:, :, S - keep:]
    else:
        cache["k"][:, :, start:start + S] = k
        cache["v"][:, :, start:start + S] = v
    return _merge_heads(o, cfg) @ p["wo"], cache


def attention_decode(p, x_t: torch.Tensor, cfg: ModelConfig, cache: dict, kv_len: int, *,
                     rope: bool = True):
    """One token: write K/V at position ``kv_len`` (in place) and attend to
    the prefix.  x_t [B, 1, d]; kv_len the tokens already in the cache.

    If the cache buffer is no longer than the attention window, it is a
    *rolling* buffer: writes wrap modulo the buffer and every live entry is
    in the window.  Once the window is full, both kinds of cache attend to
    its keys in position order (the rolling buffer rotated, the full one
    sliced), so that the two give the same bits.
    """
    L = cache["k"].shape[2]
    rolling = cfg.window > 0 and L <= cfg.window
    q, k, v = _project_qkv(p, x_t, cfg)
    if rope:
        pos = torch.full((1,), kv_len, dtype=torch.int32, device=x_t.device)
        q = apply_rope(q, pos, theta=cfg.rope_theta)
        k = apply_rope(k, pos, theta=cfg.rope_theta)
    slot = kv_len % L if rolling else kv_len
    cache["k"][:, :, slot:slot + 1] = k
    cache["v"][:, :, slot:slot + 1] = v
    if rolling and kv_len + 1 >= L:   # every slot live: the oldest key is in slot + 1
        shift = -((slot + 1) % L)
        o = decode_attention(q, torch.roll(cache["k"], shift, dims=2),
                             torch.roll(cache["v"], shift, dims=2), kv_len=L)
    elif rolling:
        o = decode_attention(q, cache["k"], cache["v"], kv_len=kv_len + 1)
    elif cfg.window > 0 and kv_len + 1 >= cfg.window:   # the window's keys only
        lo = kv_len + 1 - cfg.window
        o = decode_attention(q, cache["k"][:, :, lo:kv_len + 1], cache["v"][:, :, lo:kv_len + 1],
                             kv_len=cfg.window)
    else:
        o = decode_attention(q, cache["k"], cache["v"], window=cfg.window, kv_len=kv_len + 1)
    return _merge_heads(o, cfg) @ p["wo"], cache
