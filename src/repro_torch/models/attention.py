"""GQA attention block: full-sequence forward, prefill (cache fill), decode,
and the encoder-decoder's bidirectional and cross attention.

Prefill, forward, encoder and cross attention run the hand-written flash
kernel for CUDA tensors (``causal=False`` for the encoder and the
cross-attention, whose Sq may be 1 against Skv frames) and the plain
``chunked_attention``/``qblock_attention`` for CPU tensors.  Meta tensors
take the kernel's custom op too, so a traced step counts the kernel's work.
Unlike the JAX package, the KV cache is written in place.

On a mesh (``DTensor`` activations, heads split over 'model') a K/V
projection whose heads do not split evenly over 'model' is gathered before
its heads are formed, and GQA's K/V heads are repeated up to the query
heads where only those split evenly, so that the kernel runs on each rank's
own heads instead of every rank running all of them.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.flash_attention.ops import (
    _positions_split,
    chunked_attention,
    decode_attention,
    flash_attention,
    qblock_attention,
)
from ..parallel.sharding import is_dtensor
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
    q = _heads(q, B, S, cfg.n_heads, cfg.d_head)
    k = _heads(k, B, S, cfg.n_kv_heads, cfg.d_head)
    v = _heads(v, B, S, cfg.n_kv_heads, cfg.d_head)
    return q, k, v


def _split_ways(t, dim: int) -> int:
    """How many ways a ``DTensor`` is split on ``dim`` (1 for a plain tensor)."""
    if not is_dtensor(t):
        return 1
    n = 1
    for size, pl in zip(t.device_mesh.shape, t.placements):
        if pl.is_shard(dim):
            n *= size
    return n


def _heads(x: torch.Tensor, B: int, S: int, H: int, dh: int) -> torch.Tensor:
    """``[B, S, H * dh]`` -> ``[B, H, S, dh]`` (a transposed view).  A
    ``DTensor`` split on its last dimension other than by whole heads is
    gathered there first."""
    ways = _split_ways(x, x.dim() - 1)
    if ways > 1 and H % ways:
        from torch.distributed.tensor import Replicate

        x = x.redistribute(x.device_mesh, [Replicate() if pl.is_shard(x.dim() - 1) else pl
                                           for pl in x.placements])
    return x.view(B, S, H, dh).transpose(1, 2)


def _kv_heads_like(q, k, v):
    """On a mesh: where the query heads are split over 'model' and the K/V
    heads cannot be, each K/V head repeated for its query heads and split
    as the queries are (the same attention, without GQA's sharing)."""
    ways = _split_ways(q, 1)
    if ways == 1 or k.shape[1] % ways == 0 or _split_ways(k, 1) == ways:
        return k, v
    B, Hkv, Skv, dh = k.shape
    G = q.shape[1] // Hkv

    def rep(t):
        t = t[:, :, None].expand(B, Hkv, G, Skv, dh).reshape(B, Hkv * G, Skv, dh)
        return t.redistribute(q.device_mesh, q.placements)
    return rep(k), rep(v)


def _kernel_path(q) -> bool:
    """The flash kernel's op: on the card, and on meta tensors (a trace);
    a ``DTensor`` by its shards' device."""
    local = q.to_local() if is_dtensor(q) else q
    return local.device.type in ("cuda", "meta")


def _causal_attn(q, k, v, cfg: ModelConfig):
    if _kernel_path(q):
        k, v = _kv_heads_like(q, k, v)
        return flash_attention(q, k, v, causal=True, window=cfg.window)
    if cfg.attention_impl == "qblock":
        return qblock_attention(q, k, v, causal=True, window=cfg.window, chunk=cfg.attn_chunk,
                                q_block=cfg.attn_q_block)
    return chunked_attention(q, k, v, causal=True, window=cfg.window, chunk=cfg.attn_chunk)


def _full_attn(q, k, v, cfg: ModelConfig):
    """Attention without a mask: every query sees every key."""
    if _kernel_path(q):
        k, v = _kv_heads_like(q, k, v)
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
    q = _heads(q, B, S, cfg.n_heads, cfg.d_head)
    k, v = kv
    return _merge_heads(_full_attn(q, k, v, cfg), cfg) @ p["wo"]


def encode_cross_kv(p, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder states' cross-attention K/V, each ``[B, Hkv, T, dh]``."""
    B, T, _ = enc_out.shape
    k, v = enc_out @ p["wk"], enc_out @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return (_heads(k, B, T, cfg.n_kv_heads, cfg.d_head),
            _heads(v, B, T, cfg.n_kv_heads, cfg.d_head))


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
        if _positions_split(cache["k"]) is not None:
            for name, t in (("k", k), ("v", v)):
                _write_positions(cache[name], t[:, :, S - keep:], (start + S - keep) % L)
        else:
            slots = (start + S - keep + torch.arange(keep, device=x.device)) % L
            cache["k"][:, :, slots] = k[:, :, S - keep:]
            cache["v"][:, :, slots] = v[:, :, S - keep:]
    else:
        _write_positions(cache["k"], k, start)
        _write_positions(cache["v"], v, start)
    return _merge_heads(o, cfg) @ p["wo"], cache


def _write_positions(buf: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """``buf[:, :, start:start + n] = new`` in place (n = new's positions).
    A cache whose positions are split over a mesh dimension
    (``cache_shardings``) takes each rank's part of the range into its own
    shard, the part past the end wrapped to the front (a rolling cache):
    a ``DTensor``'s slice of a split dimension is a gathered copy, and a
    write into it would be lost.  Each rank gathers ``new`` whole over that
    dimension, or, where ``new`` fills the whole cache, only its own
    positions (an all-to-all from a head split)."""
    m_dim = _positions_split(buf)
    if m_dim is None:
        buf[:, :, start:start + new.shape[2]] = new
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = buf.device_mesh
    target = [Replicate() if pl.is_shard(2) else pl for pl in buf.placements]
    local = buf.to_local()
    if start == 0 and new.shape[2] == buf.shape[2]:
        target[m_dim] = Shard(2)
        local.copy_(new.redistribute(mesh, target).to_local())
        return
    new = new.redistribute(mesh, target).to_local()
    n, L, Lr = new.shape[2], buf.shape[2], local.shape[2]
    lo = mesh.get_local_rank(m_dim) * Lr
    for a0 in (start, start - L):
        a, b = max(a0, lo), min(a0 + n, lo + Lr)
        if a < b:
            local[:, :, a - lo:b - lo] = new[:, :, a - a0:b - a0]


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
    _write_positions(cache["k"], k, slot)
    _write_positions(cache["v"], v, slot)
    if rolling and kv_len + 1 >= L:   # every slot live: the oldest key is in slot + 1
        shift = -((slot + 1) % L)
        o = decode_attention(q, torch.roll(cache["k"], shift, dims=2),
                             torch.roll(cache["v"], shift, dims=2), kv_len=L)
    elif rolling:
        o = decode_attention(q, cache["k"], cache["v"], kv_len=kv_len + 1)
    elif cfg.window > 0 and kv_len + 1 >= cfg.window and _positions_split(cache["k"]) is None:
        # the window's keys only (a split cache masks them: a slice of it is a gather)
        lo = kv_len + 1 - cfg.window
        o = decode_attention(q, cache["k"][:, :, lo:kv_len + 1], cache["v"][:, :, lo:kv_len + 1],
                             kv_len=cfg.window)
    else:
        o = decode_attention(q, cache["k"], cache["v"], window=cfg.window, kv_len=kv_len + 1)
    return _merge_heads(o, cfg) @ p["wo"], cache

