"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

The conv/mel audio frontend is a stub: ``frames`` arrive as precomputed
``[B, T, d_model]`` embeddings.  Encoder: bidirectional attention blocks.
Decoder: causal self-attention, cross-attention over the encoder states and
a GELU MLP, with learned positions (no rope).  Every block has LayerNorms
with a bias.

``loss_fn`` trains it: ``forward`` and ``encode`` run with autograd, and
under ``cfg.remat`` each decoder layer runs under ``torch.utils.checkpoint``,
as the JAX package wraps the decoder's scanned body in ``jax.checkpoint``.

The cache holds ``len``, the decoder's self K/V ``k``/``v`` ``[L, B, Hkv,
max_len, dh]`` and each layer's cross K/V ``cross_k``/``cross_v`` ``[L, B,
Hkv, n_frames, dh]``, which ``prefill`` computes once from the encoder
states; every entry is written in place.
"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.sharding import constrain_batch, embed_rows, gather_table
from .attention import (
    attention_bidir,
    attention_decode,
    attention_prefill,
    attention_train,
    cross_attention,
    encode_cross_kv,
    init_attention,
    init_kv_cache,
)
from .config import ModelConfig
from .layers import embed_init, layernorm
from .mlp import init_mlp, mlp_forward
from .moe import AUX_KEYS
from .transformer import Block, _generator, gold_logits, remat

POS_ROWS = 4096  # learned decoder positions; later positions reuse the last


class EncDec(nn.Module):
    """Parameters of the encoder-decoder; the functions below run it."""

    def __init__(self, embed: nn.Parameter, pos_dec: nn.Parameter, enc: list[Block],
                 dec: list[Block], enc_norm: nn.ParameterDict, dec_norm: nn.ParameterDict):
        super().__init__()
        self.embed, self.pos_dec = embed, pos_dec
        self.enc, self.dec = nn.ModuleList(enc), nn.ModuleList(dec)
        self.enc_norm, self.dec_norm = enc_norm, dec_norm


def _ln_init(d: int, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        "w": nn.Parameter(torch.ones((d,), dtype=dtype, device=device), requires_grad=False),
        "b": nn.Parameter(torch.zeros((d,), dtype=dtype, device=device), requires_grad=False)})


def _ln(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    return layernorm(x, p["w"], p["b"], eps=eps)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def init_params(rng, cfg: ModelConfig, device="cuda") -> EncDec:
    """Random weights with the JAX package's scales, drawn on ``device`` from
    ``rng`` (a seed or a ``torch.Generator``)."""
    gen = _generator(rng, device)
    dtype = getattr(torch, cfg.dtype)
    d, dev = cfg.d_model, gen.device
    enc = [Block("enc", ln1=_ln_init(d, dtype, dev), attn=init_attention(gen, cfg, dtype),
                 ln2=_ln_init(d, dtype, dev), mlp=init_mlp(gen, cfg, dtype=dtype))
           for _ in range(cfg.n_enc_layers)]
    dec = [Block("dec", ln1=_ln_init(d, dtype, dev), self_attn=init_attention(gen, cfg, dtype),
                 ln2=_ln_init(d, dtype, dev), cross_attn=init_attention(gen, cfg, dtype),
                 ln3=_ln_init(d, dtype, dev), mlp=init_mlp(gen, cfg, dtype=dtype))
           for _ in range(cfg.n_dec_layers)]
    return EncDec(_param(embed_init(gen, cfg.vocab_size, d, dtype)),
                  _param(embed_init(gen, POS_ROWS, d, dtype)), enc, dec,
                  _ln_init(d, dtype, dev), _ln_init(d, dtype, dev))


def encode(params: EncDec, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, T, d] (the stub frontend's output) -> encoder states."""
    x = frames.to(getattr(torch, cfg.dtype))
    for p in params.enc:
        x = constrain_batch(x + attention_bidir(p.attn, _ln(x, p.ln1, cfg.norm_eps), cfg))
        x = constrain_batch(x + mlp_forward(p.mlp, _ln(x, p.ln2, cfg.norm_eps), cfg))
    return _ln(x, params.enc_norm, cfg.norm_eps)


def _decoder_embed(params: EncDec, tokens: torch.Tensor, start: int) -> torch.Tensor:
    pos = (start + torch.arange(tokens.shape[1], device=tokens.device)).clamp(
        0, params.pos_dec.shape[0] - 1)
    return embed_rows(params.embed, tokens) + embed_rows(params.pos_dec, pos)


def _logits(params: EncDec, x: torch.Tensor) -> torch.Tensor:
    return (x @ gather_table(params.embed).T).float()


def _decoder_layer(p: Block, x: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig):
    x = constrain_batch(x + attention_train(p.self_attn, _ln(x, p.ln1, cfg.norm_eps), cfg,
                                            rope=False))
    kv = encode_cross_kv(p.cross_attn, enc, cfg)
    x = constrain_batch(x + cross_attention(p.cross_attn, _ln(x, p.ln2, cfg.norm_eps), kv, cfg))
    return constrain_batch(x + mlp_forward(p.mlp, _ln(x, p.ln3, cfg.norm_eps), cfg))


def forward(params: EncDec, cfg: ModelConfig, tokens: torch.Tensor, frames: torch.Tensor):
    """Teacher-forced: encode ``frames``, decode ``tokens`` -> (logits
    f32[B, S, V], aux), aux the MoE keys at zero."""
    enc = encode(params, cfg, frames)
    x = constrain_batch(_decoder_embed(params, tokens, 0))
    for p in params.dec:
        x = remat(_decoder_layer, cfg, p, x, enc, cfg)
    x = _ln(x, params.dec_norm, cfg.norm_eps)
    return _logits(params, x), {k: torch.zeros((), device=x.device) for k in AUX_KEYS}


def loss_fn(params: EncDec, cfg: ModelConfig, batch: dict):
    """Next-token cross-entropy of ``forward`` -> (loss, metrics), with a
    gradient."""
    logits, aux = forward(params, cfg, batch["tokens"], batch["frames"])
    targets = batch["tokens"][:, 1:].long()
    logits = logits[:, :-1]
    gold = gold_logits(logits, targets)
    loss = (torch.logsumexp(logits, dim=-1) - gold).mean()
    return loss, dict(aux, nll=loss)


# ---------------------------------------------------------------- serving ---


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> dict:
    """``len`` 0, zeros for the decoder's self K/V ``[L, B, Hkv, max_len,
    dh]`` and the cross K/V ``[L, B, Hkv, n_frames, dh]``, in the model's
    dtype."""
    dtype = getattr(torch, cfg.dtype)
    L = cfg.n_dec_layers
    self_c = init_kv_cache(cfg, batch, max_len, dtype, device)
    cross = (L, batch, cfg.n_kv_heads, cfg.n_frames, cfg.d_head)
    return {"len": 0,
            "k": self_c["k"][None].repeat(L, 1, 1, 1, 1),
            "v": self_c["v"][None].repeat(L, 1, 1, 1, 1),
            "cross_k": torch.zeros(cross, dtype=dtype, device=device),
            "cross_v": torch.zeros(cross, dtype=dtype, device=device)}


@torch.no_grad()
def prefill(params: EncDec, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
            frames: torch.Tensor):
    """Encode ``frames [B, n_frames, d]``, write each layer's cross K/V and
    the prompt's self K/V into ``cache``, return last-position logits."""
    if frames.shape[1] != cache["cross_k"].shape[3]:
        raise ValueError(f"frames hold {frames.shape[1]} positions, the cache "
                         f"{cache['cross_k'].shape[3]} (cfg.n_frames)")
    enc = encode(params, cfg, frames)
    x = _decoder_embed(params, tokens, 0)
    for i, p in enumerate(params.dec):
        h, _ = attention_prefill(p.self_attn, _ln(x, p.ln1, cfg.norm_eps), cfg,
                                 {"k": cache["k"][i], "v": cache["v"][i]}, start=0, rope=False)
        x = x + h
        ck, cv = encode_cross_kv(p.cross_attn, enc, cfg)
        cache["cross_k"][i].copy_(ck)
        cache["cross_v"][i].copy_(cv)
        x = x + cross_attention(p.cross_attn, _ln(x, p.ln2, cfg.norm_eps), (ck, cv), cfg)
        x = x + mlp_forward(p.mlp, _ln(x, p.ln3, cfg.norm_eps), cfg)
    x = _ln(x, params.dec_norm, cfg.norm_eps)
    cache["len"] = tokens.shape[1]
    return _logits(params, x[:, -1:]), cache


@torch.no_grad()
def decode_step(params: EncDec, cfg: ModelConfig, token: torch.Tensor, cache: dict):
    """token i32[B, 1] -> (logits f32[B, 1, V], the cache updated in place);
    the cross-attention is one query against the ``n_frames`` cross K/V."""
    kv_len = cache["len"]
    x = _decoder_embed(params, token, kv_len)
    for i, p in enumerate(params.dec):
        h, _ = attention_decode(p.self_attn, _ln(x, p.ln1, cfg.norm_eps), cfg,
                                {"k": cache["k"][i], "v": cache["v"][i]}, kv_len, rope=False)
        x = x + h
        x = x + cross_attention(p.cross_attn, _ln(x, p.ln2, cfg.norm_eps),
                                (cache["cross_k"][i], cache["cross_v"][i]), cfg)
        x = x + mlp_forward(p.mlp, _ln(x, p.ln3, cfg.norm_eps), cfg)
    x = _ln(x, params.dec_norm, cfg.norm_eps)
    cache["len"] = kv_len + 1
    return _logits(params, x), cache
