"""Decoder-only LM stack: the dense family.

The JAX package stacks each segment's layer parameters and runs them with
``lax.scan``; here every layer is a ``Block`` module in an ``nn.ModuleList``
and runs in a Python loop.  The KV cache holds one ``[L, B, Hkv, max_len,
dh]`` tensor each for K and V (the JAX package's stacked layout), and each
layer writes its slice in place.  The MoE, SSM and hybrid families raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .attention import (
    attention_decode,
    attention_prefill,
    attention_train,
    init_attention,
    init_kv_cache,
)
from .config import ModelConfig
from .layers import embed_init, rmsnorm
from .mlp import init_mlp, mlp_forward


class Segment(NamedTuple):
    pattern: tuple  # block kinds, e.g. ("att",)
    repeats: int


def plan_segments(cfg: ModelConfig) -> list[Segment]:
    if cfg.family == "dense":
        return [Segment(("att",), cfg.n_layers)]
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 16); the port "
        "serves the dense family")


def _zeros(d: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros((d,), dtype=dtype, device=device), requires_grad=False)


class Block(nn.Module):
    """One ``"att"`` block: pre-norm attention and MLP, each with a residual."""

    def __init__(self, attn: nn.ParameterDict, mlp: nn.ParameterDict, ln1: nn.Parameter,
                 ln2: nn.Parameter):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class LM(nn.Module):
    """Parameters of the decoder stack; the functions below run it."""

    def __init__(self, embed: nn.Parameter, layers: list[Block], final_norm: nn.Parameter,
                 lm_head: nn.Parameter | None):
        super().__init__()
        self.embed, self.final_norm, self.lm_head = embed, final_norm, lm_head
        self.layers = nn.ModuleList(layers)


# ----------------------------------------------------------------- blocks ---


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype) -> Block:
    if kind != "att":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    return Block(init_attention(gen, cfg, dtype), init_mlp(gen, cfg, dtype=dtype),
                 _zeros(cfg.d_model, dtype, gen.device), _zeros(cfg.d_model, dtype, gen.device))


def block_train(p: Block, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = x + attention_train(p.attn, rmsnorm(x, p.ln1, eps=cfg.norm_eps), cfg)
    return x + mlp_forward(p.mlp, rmsnorm(x, p.ln2, eps=cfg.norm_eps), cfg)


def block_prefill(p: Block, x: torch.Tensor, cfg: ModelConfig, cache: dict, start: int):
    h, cache = attention_prefill(p.attn, rmsnorm(x, p.ln1, eps=cfg.norm_eps), cfg, cache,
                                 start=start)
    x = x + h
    return x + mlp_forward(p.mlp, rmsnorm(x, p.ln2, eps=cfg.norm_eps), cfg), cache


def block_decode(p: Block, x_t: torch.Tensor, cfg: ModelConfig, cache: dict, kv_len: int):
    h, cache = attention_decode(p.attn, rmsnorm(x_t, p.ln1, eps=cfg.norm_eps), cfg, cache, kv_len)
    x_t = x_t + h
    return x_t + mlp_forward(p.mlp, rmsnorm(x_t, p.ln2, eps=cfg.norm_eps), cfg), cache


# ------------------------------------------------------------------ model ---


def _generator(rng, device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(int(rng))


def init_params(rng, cfg: ModelConfig, device="cuda") -> LM:
    """Random weights with the JAX package's scales, drawn on ``device`` from
    ``rng`` (a seed or a ``torch.Generator``)."""
    gen = _generator(rng, device)
    dtype = getattr(torch, cfg.dtype)
    layers = [init_block(gen, cfg, kind, dtype)
              for seg in plan_segments(cfg) for _ in range(seg.repeats) for kind in seg.pattern]
    head = None if cfg.tie_embeddings else embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    return LM(
        nn.Parameter(embed_init(gen, cfg.vocab_size, cfg.d_model, dtype), requires_grad=False),
        layers, _zeros(cfg.d_model, dtype, gen.device),
        None if head is None else nn.Parameter(head, requires_grad=False),
    )


def _embed(params: LM, tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens]


def _logits(params: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = params.embed if cfg.tie_embeddings else params.lm_head
    return (x @ head.T).float()


def forward(params: LM, cfg: ModelConfig, tokens: torch.Tensor):
    """Teacher-forced full-sequence forward -> (logits f32[B,S,V], aux).
    ``aux`` holds the MoE losses, zero for the dense family."""
    x = _embed(params, tokens)
    for layer in params.layers:
        x = block_train(layer, x, cfg)
    x = rmsnorm(x, params.final_norm, eps=cfg.norm_eps)
    zero = torch.zeros((), device=x.device)
    return _logits(params, cfg, x), {"moe_lb_loss": zero, "moe_z_loss": zero,
                                     "moe_drop_frac": zero}


# ---------------------------------------------------------------- serving ---


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> dict:
    """``{"len": 0, "k": [L,B,Hkv,max_len,dh], "v": same}`` in the model's dtype."""
    n_layers = sum(seg.repeats * len(seg.pattern) for seg in plan_segments(cfg))
    one = init_kv_cache(cfg, batch, max_len, getattr(torch, cfg.dtype), device)
    return {"len": 0, **{name: t[None].repeat(n_layers, 1, 1, 1, 1) for name, t in one.items()}}


def _layer_cache(cache: dict, i: int) -> dict:
    return {"k": cache["k"][i], "v": cache["v"][i]}  # views: layers write in place


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, tokens: torch.Tensor, cache: dict):
    """Consume the prompt, fill the cache, return last-position logits."""
    x = _embed(params, tokens)
    for i, layer in enumerate(params.layers):
        x, _ = block_prefill(layer, x, cfg, _layer_cache(cache, i), 0)
    x = rmsnorm(x, params.final_norm, eps=cfg.norm_eps)
    cache["len"] = tokens.shape[1]
    return _logits(params, cfg, x[:, -1:]), cache


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, token: torch.Tensor, cache: dict):
    """token i32[B, 1] -> (logits f32[B, 1, V], the cache updated in place)."""
    x = _embed(params, token)
    kv_len = cache["len"]
    for i, layer in enumerate(params.layers):
        x, _ = block_decode(layer, x, cfg, _layer_cache(cache, i), kv_len)
    x = rmsnorm(x, params.final_norm, eps=cfg.norm_eps)
    cache["len"] = kv_len + 1
    return _logits(params, cfg, x), cache
