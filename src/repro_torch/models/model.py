"""Model facade: one API over every architecture family.

    m = build_model(cfg)                 # device="cuda" unless told otherwise
    params = m.init(seed)
    logits, aux = m.forward(params, batch)
    loss, metrics = m.loss(params, batch)     # differentiable: see train/
    cache = m.init_cache(batch_size, max_len)
    logits, cache = m.prefill(params, batch, cache)
    logits, cache = m.decode(params, token, cache)

``batch`` is a dict: ``tokens [B, S]`` always; ``frames [B, T, d]`` for the
encoder-decoder (the audio stub's frame embeddings, T = ``cfg.n_frames``);
``patch_embeds [B, P, d]`` for the VLM (the vision stub's output, spliced
over the first P positions; optional).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from torch import nn

from ..core.types import resolve_device
from . import encdec, transformer
from .config import ModelConfig


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss: Callable
    init_cache: Callable
    prefill: Callable
    decode: Callable


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    device = resolve_device(device)
    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            init=lambda rng: encdec.init_params(rng, cfg, device),
            forward=lambda p, b: encdec.forward(p, cfg, b["tokens"], b["frames"]),
            loss=lambda p, b: encdec.loss_fn(p, cfg, b),
            init_cache=lambda bs, ml: encdec.init_cache(cfg, bs, ml, device),
            prefill=lambda p, b, c: encdec.prefill(p, cfg, b["tokens"], c, b["frames"]),
            decode=lambda p, tok, c: encdec.decode_step(p, cfg, tok, c),
        )
    transformer.plan_segments(cfg)  # raises for an unknown family
    return Model(
        cfg=cfg,
        init=lambda rng: transformer.init_params(rng, cfg, device),
        forward=lambda p, b: transformer.forward(p, cfg, b["tokens"], b.get("patch_embeds")),
        loss=lambda p, b: transformer.loss_fn(p, cfg, b),
        init_cache=lambda bs, ml: transformer.init_cache(cfg, bs, ml, device),
        prefill=lambda p, b, c: transformer.prefill(p, cfg, b["tokens"], c,
                                                    b.get("patch_embeds")),
        decode=lambda p, tok, c: transformer.decode_step(p, cfg, tok, c),
    )


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
