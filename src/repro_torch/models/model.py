"""Model facade: one API over the ported architecture families.

    m = build_model(cfg)                 # device="cuda" unless told otherwise
    params = m.init(seed)
    logits, aux = m.forward(params, batch)
    cache = m.init_cache(batch_size, max_len)
    logits, cache = m.prefill(params, batch, cache)
    logits, cache = m.decode(params, token, cache)

``batch`` is a dict holding ``tokens [B, S]``.  The port serves the dense,
MoE, SSM and hybrid families; the encoder-decoder (whisper) and VLM
families raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from torch import nn

from ..core.types import resolve_device
from . import transformer
from .config import ModelConfig


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode: Callable


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    transformer.plan_segments(cfg)  # raises for the families not ported yet
    device = resolve_device(device)
    return Model(
        cfg=cfg,
        init=lambda rng: transformer.init_params(rng, cfg, device),
        forward=lambda p, b: transformer.forward(p, cfg, b["tokens"]),
        init_cache=lambda bs, ml: transformer.init_cache(cfg, bs, ml, device),
        prefill=lambda p, b, c: transformer.prefill(p, cfg, b["tokens"], c),
        decode=lambda p, tok, c: transformer.decode_step(p, cfg, tok, c),
    )


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
