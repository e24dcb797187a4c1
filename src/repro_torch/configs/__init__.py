"""Architecture registry: ``get_config(arch)`` is the exact public
configuration, ``get_smoke(arch)`` a reduced one of the same family for CPU
tests.

The port serves the dense, MoE, SSM and hybrid families.  The
encoder-decoder and VLM architectures of the JAX package's registry raise
``NotImplementedError`` naming the ROADMAP item (Queue 1 item 16) that brings
their blocks.
"""
from __future__ import annotations

from . import (
    deepseek_7b,
    granite_moe_1b_a400m,
    kimi_k2_1t_a32b,
    llama3_405b,
    mamba2_130m,
    nemotron_4_340b,
    qwen2_5_32b,
    recurrentgemma_2b,
)
from .shapes import SHAPES, ShapeSpec  # noqa: F401

_MODULES = {
    "mamba2-130m": mamba2_130m,
    "qwen2.5-32b": qwen2_5_32b,
    "deepseek-7b": deepseek_7b,
    "llama3-405b": llama3_405b,
    "nemotron-4-340b": nemotron_4_340b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "recurrentgemma-2b": recurrentgemma_2b,
}

_NOT_PORTED = {
    "internvl2-26b": "the VLM patch splice (ROADMAP Queue 1 item 16: VLM)",
    "whisper-small": "the encoder-decoder (ROADMAP Queue 1 item 16: encdec)",
}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"{arch} is not ported yet: it needs {_NOT_PORTED[arch]}")
    return _MODULES[arch]


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE
