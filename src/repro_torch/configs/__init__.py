"""Architecture registry: ``get_config(arch)`` is the exact public
configuration, ``get_smoke(arch)`` a reduced one of the same family for CPU
tests.

The port serves the dense family.  The other architectures of the JAX
package's registry raise ``NotImplementedError`` naming the ROADMAP item
(Queue 1 item 16) that brings their blocks.
"""
from __future__ import annotations

from . import deepseek_7b, llama3_405b, nemotron_4_340b, qwen2_5_32b
from .shapes import SHAPES, ShapeSpec  # noqa: F401

_MODULES = {
    "qwen2.5-32b": qwen2_5_32b,
    "deepseek-7b": deepseek_7b,
    "llama3-405b": llama3_405b,
    "nemotron-4-340b": nemotron_4_340b,
}

_NOT_PORTED = {
    "mamba2-130m": "the SSM block (ROADMAP Queue 1 item 16: SSM)",
    "internvl2-26b": "the VLM patch splice (ROADMAP Queue 1 item 16: VLM)",
    "whisper-small": "the encoder-decoder (ROADMAP Queue 1 item 16: encdec)",
    "kimi-k2-1t-a32b": "the MoE block and moe_route (ROADMAP Queue 1 item 16: MoE)",
    "granite-moe-1b-a400m": "the MoE block and moe_route (ROADMAP Queue 1 item 16: MoE)",
    "recurrentgemma-2b": "the RG-LRU hybrid block (ROADMAP Queue 1 item 16: hybrid)",
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
