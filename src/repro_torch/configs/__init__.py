"""Architecture registry: ``get_config(arch)`` is the exact public
configuration, ``get_smoke(arch)`` a reduced one of the same family for CPU
tests.  Every architecture of the JAX package's registry is served: the
dense, MoE, SSM, hybrid, encoder-decoder (whisper) and VLM families.  Each
module also exports PLANS ({shape: CellPlan}) and SKIPS ({shape: reason}).
"""
from __future__ import annotations

from . import (
    deepseek_7b,
    granite_moe_1b_a400m,
    internvl2_26b,
    kimi_k2_1t_a32b,
    llama3_405b,
    mamba2_130m,
    nemotron_4_340b,
    qwen2_5_32b,
    recurrentgemma_2b,
    whisper_small,
)
from .shapes import SHAPES, CellPlan, ShapeSpec  # noqa: F401

_MODULES = {
    "mamba2-130m": mamba2_130m,
    "qwen2.5-32b": qwen2_5_32b,
    "deepseek-7b": deepseek_7b,
    "llama3-405b": llama3_405b,
    "nemotron-4-340b": nemotron_4_340b,
    "internvl2-26b": internvl2_26b,
    "whisper-small": whisper_small,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "recurrentgemma-2b": recurrentgemma_2b,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str):
    return _MODULES[arch].CONFIG


def get_smoke(arch: str):
    return _MODULES[arch].SMOKE


def get_plan(arch: str, shape: str) -> CellPlan:
    return _MODULES[arch].PLANS.get(shape, CellPlan())


def get_skips(arch: str) -> dict[str, str]:
    return dict(_MODULES[arch].SKIPS)


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) cells minus documented skips."""
    cells = []
    for arch, mod in _MODULES.items():
        for shape in SHAPES:
            if shape not in mod.SKIPS:
                cells.append((arch, shape))
    return cells
