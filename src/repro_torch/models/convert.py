"""Weights carried across from the JAX package.

``lm_params_from_numpy`` takes the pytree of ``repro.models`` ``init`` as
numpy arrays (``jax.tree.map(np.asarray, params)``) and builds the port's
``LM`` module from it, so both implementations run the same weights.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.types import resolve_device
from .config import ModelConfig
from .transformer import LM, Block, plan_segments


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array on ``device``.  bfloat16 arrays (``ml_dtypes.bfloat16``,
    which ``torch.from_numpy`` rejects) go through their 16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a, copy=True).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _param(a, device) -> nn.Parameter:
    return nn.Parameter(tensor_from_numpy(a, device), requires_grad=False)


def _block(tree: dict, kind: str, r: int, device) -> Block:
    """Repeat ``r`` of one stacked ``seg{si}/k{ki}`` block as a ``Block``."""
    parts = {name: nn.ParameterDict({k: _param(v[r], device) for k, v in leaf.items()})
             if isinstance(leaf, dict) else _param(leaf[r], device)
             for name, leaf in tree.items()}
    return Block(kind, **parts)


def lm_params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> LM:
    """The JAX parameter pytree (numpy leaves) as the port's ``LM``: every
    segment's stacked ``seg{si}/k{ki}`` layer axis becomes layers of the
    ``nn.ModuleList`` in the reference's scan order (segment, repeat, pattern
    slot)."""
    device = resolve_device(device)
    layers = [_block(tree[f"seg{si}"][f"k{ki}"], kind, r, device)
              for si, seg in enumerate(plan_segments(cfg)) for r in range(seg.repeats)
              for ki, kind in enumerate(seg.pattern)]
    head = None if cfg.tie_embeddings else _param(tree["lm_head"], device)
    return LM(_param(tree["embed"], device), layers, _param(tree["final_norm"], device), head)
