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


def _group(tree: dict, layer: int, device) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v[layer], device) for k, v in tree.items()})


def lm_params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> LM:
    """The JAX parameter pytree (numpy leaves) as the port's ``LM``: the
    stacked ``seg0/k0`` layer axis becomes the ``nn.ModuleList``."""
    device = resolve_device(device)
    (seg,) = plan_segments(cfg)
    stacked = tree["seg0"]["k0"]
    layers = [
        Block(_group(stacked["attn"], i, device), _group(stacked["mlp"], i, device),
              _param(stacked["ln1"][i], device), _param(stacked["ln2"][i], device))
        for i in range(seg.repeats)
    ]
    head = None if cfg.tie_embeddings else _param(tree["lm_head"], device)
    return LM(_param(tree["embed"], device), layers, _param(tree["final_norm"], device), head)
