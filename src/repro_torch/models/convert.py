"""Weights carried across from the JAX package.

``lm_params_from_numpy`` (decoder-only families, the VLM included) and
``encdec_params_from_numpy`` take the pytree of ``repro.models`` ``init`` as
numpy arrays (``jax.tree.map(np.asarray, params)``) and build the port's
``LM`` or ``EncDec`` module from it, so both implementations run the same
weights.  ``params_from_numpy`` picks by the config's family, and
``params_to_numpy`` is its inverse (of the parameters, or of any tensors
keyed by parameter name: gradients, optimizer moments).  ``param_paths`` says
where each of the port's parameters sits in the JAX tree.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.types import resolve_device
from .config import ModelConfig
from .encdec import EncDec
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


def encdec_params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> EncDec:
    """The JAX encoder-decoder pytree (numpy leaves) as the port's
    ``EncDec``: the stacked ``enc``/``dec`` layer axes become the layers of
    two ``nn.ModuleList``s."""
    device = resolve_device(device)

    def norm(p) -> nn.ParameterDict:
        return nn.ParameterDict({k: _param(v, device) for k, v in p.items()})

    return EncDec(
        _param(tree["embed"], device), _param(tree["pos_dec"], device),
        [_block(tree["enc"], "enc", r, device) for r in range(cfg.n_enc_layers)],
        [_block(tree["dec"], "dec", r, device) for r in range(cfg.n_dec_layers)],
        norm(tree["enc_norm"]), norm(tree["dec_norm"]))


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda"):
    """``encdec_params_from_numpy`` for the encoder-decoder, else
    ``lm_params_from_numpy``."""
    if cfg.family == "encdec":
        return encdec_params_from_numpy(tree, cfg, device)
    return lm_params_from_numpy(tree, cfg, device)


def param_paths(params: nn.Module, cfg: ModelConfig) -> dict:
    """``{port parameter name: (path in the JAX tree, layer)}``: ``layer`` is
    the parameter's row on the stacked layer axis of its JAX leaf, or None
    for a leaf without one (embeddings, the final norms)."""
    out = {}
    if cfg.family == "encdec":
        for stack in ("enc", "dec"):
            for r, block in enumerate(getattr(params, stack)):
                for name, _ in block.named_parameters():
                    out[f"{stack}.{r}.{name}"] = ((stack, *name.split(".")), r)
    else:
        i = 0
        for si, seg in enumerate(plan_segments(cfg)):
            for r in range(seg.repeats):
                for ki, _ in enumerate(seg.pattern):
                    for name, _ in params.layers[i].named_parameters():
                        out[f"layers.{i}.{name}"] = ((f"seg{si}", f"k{ki}", *name.split(".")), r)
                    i += 1
    for name, _ in params.named_parameters():
        out.setdefault(name, (tuple(name.split(".")), None))
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: nn.Module, cfg: ModelConfig, values: dict | None = None) -> dict:
    """The JAX package's pytree (numpy leaves, the layers stacked on each
    leaf's leading axis) of the port's ``params``, the inverse of
    ``params_from_numpy``; with ``values`` (tensors keyed by parameter name,
    such as gradients or moments) the tree of those instead."""
    tensors = dict(params.named_parameters()) if values is None else values
    tree: dict = {}
    stacks: dict = {}
    for name, (path, r) in param_paths(params, cfg).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if r is None:
            node[path[-1]] = _numpy(tensors[name])
        else:
            stacks.setdefault(path, []).append((r, _numpy(tensors[name])))
    for path, rows in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = np.stack([a for _, a in sorted(rows, key=lambda t: t[0])])
    return tree


def leaves_from_numpy(tree: dict, params: nn.Module, cfg: ModelConfig, device="cuda") -> dict:
    """A JAX pytree shaped like the parameters (numpy leaves: gradients,
    moments) as ``{port parameter name: tensor}`` on ``device``, each layer's
    row of the stacked leaves."""
    device = resolve_device(device)
    out = {}
    for name, (path, r) in param_paths(params, cfg).items():
        leaf = tree
        for key in path:
            leaf = leaf[key]
        out[name] = tensor_from_numpy(leaf if r is None else np.asarray(leaf)[r], device)
    return out
