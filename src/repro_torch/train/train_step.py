"""The train step: gradient accumulation over microbatches, AdamW (or its
8-bit form), and optionally int8 error-feedback gradient compression, as the
JAX package's ``train/train_step.py`` computes them.

The global batch ``[GB, S]`` splits into ``microbatches`` chunks taken one
after the other (the activations a step holds are a microbatch's); each
chunk's gradients are cast to f32 and summed, then divided by the count, and
the loss and metrics are the chunks' means.  The step first pins each batch
tensor to the ambient mesh's data-parallel axes (``constrain_batch``, as the
JAX package does); a plain tensor, or no ambient mesh, passes through, so a
one-card step is unchanged.  On a mesh each rank splits its own rows into
the microbatches (``split_microbatches``).

The parameters are the model's ``nn.Module`` (``Model.init`` builds them
untrainable, so serving builds no graph); ``init_train_state`` and
``train_state_from_numpy`` turn on the gradients of every parameter, as the
JAX package differentiates every leaf.  The step updates them in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..models.config import ModelConfig
from ..models.convert import leaves_from_numpy, param_paths, params_from_numpy
from ..models.model import Model
from ..parallel.sharding import constrain_batch, split_microbatches
from .compress import compress_grads, init_error_state
from .optimizer import (AdamWConfig, adamw_update, adamw_update_8bit, init_opt_state,
                        init_opt_state_8bit)


class TrainState(NamedTuple):
    params: nn.Module
    opt: dict         # {"m", "v": by parameter name (8-bit: {"q", "scale"}), "count": i32}
    err: dict | None  # error-feedback state (gradient compression) or None


def trainable(params: nn.Module) -> dict:
    """The parameters by name, with gradients turned on."""
    named = dict(params.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    return named


def decay_mask(params: nn.Module, cfg: ModelConfig) -> dict:
    """Which parameters take weight decay: those whose JAX leaf has two or
    more dimensions.  A layer's leaf there stacks the layers on a leading
    axis, so every layer parameter counts one more dimension than the port's
    tensor (a layer's norm weight ``[d]`` is a ``[L, d]`` leaf and decays)."""
    named = dict(params.named_parameters())
    return {name: named[name].dim() + (layer is not None) >= 2
            for name, (_, layer) in param_paths(params, cfg).items()}


def leaf_groups(params: nn.Module, cfg: ModelConfig) -> dict:
    """Each parameter's JAX leaf (its path): the layers of one kind share a
    leaf there, and so one int8 scale in ``compress_grads``."""
    return {name: path for name, (path, _) in param_paths(params, cfg).items()}


def init_train_state(model: Model, rng, *, compress: bool = False,
                     opt_8bit: bool = False) -> TrainState:
    params = model.init(rng)
    named = trainable(params)
    return TrainState(
        params=params,
        opt=init_opt_state_8bit(named) if opt_8bit else init_opt_state(named),
        err=init_error_state(named) if compress else None,
    )


def _moments(tree: dict, part: str | None) -> dict:
    """The 8-bit moments' ``q`` or ``scale`` leaves of a moment tree (or the
    tree itself for f32 moments, ``part`` None)."""
    if part is None:
        return tree
    if set(tree) == {"q", "scale"}:
        return tree[part]
    return {k: _moments(v, part) for k, v in tree.items()}


def train_state_from_numpy(state, cfg: ModelConfig, device="cuda") -> TrainState:
    """The JAX package's ``TrainState`` (``params``, ``opt`` with f32 or 8-bit
    moments and ``count``, ``err`` or None; numpy leaves) as the port's, with
    the parameters' gradients on, so both can take the same step from the
    same state."""
    params_tree, opt, err = state
    params = params_from_numpy(params_tree, cfg, device)
    trainable(params)

    def leaves(tree, part=None):
        return leaves_from_numpy(_moments(tree, part), params, cfg, device)

    if _is_8bit(opt["m"]):
        m = {n: {"q": q, "scale": s} for (n, q), s in
             zip(leaves(opt["m"], "q").items(), leaves(opt["m"], "scale").values())}
        v = {n: {"q": q, "scale": s} for (n, q), s in
             zip(leaves(opt["v"], "q").items(), leaves(opt["v"], "scale").values())}
    else:
        m, v = leaves(opt["m"]), leaves(opt["v"])
    count = torch.tensor(int(opt["count"]), dtype=torch.int32,
                         device=next(params.parameters()).device)
    return TrainState(params, {"m": m, "v": v, "count": count},
                      None if err is None else leaves(err))


def _host_buffer(shape: tuple, like: torch.Tensor, copy: bool) -> torch.Tensor:
    """An uninitialized host tensor of ``like``'s dtype; pinned when a copy
    from the card will fill it (an asynchronous copy at the link's rate, and
    the caching host allocator hands the same blocks to the next snapshot)."""
    return torch.empty(shape, dtype=like.dtype, pin_memory=copy and like.is_cuda)


def _stack_to_host(values: dict, paths: dict, copy: bool) -> dict:
    """``{name: tensor}`` as the JAX tree of host tensors (``paths`` is
    ``param_paths``): a layer's tensor is copied straight into its row of the
    stacked leaf, so the device holds no second copy.  The copies from the
    card are asynchronous: the caller synchronizes."""
    tree: dict = {}
    rows: dict = {}
    for name, (path, r) in paths.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        t = values[name].detach()
        if r is None:
            node[path[-1]] = buf = _host_buffer(t.shape, t, copy)
            if copy:
                buf.copy_(t, non_blocking=t.is_cuda)
        else:
            rows.setdefault(path, []).append((r, t))
    for path, ts in rows.items():
        node = tree
        for key in path[:-1]:
            node = node[key]
        t0 = ts[0][1]
        node[path[-1]] = leaf = _host_buffer((len(ts), *t0.shape), t0, copy)
        if copy:
            for r, t in ts:
                leaf[r].copy_(t, non_blocking=t.is_cuda)
    return tree


def train_state_to_tree(state: TrainState, cfg: ModelConfig, *, copy: bool = True) -> TrainState:
    """The port's state as the JAX package's ``TrainState`` tree, in host
    memory: ``params`` (each layer's parameter a row of its stacked leaf, as
    ``convert.param_paths`` places it), ``opt`` (``m`` and ``v`` in the same
    layout, 8-bit moments as ``{"q", "scale"}`` pairs, ``count``) and ``err``
    (or None).  Every leaf is a new host tensor: the tree is a snapshot that
    later in-place steps do not reach.  ``checkpoint.save`` of it writes the
    JAX package's keys.  ``copy=False`` leaves the leaves uninitialized: the
    tree's structure, shapes and dtypes, a template for ``checkpoint.restore``
    that costs no copy."""
    paths = param_paths(state.params, cfg)

    def tree(values: dict, part=None):
        return _stack_to_host({n: v if part is None else v[part] for n, v in values.items()},
                              paths, copy)

    def moments(values: dict):
        if _is_8bit(values):
            return _pair(tree(values, "q"), tree(values, "scale"))
        return tree(values)

    params = dict(state.params.named_parameters())
    count = state.opt["count"].detach()
    host_count = _host_buffer(count.shape, count, copy)
    if copy:
        host_count.copy_(count, non_blocking=count.is_cuda)
    out = TrainState(tree(params), {"m": moments(state.opt["m"]), "v": moments(state.opt["v"]),
                                    "count": host_count},
                     None if state.err is None else tree(state.err))
    device = next(iter(params.values())).device
    if copy and device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return out


def _pair(q: dict, scale: dict) -> dict:
    """Two trees of one structure as one whose leaves are ``{"q", "scale"}``."""
    if isinstance(q, dict):
        return {k: _pair(q[k], scale[k]) for k in q}
    return {"q": q, "scale": scale}


@torch.no_grad()
def train_state_from_tree(tree, state: TrainState, cfg: ModelConfig) -> TrainState:
    """Write a tree in the JAX package's layout (``train_state_to_tree``'s, or
    ``checkpoint.restore``'s of it) into the port's ``state``, in place, each
    layer's row of a stacked leaf into its tensor; returns ``state``."""
    paths = param_paths(state.params, cfg)

    def write(values: dict, src: dict, part=None) -> None:
        for name, (path, r) in paths.items():
            leaf = src
            for key in path:
                leaf = leaf[key]
            if part is not None:
                leaf = leaf[part]
            dst = values[name] if part is None else values[name][part]
            dst.copy_(leaf if r is None else leaf[r])

    params_tree, opt, err = tree
    write(dict(state.params.named_parameters()), params_tree)
    for moment in ("m", "v"):
        parts = ("q", "scale") if _is_8bit(state.opt[moment]) else (None,)
        for part in parts:
            write(state.opt[moment], opt[moment], part)
    state.opt["count"].copy_(opt["count"])
    if (state.err is None) != (err is None):
        raise ValueError("the tree and the state differ in error-feedback state")
    if err is not None:
        write(state.err, err)
    return state


def _is_8bit(tree: dict) -> bool:
    """Whether a moment tree's leaves are 8-bit ``{"q", "scale"}`` pairs."""
    node = tree
    while isinstance(node, dict):
        if set(node) == {"q", "scale"}:
            return True
        node = next(iter(node.values()))
    return False


def _grads(loss: torch.Tensor, named: dict) -> dict:
    return {name: g.float() for name, g in zip(named, torch.autograd.grad(loss,
                                                                        list(named.values())))}


def _detach(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig = AdamWConfig(),
    *,
    microbatches: int = 1,
    compress: bool = False,
    opt_8bit: bool = False,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: ``tokens [GB, S]`` (with ``frames``/``patch_embeds`` of the same
    leading GB), GB a multiple of ``microbatches``.  ``metrics``: the loss's
    metrics (the MoE aux losses and ``nll``), ``loss``, ``grad_norm`` and
    ``lr``, as 0-d tensors."""
    decay, groups = {}, {}
    update = adamw_update_8bit if opt_8bit else adamw_update

    def train_step(state: TrainState, batch: dict):
        batch = {k: constrain_batch(v) for k, v in batch.items()}
        named = trainable(state.params)
        if not decay:
            decay.update(decay_mask(state.params, model.cfg))
            groups.update(leaf_groups(state.params, model.cfg))
        if microbatches == 1:
            loss, metrics = model.loss(state.params, batch)
            grads = _grads(loss, named)
            loss, metrics = loss.detach(), _detach(metrics)
        else:
            micro = {k: split_microbatches(v, microbatches) for k, v in batch.items()}
            grads = {name: torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
                     for name, p in named.items()}
            losses, metss = [], []
            for i in range(microbatches):
                loss_i, met = model.loss(state.params, {k: v[i] for k, v in micro.items()})
                for name, g in _grads(loss_i, named).items():
                    grads[name] += g
                losses.append(loss_i.detach())
                metss.append(_detach(met))
            grads = {name: g / microbatches for name, g in grads.items()}
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metss]).mean() for k in metss[0]}

        err = state.err
        if compress and err is not None:
            grads, err = compress_grads(grads, err, groups)
        _, new_opt, opt_metrics = update(opt_cfg, named, grads, state.opt, decay=decay)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(state.params, new_opt, err), metrics

    return train_step


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss(params, batch)
        return dict(metrics, loss=loss)

    return eval_step
