"""input_specs(): meta ``DTensor`` stand-ins (shardable, zero allocation)
for every (arch x shape) dry-run cell, plus the step function that cell
traces.  The JAX package's ``ShapeDtypeStruct``s become meta tensors placed
on the mesh by the sharding rules with ``parallel.sharding.device_put``:
each rank holds only its own shard's shape, and no memory."""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..configs import SHAPES, get_config, get_plan
from ..models import build_model
from ..parallel.sharding import (NamedSharding, P, axis_names, batch_axes, cache_shardings,
                                 device_put, params_shardings, spec_of)
from ..serve.serve_step import make_decode_step, make_prefill_step
from ..train.optimizer import AdamWConfig, init_opt_state_8bit
from ..train.train_step import TrainState, _is_8bit, init_train_state, make_train_step


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class Cell(NamedTuple):
    arch: str
    shape: str
    cfg: object
    plan: object
    kind: str
    microbatches: int


def _sizes(mesh) -> dict:
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def build_cell(arch: str, shape: str, mesh) -> Cell:
    """The cell's config and plan on ``mesh`` (a ``DeviceMesh`` or an
    ``AbstractMesh``: only its axis names and sizes are read)."""
    cfg = get_config(arch)
    plan = get_plan(arch, shape)
    spec = SHAPES[shape]
    sizes = _sizes(mesh)
    # Megatron-style vocab padding so [V, d] tables shard over 'model'
    # (pad ids are never targets)
    model_par = sizes.get("model", 1)
    cfg = cfg.replace(vocab_size=round_up(cfg.vocab_size, max(16, model_par)))
    if plan.seq_shard and spec.kind == "train":
        cfg = cfg.replace(seq_shard=True)
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    mb = plan.microbatches
    if spec.kind == "train" and dp < 32:
        mb = min(mb * (32 // dp), spec.global_batch)  # keep per-shard footprint
    return Cell(arch, shape, cfg, plan, spec.kind, mb)


def trace_mesh(mesh):
    """The mesh a cell's ``DTensor``s are placed on: ``mesh`` itself, or for
    a multi-pod mesh its ('pod', 'data') axes flattened into one 'data'
    axis, pod major.  A dimension split over ('pod', 'data') has the same
    shards either way; ``DTensor`` redistributes a dimension split over two
    mesh dimensions by a search that is ~40x slower to trace."""
    names = axis_names(mesh)
    if "pod" not in names or "data" not in names or not hasattr(mesh, "mesh"):
        return mesh
    from torch.distributed.device_mesh import DeviceMesh

    sizes = _sizes(mesh)
    rest = [n for n in names if n not in ("pod", "data")]
    ranks = mesh.mesh.permute(*[names.index(n) for n in ("pod", "data", *rest)])
    ranks = ranks.reshape(sizes["pod"] * sizes["data"], *[sizes[n] for n in rest])
    return DeviceMesh(mesh.device_type, ranks, mesh_dim_names=("data", *rest))


def _batch_spec_for(B: int, mesh):
    axes = batch_axes(mesh)
    sizes = _sizes(mesh)
    total = 1
    for a in axes:
        total *= sizes[a]
    return axes if (axes and B % total == 0) else None


def shard_module(params: nn.Module, shardings: dict) -> nn.Module:
    """Replace each parameter of ``params`` (``{name: NamedSharding}``, as
    ``params_shardings(params, mesh, cfg)`` gives) by its ``DTensor`` on the
    sharding's mesh, in place; gradients stay as they were."""
    for name, sharding in shardings.items():
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        old = getattr(mod, leaf)
        new = nn.Parameter(device_put(old.detach(), sharding), requires_grad=old.requires_grad)
        if isinstance(mod, nn.ParameterDict):
            mod[leaf] = new
        else:
            setattr(mod, leaf, new)
    return params


def _place(tensors: dict, shardings: dict) -> dict:
    return {k: device_put(v, shardings[k]) if isinstance(v, torch.Tensor) else v
            for k, v in tensors.items()}


def _shard_like(params: nn.Module, values: dict) -> dict:
    """Per-parameter tensors of the parameters' shapes (moments, error
    feedback) as ``DTensor``s placed like their parameters."""
    named = dict(params.named_parameters())
    return {name: device_put(v, NamedSharding(named[name].device_mesh, spec_of(named[name])))
            for name, v in values.items()}


def shard_train_state(state: TrainState, mesh, cfg) -> TrainState:
    """A ``TrainState`` with its parameters and f32 moments as ``DTensor``s
    on ``mesh`` by ``params_shardings`` (in place for the parameters)."""
    params = shard_module(state.params, params_shardings(state.params, mesh, cfg))
    if _is_8bit(state.opt["m"]):   # zeros: made again from the placed parameters
        opt = dict(init_opt_state_8bit(dict(params.named_parameters())),
                   count=state.opt["count"])
    else:
        opt = dict(state.opt, m=_shard_like(params, state.opt["m"]),
                   v=_shard_like(params, state.opt["v"]))
    err = None if state.err is None else _shard_like(params, state.err)
    return TrainState(params, opt, err)


def batch_inputs(cfg, B: int, S: int, mesh) -> dict:
    """The cell's batch on ``mesh``: ``tokens [B, S]`` and the
    encoder-decoder's frames or the VLM's patches, split over the batch axes
    when B divides among them."""
    axes = _batch_spec_for(B, mesh)
    dtype = getattr(torch, cfg.dtype)
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32, device="meta")}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((B, cfg.n_frames, cfg.d_model), dtype=dtype, device="meta")
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros((B, cfg.n_patches, cfg.d_model), dtype=dtype,
                                            device="meta")
    return {k: device_put(v, NamedSharding(mesh, P(axes, *(None,) * (v.dim() - 1))))
            for k, v in batch.items()}


def cache_inputs(model, cfg, B: int, cache_len: int, mesh, plan, *, full: bool = False) -> dict:
    """The model's cache on ``mesh`` by ``cache_shardings``; ``full`` makes
    it hold ``cache_len - 1`` tokens, so that a decode step writes its last
    slot (the JAX package's cache of length ``cache_len``, full)."""
    cache = model.init_cache(B, cache_len)
    axes = _batch_spec_for(B, mesh)
    csh = cache_shardings({k: v for k, v in cache.items() if isinstance(v, torch.Tensor)}, mesh,
                          shard_len=plan.shard_cache_len, batch=axes)
    cache = _place(cache, csh)
    if full:
        cache["len"] = cache_len - 1
    return cache


def sharded_params(model, mesh, *, trainable: bool = False):
    params = model.init(0)
    if trainable:
        for p in params.parameters():
            p.requires_grad_(True)
    return shard_module(params, params_shardings(params, mesh, model.cfg))


def input_specs(cell: Cell, mesh):
    """Returns ``(fn, args, donate)``: the cell's step, its arguments as
    meta ``DTensor``s on ``mesh`` (no memory), and the positions of the
    arguments the step updates in place."""
    cfg, spec = cell.cfg, SHAPES[cell.shape]
    model = build_model(cfg, device="meta")
    B, S = spec.global_batch, spec.seq_len

    if cell.kind == "train":
        opt_8bit = getattr(cell.plan, "opt_8bit", False)
        state = shard_train_state(init_train_state(model, 0, opt_8bit=opt_8bit), mesh, cfg)
        step = make_train_step(model, AdamWConfig(), microbatches=cell.microbatches,
                               opt_8bit=opt_8bit)
        return step, (state, batch_inputs(cfg, B, S, mesh)), (0,)

    params = sharded_params(model, mesh)
    if cell.kind == "prefill":
        cache = cache_inputs(model, cfg, B, S, mesh, cell.plan)
        return make_prefill_step(model), (params, batch_inputs(cfg, B, S, mesh), cache), (2,)

    # decode: one new token against a full cache of seq_len (or the plan's override)
    cache_len = cell.plan.decode_cache_len or S
    cache = cache_inputs(model, cfg, B, cache_len, mesh, cell.plan, full=True)
    tok = batch_inputs(cfg, B, 1, mesh)["tokens"]
    return make_decode_step(model), (params, tok, cache), (2,)
