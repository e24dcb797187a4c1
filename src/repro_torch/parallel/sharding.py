"""Sharding rules: parameter path -> PartitionSpec on the production mesh, the
JAX package's ``parallel/sharding.py`` on a ``torch.distributed`` mesh.

Mapping (DESIGN.md §7):
  DP    batch over ('pod', 'data')
  FSDP  parameter d_model-ish dims over ('pod', 'data') (ZeRO-3)
  TP    head / ff / vocab dims over 'model' (Megatron)
  EP    expert dim over 'model'
  SP    residual-stream seq dim over 'model' at scan boundaries (opt-in)

A ``PartitionSpec`` is a tuple with an entry a tensor dimension: ``None``, a
mesh axis name, or a tuple of two or more names (the dimension split over
each, the first major, as JAX splits it).  ``NamedSharding(mesh, spec).placements()`` gives
the ``DTensor`` placements, a ``Shard``/``Replicate`` a mesh dimension; a
dimension over several mesh axes needs them in the mesh's order, which is
DTensor's order for two mesh dimensions on one tensor dimension.  The rules
read only the mesh's dimension names and sizes, so they take a
``DeviceMesh`` or an ``AbstractMesh`` (names and sizes, no devices).
Single-pod meshes simply lack the 'pod' axis; every helper resolves axis
names against the mesh it is given.

The rules are keyed by the JAX tree's path names.  ``params_shardings`` of a
tree in the JAX package's layout (``train_state_to_tree``) gives the JAX
package's specs, the stacked layer axis included; of the port's module
(``params_shardings(params, mesh, cfg)``) it gives each per-layer parameter
the same spec without that leading ``None``.

The models call the constraints where the JAX package does
(``constrain_batch``, ``gather_fsdp`` through ``gather_block``,
``maybe_shard_seq``) and pin each residual sum to the data split; the
lookups and splits ``DTensor`` cannot place without replicating are
written here (``embed_rows``, ``gather_table``, ``split_microbatches``),
and the hand-written kernels' custom ops get their ``DTensor`` sharding
rules.  Every helper passes a plain tensor through unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from ..core.distributed import ambient_mesh, mesh_device
from ..tree_util import map_with_path


class PartitionSpec(tuple):
    """Entries normalized as JAX normalizes them: a one-name tuple is the
    name, an empty tuple None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e

        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """A mesh's dimension names and sizes, without devices: enough for the
    rules (and for ``NamedSharding.placements``)."""

    def __init__(self, shape: tuple, mesh_dim_names: tuple):
        if len(shape) != len(mesh_dim_names):
            raise ValueError(f"mesh shape {shape} and names {mesh_dim_names} differ in length")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(mesh_dim_names)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def _axis_sizes(mesh) -> dict:
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


@dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec

    def placements(self) -> tuple:
        """One ``Shard(dim)`` or ``Replicate()`` a mesh dimension."""
        from torch.distributed.tensor import Replicate, Shard

        names = axis_names(self.mesh)
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"{self.spec}: dimension {dim} is split over {axes}, not in the "
                                 f"mesh's order {names}")
            for i in pos:
                out[i] = Shard(dim)
        return tuple(out)

    def shard_index(self, shape: tuple, coordinate) -> tuple:
        """The slices of a ``shape`` array that the mesh position
        ``coordinate`` (one index a mesh dimension) holds."""
        sizes = tuple(self.mesh.shape)
        names = axis_names(self.mesh)
        out = []
        for dim, n in enumerate(shape):
            entry = self.spec[dim] if dim < len(self.spec) else None
            axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
            idx, parts = 0, 1
            for a in axes:
                i = names.index(a)
                idx, parts = idx * sizes[i] + coordinate[i], parts * sizes[i]
            if n % parts:
                raise ValueError(f"dimension {dim} of {shape} does not split {parts} ways")
            out.append(slice(idx * (n // parts), (idx + 1) * (n // parts)))
        return tuple(out)


def device_put(x: torch.Tensor, sharding: NamedSharding):
    """The whole array ``x`` (on any device) as a ``DTensor`` on the
    sharding's mesh: this rank keeps its own slice on its device, with no
    collective, as every rank holds ``x``.  A meta ``x`` stays meta: a
    shard's shape and no memory, for tracing."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    local = x[sharding.shard_index(tuple(x.shape), mesh.get_coordinate())]
    if not local.is_meta:
        local = local.to(mesh_device(mesh))
    local = local.contiguous()
    return DTensor.from_local(local, mesh, sharding.placements(), run_check=False)


def fsdp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def batch_axes(mesh) -> tuple:
    return fsdp_axes(mesh)


def _strip_stacked(path_names: list[str], shape: tuple) -> bool:
    """Params under seg*/k* (or whisper enc/dec) carry a leading layer dim."""
    return any(n.startswith("seg") for n in path_names) or any(
        n in ("enc", "dec") for n in path_names
    )


def _validate_spec(spec: P, shape: tuple, mesh) -> P:
    """Drop axes whose mesh extent does not divide the dim (e.g. mamba's
    concatenated in_proj dim, whisper's 1500-frame cross cache)."""
    sizes = _axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        extent = 1
        for a in axes:
            extent *= sizes[a]
        out.append(entry if shape[i] % extent == 0 else None)
    return P(*out)


def param_spec(path_names: list[str], shape: tuple, mesh) -> P:
    """PartitionSpec for one parameter leaf."""
    name = path_names[-1]
    if name in ("q", "scale") and len(path_names) >= 2:
        name = path_names[-2]  # 8-bit optimizer states shard like the param
    F = fsdp_axes(mesh) or None
    M = "model" if "model" in axis_names(mesh) else None
    stacked = _strip_stacked(path_names, shape)
    lead = (None,) if stacked else ()
    core = shape[1:] if stacked else shape
    nd = len(core)

    def spec(*dims):
        return P(*lead, *dims)

    if name in ("embed", "lm_head", "pos_dec"):
        return P(M, F)  # [V, d] never stacked
    if name == "router":  # [d, E] — small, replicate over model for locality
        return spec(F, None) if nd == 2 else spec(None)
    if name in ("w_gate", "w_up") and nd == 3:  # experts [E, d, ff]
        return spec(M, F, None)
    if name == "w_down" and nd == 3:            # experts [E, ff, d]
        return spec(M, None, F)
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "w_x"):
        return spec(F, M)                        # [d, out]
    if name in ("wo", "w_down", "out_proj", "w_out"):
        return spec(M, F)                        # [in, d]
    if name in ("w_rg", "w_ig"):                 # rglru [w, w]
        return spec(F, None)
    if name == "conv_w":                         # [K, C]
        return spec(None, F)
    if name in ("bq", "bk", "bv"):
        return spec(M)
    # norms, scalar gains, conv bias, A_log, D, dt_bias, lam, ...
    return spec(*(None,) * nd)


def _names(path) -> list:
    return [getattr(k, "key", getattr(k, "name", str(k))) for k in path]


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def params_shardings(params, mesh, cfg=None):
    """A ``NamedSharding`` a parameter leaf: of a tree in the JAX package's
    layout, the same tree of shardings; of the port's module (with its
    ``cfg``), ``{parameter name: sharding}``, a layer's parameter given its
    JAX leaf's spec without the stacked layer axis."""
    if isinstance(params, nn.Module):
        from ..models.convert import param_paths

        if cfg is None:
            raise TypeError("params_shardings of a module needs the model's cfg")
        named = dict(params.named_parameters())
        out = {}
        for name, (path, layer) in param_paths(params, cfg).items():
            shape = tuple(named[name].shape) if layer is None else (1, *named[name].shape)
            spec = _validate_spec(param_spec(list(path), shape, mesh), shape, mesh)
            out[name] = NamedSharding(mesh, spec if layer is None else P(*spec[1:]))
        return out

    def assign(path, leaf):
        shape = _shape(leaf)
        spec = _validate_spec(param_spec(_names(path), shape, mesh), shape, mesh)
        return NamedSharding(mesh, spec)

    return map_with_path(assign, params)


def batch_shardings(batch_like, mesh):
    B = batch_axes(mesh) or None

    def assign(_, leaf):
        nd = len(_shape(leaf))
        return NamedSharding(mesh, P(B, *(None,) * (nd - 1)))

    return map_with_path(assign, batch_like)


def cache_shardings(cache, mesh, *, shard_len: bool = True, batch="auto"):
    """KV caches: [L, B, H, S, D] -> (None, DP, None, 'model', None).
    Recurrent states: [L, B, ...] -> (None, DP, ...).

    ``batch``: DP axes tuple, None (replicate batch, e.g. global_batch=1), or
    "auto" (all of pod/data)."""
    B = (batch_axes(mesh) or None) if batch == "auto" else batch
    M = "model" if ("model" in axis_names(mesh) and shard_len) else None

    def assign(path, leaf):
        names = _names(path)
        shape = _shape(leaf)
        nd = len(shape)
        if names[-1] in ("k", "v", "cross_k", "cross_v") and nd == 5:
            spec = P(None, B, None, M, None)
        elif names[-1] == "len" or nd == 0:
            spec = P()
        else:
            # stacked recurrent states [L, B, ...]
            spec = P(None, B, *(None,) * (nd - 2))
        return NamedSharding(mesh, _validate_spec(spec, shape, mesh))

    return map_with_path(assign, cache)


def _constrain(x, mesh, spec: P):
    """``x`` redistributed to ``spec`` on ``mesh`` if it is a ``DTensor``;
    any other value passes through."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, NamedSharding(mesh, spec).placements())


def gather_fsdp(layer_params, mesh_axes=None):
    """Constrain per-layer params to their spec with the FSDP axes dropped:
    the ZeRO-3 all-gather happens HERE (small, per layer), and the 'model'
    (TP/EP) sharding is preserved so the matmuls never see full weights
    replicated.  ``layer_params``: a tree of one layer's parameters keyed as
    the JAX tree; ``DTensor`` leaves are redistributed on the ambient mesh,
    others pass through."""
    axes = mesh_axes or ambient_axis_names()
    if "model" not in axes:
        return layer_params
    mesh = ambient_mesh()
    return map_with_path(lambda path, leaf: _gather_leaf(_names(path), leaf, mesh),
                         layer_params)


def _gather_leaf(names: list, leaf, mesh):
    shape = _shape(leaf)
    spec = param_spec(names, shape, mesh)
    dropped = P(*[
        ("model" if e == "model" or (isinstance(e, tuple) and "model" in e) else None)
        for e in spec
    ])
    return _constrain(leaf, mesh, _validate_spec(dropped, shape, mesh))


def ambient_axis_names() -> tuple:
    """Axis names of the mesh of the innermost ``use_mesh`` (() if none)."""
    mesh = ambient_mesh()
    return axis_names(mesh) if mesh is not None else ()


def maybe_shard_seq(x):
    """SP-lite: constrain [B, S, d] to (DP, 'model', None) when a mesh with a
    'model' axis is ambient (no-op otherwise) — used at scan boundaries."""
    axes = ambient_axis_names()
    if "model" not in axes:
        return x
    B = tuple(a for a in ("pod", "data") if a in axes) or None
    return _constrain(x, ambient_mesh(), P(B, "model", None))


def constrain_batch(x):
    axes = ambient_axis_names()
    if not axes:
        return x
    B = tuple(a for a in ("pod", "data") if a in axes) or None
    nd = x.ndim
    return _constrain(x, ambient_mesh(), P(B, *(None,) * (nd - 1)))


def split_microbatches(x, n: int) -> list:
    """``x [B, ...]`` as ``n`` microbatches ``[B // n, ...]``, the i-th rows
    ``i * B // n ..``.  A ``DTensor`` is gathered first (a token batch is
    small) and each microbatch split as ``x`` was: every rank holds its
    own share of every microbatch, the rows one card would take."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return list(x.reshape(n, x.shape[0] // n, *x.shape[1:]).unbind(0))
    mesh = x.device_mesh
    full = x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    sharding = NamedSharding(mesh, spec_of(x))
    return [device_put(part, sharding)
            for part in full.reshape(n, x.shape[0] // n, *x.shape[1:]).unbind(0)]


def spec_of(dt) -> PartitionSpec:
    """The ``PartitionSpec`` of a ``DTensor``'s placements."""
    names = axis_names(dt.device_mesh)
    per_dim: dict = {}
    for axis, pl in zip(names, dt.placements):
        if pl.is_shard():
            per_dim.setdefault(pl.dim, []).append(axis)
    return P(*[tuple(per_dim[d]) if d in per_dim else None for d in range(dt.ndim)])


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def gather_table(table):
    """``gather_fsdp`` of an embedding table ``[V, d]``: its FSDP axes
    dropped, its vocab split over 'model' kept; anything else as it is."""
    return gather_fsdp({"embed": table})["embed"]


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; for a ``DTensor`` table, Megatron's vocab-parallel
    lookup: the table gathered over its FSDP axes, each 'model' rank
    reading the ids that fall in its own rows (zeros elsewhere), the
    results a partial sum over 'model' that the caller's constraint adds
    up (``constrain_batch``: one all-reduce of the activations)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    names = axis_names(mesh)
    split = [n == "model" and pl.is_shard(0) for n, pl in zip(names, table.placements)]
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * len(names), run_check=False)
    id_pl = [Replicate() if s else pl for s, pl in zip(split, ids.placements)]
    out_pl = [Partial() if s else pl for s, pl in zip(split, id_pl)]
    tab_pl = [Shard(0) if s else Replicate() for s in split]
    model_dim = split.index(True) if any(split) else None

    def lookup(tab, idx):
        if model_dim is None:
            return tab[idx]
        rows = tab.shape[0]
        r = idx.long() - mesh.get_local_rank(model_dim) * rows
        ok = (r >= 0) & (r < rows)
        return tab[r.clamp(0, rows - 1)] * ok[..., None].to(tab.dtype)

    # each rank's rows' gradient is its own tokens' share: a partial sum
    # over the axes the ids are split over and the table is not
    grad_pl = [Partial() if not s and pl.is_shard() else tp
               for s, pl, tp in zip(split, id_pl, tab_pl)]
    return local_map(lookup, out_placements=out_pl, in_placements=(tab_pl, id_pl),
                     in_grad_placements=(grad_pl, id_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)


class BlockView:
    """One layer's parameters as a ``Block`` reads them (``p.kind``,
    ``p.ln1``, ``p.attn["wq"]``, ``"w_gate" in p.moe``), holding the
    redistributed ``DTensor``s that ``gather_block`` made."""

    def __init__(self, kind: str, parts: dict):
        self.kind = kind
        self.__dict__.update(parts)


def gather_block(block):
    """``gather_fsdp`` of one layer (a ``Block`` module): its parameters with
    the FSDP axes dropped and the 'model' sharding kept, as a ``BlockView``.
    Without an ambient mesh with a 'model' axis, the block itself."""
    axes = ambient_axis_names()
    if "model" not in axes:
        return block
    tree: dict = {}
    for name, param in block.named_parameters():
        node = tree
        *owners, leaf = name.split(".")
        for o in owners:
            node = node.setdefault(o, {})
        node[leaf] = param
    return BlockView(block.kind, gather_fsdp(tree, axes))


def _register_op_shardings() -> None:
    """``DTensor`` sharding rules of the hand-written kernels' custom ops:
    each runs on its local shards when every operand is split the same way
    on a dimension the op keeps apart (the batch or the heads of attention,
    the routing groups of the assignment), or replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    from ..kernels.assign import ops as _assign_ops  # noqa: F401  (defines the ops)
    from ..kernels.flash_attention import ops as _flash_ops  # noqa: F401

    ops = torch.ops.repro_torch

    def rule(n_in, n_out, dims):
        def strategies(*args, **kwargs):
            out = [([Replicate()] * n_out, [Replicate() if i < n_in else None
                                            for i in range(len(args))])]
            for d in dims:
                if len(args[0].shape) < 3:   # one assignment problem: rows are not apart
                    break
                out.append(([Shard(d)] * n_out, [Shard(d) if i < n_in else None
                                                 for i in range(len(args))]))
            return out
        return strategies

    register_sharding(ops.flash_fwd.default)(rule(3, 2, (0, 1)))
    register_sharding(ops.flash_bwd.default)(rule(6, 3, (0, 1)))
    register_sharding(ops.assign.default)(rule(3, 4, (0,)))
    register_sharding(ops.gate_backward.default)(rule(3, 1, (0,)))


if torch.distributed.is_available():
    _register_op_shardings()
