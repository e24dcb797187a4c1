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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from ..core.distributed import ambient_mesh, mesh_device
from ..models.convert import param_paths
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
    collective, as every rank holds ``x``."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    local = x[sharding.shard_index(tuple(x.shape), mesh.get_coordinate())]
    local = local.to(mesh_device(mesh)).contiguous()
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
