"""Roofline terms of a cell from the counts of its traced step.

    compute term    = FLOPs / peak FLOP/s          (per card)
    memory term     = bytes / HBM bandwidth        (per card)
    collective term = collective bytes / link bw   (per card)

The JAX package reads these counts from a compiled XLA program:
``cost_analysis()`` for FLOPs and bytes, and its HLO text for the
collectives (``_shape_bytes``, ``collective_bytes(hlo_text)``,
``measure._collective_bytes_corrected``, ``_fusion_adjusted_bytes``).  The
port has no HLO text, so those parsers have no counterpart; ``Counter``
counts the program as it runs instead, on meta tensors (no memory, no
kernel) or on the card:

* FLOPs: ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``),
  the custom kernels' own included (``repro_torch::flash_fwd`` and
  ``flash_bwd``, ``assign``, ``gate_backward``);
* bytes: operand and result bytes of the ops that move data through HBM on
  the target, the JAX package's ``_MATERIAL_OPS`` (``MATERIAL_OPS`` below):
  matmuls, the custom kernels, gathers and scatters, sorts, copies,
  concatenation and padding, reductions, collectives and RNG; elementwise
  ops are left out, as XLA fuses them on the target;
* collective bytes: the result bytes of each ``_c10d_functional`` collective
  that ``DTensor`` issues, by kind, weighted by ``_COST_FACTOR``;
* peak bytes: the most bytes that the program's own results (each op's
  result that is not a view of an operand, on rank 0's shards) held at
  once, each freed when it dies; on the card ``torch.cuda.max_memory_allocated``
  where larger.  (``torch.distributed._tools.mem_tracker.MemTracker``
  counts a ``DTensor``'s global size, so it reads far high under a mesh.)
  The program's arguments are the caller's to add.

Under a ``DTensor`` the counter sees each op on rank 0's local shards (it
lets ``DTensor`` run first, as ``CommDebugMode`` does), so every count is
per card.  The JAX package halves f32 bytes in a bf16 model to undo the
CPU backend's upcasts; the port counts the dtypes its program has.
"""
from __future__ import annotations

import json
import weakref
from collections import defaultdict
from dataclasses import asdict, dataclass

import torch
from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode

from .mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
)

# ring-cost multipliers: bytes actually moved per device per op result-byte
_COST_FACTOR = {
    "all-gather": 1.0,          # (n-1)/n ~ 1 of the gathered result
    "all-reduce": 2.0,          # reduce-scatter + all-gather phases
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# the collectives by kind: ``_c10d_functional`` (and the legacy
# ``c10d_functional``) op names, and DTensor's own shard-to-shard all-to-all
COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "permute_tensor": "collective-permute",
}

# aten (and custom) ops whose operands and results move through HBM, the
# JAX package's _MATERIAL_OPS: dot/convolution, the custom kernels,
# gather/scatter/dynamic-(update-)slice, sort, copy, pad/concatenate,
# reduce/reduce-window, iota and rng-bit-generator
MATERIAL_OPS = frozenset({
    # matmuls and convolutions
    "aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::_scaled_mm",
    "aten::convolution", "aten::convolution_backward",
    # the hand-written kernels
    "repro_torch::flash_fwd", "repro_torch::flash_bwd", "repro_torch::assign",
    "repro_torch::gate_backward",
    # gathers, scatters, slices written into
    "aten::index", "aten::index_put", "aten::index_put_", "aten::_index_put_impl_",
    "aten::gather", "aten::scatter", "aten::scatter_", "aten::scatter_add",
    "aten::scatter_add_", "aten::scatter_reduce", "aten::scatter_reduce_", "aten::index_add",
    "aten::index_add_", "aten::index_select", "aten::index_fill", "aten::index_fill_",
    "aten::embedding", "aten::embedding_dense_backward", "aten::slice_scatter",
    "aten::select_scatter", "aten::masked_scatter",
    # sorts
    "aten::sort", "aten::topk",
    # copies
    "aten::copy_", "aten::_to_copy", "aten::clone", "aten::roll",
    # concatenation and padding
    "aten::cat", "aten::constant_pad_nd",
    # reductions
    "aten::sum", "aten::mean", "aten::amax", "aten::amin", "aten::max", "aten::min",
    "aten::argmax", "aten::argmin", "aten::logsumexp", "aten::cumsum", "aten::prod",
    "aten::var_mean", "aten::linalg_vector_norm", "aten::_softmax", "aten::_log_softmax",
    "aten::_softmax_backward_data", "aten::_log_softmax_backward_data", "aten::all",
    "aten::any",
    # iota and random bits
    "aten::arange", "aten::normal_", "aten::uniform_", "aten::bernoulli_", "aten::random_",
    "aten::randint",
})


def _tensor_bytes(tree) -> int:
    leaves = tree if isinstance(tree, (list, tuple)) else (tree,)
    total = 0
    for t in leaves:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, (list, tuple)):
            total += _tensor_bytes(t)
    return total


def _free(live: list, nbytes: int) -> None:
    live[0] -= nbytes


class _LocalCountMode(_FlopCounterMode):
    """FlopCounterMode's dispatch mode that lets a tensor subclass
    (``DTensor``) run first: the ops it issues on its local shards, its
    collectives among them, come back here and are counted."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # DTensor runs first; its sharding propagation's fake tensors
        # (global shapes, to infer an output's metadata, made under a fake
        # mode) are not the program
        names = {t.__name__ for t in types}
        if "DTensor" in names:
            return NotImplemented
        if "FakeTensor" in names or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class Counter(FlopCounterMode):
    """Counts a program's FLOPs, HBM bytes, collective bytes by kind and
    peak bytes per card (see the module docstring)::

        with Counter() as c:
            step(state, batch)
        c.record()   # {"flops", "bytes", "coll_breakdown", "coll_bytes", "peak_bytes", ...}

    ``peak=False`` skips the peak (a weak reference a result).  The card's
    allocator peak is read only where this process has started CUDA: a
    trace on meta tensors starts none."""

    def __init__(self, *, peak: bool = True):
        super().__init__(display=False)
        self.peak = peak
        self._reset()

    def _reset(self) -> None:
        self.bytes = 0
        self.coll_breakdown = {k: 0 for k in _COLLECTIVES}
        self.ops = defaultdict(int)
        self.coll_by_shape = defaultdict(int)   # (kind, result shape, dtype) -> bytes
        self.peak_bytes = -1.0
        self._live = [0, 0]                     # the results' bytes alive now, the most
        self._cuda = None

    def __enter__(self):
        self._reset()
        if self.peak and torch.cuda.is_initialized():
            self._cuda = torch.cuda.current_device()
            torch.cuda.reset_peak_memory_stats(self._cuda)
        self.flop_counts.clear()
        self.mod_tracker.__enter__()
        self.mode = _LocalCountMode(self)
        self.mode.__enter__()
        return self

    def __exit__(self, *args):
        out = super().__exit__(*args)
        if self.peak:
            card = torch.cuda.max_memory_allocated(self._cuda) if self._cuda is not None else 0
            self.peak_bytes = float(max(self._live[1], card))
        return out

    def _track(self, out, args) -> None:
        """A result that is not a view of an operand counts as live until
        it dies."""
        if not isinstance(out, torch.Tensor):
            return
        mine = out.untyped_storage()._cdata
        if any(isinstance(a, torch.Tensor) and a.untyped_storage()._cdata == mine for a in args):
            return
        nbytes = out.numel() * out.element_size()
        self._live[0] += nbytes
        self._live[1] = max(self._live[1], self._live[0])
        weakref.finalize(out, _free, self._live, nbytes)

    def _count_flops(self, func_packet, out, args, kwargs):
        name = func_packet._qualified_op_name
        ns, _, op = name.partition("::")
        kind = COLLECTIVE_OPS.get(op) if ns in ("_c10d_functional", "c10d_functional",
                                                 "_dtensor") else None
        if kind is not None:
            nbytes = _tensor_bytes(out)
            self.coll_breakdown[kind] += nbytes
            if isinstance(out, torch.Tensor):
                self.coll_by_shape[(kind, tuple(out.shape), str(out.dtype))] += nbytes
            self.bytes += nbytes + _tensor_bytes(args)
        elif name in MATERIAL_OPS:
            self.bytes += _tensor_bytes(out) + _tensor_bytes(args) + _tensor_bytes(
                tuple(kwargs.values()))
        self.ops[name] += 1
        if self.peak:
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                self._track(o, args)
        return super()._count_flops(func_packet, out, args, kwargs)

    @property
    def coll_bytes(self) -> float:
        return sum(_COST_FACTOR[k] * v for k, v in self.coll_breakdown.items())

    def top_collectives(self, n: int = 8) -> list:
        """The ``n`` largest (kind, result shape, dtype, bytes) collectives."""
        top = sorted(self.coll_by_shape.items(), key=lambda kv: -kv[1])[:n]
        return [[k, list(s), d, b] for (k, s, d), b in top]

    def record(self) -> dict:
        return dict(flops=float(self.get_total_flops()), bytes=float(self.bytes),
                    coll_breakdown=dict(self.coll_breakdown), coll_bytes=self.coll_bytes,
                    peak_bytes=self.peak_bytes, top_collectives=self.top_collectives())


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_flops: float            # per device
    hlo_bytes: float            # per device
    coll_bytes: float           # per device (cost-weighted)
    coll_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float          # 6*N_active*D (train) / 2*N_active*D (serve)
    useful_ratio: float         # model_flops_per_device / hlo_flops
    peak_bytes_per_device: float
    step_s: float               # max of the three terms
    roofline_frac: float        # model-flops-time / step_s (perf score)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def analyze(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    n_devices: int,
    counts: dict,
    model_flops_total: float,
    peak_bytes: float | None = None,
) -> Roofline:
    """The roofline of one cell from a ``Counter.record()`` of its step
    (the JAX package's ``analyze`` reads a compiled XLA program instead)."""
    flops = float(counts.get("flops", 0.0))
    bytes_ = float(counts.get("bytes", 0.0))
    breakdown = dict(counts.get("coll_breakdown", {k: 0 for k in _COLLECTIVES}))
    coll = sum(_COST_FACTOR[k] * v for k, v in breakdown.items())

    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = bytes_ / HBM_BW
    collective_s = coll / ICI_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    model_flops_dev = model_flops_total / n_devices
    step_s = max(terms.values())
    ideal_s = model_flops_dev / PEAK_FLOPS_BF16
    if peak_bytes is None:
        peak_bytes = float(counts.get("peak_bytes", -1.0))
    return Roofline(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        n_devices=n_devices,
        hlo_flops=flops,
        hlo_bytes=bytes_,
        coll_bytes=coll,
        coll_breakdown=breakdown,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops_total,
        useful_ratio=(model_flops_dev / flops) if flops else 0.0,
        peak_bytes_per_device=peak_bytes,
        step_s=step_s,
        roofline_frac=(ideal_s / step_s) if step_s else 0.0,
    )


def model_flops_for_cell(cfg, shape_spec, kind: str) -> float:
    """6*N_active*tokens for train; 2*N_active*tokens for serving steps."""
    if kind == "train":
        tokens = shape_spec.global_batch * shape_spec.seq_len
        return cfg.model_flops_per_token(backward=True) * tokens
    if kind == "prefill":
        tokens = shape_spec.global_batch * shape_spec.seq_len
        return cfg.model_flops_per_token(backward=False) * tokens
    # decode: one token per sequence; attention reads the cache (memory-bound,
    # not counted in 2N) — 2*N_active per new token
    tokens = shape_spec.global_batch
    return cfg.model_flops_per_token(backward=False) * tokens
