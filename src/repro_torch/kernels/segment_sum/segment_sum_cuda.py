"""Wrapper of the CUDA per-segment sum (``csrc/segment_sum.cu``).

Replaces the engine's ``jax.ops.segment_sum`` scatter-adds
(``src/repro/core/engine.py:142``; XLA's scatter, no TPU kernel).  Rows are
stably sorted by segment here, and the kernel folds each segment's rows in
row order, so float sums carry the same bits as the CPU's sequential scatter
and do not change from run to run.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build

# kernel launches since the count was last reset (see chip_smoke.py)
launches = 0

_FNS = {torch.float32: "segment_sum_f32", torch.int32: "segment_sum_i32"}
_MAX_FEATURES = 4


def _fn(dtype):
    fn = getattr(_build.load("segment_sum"), _FNS[dtype])
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
    return fn


def segment_sum_cuda(values: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = sum of values[j] over rows j with seg[j] == s``, added in row
    order; rows whose id lies outside ``[0, num_segments)`` are dropped.

    ``values`` is f32 or i32, ``[J]`` or ``[J, F]`` with ``F <= 4``; ``seg`` is
    an integer ``[J]`` on the same device."""
    global launches
    if not values.is_cuda or seg.device != values.device:
        raise ValueError("segment_sum_cuda needs values and seg on one CUDA device")
    if values.dtype not in _FNS:
        raise TypeError(f"segment_sum_cuda takes float32 or int32 values, not {values.dtype}")
    if seg.dtype not in (torch.int32, torch.int64) or seg.dim() != 1:
        raise TypeError("segment_sum_cuda takes a 1-D int32/int64 seg")
    if values.dim() not in (1, 2) or values.shape[0] != seg.shape[0]:
        raise ValueError(f"values {tuple(values.shape)} do not match seg {tuple(seg.shape)}")
    features = 1 if values.dim() == 1 else values.shape[1]
    if not 1 <= features <= _MAX_FEATURES:
        raise ValueError(f"segment_sum_cuda takes 1..{_MAX_FEATURES} features, not {features}")
    if not values.is_contiguous():
        raise ValueError("segment_sum_cuda needs contiguous values")
    sorted_seg, perm = torch.sort(seg, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=seg.dtype, device=seg.device)
    offsets = torch.searchsorted(sorted_seg, bounds)
    out = torch.empty((num_segments, features), dtype=values.dtype, device=values.device)
    rc = _fn(values.dtype)(
        values.data_ptr(), features, perm.data_ptr(), offsets.data_ptr(), num_segments,
        out.data_ptr(), torch.cuda.current_stream(values.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError {rc}")
    launches += 1
    return out[:, 0] if values.dim() == 1 else out
