"""Wrapper of the CUDA per-segment sum (``csrc/segment_sum.cu``).

Replaces the engine's ``jax.ops.segment_sum`` scatter-adds
(``src/repro/core/engine.py:142``; XLA's scatter, no TPU kernel).  One
cooperative launch a call: a stable counting sort of the rows by segment,
then one warp a segment folds its rows in row order, so float sums carry the
same bits as the CPU's sequential scatter and do not change from run to run.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build

# kernel launches since the count was last reset (see chip_smoke.py)
launches = 0

_NAMES = {torch.float32: "f32", torch.int32: "i32"}
_IDS = {torch.int32: "i32", torch.int64: "i64"}
_MAX_FEATURES = 4
_FNS: dict = {}
_SCRATCH: dict = {}   # scratch bytes by (dtype, id dtype, features, rows, segments)


def _fn(dtype, id_dtype):
    fns = _FNS.get((dtype, id_dtype))
    if fns is None:
        lib = _build.load("segment_sum")
        name = f"segment_sum_{_NAMES[dtype]}_{_IDS[id_dtype]}"
        fn, size = getattr(lib, name), getattr(lib, name + "_scratch")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, p, ll, i, p, p, p]
        fn.restype = i
        size.argtypes = [i, ll, i]
        size.restype = ll
        fns = _FNS[dtype, id_dtype] = fn, size
    return fns


def segment_sum_cuda(values: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = sum of values[j] over rows j with seg[j] == s``, added in row
    order from +0.0; rows whose id lies outside ``[0, num_segments)`` are
    dropped.

    ``values`` is f32 or i32, ``[J]`` or ``[J, F]`` with ``F <= 4``; ``seg`` is
    an int32 or int64 ``[J]`` on the same device."""
    global launches
    if not values.is_cuda or seg.device != values.device:
        raise ValueError("segment_sum_cuda needs values and seg on one CUDA device")
    if values.dtype not in _NAMES:
        raise TypeError(f"segment_sum_cuda takes float32 or int32 values, not {values.dtype}")
    if seg.dtype not in _IDS or seg.dim() != 1:
        raise TypeError("segment_sum_cuda takes a 1-D int32/int64 seg")
    if values.dim() not in (1, 2) or values.shape[0] != seg.shape[0]:
        raise ValueError(f"values {tuple(values.shape)} do not match seg {tuple(seg.shape)}")
    features = 1 if values.dim() == 1 else values.shape[1]
    if not 1 <= features <= _MAX_FEATURES:
        raise ValueError(f"segment_sum_cuda takes 1..{_MAX_FEATURES} features, not {features}")
    if not values.is_contiguous() or not seg.is_contiguous():
        raise ValueError("segment_sum_cuda needs contiguous values and seg")
    out = torch.empty((num_segments, features), dtype=values.dtype, device=values.device)
    if num_segments == 0:
        return out[:, 0] if values.dim() == 1 else out
    fn, size = _fn(values.dtype, seg.dtype)
    key = (values.dtype, seg.dtype, features, seg.shape[0], num_segments)
    nbytes = _SCRATCH.get(key)
    if nbytes is None:
        nbytes = _SCRATCH[key] = size(features, seg.shape[0], num_segments)
    if nbytes < 0:
        raise ValueError(f"segment_sum_cuda: {num_segments} segments do not fit a CTA's "
                         "shared memory")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=values.device)
    rc = fn(
        values.data_ptr(), features, seg.data_ptr(), seg.shape[0], num_segments,
        scratch.data_ptr(), out.data_ptr(), _build.stream_handle(values.device),
    )
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError {rc}")
    launches += 1
    return out[:, 0] if values.dim() == 1 else out
