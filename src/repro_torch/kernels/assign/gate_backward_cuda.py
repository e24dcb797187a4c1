"""Wrapper of the router gate's backward kernel (``csrc/gate_backward.cu``).

Replaces no TPU kernel: the JAX package differentiates ``assign_ref``'s
masked row softmax and its gather at the picks with XLA's autodiff
(``src/repro/kernels/assign/ref.py:35-39, 68``).  One launch a call, one
warp a row (a warp walks a run of rows, the next one loading), its values a
lane matched to E; its plain version is ``ref.gate_backward_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build

# kernel launches since the count was last reset (see chip_smoke.py)
launches = 0


def _lib():
    lib = _build.load("gate_backward")
    if lib.gate_backward_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gate_backward_max_bins.argtypes = []
        lib.gate_backward_max_bins.restype = i
        lib.gate_backward_launch.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, p]
        lib.gate_backward_launch.restype = i
    return lib


def gate_backward_cuda(scores: torch.Tensor, idx: torch.Tensor,
                       dgate: torch.Tensor) -> torch.Tensor:
    """The scores' gradient ``f32[..., N, E]`` of the gates ``assign`` picked:
    ``scores f32[..., N, E]``, ``idx i32[..., N, k]`` (-1 for an infeasible
    pick) and the gates' gradient ``dgate f32[..., N, k]``, contiguous, on
    one CUDA device, E at most 512; raises on anything else."""
    global launches
    if scores.dim() < 2:
        raise ValueError(f"scores must be [..., N, E], got {tuple(scores.shape)}")
    lead, E = scores.shape[:-1], scores.shape[-1]
    k = idx.shape[-1] if idx.dim() else 0
    for name, t, dtype, shape in (("scores", scores, torch.float32, tuple(scores.shape)),
                                  ("idx", idx, torch.int32, (*lead, k)),
                                  ("dgate", dgate, torch.float32, (*lead, k))):
        if not t.is_cuda or t.device != scores.device:
            raise ValueError(f"{name} must lie on the CUDA device of scores")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _lib()
    if k < 1 or not 1 <= E <= lib.gate_backward_max_bins():
        raise ValueError(f"the kernel takes k >= 1 and 1 <= E <= "
                         f"{lib.gate_backward_max_bins()}, got k={k}, E={E}")
    out = torch.empty_like(scores)
    rows = scores.numel() // E
    with torch.cuda.device(scores.device):
        rc = lib.gate_backward_launch(scores.data_ptr(), idx.data_ptr(), dgate.data_ptr(),
                                      out.data_ptr(), rows, E, k,
                                      _build.stream_handle(scores.device))
    if rc != 0:
        raise RuntimeError(f"gate backward kernel launch failed: cudaError {rc}")
    launches += 1
    return out
