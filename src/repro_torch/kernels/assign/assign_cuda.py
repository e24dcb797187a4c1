"""Wrapper of the Hopper assignment kernel (``csrc/assign.cu``).

Replaces the TPU kernel ``src/repro/kernels/assign/assign.py:_assign_kernel``
(entry point ``assign_pallas``).  The kernel reads the ``N x E`` f32 score
matrix once, so it is bound by device-memory bandwidth: 120 MB at the
engine's N=100000, E=300.  See the source for the two-pass design.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build

# kernel launches since the count was last reset (see chip_smoke.py)
launches = 0


def _fn():
    fn = _build.load("assign").assign_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def assign_cuda(scores: torch.Tensor, sizes: torch.Tensor, caps: torch.Tensor, *,
                k: int = 1, block_n: int = 256):
    """Launch the kernel; same contract as ``ref.assign_ref``.  Takes
    contiguous float32 ``scores [N, E]``, ``sizes [N]``, ``caps [E]`` on one
    CUDA device and raises on anything else."""
    global launches
    if scores.dim() != 2:
        raise ValueError(f"scores must be [N, E], got {tuple(scores.shape)}")
    N, E = scores.shape
    for name, t, shape in (("scores", scores, (N, E)), ("sizes", sizes, (N,)),
                           ("caps", caps, (E,))):
        if not t.is_cuda or t.device != scores.device:
            raise ValueError(f"{name} must lie on the CUDA device of scores")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k < 1 or block_n < 1:
        raise ValueError(f"k and block_n must be positive, got k={k}, block_n={block_n}")
    dev = scores.device
    idx = torch.empty((N, k), dtype=torch.int32, device=dev)
    gate = torch.empty((N, k), dtype=torch.float32, device=dev)
    admit = torch.empty((N, k), dtype=torch.bool, device=dev)
    pos = torch.empty((N, k), dtype=torch.float32, device=dev)
    rc = _fn()(
        scores.data_ptr(), sizes.data_ptr(), caps.data_ptr(), N, E, k, block_n,
        idx.data_ptr(), gate.data_ptr(), admit.data_ptr(), pos.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"assign kernel launch failed: cudaError {rc}")
    launches += 1
    return idx, gate, admit, pos
