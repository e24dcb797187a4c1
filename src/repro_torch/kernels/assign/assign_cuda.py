"""Wrapper of the Hopper assignment kernel (``csrc/assign.cu``).

Replaces the TPU kernel ``src/repro/kernels/assign/assign.py:_assign_kernel``
(entry point ``assign_pallas``).  The kernel reads the ``N x E`` f32 score
matrix once, so it is bound by device-memory bandwidth: 120 MB at the
engine's N=100000, E=300.  Three launches: rows (gates, picks and in-tile
prefixes), a scan of the tile totals, then positions and admits; see the
source.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build

# kernel launches since the count was last reset (see chip_smoke.py)
launches = 0
_SCRATCH: dict = {}   # scratch floats by (N, E, k, block_n)


def _lib():
    lib = _build.load("assign")
    if lib.assign_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.assign_launch.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p, p]
        lib.assign_launch.restype = i
        lib.assign_scratch_floats.argtypes = [i, i, i, i]
        lib.assign_scratch_floats.restype = ctypes.c_longlong
    return lib


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
    lib = _lib()
    floats = _SCRATCH.get((N, E, k, block_n))
    if floats is None:
        floats = _SCRATCH[N, E, k, block_n] = lib.assign_scratch_floats(N, E, k, block_n)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    rc = lib.assign_launch(
        scores.data_ptr(), sizes.data_ptr(), caps.data_ptr(), N, E, k, block_n,
        idx.data_ptr(), gate.data_ptr(), admit.data_ptr(), pos.data_ptr(), scratch.data_ptr(),
        _build.stream_handle(dev),
    )
    if rc != 0:
        raise RuntimeError(f"assign kernel launch failed: cudaError {rc}")
    launches += 1
    return idx, gate, admit, pos
