"""Wrapper of the Hopper fused candidate-set assignment kernel
(``csrc/fused.cu``).

Replaces the TPU kernel ``src/repro/kernels/assign/fused.py:_fused_kernel``
(entry point ``fused_assign_pallas``).  The kernel reads the ``N x K`` f32
scores and i32 candidates once, so it is bound by device-memory bandwidth:
13.7 MB at the engine's N=100000, K=16, E=300.  Three launches: rows (picks
and in-tile prefixes over 256-row tiles), a scan of the per-site tile
totals, then positions and admits; see the source.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build

# kernel launches since the count was last reset (see chip_smoke.py)
launches = 0
_TILE_ROWS = None   # rows of a tile (fused_tile_rows)


def _lib():
    lib = _build.load("fused")
    if lib.fused_launch.restype is not ctypes.c_int or lib.fused_launch.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.fused_tile_rows.argtypes = []
        lib.fused_tile_rows.restype = i
        lib.fused_launch.argtypes = [p, p, p, p, i, i, i, p, p, p, p, p]
        lib.fused_launch.restype = i
    return lib


def fused_assign_cuda(scores_k: torch.Tensor, cand: torch.Tensor, sizes: torch.Tensor,
                      caps: torch.Tensor):
    """Launch the kernel; same contract as ``fused_ref.fused_assign_ref``
    (whose ``block_n`` does not change the result for integral sizes).  Takes
    contiguous float32 ``scores_k [N, K]``, int32 ``cand [N, K]``, float32
    ``sizes [N]`` and ``caps [E]`` on one CUDA device, ``K, E >= 1``, and
    raises on anything else."""
    global launches, _TILE_ROWS
    if scores_k.dim() != 2:
        raise ValueError(f"scores_k must be [N, K], got {tuple(scores_k.shape)}")
    N, K = scores_k.shape
    E = caps.shape[0] if caps.dim() == 1 else -1
    for name, t, dtype, shape in (("scores_k", scores_k, torch.float32, (N, K)),
                                  ("cand", cand, torch.int32, (N, K)),
                                  ("sizes", sizes, torch.float32, (N,)),
                                  ("caps", caps, torch.float32, (E,))):
        if not t.is_cuda or t.device != scores_k.device:
            raise ValueError(f"{name} must lie on the CUDA device of scores_k")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if K < 1 or E < 1:
        raise ValueError(f"K and E must be positive, got K={K}, E={E}")
    lib = _lib()
    dev = scores_k.device
    if _TILE_ROWS is None:
        _TILE_ROWS = lib.fused_tile_rows()
    tiles = -(-N // _TILE_ROWS)
    # one allocation: site i32[N], local f32[N], tile totals f32[E, tiles], admit bool[N]
    buf = torch.empty((8 * N + 4 * E * tiles + N,), dtype=torch.uint8, device=dev)
    site = buf[:4 * N].view(torch.int32)
    admit = buf[buf.numel() - N:].view(torch.bool)
    with torch.cuda.device(dev):
        rc = lib.fused_launch(
            scores_k.data_ptr(), cand.data_ptr(), sizes.data_ptr(), caps.data_ptr(), N, K, E,
            site.data_ptr(), admit.data_ptr(), buf.data_ptr() + 4 * N,
            buf.data_ptr() + 8 * N, _build.stream_handle(dev),
        )
    if rc != 0:
        raise RuntimeError(f"fused assign kernel launch failed: cudaError {rc}")
    launches += 1
    return site, admit
