"""Wrapper of the Hopper fused candidate-set assignment kernel
(``csrc/fused.cu``).

Replaces the TPU kernel ``src/repro/kernels/assign/fused.py:_fused_kernel``
(entry point ``fused_assign_pallas``), also batched over lanes as ``jax.vmap``
runs it.  The kernel reads the ``N x K`` f32 scores and i32 candidates once,
so it is bound by device-memory bandwidth: 13.7 MB at the engine's N=100000,
K=16, E=300.  Three launches: rows (picks and in-tile prefixes over 256-row
tiles), a scan of the per-site tile totals, then positions and admits; see
the source.  With a leading lane axis (``scores_k [L, N, K]``) the same three
launches solve L independent problems.  ``with_pos=True`` also returns each
row's ``pos``, the units its site had claimed before it (4 bytes a row more).
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
        lib.fused_launch.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p, p]
        lib.fused_launch.restype = i
    return lib


def fused_assign_cuda(scores_k: torch.Tensor, cand: torch.Tensor, sizes: torch.Tensor,
                      caps: torch.Tensor, *, with_pos: bool = False):
    """Launch the kernel; same contract as ``fused_ref.fused_assign_ref``
    (whose ``block_n`` does not change the result for integral sizes):
    ``(site, admit)``, or ``(site, admit, pos)`` with ``with_pos``.  Takes
    contiguous float32 ``scores_k [N, K]``, int32 ``cand [N, K]``, float32
    ``sizes [N]`` and ``caps [E]``, or a batch of L problems ``[L, N, K]``,
    ``[L, N, K]``, ``[L, N]``, ``[L, E]`` (outputs ``[L, N]``), on one CUDA
    device, ``K, E >= 1``, and raises on anything else."""
    global launches, _TILE_ROWS
    if scores_k.dim() not in (2, 3):
        raise ValueError(f"scores_k must be [N, K] or [L, N, K], got {tuple(scores_k.shape)}")
    lanes = tuple(scores_k.shape[:-2])
    L = lanes[0] if lanes else 1
    N, K = scores_k.shape[-2:]
    E = caps.shape[-1] if caps.dim() == len(lanes) + 1 else -1
    for name, t, dtype, shape in (("scores_k", scores_k, torch.float32, (*lanes, N, K)),
                                  ("cand", cand, torch.int32, (*lanes, N, K)),
                                  ("sizes", sizes, torch.float32, (*lanes, N)),
                                  ("caps", caps, torch.float32, (*lanes, E))):
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
    dev = scores_k.device
    rows = L * N
    lib = _lib()
    if _TILE_ROWS is None:
        _TILE_ROWS = lib.fused_tile_rows()
    tiles = -(-N // _TILE_ROWS)
    # one allocation: site i32[L*N], local f32[L*N], tile totals f32[L, E, tiles],
    # pos f32[L*N] (with_pos), admit bool[L*N]
    tot = 8 * rows + 4 * L * E * tiles
    buf = torch.empty((tot + (4 * rows if with_pos else 0) + rows,), dtype=torch.uint8,
                      device=dev)
    site = buf[:4 * rows].view(torch.int32).view(*lanes, N)
    pos = buf[tot:tot + 4 * rows].view(torch.float32).view(*lanes, N) if with_pos else None
    admit = buf[buf.numel() - rows:].view(torch.bool).view(*lanes, N)
    with torch.cuda.device(dev):
        rc = lib.fused_launch(
            scores_k.data_ptr(), cand.data_ptr(), sizes.data_ptr(), caps.data_ptr(), L, N, K, E,
            site.data_ptr(), admit.data_ptr(), buf.data_ptr() + 4 * rows,
            buf.data_ptr() + 8 * rows, pos.data_ptr() if with_pos else None,
            _build.stream_handle(dev),
        )
    if rc != 0:
        raise RuntimeError(f"fused assign kernel launch failed: cudaError {rc}")
    launches += 1
    return (site, admit, pos) if with_pos else (site, admit)
