"""Wrapper of the Hopper assignment kernels (``csrc/assign.cu``).

Replaces the TPU kernel ``src/repro/kernels/assign/assign.py:_assign_kernel``
(entry point ``assign_pallas``).  The source chooses one of three forms by
shape (:func:`plan` says which): the engine's one large problem (reading the
``N x E`` f32 scores once bounds it: 120 MB at N=100000, E=300) takes three
launches (rows, a scan of the tile totals, positions and admits); a problem
of at most 8 tiles (the MoE router's groups) takes one launch of a
thread-block cluster a problem; a larger routing problem (k > 1) takes the
cluster form's tile kernel with the same scan and place launches.  With a
leading lane axis (``scores [K, N, E]``) the same launches solve K
independent problems.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build

# kernel launches since the count was last reset (see chip_smoke.py)
launches = 0
_SCRATCH: dict = {}   # scratch floats by (K, N, E, k, block_n)


def _lib():
    lib = _build.load("assign")
    if lib.assign_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.assign_launch.argtypes = [p, p, p, i, i, i, i, i, p, p, p, p, p, p]
        lib.assign_launch.restype = i
        lib.assign_scratch_floats.argtypes = [i, i, i, i, i]
        lib.assign_scratch_floats.restype = ctypes.c_longlong
        lib.assign_plan.argtypes = [i, i, i, i, i, p]
        lib.assign_plan.restype = None
    return lib


FORMS = ("rows", "cluster", "tiles")
# the kernels each form launches (profiler names hold these)
FORM_KERNELS = {
    "rows": ("assign_rows_kernel", "assign_base_kernel", "assign_place_kernel"),
    "cluster": ("assign_cluster_kernel",),
    "tiles": ("assign_tile_kernel", "assign_base_kernel", "assign_place_kernel"),
}


def plan(K: int, N: int, E: int, k: int, block_n: int) -> dict:
    """The form ``assign_cuda`` takes for ``K`` problems of ``[N, E]`` at
    ``k`` picks and row blocks of ``block_n``, as the source chooses it:
    ``form``, ``tile_rows``, ``ctas`` (a problem's CTAs: its cluster's size
    in the cluster form), ``launches`` a call and ``kernels`` (their
    names).  Builds the library."""
    out = (ctypes.c_int * 4)()
    _lib().assign_plan(K, N, E, k, block_n, out)
    form = FORMS[out[0]]
    return dict(form=form, tile_rows=out[1], ctas=out[2], launches=out[3],
                kernels=FORM_KERNELS[form])


def assign_cuda(scores: torch.Tensor, sizes: torch.Tensor, caps: torch.Tensor, *,
                k: int = 1, block_n: int = 256):
    """Launch the kernel; same contract as ``ref.assign_ref``.  Takes
    contiguous float32 ``scores [N, E]``, ``sizes [N]``, ``caps [E]``, or a
    batch of K problems ``[K, N, E]``, ``[K, N]``, ``[K, E]`` (outputs
    ``[K, N, k]``), on one CUDA device and raises on anything else."""
    global launches
    if scores.dim() not in (2, 3):
        raise ValueError(f"scores must be [N, E] or [K, N, E], got {tuple(scores.shape)}")
    lanes = scores.shape[:-2]
    K = scores.shape[0] if lanes else 1
    N, E = scores.shape[-2:]
    for name, t, shape in (("scores", scores, (*lanes, N, E)), ("sizes", sizes, (*lanes, N)),
                           ("caps", caps, (*lanes, E))):
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
    out = (*lanes, N, k)
    idx = torch.empty(out, dtype=torch.int32, device=dev)
    gate = torch.empty(out, dtype=torch.float32, device=dev)
    admit = torch.empty(out, dtype=torch.bool, device=dev)
    pos = torch.empty(out, dtype=torch.float32, device=dev)
    if K == 0:
        return idx, gate, admit, pos
    lib = _lib()
    floats = _SCRATCH.get((K, N, E, k, block_n))
    if floats is None:
        floats = _SCRATCH[K, N, E, k, block_n] = lib.assign_scratch_floats(K, N, E, k, block_n)
    # the cluster form keeps its tile totals in shared memory: no scratch
    scratch = torch.empty(floats, dtype=torch.float32, device=dev) if floats else None
    with torch.cuda.device(dev):
        rc = lib.assign_launch(
            scores.data_ptr(), sizes.data_ptr(), caps.data_ptr(), K, N, E, k, block_n,
            idx.data_ptr(), gate.data_ptr(), admit.data_ptr(), pos.data_ptr(),
            scratch.data_ptr() if floats else None, _build.stream_handle(dev),
        )
    if rc != 0:
        raise RuntimeError(f"assign kernel launch failed: cudaError {rc}")
    launches += 1
    return idx, gate, admit, pos
