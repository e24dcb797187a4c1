"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the TPU kernel
``src/repro/kernels/flash_attention/flash_attention.py:_flash_kernel`` (entry
point ``flash_attention_pallas``).  At the serving shape (B=4, H=32,
S=4096, D=128, causal) the kernel does 0.55 TFLOP against 0.54 GB of
inputs and output, so it is bound by operations.  bfloat16 inputs with
D = 64 or 128 run on Hopper's TMA, ``wgmma`` and warp-specialised path
(``flash_fwd_kernel_wgmma``); bf16 with D = 16, 32 or 96 on ``mma.sync``;
float32 inputs, and bf16 with a larger D, in f32 on the CUDA cores.  See the
source for the tiling.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build

# kernel launches since the count was last reset (see chip_smoke.py)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# codes of flash_attention_launch above every cudaError_t (see the source)
_TENSOR_MAP_ERROR, _NO_ENCODER = 100000, 200000


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_launch.restype is not ctypes.c_int or \
            lib.flash_attention_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_supports.argtypes = [i]
        lib.flash_attention_supports.restype = i
        lib.flash_attention_row_align.argtypes = [i, i]
        lib.flash_attention_row_align.restype = i
        lib.flash_attention_wgmma_smem_bytes.argtypes = [i]
        lib.flash_attention_wgmma_smem_bytes.restype = i
        lib.flash_attention_launch.argtypes = [
            p, p, p, p, i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_float, i, i, p,
        ]
        lib.flash_attention_launch.restype = i
    return lib


def _rows_aligned(t: torch.Tensor, align: int) -> bool:
    return t.data_ptr() % align == 0 and all(
        st * t.element_size() % align == 0 for st in t.stride()[:3])


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         scale: float | None = None) -> torch.Tensor:
    """Launch the kernel; same contract as ``ref.attention_ref``.  Takes
    ``q [B,Hq,S,D]`` and ``k``/``v [B,Hkv,Skv,D]`` of one dtype (float32 or
    bfloat16) on one CUDA device, each with a contiguous last dimension (other
    strides are free, so the transposed views of a projection need no copy),
    ``Hq % Hkv == 0`` and D in 16, 32, 64, 96, 128, 192, 256; raises on
    anything else.  A tensor whose rows do not start where the kernel needs
    (16 bytes on the tensor-core paths, the TMA's rule on the wgmma path) is
    copied first.  Returns a
    contiguous ``[B,Hq,S,D]`` in q's dtype."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D [B, H, S, D], got {tuple(t.shape)}")
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on the CUDA device of q")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must have q's dtype {q.dtype}, got {t.dtype}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dimension")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    B, Hq, S, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if tuple(k.shape) != (B, Hkv, Skv, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be [B, Hkv, Skv, D] = [{B}, *, *, {D}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if Hkv < 1 or Hq % Hkv != 0:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    lib = _lib()
    if not lib.flash_attention_supports(D):
        raise ValueError(f"head dimension D={D} is not compiled into the kernel")
    align = lib.flash_attention_row_align(_DTYPES[q.dtype], D)
    q, k, v = (t if _rows_aligned(t, align) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    scale = float(scale if scale is not None else D ** -0.5)
    out = torch.empty((B, Hq, S, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v) for s in t.stride()[:3]))
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        B, Hq, Hkv, S, Skv, D, strides, scale, int(causal), int(window),
        _build.stream_handle(q.device),
    )
    if rc >= _NO_ENCODER:
        raise RuntimeError("flash attention: the driver has no cuTensorMapEncodeTiled")
    if rc >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"flash attention: the driver refused a tensor map: CUresult "
                           f"{rc - _TENSOR_MAP_ERROR}")
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {rc}")
    launches += 1
    return out
