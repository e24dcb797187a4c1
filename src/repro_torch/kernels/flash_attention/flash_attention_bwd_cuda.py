"""Wrapper of the flash-attention backward kernels (``csrc/flash_attention_bwd.cu``).

Replaces no TPU kernel: the JAX package differentiates its plain chunked
attention with XLA's autodiff (``src/repro/kernels/flash_attention/ops.py:34``).
Three launches a call (preprocess: ``rowsum(dO * O)``; dK/dV, a CTA a key
tile and KV head; dQ, a CTA a q tile and head), no atomics, each row's
softmax taken from the log-sum-exp that the forward kernel saved: on TMA and
``wgmma`` for bf16 at D = 64, 128 and 256, on ``mma.sync`` for bf16 at
D = 16, 32 and 96, in f32 on the CUDA cores otherwise; see the source.  Its
plain version is ``ref.attention_bwd_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build
from .flash_attention_cuda import _NO_ENCODER, _TENSOR_MAP_ERROR, _rows_aligned

# calls that launched the kernels since the count was last reset (see chip_smoke.py)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("flash_attention_bwd")
    if lib.flash_attention_bwd_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd_supports.argtypes = [i]
        lib.flash_attention_bwd_supports.restype = i
        lib.flash_attention_bwd_row_align.argtypes = [i, i]
        lib.flash_attention_bwd_row_align.restype = i
        lib.flash_attention_bwd_scratch_floats.argtypes = [i, i, i, i, i]
        lib.flash_attention_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.flash_attention_bwd_launch.argtypes = [
            p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, i, p,
        ]
        lib.flash_attention_bwd_launch.restype = i
    return lib


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                                  causal: bool = True, window: int = 0,
                                  scale: float | None = None):
    """``(dq, dk, dv)`` of attention ``o, lse = attention_ref(q, k, v,
    causal=, window=, scale=, return_lse=True)`` given the output's gradient
    ``do``, each in the inputs' dtype.  Takes ``q [B,Hq,S,D]`` and
    ``k``/``v [B,Hkv,Skv,D]`` (contiguous last dimension, other strides free;
    a tensor whose rows do not start on 16 bytes on the tensor-core paths is
    copied first), ``o`` and ``do [B,Hq,S,D]`` of one dtype (float32 or
    bfloat16) on one CUDA device, the forward's float32 log-sum-exp
    ``lse [B,Hq,S]``, ``Hq % Hkv == 0`` and D in 16, 32, 64, 96, 128, 192,
    256; raises on anything else."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do), ("lse", lse)):
        if t.dim() != (3 if name == "lse" else 4):
            raise ValueError(f"{name} must be 4-D [B, H, S, D] (lse 3-D [B, H, S]), got "
                             f"{tuple(t.shape)}")
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on the CUDA device of q")
        if name == "lse":
            continue
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must have q's dtype {q.dtype}, got {t.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    B, Hq, S, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if tuple(k.shape) != (B, Hkv, Skv, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be [B, Hkv, Skv, D] = [{B}, *, *, {D}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"o and do must have q's shape {tuple(q.shape)}")
    if tuple(lse.shape) != (B, Hq, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [{B}, {Hq}, {S}], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if Hkv < 1 or Hq % Hkv != 0:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    lib = _lib()
    if not lib.flash_attention_bwd_supports(D):
        raise ValueError(f"head dimension D={D} is not compiled into the backward kernel")
    align = lib.flash_attention_bwd_row_align(_DTYPES[q.dtype], D)
    q, k, v = (t if t.stride(-1) == 1 and _rows_aligned(t, align)
               else t.clone(memory_format=torch.contiguous_format) for t in (q, k, v))
    o, do = (t if t.is_contiguous() and t.data_ptr() % align == 0
             else t.clone(memory_format=torch.contiguous_format) for t in (o, do))
    if not lse.is_contiguous() or lse.data_ptr() % 16 != 0:
        lse = lse.clone(memory_format=torch.contiguous_format)
    dq = torch.empty((B, Hq, S, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, Skv, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    scratch = torch.empty(lib.flash_attention_bwd_scratch_floats(_DTYPES[q.dtype], D, B, Hq, S),
                          dtype=torch.float32, device=q.device)  # delta (and a padded lse)
    scale = float(scale if scale is not None else D ** -0.5)
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), _DTYPES[q.dtype],
            B, Hq, Hkv, S, Skv, D, strides, scale, int(causal), int(window),
            _build.stream_handle(q.device),
        )
    if rc >= _NO_ENCODER:
        raise RuntimeError("flash attention backward: the driver has no cuTensorMapEncodeTiled")
    if rc >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"flash attention backward: the driver refused a tensor map: CUresult "
                           f"{rc - _TENSOR_MAP_ERROR}")
    if rc != 0:
        raise RuntimeError(f"flash attention backward launch failed: cudaError {rc}")
    launches += 1
    return dq, dk, dv
