"""Counter-based threefry2x32 keys, bit-compatible with ``jax.random``.

The engine's draws (the per-round key split, failure sampling, the random
policy) must give the same bits as the JAX package so that whole runs compare
exactly.  This module reproduces JAX's default stream, the "partitionable"
threefry layout: ``split``, ``fold_in`` and random bits all hash a 64-bit
element counter, given as (hi, lo) uint32 words, under the key.

A key is an ``int64[2]`` tensor holding two uint32 words, on the device of
the tensors it draws for.  The uint32 arithmetic runs in int64 with masking,
so it is exact on the CPU and the GPU alike.
"""
from __future__ import annotations

import math

import torch

from .scan import fma_f32

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: a 32-bit seed pads with a zero high word."""
    seed = int(seed)
    hi = 0 if -(2**31) <= seed < 2**31 else (seed % 2**64) >> 32
    return torch.tensor([hi, seed & _MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The 20-round threefry2x32 block function on counter words ``(x0, x1)``.
    ``key`` is ``[2]``, or ``[K, 2]`` to hash the counters under K keys at once
    (outputs ``[K, n]``)."""
    k0, k1 = key[..., 0:1], key[..., 1:2]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _counters(n: int, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``int64[num, 2]``, key ``i`` hashes counter ``i``."""
    hi, lo = _counters(num, key.device)
    return torch.stack(threefry2x32(key, hi, lo), dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter ``(0, data)`` under the key."""
    x = torch.tensor([0, int(data) & _MASK], dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key, x[:1], x[1:])
    return torch.cat([o0, o1])


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element (as int64), the XOR of both output words.
    With keys ``[K, 2]`` the result is ``[K, *shape]``, one draw per key."""
    hi, lo = _counters(math.prod(shape), key.device)
    o0, o1 = threefry2x32(key, hi, lo)
    return (o0 ^ o1).reshape(key.shape[:-1] + tuple(shape))


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform``'s float32 map: 23 mantissa bits in [1, 2), minus
    1, scaled with one rounding (``fma_f32``) and clamped below at ``minval``."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = float(torch.tensor(minval, dtype=torch.float32))
    span = float(torch.tensor(maxval, dtype=torch.float32) - lo)
    if lo == 0.0 and span == 1.0:
        out = floats  # f * 1 + 0 is exact: skip the float64 detour
    else:
        out = fma_f32(floats, span, lo)
    return torch.clamp_min(out, lo)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` for float32."""
    return uniform_from_bits(random_bits(key, shape), minval, maxval)
