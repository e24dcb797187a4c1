"""Counter-based threefry2x32 keys, bit-compatible with ``jax.random``.

The engine's draws (the per-round key split, failure sampling, the random
policy) must give the same bits as the JAX package so that whole runs compare
exactly.  This module reproduces JAX's default stream, the "partitionable"
threefry layout: ``split``, ``fold_in`` and random bits all hash a 64-bit
element counter, given as (hi, lo) uint32 words, under the key.

A key is an ``int64[2]`` tensor holding two uint32 words, on the device of
the tensors it draws for.  The uint32 arithmetic runs in int64 with masking,
so it is exact on the CPU and the GPU alike.

The samplers built on ``uniform`` follow ``jax.random``'s float32 forms:
``bernoulli`` and ``rademacher`` use only uniform bits and are exact;
``normal`` is ``sqrt(2) * erf_inv(u)`` with XLA's f32 ``ErfInv`` and
``gumbel``/``categorical`` take ``log(-log(u))``, both through XLA:CPU's
``log``/``log1p`` as ``scan`` spells them, whose last bit still differs on
about one input in 2000.
"""
from __future__ import annotations

import math

import torch

from .scan import fma_f32, log1p_f32, log_f32, sqrt_f32

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
    """``jax.random.split``: ``int64[num, 2]``, key ``i`` hashes counter ``i``.
    A batch of keys ``[K, 2]`` splits to ``[K, num, 2]``, each row its own
    key's split."""
    hi, lo = _counters(num, key.device)
    return torch.stack(threefry2x32(key, hi, lo), dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter ``(0, data)`` under the key
    (``[2]``, or a batch ``[K, 2]`` folded key by key)."""
    x = torch.tensor([0, int(data) & _MASK], dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key, x[:1], x[1:])
    return torch.cat([o0, o1], -1)


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


def bernoulli(key: torch.Tensor, p: float = 0.5, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode "low"): ``uniform < p``, bool."""
    return uniform(key, shape) < p


def rademacher(key: torch.Tensor, shape, dtype=torch.int32) -> torch.Tensor:
    """``jax.random.rademacher``: ``2 * bernoulli(0.5) - 1`` in ``dtype``."""
    return 2 * bernoulli(key, 0.5, shape).to(dtype) - 1


# XLA's f32 ErfInv (Giles' single-precision polynomials in w = -log1p(-x*x),
# one for w < 5 and one in sqrt(w) above), highest power first
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_F32_MAX = 3.4028234663852886e38
_SQRT2 = 1.4142135381698608             # np.float32(np.sqrt(2))
_TINY = 1.1754943508222875e-38          # finfo(float32).tiny


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` of an f32 tensor in XLA's form (the polynomial's
    multiply-adds contracted to FMAs); +-1 give +-inf."""
    w = -log1p_f32(x * -x)
    low = w < 5.0
    w = torch.where(low, w - 2.5, sqrt_f32(w) - 3.0)
    coeff = [torch.where(low, torch.tensor(a, dtype=torch.float32, device=x.device),
                         torch.tensor(b, dtype=torch.float32, device=x.device))
             for a, b in zip(_ERFINV_LO, _ERFINV_HI)]
    p = coeff[0].expand_as(x)
    for c in coeff[1:]:
        p = fma_f32(p, w, c)
    return torch.where(x.abs() == 1.0, x * _F32_MAX, p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` for float32: ``sqrt(2) * erf_inv(u)`` with ``u``
    uniform on ``[nextafter(-1, 0), 1)``."""
    u = uniform(key, shape, minval=-0.99999994, maxval=1.0)
    return _SQRT2 * erf_inv(u)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): ``-log(-log(u))`` with ``u``
    uniform on ``[tiny, 1)``."""
    return -log_f32(-log_f32(uniform(key, shape, minval=_TINY, maxval=1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical`` with replacement: the first argmax of
    ``logits + gumbel`` along ``axis`` (int64 indices)."""
    return (gumbel(key, tuple(logits.shape)) + logits).argmax(axis)
