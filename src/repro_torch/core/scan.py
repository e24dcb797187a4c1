"""Float arithmetic in the order XLA on the CPU performs it.

The JAX package's results depend, in their last bits, on the order and the
rounding of a few float operations.  Whole runs of the port match them
exactly, on the CPU and on the GPU, because it spells those operations out:

- ``cumsum_f32``: XLA evaluates ``jnp.cumsum`` as a two-level scan of base
  16, here written as explicit f32 adds;
- ``sum_f32``: XLA reduces a long axis in windows of 32, then the windows
  (on the GPU, for few enough windows, one segment-sum launch a level);
- ``segment_sum_f32``: XLA's scatter adds rows in index order; the port's
  segment sum keeps that order on the GPU too (a CUDA kernel, no atomics);
- ``fma_f32``: XLA contracts ``x * y + z`` into one fused multiply-add.

XLA also rewrites ``A / (B / C)`` as ``(A * C) / B``; the engine writes its
shared-link stage times in that form (``engine.stage_in_time``).

Integer sums are exact in any order and need none of this.
"""
from __future__ import annotations

import struct

import torch

from ..kernels.segment_sum import segment_sum

_BASE = 16     # cumsum row length
_WINDOW = 32   # reduce window
# float segment sums up to this many segments take one launch of the
# segment-sum kernel (``segment_sum.cu``); above it, one launch a window
_ONE_LAUNCH_SEGMENTS = 25599


def _row_scan(cols, dim: int):
    """Sequential f32 prefix sums over a list of equal-shape tensors, stacked
    along ``dim``."""
    out = [cols[0]]
    for col in cols[1:]:
        out.append(out[-1] + col)
    return torch.stack(out, dim=dim)


def cumsum_f32(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.cumsum(x, axis=dim)`` of an f32 tensor with XLA's bits: pad the
    axis to a multiple of 16, scan each row of 16 sequentially, scan the row
    totals the same way (recursively), and add each row's exclusive offset.
    Every position of the other axes is scanned on its own."""
    dim %= max(x.dim(), 1)
    if dim != 0:
        return cumsum_f32(x.movedim(dim, 0), 0).movedim(0, dim)
    n, rest = x.shape[0], x.shape[1:]
    if n <= 1:
        return x.clone()
    if n <= _BASE:
        return _row_scan(x.unbind(0), 0)
    rows = -(-n // _BASE)
    padded = x.new_zeros((rows * _BASE, *rest))
    padded[:n] = x
    rc = _row_scan(padded.view(rows, _BASE, *rest).unbind(1), 1)
    tot = cumsum_f32(rc[:, -1].contiguous())
    off = torch.cat([tot.new_zeros((1, *rest)), tot[:-1]])
    return (rc + off[:, None]).reshape(rows * _BASE, *rest)[:n]


def sum_f32(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.sum(x, axis=dim)`` of an f32 tensor with XLA's bits.  An axis of
    up to 32 adds sequentially from 0; a longer one is cut into windows of 32
    (its zero padding split between the two ends, the smaller half first),
    each window adds sequentially, and the window sums reduce the same way."""
    if dim != 0:
        return sum_f32(x.movedim(dim, 0), 0)
    n, rest = x.shape[0], x.shape[1:]
    if x.is_cuda and n and x.numel() // n * -(-n // _WINDOW) <= _ONE_LAUNCH_SEGMENTS:
        return _sum_f32_segments(x)
    if n > _WINDOW:
        pad = -n % _WINDOW
        lo = pad // 2
        padded = x.new_zeros((n + pad, *rest))
        padded[lo:lo + n] = x
        x = padded.view(-1, _WINDOW, *rest).transpose(0, 1)
        return sum_f32(sum_f32(x, 0), 0)
    acc = x.new_zeros(rest)
    for row in x.unbind(0):
        acc = acc + row
    return acc


def _sum_f32_segments(x: torch.Tensor) -> torch.Tensor:
    """``sum_f32(x, 0)`` with each level's windows as segments of one
    segment sum: the kernel folds a segment's rows in order from +0.0,
    which is the sequential window sum.  One launch a level instead of one
    a row; the same bits."""
    n, rest = x.shape[0], x.shape[1:]
    if n == 0:
        return x.new_zeros(rest)
    cols = x.reshape(n, -1).t()                          # [M, n]: one row a sum
    while True:
        n = cols.shape[1]
        w = _WINDOW if n > _WINDOW else n
        if n > _WINDOW and n % _WINDOW:
            pad = -n % _WINDOW
            cols = torch.nn.functional.pad(cols, (pad // 2, pad - pad // 2))
        flat = cols.reshape(-1)
        seg = torch.arange(flat.shape[0], dtype=torch.int32, device=flat.device) // w
        cols = segment_sum(flat, seg, flat.shape[0] // w).view(cols.shape[0], -1)
        if w == n:
            return cols.reshape(rest)


def segment_sum_f32(values: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment sums of f32 ``values`` added in row order (ids outside
    ``[0, num_segments)`` dropped): XLA's ``segment_sum`` bits, and the same
    bits on every run on the GPU."""
    return segment_sum(values, seg, num_segments)


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add does
    (``b`` and ``c`` are float32 tensors or Python floats holding float32
    values).

    The product of two float32 values is exact in float64, and so is the error
    of the float64 sum (TwoSum).  The float64 sum then rounds to the right
    float32 unless it lies exactly on a float32 midpoint, where the sign of
    the error decides the direction.
    """
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
    c = c.double() if isinstance(c, torch.Tensor) else float(c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    midpoint = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(torch.float64)
    s = torch.where(midpoint & (err != 0), torch.nextafter(s, toward), s)
    return s.float()


def _f32(v: float) -> float:
    """``v`` rounded to float32 (``fma_f32`` takes its Python floats as is)."""
    return struct.unpack("f", struct.pack("f", v))[0]


# XLA:CPU's own f32 ``exp`` and ``log`` (Cephes polynomials, the multiply-
# adds contracted to FMAs); ``torch.exp``/``torch.log`` differ from them in
# the last bit on ~10% of inputs.  Every constant is a float32 value.
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
          1.6666665459e-1, 5.0000001201e-1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
# log1p's Cephes rational form for |x| < sqrt(2) - 1, highest power first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_EXP_P, _LOG_P, _LOG1P_NUM, _LOG1P_DEN = (
    tuple(map(_f32, c)) for c in (_EXP_P, _LOG_P, _LOG1P_NUM, _LOG1P_DEN))
_LOG2E, _LN2_HI, _LN2_LO = _f32(1.44269504088896341), 0.693359375, _f32(-2.12194440e-4)
_SQRT_HALF, _LOG1P_SMALL = _f32(0.707106781186547524), _f32(0.41421356237309504880)
_MIN_NORMAL = 1.1754943508222875e-38


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    t = x.clamp(-87.8, 88.8)
    fx = torch.floor(t * _LOG2E + 0.5)
    r = fma_f32(-fx, _LN2_HI, t)
    r = fma_f32(-fx, _LN2_LO, r)
    y = fma_f32(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = fma_f32(y, r, c)
    y = 1.0 + fma_f32(y, r * r, r)
    two_n = ((fx.nan_to_num().int() + 127) << 23).view(torch.float32)
    return torch.where(torch.isnan(x), x, y * two_n)


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    bits = torch.maximum(x, x.new_tensor(_MIN_NORMAL)).view(torch.int32)
    e = ((bits >> 23) - 126).float()
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)   # mantissa in [0.5, 1)
    small = m < _SQRT_HALF
    m = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.float()
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = fma_f32(fma_f32(m, p[0], p[1]), m, p[2])
    y1 = fma_f32(fma_f32(m, p[3], p[4]), m, p[5])
    y2 = fma_f32(fma_f32(m, p[6], p[7]), m, p[8])
    y = fma_f32(fma_f32(y, m3, y1), m3, y2) * m3
    out = ((m - m2 * 0.5) + (y + e * _LN2_LO)) + e * _LN2_HI
    out = torch.where(x == float("inf"), x, out)
    out = torch.where(x.abs() < _MIN_NORMAL, float("-inf"), out)   # subnormals flush to 0
    return torch.where((x < 0) | torch.isnan(x), float("nan"), out)


class _Exp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _exp_f32(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


class _Log(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _log_f32(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / x


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` of an f32 tensor with XLA:CPU's bits (exact on every input
    tested); the gradient is ``g * exp(x)``, as JAX's."""
    return _Exp.apply(x)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of an f32 tensor in XLA:CPU's form; one input in ~1000
    still differs in the last bit.  The gradient is ``g / x``, as JAX's."""
    return _Log.apply(x)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's: the float64 root
    rounded once (53 bits are enough for a root to round right).  The CPU's
    f32 ``torch.sqrt`` is off by an ulp on ~0.6% of inputs."""
    return torch.sqrt(x.double()).to(x.dtype)


def _poly(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = fma_f32(p, x, c)
    return p


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` in XLA:CPU's form: ``log(1 + x)`` where ``|x| >= sqrt(2)
    - 1``, Cephes' rational form below.  No gradient."""
    x2 = x * x
    small = x + fma_f32(x2, -0.5, (x * x2) * (_poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN)))
    return torch.where(x.abs() < _LOG1P_SMALL, small, _log_f32(x + 1.0))
