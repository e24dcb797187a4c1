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
