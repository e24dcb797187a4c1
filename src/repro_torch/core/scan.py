"""Float arithmetic in the order XLA on the CPU performs it.

The JAX package's results depend, in their last bits, on the order and the
rounding of a few float operations.  Whole runs of the port match them
exactly, on the CPU and on the GPU, because it spells those operations out:

- ``cumsum_f32``: XLA evaluates ``jnp.cumsum`` as a two-level scan of base
  16, here written as explicit f32 adds;
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

_BASE = 16


def _row_scan(cols):
    """Sequential f32 prefix sums over a list of equal-shape tensors."""
    out = [cols[0]]
    for col in cols[1:]:
        out.append(out[-1] + col)
    return torch.stack(out, dim=-1)


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` of a 1-D f32 tensor with XLA's bits: pad to a multiple of
    16, scan each row of 16 sequentially, scan the row totals the same way
    (recursively), and add each row's exclusive offset."""
    n = x.shape[0]
    if n <= 1:
        return x.clone()
    if n <= _BASE:
        return _row_scan(x.unbind(0))
    rows = -(-n // _BASE)
    padded = torch.zeros((rows * _BASE,), dtype=x.dtype, device=x.device)
    padded[:n] = x
    rc = _row_scan(padded.view(rows, _BASE).unbind(1))
    tot = cumsum_f32(rc[:, -1].contiguous())
    off = torch.cat([tot.new_zeros((1,)), tot[:-1]])
    return (rc + off[:, None]).reshape(-1)[:n]


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
