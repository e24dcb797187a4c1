"""Per-segment sums: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors.

On the card an f32 sum that needs a gradient goes through ``_SegmentSum``:
the forward is the kernel, unchanged (plus the rows' gather index, kept for
the backward); the backward gathers ``grad_out`` at each row's segment
(zero for rows whose id lies outside ``[0, num_segments)``), the transpose
of the scatter, as plain indexing.  Sums
that need no gradient call the kernel directly.  The CPU's plain version
differentiates through ``index_add_``.
"""
from __future__ import annotations

import math

import torch

from .segment_sum_cuda import segment_sum_cuda

# backward passes run on the card since the count was last reset (see chip_smoke.py)
backward_launches = 0


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, seg, num_segments):
        out = segment_sum_cuda(values, seg, num_segments)
        inside = (seg >= 0) & (seg < num_segments)
        ctx.save_for_backward(torch.where(inside, seg, num_segments).long())
        return out

    @staticmethod
    def backward(ctx, grad_out):
        global backward_launches
        (idx,) = ctx.saved_tensors        # outside ids point at an appended zero row
        padded = torch.cat([grad_out, grad_out.new_zeros((1,) + grad_out.shape[1:])])
        backward_launches += 1
        return padded.index_select(0, idx), None, None


def segment_sum_ref(values: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Plain version: ``index_add_`` into one spare segment that collects the
    rows whose id is out of range.  On the CPU it adds rows in index order,
    as XLA's scatter does; on the GPU its atomics add in no fixed order."""
    inside = (seg >= 0) & (seg < num_segments)
    idx = torch.where(inside, seg, num_segments).long()
    out = torch.zeros((num_segments + 1,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, idx, values)[:num_segments]


def segment_sum(values: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum ``values`` (``[J]`` or ``[J, F]``, f32 or i32) per segment id, in row
    order; ids outside ``[0, num_segments)`` are dropped.

    With leading lane dimensions (``seg [..., J]``, ``values [..., J]`` or
    ``[..., J, F]``) each lane sums on its own, ``[..., num_segments(, F)]``,
    in one call over ``lanes * num_segments`` segments: lane ``l``'s segment
    ``s`` is id ``l * num_segments + s``.  A lane's out-of-range ids are
    dropped before the offset, so none reaches the next lane's segments;
    every segment still folds its rows in row order, so each lane gets the
    bits of its own call."""
    if seg.dim() > 1:
        lanes, J = seg.shape[:-1], seg.shape[-1]
        n = math.prod(lanes)
        off = torch.arange(0, n * num_segments, num_segments, dtype=seg.dtype,
                           device=seg.device).view(*lanes, 1)
        inside = (seg >= 0) & (seg < num_segments)
        ids = torch.where(inside, seg + off, n * num_segments).reshape(-1)
        tail = values.shape[seg.dim():]
        out = segment_sum(values.reshape(n * J, *tail), ids, n * num_segments)
        return out.view(*lanes, num_segments, *tail)
    if values.is_cuda:
        if values.requires_grad and torch.is_grad_enabled():
            return _SegmentSum.apply(values.contiguous(), seg.contiguous(), num_segments)
        return segment_sum_cuda(values.contiguous(), seg.contiguous(), num_segments)
    return segment_sum_ref(values, seg, num_segments)
