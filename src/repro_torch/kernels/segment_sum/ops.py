"""Per-segment sums: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors."""
from __future__ import annotations

import torch

from .segment_sum_cuda import segment_sum_cuda


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
    order; ids outside ``[0, num_segments)`` are dropped."""
    if values.is_cuda:
        return segment_sum_cuda(values.contiguous(), seg.contiguous(), num_segments)
    return segment_sum_ref(values, seg, num_segments)
