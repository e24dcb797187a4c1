"""The assignment kernel as a simulator dispatch combinator."""
from __future__ import annotations

import torch

from .assign_cuda import assign_cuda
from .ref import assign_ref


def assign(scores, sizes, caps, *, k: int = 1, block_n: int = 256):
    """Capacity-constrained greedy assignment (see ref.py for semantics): the
    Hopper kernel for CUDA tensors, the plain version for CPU tensors."""
    if scores.is_cuda:
        return assign_cuda(scores.contiguous(), sizes.contiguous(), caps.contiguous(),
                           k=k, block_n=block_n)
    return assign_ref(scores, sizes, caps, k=k, block_n=block_n)


def make_capacity_assign(jobs_cores: torch.Tensor | None = None, *, block_n: int = 256):
    """Build an engine-compatible ``Policy.assign`` fn: jobs -> sites under
    free-core capacity; jobs beyond capacity stay QUEUED at the main server."""

    def assign_fn(scores, queued, feasible, sites):
        NEG = -1e30
        masked = torch.where(feasible & queued[:, None], scores, NEG)
        sizes = (
            torch.ones((scores.shape[0],), dtype=torch.float32, device=scores.device)
            if jobs_cores is None else jobs_cores.float()
        )
        sizes = torch.where(queued, sizes, 0.0)
        caps = torch.where(sites.active, sites.free_cores, 0).float()
        idx, gate, admit, pos = assign(masked, sizes, caps, k=1, block_n=block_n)
        ok = admit[:, 0] & queued
        return torch.where(ok, idx[:, 0], -1), ok

    return assign_fn
