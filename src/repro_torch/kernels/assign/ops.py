"""The assignment kernels as simulator dispatch combinators: dense
(``make_capacity_assign``) and sparse top-k (``make_fused_capacity_assign``)."""
from __future__ import annotations

import torch

from .assign_cuda import assign_cuda
from .fused_cuda import fused_assign_cuda
from .fused_ref import fused_assign_ref
from .ref import assign_ref


def assign(scores, sizes, caps, *, k: int = 1, block_n: int = 256):
    """Capacity-constrained greedy assignment (see ref.py for semantics), one
    problem ``[N, E]`` or K of them ``[K, N, E]``: the Hopper kernel for CUDA
    tensors (one set of launches for all K), the plain version for CPU
    tensors."""
    if scores.is_cuda:
        return assign_cuda(scores.contiguous(), sizes.contiguous(), caps.contiguous(),
                           k=k, block_n=block_n)
    return assign_ref(scores, sizes, caps, k=k, block_n=block_n)


def _sizes_and_caps(jobs_cores, queued, sites):
    """Capacity units per queued job (its cores, or 1) and free cores per
    active site, as f32."""
    sizes = (
        torch.ones(queued.shape, dtype=torch.float32, device=queued.device)
        if jobs_cores is None else jobs_cores.float()
    )
    sizes = torch.where(queued, sizes, 0.0)
    caps = torch.where(sites.active, sites.free_cores, 0).float()
    return sizes, caps


def make_capacity_assign(jobs_cores: torch.Tensor | None = None, *, block_n: int = 256):
    """Build an engine-compatible ``Policy.assign`` fn: jobs -> sites under
    free-core capacity; jobs beyond capacity stay QUEUED at the main server.
    In an ensemble (``scores [K, J, S]``) every lane is its own problem, all
    in one call; ``jobs_cores`` is ``[J]`` (the same for every lane) or
    ``[K, J]``."""

    def assign_fn(scores, queued, feasible, sites):
        NEG = -1e30
        masked = torch.where(feasible & queued[..., None], scores, NEG)
        sizes, caps = _sizes_and_caps(jobs_cores, queued, sites)
        idx, gate, admit, pos = assign(masked, sizes, caps, k=1, block_n=block_n)
        ok = admit[..., 0] & queued
        return torch.where(ok, idx[..., 0], -1), ok

    return assign_fn


def fused_topk_assign(scores_k, cand, sizes, caps, *, block_n: int = 256):
    """Fused candidate-set rank + capacity pick (see fused_ref.py for
    semantics), one problem ``[N, K]`` or L of them ``[L, N, K]``: the Hopper
    kernel for CUDA tensors (one set of launches for all L), the plain
    version with row blocks of ``block_n`` for CPU tensors."""
    if scores_k.is_cuda:
        return fused_assign_cuda(scores_k.float().contiguous(), cand.int().contiguous(),
                                 sizes.float().contiguous(), caps.float().contiguous())
    return fused_assign_ref(scores_k, cand, sizes, caps, block_n=block_n)


def make_fused_capacity_assign(jobs_cores: torch.Tensor | None = None, *, block_n: int = 256):
    """Build an engine-compatible ``Policy.assign_cand`` fn for sparse top-k
    mode (``simulate(..., topk=)``): rank each job's candidate set and admit
    under free-core capacity in one fused pass, without the dense ``[J, S]``
    masked-score matrix that ``make_capacity_assign`` builds.  With candidates
    covering all feasible sites (``topk >= S``) the result equals the dense
    ``make_capacity_assign`` path bit for bit.  In an ensemble (``scores_k
    [L, J, K]``) every lane is its own problem, all in one call;
    ``jobs_cores`` is ``[J]`` or ``[L, J]``."""

    def assign_cand(scores_k, queued, feas_k, cand, sites):
        S = sites.capacity
        cand_eff = torch.where(feas_k & queued[..., None], cand, S).int()
        sizes, caps = _sizes_and_caps(jobs_cores, queued, sites)
        site, admit = fused_topk_assign(scores_k, cand_eff, sizes, caps, block_n=block_n)
        ok = admit & queued
        return torch.where(ok, site, -1), ok

    return assign_cand
