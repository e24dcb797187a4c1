"""The assignment kernels as simulator dispatch combinators, dense
(``make_capacity_assign``) and sparse top-k (``make_fused_capacity_assign``),
and as the MoE router (``moe_route``)."""
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


def moe_route(router_logits: torch.Tensor, *, k: int, capacity: int, block_n: int = 256):
    """Token->expert routing for the MoE layer: ``router_logits`` f32 ``[T, E]``,
    or ``[G, T, E]`` for G routing groups solved in one call, ->
    ``(expert i32[.., T, k], combine f32[.., T, k], slot i32[.., T, k],
    keep bool[.., T, k])``.  Every token has size 1 and every expert
    ``capacity`` slots; ``slot`` is the token's place in its expert's
    capacity buffer.  Combine weights are renormalised over the kept slots
    (the Switch/GShard convention).  ``block_n`` sets the rows whose picks are
    resolved slot-major together, so it changes the result for ``k > 1``."""
    return _route(assign, router_logits, k, capacity, block_n)


def moe_route_ref(router_logits: torch.Tensor, *, k: int, capacity: int, block_n: int = 256):
    """``moe_route`` through the plain assignment (``assign_ref``) on the
    logits' own device: the plain version of the kernel route."""
    return _route(assign_ref, router_logits, k, capacity, block_n)


def _route(assign_fn, router_logits, k, capacity, block_n):
    lanes = router_logits.shape[:-2]
    T, E = router_logits.shape[-2:]
    dev = router_logits.device
    sizes = torch.ones((*lanes, T), dtype=torch.float32, device=dev)
    caps = torch.full((*lanes, E), float(capacity), dtype=torch.float32, device=dev)
    idx, gate, keep, pos = assign_fn(router_logits.float(), sizes, caps, k=k, block_n=block_n)
    combine = gate * keep
    norm = combine.sum(-1, keepdim=True).clamp_min(1e-9)
    combine = combine / norm * gate.sum(-1, keepdim=True).clamp(0.0, 1.0)
    return idx, combine, pos.int(), keep
