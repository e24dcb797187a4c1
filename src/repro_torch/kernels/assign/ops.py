"""The assignment kernels as simulator dispatch combinators, dense
(``make_capacity_assign``) and sparse top-k (``make_fused_capacity_assign``),
and as the MoE router (``moe_route``), whose gates carry a gradient to the
router's scores (``_AssignGate``: the gate backward kernel for CUDA tensors,
its plain version for CPU tensors).

The two dispatch combinators split over a job-parallel mesh
(``core.distributed.simulate_distributed``): given ``block=`` (this rank's
``JobBlock``) they solve only the block's rows and admit them behind the
claims of the lower ranks' blocks (``block_admit``); their ``splits_rows``
attribute tells the engine so.

The assignment and the gate backward are the custom ops
``repro_torch::assign`` and ``repro_torch::gate_backward``: a CUDA
implementation that launches the kernel, a CPU one that is the plain
version, a fake one for meta and fake tensors, and a FLOP formula that
``torch.utils.flop_counter`` reads.  Registering them builds nothing."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from ...core.types import take
from ..segment_sum import segment_sum

from .assign_cuda import assign_cuda
from .fused_cuda import fused_assign_cuda
from .fused_ref import fused_assign_ref
from .gate_backward_cuda import gate_backward_cuda
from .ref import assign_ref, gate_backward_ref

# f32 operations an element of the scores: the assignment's mask, max,
# subtract, exp, add, argmax compare and select; the gate backward's mask,
# max, exp, normalise, fold, dot and product
ASSIGN_OPS_PER_SCORE = 7
GATE_BACKWARD_OPS_PER_SCORE = 7

_lib = torch.library.Library("repro_torch", "FRAGMENT")
_lib.define("assign(Tensor scores, Tensor sizes, Tensor caps, int k, int block_n) "
            "-> (Tensor, Tensor, Tensor, Tensor)")
_lib.define("gate_backward(Tensor scores, Tensor idx, Tensor dgate) -> Tensor")


@torch.library.impl(_lib, "assign", "CUDA")
def _assign_cuda(scores, sizes, caps, k, block_n):
    return assign_cuda(scores.contiguous(), sizes.contiguous(), caps.contiguous(), k=k,
                       block_n=block_n)


@torch.library.impl(_lib, "assign", "CPU")
def _assign_cpu(scores, sizes, caps, k, block_n):
    return assign_ref(scores, sizes, caps, k=k, block_n=block_n)


@torch.library.register_fake("repro_torch::assign", lib=_lib)
def _assign_fake(scores, sizes, caps, k, block_n):
    out = (*scores.shape[:-1], k)
    return (scores.new_empty(out, dtype=torch.int32), scores.new_empty(out, dtype=torch.float32),
            scores.new_empty(out, dtype=torch.bool), scores.new_empty(out, dtype=torch.float32))


@torch.library.impl(_lib, "gate_backward", "CUDA")
def _gate_backward_cuda(scores, idx, dgate):
    return gate_backward_cuda(scores.float().contiguous(), idx.int().contiguous(),
                              dgate.float().contiguous())


@torch.library.impl(_lib, "gate_backward", "CPU")
def _gate_backward_cpu(scores, idx, dgate):
    return gate_backward_ref(scores, idx, dgate)


@torch.library.register_fake("repro_torch::gate_backward", lib=_lib)
def _gate_backward_fake(scores, idx, dgate):
    return scores.new_empty(scores.shape, dtype=torch.promote_types(scores.dtype, torch.float32))


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@register_flop_formula(torch.ops.repro_torch.assign)
def _assign_flop(scores, *args, out_shape=None, **kwargs) -> int:
    return ASSIGN_OPS_PER_SCORE * _numel(scores)


@register_flop_formula(torch.ops.repro_torch.gate_backward)
def _gate_backward_flop(scores, *args, out_shape=None, **kwargs) -> int:
    return GATE_BACKWARD_OPS_PER_SCORE * _numel(scores)


def _assign(scores, sizes, caps, k, block_n):
    return torch.ops.repro_torch.assign(scores, sizes, caps, k, block_n)


def gate_backward(scores, idx, dgate):
    """The scores' gradient of ``assign``'s ``gate`` output given its
    gradient ``dgate``: the Hopper kernel for CUDA tensors, the plain version
    for CPU tensors."""
    return torch.ops.repro_torch.gate_backward(scores, idx, dgate)


class _AssignGate(torch.autograd.Function):
    """``assign`` with a gradient from ``gate`` to ``scores``; the picks,
    admits and positions are integers or do not depend on the scores
    smoothly, so they carry none."""

    @staticmethod
    def forward(ctx, scores, sizes, caps, k, block_n):
        idx, gate, admit, pos = _assign(scores, sizes, caps, k, block_n)
        ctx.save_for_backward(scores, idx)
        ctx.mark_non_differentiable(idx, admit, pos)
        return idx, gate, admit, pos

    @staticmethod
    def backward(ctx, _didx, dgate, _dadmit, _dpos):
        scores, idx = ctx.saved_tensors
        return gate_backward(scores, idx, dgate), None, None, None, None


def assign(scores, sizes, caps, *, k: int = 1, block_n: int = 256):
    """Capacity-constrained greedy assignment (see ref.py for semantics), one
    problem ``[N, E]`` or K of them ``[K, N, E]``: the Hopper kernel for CUDA
    tensors (one set of launches for all K), the plain version for CPU
    tensors.  With grad mode on and ``scores`` requiring grad, ``gate``
    carries a gradient to ``scores`` through the gate backward kernel (or its
    plain version)."""
    if torch.is_grad_enabled() and scores.requires_grad:
        return _AssignGate.apply(scores, sizes, caps, k, block_n)
    return _assign(scores, sizes, caps, k, block_n)


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


def _row_cores(jobs_cores, queued, block):
    """The closed-over ``jobs_cores`` for the rows in hand: padded with zeros
    to the run's job capacity (a run on padded jobs, ``pad_jobs_capacity``),
    then cut to this rank's block of a job-parallel run."""
    if jobs_cores is None:
        return None
    J = queued.shape[-1] if block is None else block.capacity
    short = J - jobs_cores.shape[-1]
    if short > 0:
        jobs_cores = torch.cat([jobs_cores, jobs_cores.new_zeros((*jobs_cores.shape[:-1], short))],
                               -1)
    return jobs_cores if block is None else jobs_cores[..., block.lo:block.hi]


def block_claims(site, sizes, num_sites: int) -> torch.Tensor:
    """``i32[num_sites]``: the capacity units that a block's rows claim at
    each site, every row with a pick (``site >= 0``) counting, admitted or
    not.  Integral sizes (cores) sum exactly in the segment-sum kernel."""
    claim = site >= 0
    return segment_sum(torch.where(claim, sizes, 0.0).int(), torch.where(claim, site, num_sites),
                       num_sites)


def block_admit(site, pos, sizes, caps, base) -> torch.Tensor:
    """FIFO admission of a block of rows behind the claims ``base i32[E]``
    of the rows before the block: the kernels' own test ``pos + size <= cap
    + 1e-6``, with ``pos`` (the claims before a row within its block) moved
    up by ``base`` at the row's site.  For integral sizes whose sums stay
    below 2^24 (the kernels' contract) every term is an integer that f32
    holds exactly, so the admits equal those of one call on all the rows."""
    s = site.clamp(0, caps.shape[-1] - 1).long()
    return (site >= 0) & (pos + take(base, s).float() + sizes <= take(caps, s) + 1e-6)


def _admit_block(site, pos, sizes, caps, block):
    """A block's admits in a job-parallel run: its claims go to every rank
    (``block.claims_base``), which hands back the lower ranks' claims."""
    base = block.claims_base(block_claims(site, sizes, caps.shape[-1]))
    return block_admit(site, pos, sizes, caps, base)


def make_capacity_assign(jobs_cores: torch.Tensor | None = None, *, block_n: int = 256):
    """Build an engine-compatible ``Policy.assign`` fn: jobs -> sites under
    free-core capacity; jobs beyond capacity stay QUEUED at the main server.
    In an ensemble (``scores [K, J, S]``) every lane is its own problem, all
    in one call; ``jobs_cores`` is ``[J]`` (the same for every lane) or
    ``[K, J]``, padded with zeros when the run's jobs were padded.  With
    ``block=`` (a job-parallel run) the rows are this rank's block and the
    admits are held behind the lower ranks' claims."""

    def assign_fn(scores, queued, feasible, sites, block=None):
        NEG = -1e30
        masked = torch.where(feasible & queued[..., None], scores, NEG)
        sizes, caps = _sizes_and_caps(_row_cores(jobs_cores, queued, block), queued, sites)
        idx, gate, admit, pos = assign(masked, sizes, caps, k=1, block_n=block_n)
        admit = (admit[..., 0] if block is None else
                 _admit_block(idx[..., 0], pos[..., 0], sizes, caps, block))
        ok = admit & queued
        return torch.where(ok, idx[..., 0], -1), ok

    assign_fn.splits_rows = True
    return assign_fn


def fused_topk_assign(scores_k, cand, sizes, caps, *, block_n: int = 256,
                      with_pos: bool = False):
    """Fused candidate-set rank + capacity pick (see fused_ref.py for
    semantics), one problem ``[N, K]`` or L of them ``[L, N, K]``: the Hopper
    kernel for CUDA tensors (one set of launches for all L), the plain
    version with row blocks of ``block_n`` for CPU tensors.  ``(site,
    admit)``, or ``(site, admit, pos)`` with ``with_pos``."""
    if scores_k.is_cuda:
        return fused_assign_cuda(scores_k.float().contiguous(), cand.int().contiguous(),
                                 sizes.float().contiguous(), caps.float().contiguous(),
                                 with_pos=with_pos)
    return fused_assign_ref(scores_k, cand, sizes, caps, block_n=block_n, with_pos=with_pos)


def make_fused_capacity_assign(jobs_cores: torch.Tensor | None = None, *, block_n: int = 256):
    """Build an engine-compatible ``Policy.assign_cand`` fn for sparse top-k
    mode (``simulate(..., topk=)``): rank each job's candidate set and admit
    under free-core capacity in one fused pass, without the dense ``[J, S]``
    masked-score matrix that ``make_capacity_assign`` builds.  With candidates
    covering all feasible sites (``topk >= S``) the result equals the dense
    ``make_capacity_assign`` path bit for bit.  In an ensemble (``scores_k
    [L, J, K]``) every lane is its own problem, all in one call;
    ``jobs_cores`` is ``[J]`` or ``[L, J]``, padded with zeros when the run's
    jobs were padded.  With ``block=`` (a job-parallel run) the rows are
    this rank's block, and the kernel's ``pos`` holds its admits behind the
    lower ranks' claims."""

    def assign_cand(scores_k, queued, feas_k, cand, sites, block=None):
        S = sites.capacity
        cand_eff = torch.where(feas_k & queued[..., None], cand, S).int()
        sizes, caps = _sizes_and_caps(_row_cores(jobs_cores, queued, block), queued, sites)
        if block is None:
            site, admit = fused_topk_assign(scores_k, cand_eff, sizes, caps, block_n=block_n)
        else:
            site, _, pos = fused_topk_assign(scores_k, cand_eff, sizes, caps, block_n=block_n,
                                             with_pos=True)
            admit = _admit_block(site, pos, sizes, caps, block)
        ok = admit & queued
        return torch.where(ok, site, -1), ok

    assign_cand.splits_rows = True
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
    # jnp.maximum and jnp.clip (minimum of maximum): at a bound the gradient
    # splits between the two sides, 0.5 each, where torch.clamp passes all of it
    norm = torch.maximum(combine.sum(-1, keepdim=True), _scalar(1e-9, combine))
    total = gate.sum(-1, keepdim=True)
    combine = combine / norm * torch.minimum(torch.maximum(total, _scalar(0.0, total)),
                                             _scalar(1.0, total))
    return idx, combine, pos.int(), keep


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)
