"""Sparse top-k candidate scoring: the WLCG-scale path.

At S=300 sites and J=100k jobs the dense per-round score matrix is the
engine's memory wall: every round writes ``f32[J, S]`` scores and a
``bool[J, S]`` feasibility mask.  The sparse mode replaces both with a
per-job candidate-site index ``i32[J, K]`` built here, once at init or every
``topk_refresh`` rounds, from static feasibility and the policy's dense
pre-rank (``Policy.pre_rank``, falling back to ``Policy.score``).

Per round the engine then evaluates ``Policy.score_cand`` (or a dense-score
gather) over ``[J, K]`` only.  Candidate rows are sorted ascending by site id
with sentinel ``S`` padding, so at ``k >= S`` the index enumerates all
statically feasible sites and the sparse argmax equals the dense first-max
tie-break bit for bit; at ``k < S`` assignment is an approximation, the same
one as the JAX package's.

With the data subsystem attached, replica holders of a job's dataset (and
the nearest WAN source toward its pre-rank-best site) rank ahead of equally
scored sites, as in the JAX package.
"""
from __future__ import annotations

import torch

# salt for the non-consuming candidate-build key: folding the round's key
# leaves the engine's own split(key, 4) stream untouched, so a sparse run
# draws the same failure and policy randomness as its dense twin
CAND_SALT = 0x7093


def static_feasibility(jobs, sites) -> torch.Tensor:
    """``bool[..., J, S]``: can this job *ever* fit this site (active, total
    cores, total memory).  Constant over a run, so it is baked into the
    candidate index; per-round masks are applied again when the engine
    gathers."""
    return (
        sites.active[..., None, :]
        & (jobs.cores[..., :, None] <= sites.cores[..., None, :])
        & (jobs.memory[..., :, None] <= sites.memory[..., None, :])
    )


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key whose signed order is the IEEE total order of the f32 ``x``
    (``-0.0`` below ``+0.0``): flip the magnitude bits of negatives."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k(x, k)[1]``: the first ``k`` indices of each row in
    descending total order, ties to the lower index.  A stable sort of an
    integer key gives this one permutation on every device."""
    key = _total_order_key(x)
    return torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]


def build_candidates(jobs, sites, policy, pstate, clock, key, ext, k: int) -> torch.Tensor:
    """Build the ``i32[J, K]`` candidate-site index (sentinel ``S`` = empty).

    O(J*S) work, paid only at init and every ``topk_refresh`` rounds.  Rows
    come out sorted ascending by site id with the dense pre-rank argmax
    force-included, so ``k >= S`` is "all feasible sites in dense scan
    order" and the set holds the dense argmax whenever any site is feasible.
    An ensemble's states (``[K, J]``, ``[K, S]``, keys ``[K, 2]``) give
    ``i32[K, J, k]``, each lane its own run's index.
    """
    from .types import take

    S = sites.capacity
    k = min(int(k), S)
    feas = static_feasibility(jobs, sites)
    pre_fn = getattr(policy, "pre_rank", None) or policy.score
    masked = torch.where(feas, pre_fn(jobs, sites, pstate, clock, key), float("-inf"))
    best_val = masked.amax(-1)
    iota = torch.arange(S, device=masked.device)
    best = torch.where(masked == best_val[..., None], iota, S).amin(-1)  # first max

    sel = masked
    if "data" in ext:
        # data-locality bonus: replica holders of the job's dataset, plus the
        # nearest WAN source toward the pre-rank-best destination, outrank
        # equally scored non-holders.  The bonus exceeds the row's finite
        # score range, so it reorders between the groups, never within.
        from .replicas import nearest_source

        dext = ext["data"]
        rep, net = dext.replicas, dext.network
        D = rep.present.shape[-2]
        has_ds = jobs.dataset >= 0
        holders = take(rep.present, jobs.dataset.clamp(0, D - 1).long(), tail=1)  # [J, S]
        src = nearest_source(rep, net, jobs.dataset, best)                         # [J]
        local = holders | (iota == src[..., None])
        row_min = torch.where(feas, masked, float("inf")).amin(-1)
        span = torch.where(torch.isfinite(best_val) & torch.isfinite(row_min),
                           best_val - row_min, 0.0)
        bonus = (span + 1.0)[..., None]
        sel = torch.where(feas & local & has_ds[..., None], masked + bonus, masked)

    idx = _top_k_indices(sel, k)
    # force-include the dense pre-rank argmax in the last slot
    missing = torch.isfinite(best_val) & ~(idx == best[..., None]).any(-1)
    idx[..., -1] = torch.where(missing, best, idx[..., -1])
    # sentinel-out infeasible slots, then sort ascending by site id
    # (sentinels last): the dense argmax tie-break order
    vals = masked.gather(-1, idx)
    cand = torch.where(torch.isfinite(vals), idx, S).int()
    return torch.sort(cand, dim=-1).values


def bytes_per_round(J: int, S: int, k: int | None) -> dict:
    """Per-round score-path bytes, dense vs sparse: dense rounds write the
    f32 score matrix, the bool feasibility mask and the masked scores; sparse
    rounds carry the i32 candidate index plus f32 score and bool mask gathers
    over [J, K]."""
    dense = J * S * (4 + 1 + 4)
    sparse = None if k is None else J * min(k, S) * (4 + 4 + 1) + S
    return dict(dense=dense, sparse=sparse,
                ratio=None if sparse is None else dense / sparse)
