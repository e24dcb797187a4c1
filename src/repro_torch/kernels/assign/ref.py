"""Plain PyTorch version of capacity-constrained greedy assignment.

Semantics ("block-sequential greedy"): items are processed in blocks of
``block_n`` in array order; within a block, slot s of *all* block items is
resolved before slot s+1 (slot-major), and admission consumes capacity in
item order via a weighted prefix sum.  With ``block_n >= N`` this is exactly
GShard slot-major routing; with ``k == 1`` it is exact FIFO admission
regardless of block size (the simulator dispatch case).

Inputs
  scores  f32[N, E]  raw policy/router logits; -1e30 (or -inf) marks infeasible pairs
  sizes   f32[N]     capacity units an item consumes (1 for tokens, cores for jobs)
  caps    f32[E]     per-bin capacity in the same units
Outputs
  bin_idx i32[N, k]  chosen bin per slot (-1 if infeasible)
  gate    f32[N, k]  softmax(scores) value of the chosen bin
  admit   bool[N, k] admitted under capacity
  pos     f32[N, k]  units consumed in the chosen bin *before* this item

A leading lane axis (``scores [K, N, E]``, ``sizes [K, N]``, ``caps [K, E]``)
solves K independent problems, each as its own call would.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def assign_ref(scores, sizes, caps, *, k: int = 1, block_n: int = 256):
    if scores.dim() == 3:
        outs = [assign_ref(s, z, c, k=k, block_n=block_n) for s, z, c in zip(scores, sizes, caps)]
        return tuple(torch.stack(col) for col in zip(*outs))
    N, E = scores.shape
    dev = scores.device
    scores = scores.float()
    sizes = sizes.float()
    caps = caps.float()

    # row softmax over feasible bins only
    feas = scores > NEG_INF / 2
    m = torch.where(feas, scores, float("-inf")).amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)  # rows without a feasible bin
    p = torch.where(feas, torch.exp(torch.where(feas, scores, m) - m), 0.0)
    gates_full = p / p.sum(-1, keepdim=True).clamp_min(1e-30)

    # k first-argmax rounds; a feasible pick masks its bin for later slots.
    # The picks do not depend on capacity, so every row's are found first.
    iota = torch.arange(E, device=dev)[None, :]
    masked = scores
    picks = []
    for _ in range(k):
        best_val = masked.amax(-1)
        idx = torch.where(masked >= best_val[:, None], iota, E).amin(-1)  # first argmax
        ok = best_val > NEG_INF / 2
        onehot = (iota == idx[:, None]) & ok[:, None]
        picks.append((idx, ok, onehot))
        masked = torch.where(onehot, NEG_INF, masked)

    # FIFO admission: claims are taken in (row block, slot, row) order and
    # every claim counts, admitted or not (head-of-line blocking, as in the
    # engine's start phase).  The per-bin ``used`` carry of the block loop is
    # the exclusive prefix sum of the claims in that order.
    nb = -(-N // block_n)
    w = torch.zeros((k, nb * block_n, E), dtype=torch.float32, device=dev)
    for s, (_, _, onehot) in enumerate(picks):
        w[s, :N] = onehot * sizes[:, None]
    w = w.view(k, nb, block_n, E).transpose(0, 1).reshape(-1, E)
    before = (torch.cumsum(w, 0) - w).view(nb, k, block_n, E).transpose(0, 1)
    before = before.reshape(k, nb * block_n, E)[:, :N]

    out = []
    for s, (idx, ok, _) in enumerate(picks):
        col = idx.clamp_max(E - 1)[:, None]
        pos = before[s].gather(1, col)[:, 0]
        admit = ok & (pos + sizes <= caps[col[:, 0]] + 1e-6)
        gate = gates_full.gather(1, col)[:, 0]
        out.append((torch.where(ok, idx, -1), gate * ok, admit, pos * ok))
    idx, gate, admit, pos = (torch.stack(c, -1) for c in zip(*out))
    return idx.int(), gate, admit, pos


def gate_backward_ref(scores, idx, dgate):
    """Plain version of the gate backward kernel (``csrc/gate_backward.cu``):
    the scores' gradient ``f32[..., N, E]`` of ``assign_ref``'s ``gate``
    output, given the picks ``idx [..., N, k]`` (-1 where infeasible) and the
    gates' gradient ``dgate [..., N, k]``.  With ``g`` the row softmax over
    the feasible bins, ``G`` the gradients folded onto their picked bins in
    slot order and ``dot = sum(G * g)``, it is ``g * (G - dot)`` on the
    feasible bins and 0 elsewhere; an infeasible pick, and a row without a
    feasible bin, add nothing.  In f32 (f64 for f64 scores)."""
    scores = scores.to(torch.promote_types(scores.dtype, torch.float32))
    feas = scores > NEG_INF / 2
    m = torch.where(feas, scores, float("-inf")).amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(feas, torch.exp(torch.where(feas, scores, m) - m), 0.0)
    g = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    iota = torch.arange(scores.shape[-1], device=scores.device)
    G = torch.zeros_like(scores)
    for j in range(idx.shape[-1]):
        G = G + (iota == idx[..., j:j + 1].long()) * dgate[..., j:j + 1].to(scores.dtype)
    dot = (G * g).sum(-1, keepdim=True)
    return torch.where(feas, g * (G - dot), 0.0)
