"""Plain PyTorch version of the fused candidate-set assignment (sparse top-k).

In sparse top-k mode (``simulate(..., topk=K)``) each job's score row is
compacted to ``K`` candidate sites: ``f32[N, K]`` scores and an ``i32[N, K]``
site index whose sentinel ``E`` marks an empty slot.  The assignment ranks
those candidates and admits under capacity in one pass (k=1 FIFO admission):

  - per row, the best valid candidate wins, ties to the *lowest slot*; the
    engine's candidate rows are sorted ascending by site id, so this is the
    dense lowest-site tie-break;
  - admission consumes per-site capacity in row order.  Rows go in blocks of
    ``block_n``: within a block a weighted prefix sum, across blocks a
    per-site ``used`` carry;
  - claims count whether or not they are admitted (FIFO head-of-line
    blocking, as in the engine's start phase and ``ref.assign_ref``).

The float sums follow XLA on the CPU (``scan.cumsum_f32``, ``scan.sum_f32``),
so this equals the JAX package's ``fused_assign_ref`` bit for bit, whatever
the sizes.  With integral sizes every sum is exact and ``block_n`` does not
change the result.

Inputs
  scores_k f32[N, K]  candidate scores
  cand     i32[N, K]  candidate site ids (sentinel >= E)
  sizes    f32[N]     capacity units a row consumes (cores for jobs)
  caps     f32[E]     per-site capacity in the same units
Outputs
  site     i32[N]     picked site, -1 when the row has no valid candidate
  admit    bool[N]    admitted under capacity
  pos      f32[N]     (``with_pos=True``) units claimed at the row's site by
                      the rows before it, the exclusive per-site prefix of
                      the claims; 0 when the row has no valid candidate

With a leading lane axis (``[L, N, K]``, ``[L, N]``, ``[L, E]`` in,
``[L, N]`` out) every lane is an independent problem with its own ``used``
carry, the JAX package's kernel under ``jax.vmap``.
"""
from __future__ import annotations

import torch

from ...core.scan import cumsum_f32, sum_f32

NEG_INF = -1e30


def fused_assign_ref(scores_k, cand, sizes, caps, *, block_n: int = 256,
                     with_pos: bool = False):
    if scores_k.dim() == 3:
        outs = [fused_assign_ref(s, c, z, e, block_n=block_n, with_pos=with_pos)
                for s, c, z, e in zip(scores_k, cand, sizes, caps)]
        return tuple(torch.stack(col) for col in zip(*outs))
    N, K = scores_k.shape
    E = caps.shape[0]
    dev = scores_k.device
    scores_k = scores_k.float()
    sizes = sizes.float()
    caps = caps.float()

    v = torch.where(cand < E, scores_k, NEG_INF)
    best_val = v.amax(-1)
    iota_k = torch.arange(K, device=dev)
    slot = torch.where(v == best_val[:, None], iota_k, K).amin(-1)  # first max
    site = cand.gather(1, slot[:, None])[:, 0]
    ok = best_val > NEG_INF / 2

    nb = -(-N // block_n)
    site_b = torch.zeros((nb * block_n,), dtype=torch.int64, device=dev)
    site_b[:N] = site.clamp(0, E - 1)
    ok_b = torch.zeros((nb * block_n,), dtype=torch.bool, device=dev)
    ok_b[:N] = ok
    sz_b = torch.zeros((nb * block_n,), dtype=torch.float32, device=dev)
    sz_b[:N] = sizes

    onehot = (torch.arange(E, device=dev) == site_b[:, None]) & ok_b[:, None]
    w = (onehot * sz_b[:, None]).view(nb, block_n, E)
    cum_excl = cumsum_f32(w, 1) - w
    block_tot = sum_f32(w, 1)  # [nb, E]
    # the block loop's carry: claims of all earlier blocks, added block by block
    used = torch.zeros((E,), dtype=torch.float32, device=dev)
    used_before = []
    for b in range(nb):
        used_before.append(used)
        used = used + block_tot[b]
    used_before = torch.stack(used_before)

    col = site_b.view(nb, block_n, 1)
    pos = cum_excl.gather(2, col)[..., 0] + used_before.gather(1, col[..., 0])
    admit = ok_b & (pos.reshape(-1) + sz_b <= caps[site_b] + 1e-6)
    out = torch.where(ok, site, -1).int(), admit[:N] & ok
    return (*out, torch.where(ok, pos.reshape(-1)[:N], 0.0)) if with_pos else out
