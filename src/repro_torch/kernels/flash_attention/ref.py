"""Dense plain-PyTorch oracle for (causal | sliding-window) GQA attention: the
plain version of the flash kernel (``csrc/flash_attention.cu``)."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0, scale: float | None = None,
                  return_lse: bool = False):
    """q [B,Hq,S,D], k/v [B,Hkv,Skv,D] -> [B,Hq,S,D] in q's dtype.

    q rows are right-aligned to the end of the KV (row i sits at position
    ``i + Skv - S``); window > 0 keeps only kv in (q_pos - window, q_pos]
    (local attention); softmax in f32 (f64 for f64 inputs).  With
    ``return_lse``, also each row's log-sum-exp of the scaled, masked scores
    ``[B,Hq,S]`` in the softmax's dtype: the forward kernels' saved statistic,
    +inf for a row that keeps no key, so that ``exp(s - lse)`` is 0 there.
    """
    _, Hq, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5

    acc = _acc_dtype(q)
    kq = k.repeat_interleave(G, dim=1)
    vq = v.repeat_interleave(G, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.to(acc), kq.to(acc)) * scale

    q_pos = torch.arange(S, device=q.device)[:, None] + (Skv - S)
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window > 0:
        mask &= kv_pos > q_pos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)  # a row that keeps no key: p = 0, out = 0
    p = torch.exp(logits - m)
    denom = p.sum(-1, keepdim=True)
    p = p / denom.clamp_min(1e-30)
    out = torch.einsum("bhst,bhtd->bhsd", p, vq.to(acc)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(denom > 0, m + torch.log(denom), float("inf"))
    return out, lse.squeeze(-1)


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """f32, or f64 for f64 inputs (the finite-difference checks)."""
    return torch.promote_types(t.dtype, torch.float32)


def attention_bwd_ref(q, k, v, o, do, *, causal: bool = True, window: int = 0,
                      scale: float | None = None, lse=None):
    """Plain version of the backward kernel (``csrc/flash_attention_bwd.cu``):
    ``(dq, dk, dv)`` of ``o = attention_ref(q, k, v, ...)`` given the
    output's gradient ``do``, in the kernel's arithmetic: every product in
    f32 (f64 for f64 inputs), ``P = exp(s - lse)`` over the kept keys from
    the forward's log-sum-exp ``lse [B,Hq,S]`` when it is given (as the
    kernel takes it), else recomputed from each row's max and sum,
    ``dS = P * (dO V^T - rowsum(dO * O))`` with the forward's output ``o``,
    ``dQ = scale dS K``, ``dK = scale dS^T Q`` (summed over each KV head's
    query heads), ``dV = P^T dO``; gradients in the inputs' dtype.  A row
    that keeps no key gets zeros (the forward writes it as 0)."""
    B, Hq, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    acc = _acc_dtype(q)
    qf = q.to(acc)
    kf, vf = (t.to(acc).repeat_interleave(G, dim=1) for t in (k, v))
    dof = do.to(acc)

    q_pos = torch.arange(S, device=q.device)[:, None] + (Skv - S)
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window > 0:
        mask &= kv_pos > q_pos - window
    s = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    s = s.masked_fill(~mask, float("-inf"))
    if lse is not None:
        p = torch.exp(s - lse.to(acc)[..., None])  # 0 where masked, and in a row of lse +inf
    else:
        m = s.amax(-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.exp(s - m)
        p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    delta = (dof * o.to(acc)).sum(-1, keepdim=True)
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    dk = (torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale).view(B, Hkv, G, Skv, D).sum(2)
    dv = torch.einsum("bhst,bhsd->bhtd", p, dof).view(B, Hkv, G, Skv, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
