"""Dense plain-PyTorch oracle for (causal | sliding-window) GQA attention: the
plain version of the flash kernel (``csrc/flash_attention.cu``)."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0, scale: float | None = None):
    """q [B,Hq,S,D], k/v [B,Hkv,Skv,D] -> [B,Hq,S,D] in q's dtype.

    q rows are right-aligned to the end of the KV (row i sits at position
    ``i + Skv - S``); window > 0 keeps only kv in (q_pos - window, q_pos]
    (local attention); softmax in f32 regardless of input dtype.
    """
    _, Hq, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5

    kq = k.repeat_interleave(G, dim=1)
    vq = v.repeat_interleave(G, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), kq.float()) * scale

    q_pos = torch.arange(S, device=q.device)[:, None] + (Skv - S)
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window > 0:
        mask &= kv_pos > q_pos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhst,bhtd->bhsd", p, vq.float()).to(q.dtype)
