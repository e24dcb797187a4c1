"""Mixture-of-Experts FFN with capacity routing.

The router is the simulator's assignment problem: token->expert scores with
a per-expert capacity, solved by ``kernels.assign.moe_route`` (the Hopper
assignment kernel for CUDA tensors, its plain version for CPU tensors).
Routing is grouped (GShard-style): the tokens split into
``cfg.router_groups`` independent groups, all of them routed in one call.

Dispatch writes each kept ``(group, expert, slot)`` triple's token into an
expert-major capacity buffer ``[E, G * C, d]``.  Kept triples are unique, so
every kept cell is written once and the buffer cannot depend on the order of
the writes; dropped triples go to one scratch row past the buffer, which is
cut off.  The experts are batched matmuls over E, as in the reference, which
computes them outside any kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.assign.ops import moe_route
from .config import ModelConfig
from .layers import _normal

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> nn.ParameterDict:
    """Router ``f32[d, E]`` and expert matrices ``[E, d_in, d_out]``, each
    expert's matrix drawn in f32 and cast on its own (one f32 temporary of
    kimi-k2's ``[384, 7168, 2048]`` would take 22.5 GB)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    out_scale = ff ** -0.5 / (2 * cfg.n_layers) ** 0.5

    def expert_mats(d_in, d_out, scale):
        out = torch.empty((E, d_in, d_out), dtype=dtype, device=gen.device)
        for e in range(E):
            out[e] = _normal(gen, (d_in, d_out), scale, dtype)
        return out

    p = {"router": _normal(gen, (d, E), 0.02, torch.float32),
         "w_up": expert_mats(d, ff, d ** -0.5),
         "w_down": expert_mats(ff, d, out_scale)}
    if cfg.mlp_act in ("swiglu", "geglu"):
        p["w_gate"] = expert_mats(d, ff, d ** -0.5)
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in p.items()})


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    return max(1, int(math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def _experts(p, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """buf [E, N, d] -> [E, N, d] through each expert's feed-forward."""
    if "w_gate" in p:
        gate = torch.bmm(buf, p["w_gate"])
        act = F.silu(gate) if cfg.mlp_act == "swiglu" else F.gelu(gate, approximate="tanh")
        h = act * torch.bmm(buf, p["w_up"])
    else:
        h = torch.bmm(buf, p["w_up"])
        h = torch.square(F.relu(h)) if cfg.mlp_act == "relu2" else F.gelu(h, approximate="tanh")
    return torch.bmm(h, p["w_down"])


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig, *, with_aux: bool = True):
    """x [B, S, d] -> (y [B, S, d], aux with the load-balance and z losses
    and the dropped share of token slots; ``None`` without ``with_aux``)."""
    B, S, d = x.shape
    T = B * S
    G = 1 if T % cfg.router_groups else cfg.router_groups   # groups split the tokens evenly
    Tg = T // G
    E, k = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, Tg)

    xf = x.reshape(G, Tg, d)
    logits = torch.einsum("gtd,de->gte", xf.float(), p["router"])
    route_bn = Tg if not cfg.scan_layers else 256
    idx, combine, slot, keep = moe_route(logits, k=k, capacity=C, block_n=route_bn)

    # dispatch: row (expert, group, slot) of the expert-major buffer
    g_ix = torch.arange(G, device=x.device)[:, None, None]
    expert = idx.clamp_min(0).long()
    rows = (expert * G + g_ix) * C + slot.clamp(0, C - 1).long()      # [G, Tg, k]
    scratch = E * G * C
    buf = torch.zeros((scratch + 1, d), dtype=x.dtype, device=x.device)
    src = xf[:, :, None, :].expand(G, Tg, k, d)
    buf[torch.where(keep, rows, scratch).reshape(-1)] = src.reshape(-1, d)
    y_buf = _experts(p, buf[:scratch].view(E, G * C, d), cfg).view(E * G * C, d)

    # combine: gather each token's k slots back (slot clamped, as the reference)
    y_tok = y_buf[rows.reshape(-1)].view(G, Tg, k, d)
    y = (y_tok * (combine * keep)[..., None].to(x.dtype)).sum(dim=2)
    if not with_aux:
        return y.reshape(B, S, d), None

    # aux losses (Switch/GShard load balancing, router z-loss); the expert
    # counts are integers
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=1)                                             # [G, E]
    counts = torch.zeros((G * E,), dtype=torch.int64, device=x.device)
    counts.index_add_(0, (g_ix * E + expert).reshape(-1), keep.reshape(-1).long())
    ce = counts.view(G, E).float() / keep.sum(dim=(1, 2)).float().clamp_min(1.0)[:, None]
    aux = {"moe_lb_loss": (E * (me * ce).sum(-1)).mean(),
           "moe_z_loss": torch.square(torch.logsumexp(logits, dim=-1)).mean(),
           "moe_drop_frac": 1.0 - keep.float().mean()}
    return y.reshape(B, S, d), aux
