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
from ..parallel.sharding import is_dtensor
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
        if out.is_meta:   # shapes only: no draw to make
            return out
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
    if is_dtensor(x):
        return _moe_forward_mesh(p, x, cfg, with_aux)
    B, S, d = x.shape
    G, Tg = _groups(cfg, B * S)
    return _moe_local(p, x, cfg, G, Tg, with_aux)


def _groups(cfg: ModelConfig, T: int) -> tuple:
    G = 1 if T % cfg.router_groups else cfg.router_groups   # groups split the tokens evenly
    return G, T // G


def _moe_local(p, x: torch.Tensor, cfg: ModelConfig, G: int, Tg: int, with_aux: bool):
    """The layer on G whole groups of Tg tokens: route, dispatch, the
    experts, combine -> (y, the aux losses or None)."""
    B, S, d = x.shape
    buf, rows, cw, logits, keep, key = _dispatch(p, x, cfg, G, Tg)
    y_buf = _experts(p, buf, cfg)
    y = _combine(y_buf, rows, cw, x.shape)
    if not with_aux:
        return y, None
    lb, z = _aux_terms(logits, keep, key, cfg, G)
    aux = {"moe_lb_loss": lb.mean(), "moe_z_loss": z.mean(),
           "moe_drop_frac": 1.0 - keep.float().mean()}
    return y, aux


def _dispatch(p, x: torch.Tensor, cfg: ModelConfig, G: int, Tg: int):
    """Route G groups of Tg tokens and write each kept (group, expert,
    slot) triple's token into the expert-major buffer -> (buf [E, G * C,
    d], rows [G, Tg, k] (each pick's row of the buffer), the combine
    weights of the kept picks, the router logits, keep, and each pick's
    (group, expert) key for the expert counts)."""
    B, S, d = x.shape
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
    return (buf[:scratch].view(E, G * C, d), rows, (combine * keep)[..., None].to(x.dtype),
            logits, keep, g_ix * E + expert)


def _combine(y_buf: torch.Tensor, rows: torch.Tensor, cw: torch.Tensor, shape) -> torch.Tensor:
    """Gather each token's k slots back (slot clamped, as the reference) and
    weigh them: y_buf [E, G * C, d] -> y of ``shape``."""
    G, Tg, k = rows.shape
    d = y_buf.shape[-1]
    y_tok = y_buf.reshape(-1, d)[rows.reshape(-1)].view(G, Tg, k, d)
    return (y_tok * cw).sum(dim=2).reshape(shape)


def _aux_terms(logits, keep, key, cfg: ModelConfig, G: int):
    """Each group's load-balance loss and each token's squared router
    log-partition (Switch/GShard, router z-loss); the expert counts are
    integers."""
    E = cfg.n_experts
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=1)                                             # [G, E]
    counts = torch.zeros((G * E,), dtype=torch.int64, device=logits.device)
    counts.index_add_(0, key.reshape(-1), keep.reshape(-1).long())
    ce = counts.view(G, E).float() / keep.sum(dim=(1, 2)).float().clamp_min(1.0)[:, None]
    return E * (me * ce).sum(-1), torch.square(torch.logsumexp(logits, dim=-1))


def _aux(sums: torch.Tensor, cfg: ModelConfig, G: int, T: int) -> dict:
    """The aux losses from their sums over all G groups of T tokens (on a
    mesh, each rank's a partial sum): means over the groups, the tokens and
    the token slots."""
    return {"moe_lb_loss": sums[0] / G, "moe_z_loss": sums[1] / T,
            "moe_drop_frac": 1.0 - sums[2] / (T * cfg.top_k)}


def _moe_forward_mesh(p, x, cfg: ModelConfig, with_aux: bool):
    """The layer on a mesh (``DTensor`` x and weights), as the JAX package
    constrains it: the tokens' groups split over the data axes, so the
    routing and the dispatch stay on each rank's own tokens (``local_map``),
    the capacity buffer split over the data axes only, and the experts'
    batched matmuls over 'model' (EP: ``DTensor`` runs each rank's own
    experts); the combine all-gathers the experts' outputs over 'model',
    this layer's one EP collective.  The router's gradient is each data
    rank's partial sum.  Where the groups do not split evenly over the
    data axes every data rank routes all of them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    B, S, d = x.shape
    T = B * S
    G, Tg = _groups(cfg, T)
    dp = [i for i, n in enumerate(names) if n in ("pod", "data")]
    ways = 1
    for i in dp:
        ways *= mesh.shape[i]
    split = B % ways == 0 and (B // ways * S) % Tg == 0
    n = len(names)
    x_pl = [Shard(0) if i in dp and split else Replicate() for i in range(n)]
    buf_pl = [Shard(1) if i in dp and split else Replicate() for i in range(n)]
    part = [Partial() if i in dp and split else Replicate() for i in range(n)]
    rep = [Replicate()] * n
    m_dim = names.index("model") if "model" in names else None
    ep_dim = m_dim if m_dim is not None and cfg.n_experts % mesh.shape[m_dim] == 0 else None

    def route(xl, router):
        Gl = xl.shape[0] * S // Tg
        buf, rows, cw, logits, keep, key = _dispatch({"router": router}, xl, cfg, Gl, Tg)
        lb, z = _aux_terms(logits, keep, key, cfg, Gl)
        return buf, rows, cw, torch.stack([lb.sum(), z.sum(), keep.float().sum()])

    buf, rows, cw, sums = local_map(
        route, out_placements=(buf_pl, x_pl, x_pl, part), in_placements=(x_pl, rep),
        in_grad_placements=(x_pl, part), device_mesh=mesh, redistribute_inputs=True,
    )(x, p["router"])
    if ep_dim is not None:   # each 'model' rank runs its own experts
        buf = buf.redistribute(mesh, [Shard(0) if i == ep_dim else pl
                                      for i, pl in enumerate(buf_pl)])
    y_buf = _experts(p, buf, cfg)
    y = local_map(lambda yb, r, c: _combine(yb, r, c, (r.shape[0] * Tg // S, S, d)),
                  out_placements=x_pl, in_placements=(buf_pl, x_pl, x_pl),
                  device_mesh=mesh, redistribute_inputs=True)(y_buf, rows, cw)
    return y, (_aux(sums, cfg, G, T) if with_aux else None)
