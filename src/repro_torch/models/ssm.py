"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060).

The prompt runs the chunked SSD algorithm: the intra-chunk terms are dense
matmuls, quadratic in the chunk, and the state passes between chunks in a
short Python loop over the ``S / chunk`` chunks.  Decode is the O(1)
recurrent update of the state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.sharding import constrain_batch
from .config import ModelConfig
from .layers import _normal, causal_conv1d, causal_conv1d_step, dense_init, rmsnorm, softplus


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype) -> nn.ParameterDict:
    d, di, ns, ng, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.n_ssm_heads
    conv_ch = di + 2 * ng * ns
    dev = gen.device
    u = torch.rand((nh,), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    p = {
        "in_proj": dense_init(gen, d, 2 * di + 2 * ng * ns + nh, dtype=dtype),
        "conv_w": _normal(gen, (cfg.ssm_conv, conv_ch), 0.1, dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),          # inverse softplus
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32, device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "norm_w": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, d, scale=di ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                               dtype=dtype),
    }
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in p.items()})


def _split_proj(z_all: torch.Tensor, cfg: ModelConfig):
    di, ns, ng, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.n_ssm_heads
    return torch.split(z_all, [di, di + 2 * ng * ns, nh], dim=-1)  # z, xBC, dt


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig):
    gn = cfg.ssm_groups * cfg.ssm_state
    return torch.split(xbc, [cfg.d_inner, gn, gn], dim=-1)  # x, B, C


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., l] -> [..., l, l]: the sum of a over (j, i] for i >= j, else -inf."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(l, device=a.device)
    return seg.masked_fill(~(i[:, None] >= i[None, :]), float("-inf"))


def ssd_scan(x, dt, A_log, B, C, *, chunk: int):
    """Chunked SSD.  x [b, l, h, p]; dt [b, l, h] (after softplus); B, C
    [b, l, g, n].  Returns y f32[b, l, h, p] and the final state f32[b, h, p,
    n].  Products mix x's dtype with f32 as the reference's promotion does:
    the C.B scores and the carried states round to x's dtype first."""
    b, l, h, p_ = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-l) % chunk
    if pad:
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (l + pad) // chunk
    rep = h // g

    def group(t):  # [b, l, g, n] -> [b, nc, chunk, h, n]
        return t.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    xc = x.reshape(b, nc, chunk, h, p_)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc, Cc = group(B), group(C)

    xbar = xc * dtc[..., None]                              # f32
    dA = -torch.exp(A_log) * dtc                            # [b, nc, chunk, h]
    dA_t = dA.permute(0, 1, 3, 2)                           # [b, nc, h, chunk]
    dA_cum = torch.cumsum(dA_t, dim=-1)

    # 1) intra-chunk: the quadratic, attention-like term
    L = torch.exp(_segsum(dA_t))                            # [b, nc, h, chunk, chunk]
    scores = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc).float()
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores * L, xbar)

    # 2) each chunk's state
    decay_tail = torch.exp(dA_cum[..., -1:] - dA_cum)      # [b, nc, h, chunk]
    states = torch.einsum("bcjhn,bcjhp->bchpn",
                          Bc.float() * decay_tail.permute(0, 1, 3, 2)[..., None], xbar)

    # 3) the state passes from chunk to chunk
    chunk_decay = torch.exp(dA_cum[..., -1])                # [b, nc, h]
    s = torch.zeros((b, h, p_, n), dtype=torch.float32, device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prev = torch.stack(s_prevs, dim=1).to(x.dtype).float()  # [b, nc, h, p, n]

    # 4) the carried state's output within each chunk
    decay_in = torch.exp(dA_cum).permute(0, 1, 3, 2)[..., None]  # [b, nc, chunk, h, 1]
    y_off = torch.einsum("bcihn,bchpn->bcihp", Cc.float(), s_prev) * decay_in

    y = (y_diag + y_off).reshape(b, l + pad, h, p_)[:, :l]
    return y, s


def ssm_forward(p, x: torch.Tensor, cfg: ModelConfig):
    """Prompt forward.  x [B, S, d] -> (y [B, S, d], cache with the conv
    tail and the final SSM state, from which decode continues)."""
    B, S, _ = x.shape
    nh, ph, ng, ns = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    # on a mesh the scan runs on each rank's own rows, whole: the
    # projection's outputs are gathered over 'model' where it splits them
    z, xbc, dt_raw = (constrain_batch(t) for t in _split_proj(x @ p["in_proj"], cfg))
    K = cfg.ssm_conv
    conv_tail = F.pad(xbc, (0, 0, K - 1, 0))[:, xbc.shape[1]:]     # the last K-1 inputs
    xbc = F.silu(causal_conv1d(xbc, p["conv_w"], p["conv_b"]))
    xs, Bv, Cv = _split_xbc(xbc, cfg)
    dt = softplus(dt_raw.float() + p["dt_bias"])
    y, final = ssd_scan(xs.reshape(B, S, nh, ph), dt, p["A_log"], Bv.reshape(B, S, ng, ns),
                        Cv.reshape(B, S, ng, ns), chunk=cfg.ssm_chunk)
    y = y + p["D"][:, None] * xs.reshape(B, S, nh, ph)
    y = y.reshape(B, S, cfg.d_inner)
    y = rmsnorm(y * F.silu(z.float()), p["norm_w"], eps=cfg.norm_eps)
    return (y @ p["out_proj"].float()).to(x.dtype), {"conv": conv_tail, "state": final}


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
    }


def ssm_decode(p, x_t: torch.Tensor, cfg: ModelConfig, cache: dict):
    """One-token recurrent update.  x_t [B, 1, d] -> (y [B, 1, d], the next
    cache)."""
    B = x_t.shape[0]
    nh, ph, ng, ns = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    z, xbc, dt_raw = _split_proj(x_t[:, 0] @ p["in_proj"], cfg)
    xbc, conv_state = causal_conv1d_step(xbc, cache["conv"], p["conv_w"], p["conv_b"])
    xs, Bv, Cv = _split_xbc(F.silu(xbc), cfg)
    dt = softplus(dt_raw.float() + p["dt_bias"])                       # [B, nh]
    xh = xs.reshape(B, nh, ph).float()
    rep = nh // ng
    Bh = Bv.reshape(B, ng, ns).repeat_interleave(rep, dim=1).float()
    Ch = Cv.reshape(B, ng, ns).repeat_interleave(rep, dim=1).float()
    dA = torch.exp(-torch.exp(p["A_log"]) * dt)                        # [B, nh]
    state = cache["state"] * dA[..., None, None] + (xh * dt[..., None])[..., None] * Bh[:, :, None]
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + p["D"][:, None] * xh
    y = rmsnorm(y.reshape(B, cfg.d_inner) * F.silu(z.float()), p["norm_w"], eps=cfg.norm_eps)
    out = (y.to(x_t.dtype) @ p["out_proj"]).to(x_t.dtype)[:, None, :]
    return out, {"conv": conv_state, "state": state}
