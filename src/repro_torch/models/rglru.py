"""Griffin / RecurrentGemma recurrent block (RG-LRU, arXiv:2402.19427).

Recurrence: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) with
a_t = exp(-c * softplus(lam) * r_t), r_t and i_t sigmoid gates.  The prompt
runs a log-depth associative scan over time (``associative_scan``: about
2 log2(S) elementwise steps, 24 at S = 4096); decode is the O(1) update.
The block wraps the LRU in the Griffin shape: two input branches (a GeLU
gate, and a conv then the LRU) multiplied, then the output projection.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import _normal, causal_conv1d, causal_conv1d_step, dense_init, softplus

_C = 8.0  # Griffin's fixed recurrence sharpness


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype) -> nn.ParameterDict:
    d, w = cfg.d_model, cfg.rnn_width
    dev = gen.device
    # lam so that a^c is uniform in [0.9, 0.999] (the paper's appendix)
    u = 0.9 + 0.099 * torch.rand((w,), generator=gen, device=dev)
    p = {
        "w_x": dense_init(gen, d, w, dtype=dtype),              # recurrent branch
        "w_gate": dense_init(gen, d, w, dtype=dtype),           # GeLU branch
        "conv_w": _normal(gen, (4, w), 0.1, dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "w_rg": dense_init(gen, w, w, dtype=dtype),             # recurrence gate
        "b_rg": torch.zeros((w,), dtype=torch.float32, device=dev),
        "w_ig": dense_init(gen, w, w, dtype=dtype),             # input gate
        "b_ig": torch.zeros((w,), dtype=torch.float32, device=dev),
        "lam": torch.log(torch.expm1(-torch.log(u) / _C)),      # inverse softplus
        "w_out": dense_init(gen, w, d, scale=w ** -0.5 / (2 * cfg.n_layers) ** 0.5, dtype=dtype),
    }
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in p.items()})


def _gates(p, xb: torch.Tensor):
    """(a, b) of h_t = a * h_{t-1} + b, in f32."""
    xf = xb.float()
    r = torch.sigmoid(xf @ p["w_rg"].float() + p["b_rg"])
    i = torch.sigmoid(xf @ p["w_ig"].float() + p["b_ig"])
    log_a = -_C * softplus(p["lam"]) * r
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return torch.exp(log_a), beta * (i * xf)


def _combine(a1, u1, a2, u2):
    """Two steps of the recurrence, the earlier first."""
    return a1 * a2, u1 * a2 + u2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Elements even[0], odd[0], even[1], odd[1], ... along dim 1."""
    shape = list(even.shape)
    shape[1] += odd.shape[1]
    out = even.new_empty(shape)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a: torch.Tensor, u: torch.Tensor):
    """Inclusive scan of the recurrence over dim 1, ``jax.lax.associative_scan``'s
    odd/even recursion: combine adjacent pairs, scan those, then fill in the
    even positions."""
    n = a.shape[1]
    if n < 2:
        return a, u
    ra, ru = _combine(a[:, 0:-1:2], u[:, 0:-1:2], a[:, 1::2], u[:, 1::2])
    oa, ou = associative_scan(ra, ru)
    if n % 2 == 0:
        ea, eu = _combine(oa[:, :-1], ou[:, :-1], a[:, 2::2], u[:, 2::2])
    else:
        ea, eu = _combine(oa, ou, a[:, 2::2], u[:, 2::2])
    ea, eu = torch.cat([a[:, :1], ea], dim=1), torch.cat([u[:, :1], eu], dim=1)
    return _interleave(ea, oa), _interleave(eu, ou)


def rglru_forward(p, x: torch.Tensor, cfg: ModelConfig):
    """x [B, S, d] -> (y [B, S, d], cache with the conv tail and the last h)."""
    xb = x @ p["w_x"]
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    K = p["conv_w"].shape[0]
    conv_tail = F.pad(xb, (0, 0, K - 1, 0))[:, xb.shape[1]:]
    xb = causal_conv1d(xb, p["conv_w"], p["conv_b"])
    _, h = associative_scan(*_gates(p, xb))
    y = (h.to(x.dtype) * gate) @ p["w_out"]
    return y, {"conv": conv_tail, "h": h[:, -1]}


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    return {"conv": torch.zeros((batch, 3, cfg.rnn_width), dtype=dtype, device=device),
            "h": torch.zeros((batch, cfg.rnn_width), dtype=torch.float32, device=device)}


def rglru_decode(p, x_t: torch.Tensor, cfg: ModelConfig, cache: dict):
    """x_t [B, 1, d] -> (y [B, 1, d], the next cache)."""
    xb = x_t[:, 0] @ p["w_x"]
    gate = F.gelu(x_t[:, 0] @ p["w_gate"], approximate="tanh")
    xb, conv_state = causal_conv1d_step(xb, cache["conv"], p["conv_w"], p["conv_b"])
    a, u = _gates(p, xb)
    h = a * cache["h"] + u
    return ((h.to(x_t.dtype) * gate) @ p["w_out"])[:, None, :], {"conv": conv_state, "h": h}
