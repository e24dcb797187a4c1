"""Feed-forward variants: SwiGLU (llama/deepseek/qwen), GeGLU (gemma),
GELU (whisper), squared-ReLU (nemotron-4)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import dense_init


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None,
             dtype=torch.float32) -> nn.ParameterDict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    out_scale = ff ** -0.5 / (2 * cfg.n_layers) ** 0.5
    if cfg.mlp_act in ("swiglu", "geglu"):
        names = {"w_gate": (d, ff, None), "w_up": (d, ff, None), "w_down": (ff, d, out_scale)}
    else:
        names = {"w_up": (d, ff, None), "w_down": (ff, d, out_scale)}
    return nn.ParameterDict({
        k: nn.Parameter(dense_init(gen, i, o, scale=s, dtype=dtype), requires_grad=False)
        for k, (i, o, s) in names.items()
    })


def mlp_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = cfg.mlp_act
    if act == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if act == "geglu":
        return (F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])) @ p["w_down"]
    h = x @ p["w_up"]
    if act == "gelu":
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default form
    elif act == "relu2":  # squared ReLU (Primer / nemotron-4)
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown mlp_act {act}")
    return h @ p["w_down"]
