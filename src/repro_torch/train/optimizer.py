"""AdamW with a warmup + cosine schedule and global-norm clipping, in plain
tensor ops, as the JAX package's ``train/optimizer.py`` computes it: the
gradient clipped by the global norm, the moments in f32, bias corrections
from the f32 step count, decoupled weight decay only on leaves of two or more
dimensions, the update in f32 and cast back to the parameter's dtype.
(``torch.optim.AdamW`` decays before the step and does not clip, so its bits
differ.)

Parameters, gradients and moments are dictionaries keyed by parameter name.
Unlike the JAX package, whose arrays are immutable, the updates write the new
parameters into the given tensors in place (a 1.3e9-parameter model keeps one
copy on the card) and return the same dictionary.

``adamw_update_8bit`` keeps the moments block-wise in int8 (blocks of 256
along the last axis, an f32 scale a block, round half to even), a quarter of
the f32 moments' bytes.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 count): linear warmup, then a
    cosine decay to ``min_lr_frac`` of ``lr`` at ``total_steps``; f32."""
    step = torch.as_tensor(step).float()
    dev = step.device
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0, dev))
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.minimum(torch.maximum(prog, _f32(0.0, dev)), _f32(1.0, dev))
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init_opt_state(params: dict) -> dict:
    zeros = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for name, p in params.items()}
    device = next(iter(params.values())).device
    return {"m": zeros, "v": {name: torch.zeros_like(z) for name, z in zeros.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


# ---- 8-bit optimizer states (block-wise quantization) ----------------------

_QBLOCK = 256


def _whole_rows(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` split along its last axis gathered there (a block of
    256 would straddle the shards); anything else as it is."""
    placements = getattr(x, "placements", ())
    if not any(pl.is_shard(x.ndim - 1) for pl in placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if pl.is_shard(x.ndim - 1) else pl
                                          for pl in placements])


def _q8_block(x: torch.Tensor):
    """f32 ``x [..., n]`` -> (int8 codes ``[..., n]``, f32 scales
    ``[..., ceil(n / 256)]``): each block of 256 along the last axis (the
    last one padded with zeros) scaled by its largest magnitude / 127."""
    x = _whole_rows(x)
    *lead, last = x.shape
    pad = (-last) % _QBLOCK
    xb = torch.nn.functional.pad(x, (0, pad)).view(*lead, (last + pad) // _QBLOCK, _QBLOCK)
    scale = xb.abs().amax(-1, keepdim=True) / 127.0
    scale = torch.maximum(scale, _f32(1e-12, x.device))
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.view(*lead, last + pad)[..., :last], scale[..., 0]


def _dq8_block(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = _whole_rows(q)
    *lead, last = q.shape
    pad = (-last) % _QBLOCK
    qb = torch.nn.functional.pad(q, (0, pad)).view(*lead, (last + pad) // _QBLOCK, _QBLOCK)
    x = qb.float() * scale[..., None]
    return x.view(*lead, last + pad)[..., :last]


def init_opt_state_8bit(params: dict) -> dict:
    def zq(p):
        q, s = _q8_block(torch.zeros_like(p, dtype=torch.float32,
                                          memory_format=torch.contiguous_format))
        return {"q": q, "scale": s}

    device = next(iter(params.values())).device
    return {"m": {name: zq(p) for name, p in params.items()},
            "v": {name: zq(p) for name, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors: dict) -> torch.Tensor:
    """sqrt of the sum over every tensor of its f32 squares' sum."""
    total = None
    for g in tensors.values():
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _decays(params: dict, decay) -> dict:
    if decay is None:
        return {name: p.dim() >= 2 for name, p in params.items()}
    return decay


def _prologue(cfg: AdamWConfig, grads: dict, state: dict):
    count = state["count"] + 1
    gnorm = global_norm(grads)
    dev = gnorm.device
    scale = torch.minimum(_f32(1.0, dev), cfg.clip_norm / torch.maximum(gnorm, _f32(1e-9, dev)))
    lr = schedule(cfg, count)
    cf = count.float()
    b1c = 1 - torch.pow(_f32(cfg.b1, dev), cf)
    b2c = 1 - torch.pow(_f32(cfg.b2, dev), cf)
    return count, gnorm, scale, lr, b1c, b2c


@torch.no_grad()
def _apply(cfg, p, m, v, lr, b1c, b2c, decay: bool):
    """Write p's update in place: ``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``."""
    step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    pf = p.float()
    wd = cfg.weight_decay if decay else 0.0
    p.copy_(pf - lr * (step + wd * pf))


def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict, *, decay=None):
    """One AdamW step -> (params, state, {"grad_norm", "lr"}).  ``decay``
    (parameter name -> bool) says which parameters take weight decay: by
    default those of two or more dimensions (the JAX package's rule on its
    leaves; a model's stacked layers count their layer axis, see
    ``train_step.decay_mask``).  The parameters are updated in place."""
    count, gnorm, scale, lr, b1c, b2c = _prologue(cfg, grads, state)
    decay = _decays(params, decay)
    new_m, new_v = {}, {}
    for name, p in params.items():
        g = grads[name].float() * scale
        m = cfg.b1 * state["m"][name] + (1 - cfg.b1) * g
        v = cfg.b2 * state["v"][name] + (1 - cfg.b2) * torch.square(g)
        _apply(cfg, p, m, v, lr, b1c, b2c, decay[name])
        new_m[name], new_v[name] = m, v
    return params, {"m": new_m, "v": new_v, "count": count}, {"grad_norm": gnorm, "lr": lr}


def adamw_update_8bit(cfg: AdamWConfig, params: dict, grads: dict, state: dict, *, decay=None):
    """``adamw_update`` with the moments kept block-wise in int8: each step
    dequantizes them, updates in f32 and quantizes them again."""
    count, gnorm, scale, lr, b1c, b2c = _prologue(cfg, grads, state)
    decay = _decays(params, decay)
    new_m, new_v = {}, {}
    for name, p in params.items():
        g = grads[name].float() * scale
        mq, vq = state["m"][name], state["v"][name]
        m = cfg.b1 * _dq8_block(mq["q"], mq["scale"]) + (1 - cfg.b1) * g
        v = cfg.b2 * _dq8_block(vq["q"], vq["scale"]) + (1 - cfg.b2) * torch.square(g)
        _apply(cfg, p, m, v, lr, b1c, b2c, decay[name])
        (mq_q, mq_s), (vq_q, vq_s) = _q8_block(m), _q8_block(v)
        new_m[name], new_v[name] = {"q": mq_q, "scale": mq_s}, {"q": vq_q, "scale": vq_s}
    return params, {"m": new_m, "v": new_v, "count": count}, {"grad_norm": gnorm, "lr": lr}
