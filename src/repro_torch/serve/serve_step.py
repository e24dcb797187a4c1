"""Serving steps: prefill a prompt batch, decode one token for the whole
batch, and the greedy or sampled generation loop over them."""
from __future__ import annotations

import torch

from ..core import rng as prng
from ..models.model import Model


def make_prefill_step(model: Model):
    def prefill_step(params, batch, cache):
        """batch tokens [B, S_prompt] (and the encoder-decoder's ``frames`` or a
        VLM's ``patch_embeds``) -> (next-token logits [B,1,V], cache)."""
        return model.prefill(params, batch, cache)

    return prefill_step


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    last = logits[:, -1]
    if hasattr(last, "redistribute"):   # on a mesh: the last position's logits whole
        from torch.distributed.tensor import Replicate

        last = last.redistribute(last.device_mesh, [Replicate()] * last.device_mesh.ndim)
    return last.argmax(-1, keepdim=True).int()


def make_decode_step(model: Model, *, sample: bool = False, temperature: float = 1.0):
    def decode_step(params, token, cache, rng=None):
        """token i32[B,1] -> (next token i32[B,1], logits, cache).  With
        ``sample`` and a key ``rng`` (``core.rng``'s threefry key) the token is
        ``jax.random.categorical``'s draw from ``logits / temperature``."""
        logits, cache = model.decode(params, token, cache)
        if sample and rng is not None:
            key = rng.to(logits.device)
            nxt = prng.categorical(key, logits[:, -1] / temperature)[:, None].int()
        else:
            nxt = _greedy(logits)
        return nxt, logits, cache

    return decode_step


def generate(model: Model, params, batch, *, max_new: int, cache_len: int, rng=None):
    """``max_new`` tokens i32[B, max_new] after the prompt.  The first is the
    prefill's argmax; with a key ``rng`` step ``i`` then samples under
    ``fold_in(rng, i)``, greedy otherwise."""
    B = batch["tokens"].shape[0]
    cache = model.init_cache(B, cache_len)
    logits, cache = make_prefill_step(model)(params, batch, cache)
    decode = make_decode_step(model, sample=rng is not None)
    cur = _greedy(logits)
    out = [cur]
    for i in range(max_new - 1):
        step_rng = prng.fold_in(rng, i) if rng is not None else None
        cur, logits, cache = decode(params, cur, cache, step_rng)
        out.append(cur)
    return torch.cat(out, dim=1)
