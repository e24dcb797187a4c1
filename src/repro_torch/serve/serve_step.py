"""Serving steps: prefill a prompt batch, decode one token for the whole
batch, and the greedy generation loop over them."""
from __future__ import annotations

import torch

from ..models.model import Model


def make_prefill_step(model: Model):
    def prefill_step(params, batch, cache):
        """batch tokens [B, S_prompt] -> (next-token logits [B,1,V], cache)."""
        return model.prefill(params, batch, cache)

    return prefill_step


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits[:, -1].argmax(-1, keepdim=True).int()


_NO_SAMPLING = ("sampling needs jax.random.categorical's stream in the port's PRNG "
                "(ROADMAP Queue 1 item 14); the port decodes greedily")


def make_decode_step(model: Model, *, sample: bool = False):
    if sample:
        raise NotImplementedError(_NO_SAMPLING)

    def decode_step(params, token, cache):
        """token i32[B,1] -> (next token i32[B,1], logits, cache)."""
        logits, cache = model.decode(params, token, cache)
        return _greedy(logits), logits, cache

    return decode_step


def generate(model: Model, params, batch, *, max_new: int, cache_len: int, rng=None):
    """Greedy generation: ``max_new`` tokens i32[B, max_new] after the prompt
    (the first from the prefill's logits)."""
    if rng is not None:
        raise NotImplementedError(_NO_SAMPLING)
    B = batch["tokens"].shape[0]
    cache = model.init_cache(B, cache_len)
    logits, cache = make_prefill_step(model)(params, batch, cache)
    decode = make_decode_step(model)
    cur = _greedy(logits)
    out = [cur]
    for _ in range(max_new - 1):
        cur, logits, cache = decode(params, cur, cache)
        out.append(cur)
    return torch.cat(out, dim=1)
