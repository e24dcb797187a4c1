"""Decoder-only LM stack: the dense, MoE, SSM, hybrid and VLM families (the
VLM backbone is the dense stack, with patch embeddings spliced over the
first token positions).

Layers are organised in *segments*, as in the JAX package: a block pattern
(e.g. ``("rec", "rec", "att")``) repeated ``repeats`` times.  The JAX package
stacks each segment's parameters and runs them with ``lax.scan``; here every
layer is a ``Block`` module in an ``nn.ModuleList``, in the reference's scan
order (segment, then repeat, then pattern slot), and runs in a Python loop.

Training (``loss_fn``) runs the same forward with autograd; under
``cfg.remat`` each block runs under ``torch.utils.checkpoint``, as the JAX
package wraps each scanned group in ``jax.checkpoint``, so its activations are
recomputed in the backward pass (the flash and assign kernels run again there,
with the same bits).

The cache holds one stacked tensor per kind of state, each layer writing its
own slice in place: ``k``/``v`` ``[n_att, B, Hkv, max_len, dh]`` for the
attention layers (``att`` and ``moe``), ``ssm_conv``/``ssm_state`` for the
SSM layers and ``rec_conv``/``rec_h`` for the RG-LRU layers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import (constrain_batch, embed_rows, gather_block, gather_table,
                                 is_dtensor, maybe_shard_seq)

from .attention import (
    attention_decode,
    attention_prefill,
    attention_train,
    init_attention,
    init_kv_cache,
)
from .config import ModelConfig
from .layers import MetaGenerator, embed_init, rmsnorm
from .mlp import init_mlp, mlp_forward
from .moe import AUX_KEYS, init_moe, moe_forward
from .rglru import init_rglru, init_rglru_cache, rglru_decode, rglru_forward
from .ssm import init_ssm, init_ssm_cache, ssm_decode, ssm_forward


class Segment(NamedTuple):
    pattern: tuple  # block kinds, e.g. ("att",) or ("rec", "rec", "att")
    repeats: int


def plan_segments(cfg: ModelConfig) -> list[Segment]:
    if cfg.family in ("dense", "vlm"):
        return [Segment(("att",), cfg.n_layers)]
    if cfg.family == "moe":
        return [Segment(("moe",), cfg.n_layers)]
    if cfg.family == "ssm":
        return [Segment(("ssm",), cfg.n_layers)]
    if cfg.family == "hybrid":
        pat = tuple(cfg.block_pattern)
        reps, rem = divmod(cfg.n_layers, len(pat))
        return [Segment(pat, reps)] + ([Segment(pat[:rem], 1)] if rem else [])
    raise ValueError(f"family {cfg.family!r} has no decoder-only stack (the encoder-decoder "
                     "runs in models/encdec.py)")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Every layer's kind, in the port's layer order."""
    return [kind for seg in plan_segments(cfg) for _ in range(seg.repeats) for kind in seg.pattern]


# each kind's cache entries: the layer's own name -> the stacked entry's
CACHE_ENTRIES = {"att": {"k": "k", "v": "v"}, "moe": {"k": "k", "v": "v"},
                 "ssm": {"conv": "ssm_conv", "state": "ssm_state"},
                 "rec": {"conv": "rec_conv", "h": "rec_h"}}


def _zeros(d: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros((d,), dtype=dtype, device=device), requires_grad=False)


class Block(nn.Module):
    """One layer of kind ``"att"``, ``"moe"``, ``"ssm"`` or ``"rec"``: ``ln1``
    and its mixer (``attn``, ``ssm`` or ``rec``), then, for every kind but
    ``"ssm"``, ``ln2`` and its feed-forward (``mlp`` or ``moe``); each with a
    residual."""

    def __init__(self, kind: str, **parts):
        super().__init__()
        self.kind = kind
        for name, part in parts.items():
            setattr(self, name, part)


class LM(nn.Module):
    """Parameters of the decoder stack; the functions below run it."""

    def __init__(self, embed: nn.Parameter, layers: list[Block], final_norm: nn.Parameter,
                 lm_head: nn.Parameter | None):
        super().__init__()
        self.embed, self.final_norm, self.lm_head = embed, final_norm, lm_head
        self.layers = nn.ModuleList(layers)


# ----------------------------------------------------------------- blocks ---


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype) -> Block:
    ln = lambda: _zeros(cfg.d_model, dtype, gen.device)  # noqa: E731
    if kind == "att":
        return Block(kind, ln1=ln(), attn=init_attention(gen, cfg, dtype), ln2=ln(),
                     mlp=init_mlp(gen, cfg, dtype=dtype))
    if kind == "moe":
        return Block(kind, ln1=ln(), attn=init_attention(gen, cfg, dtype), ln2=ln(),
                     moe=init_moe(gen, cfg, dtype))
    if kind == "ssm":
        return Block(kind, ln1=ln(), ssm=init_ssm(gen, cfg, dtype))
    if kind == "rec":
        return Block(kind, ln1=ln(), rec=init_rglru(gen, cfg, dtype), ln2=ln(),
                     mlp=init_mlp(gen, cfg, dtype=dtype))
    raise ValueError(kind)


def _ffn(p: Block, x: torch.Tensor, cfg: ModelConfig, with_aux: bool = False):
    """The block's second half: x plus its MLP or MoE output (and the MoE aux)."""
    h = rmsnorm(x, p.ln2, eps=cfg.norm_eps)
    if p.kind == "moe":
        y, aux = moe_forward(p.moe, h, cfg, with_aux=with_aux)
        return constrain_batch(x + y.to(x.dtype)), aux
    return constrain_batch(x + mlp_forward(p.mlp, h, cfg)), None


def block_train(p: Block, x: torch.Tensor, cfg: ModelConfig):
    """-> (x, the MoE aux or None).  On a mesh each residual sum is pinned
    to the data-parallel split (``constrain_batch``): a row-parallel
    projection's partial sums are added up there, once, in the activations'
    dtype, and the next norm reads whole rows."""
    h = rmsnorm(x, p.ln1, eps=cfg.norm_eps)
    if p.kind == "ssm":
        return constrain_batch(x + ssm_forward(p.ssm, h, cfg)[0].to(x.dtype)), None
    if p.kind == "rec":
        x = constrain_batch(x + rglru_forward(p.rec, h, cfg)[0].to(x.dtype))
    else:
        x = constrain_batch(x + attention_train(p.attn, h, cfg))
    return _ffn(p, x, cfg, with_aux=True)


def _write(cache: dict, new: dict) -> None:
    for name, t in new.items():
        cache[name].copy_(t)


def block_prefill(p: Block, x: torch.Tensor, cfg: ModelConfig, cache: dict, start: int):
    h = rmsnorm(x, p.ln1, eps=cfg.norm_eps)
    if p.kind == "ssm":
        y, new = ssm_forward(p.ssm, h, cfg)
        _write(cache, new)
        return constrain_batch(x + y.to(x.dtype)), cache
    if p.kind == "rec":
        y, new = rglru_forward(p.rec, h, cfg)
        _write(cache, new)
        x = constrain_batch(x + y.to(x.dtype))
    else:
        y, cache = attention_prefill(p.attn, h, cfg, cache, start=start)
        x = constrain_batch(x + y)
    return _ffn(p, x, cfg)[0], cache


def block_decode(p: Block, x_t: torch.Tensor, cfg: ModelConfig, cache: dict, kv_len: int):
    h = rmsnorm(x_t, p.ln1, eps=cfg.norm_eps)
    if p.kind == "ssm":
        y, new = ssm_decode(p.ssm, h, cfg, cache)
        _write(cache, new)
        return constrain_batch(x_t + y.to(x_t.dtype)), cache
    if p.kind == "rec":
        y, new = rglru_decode(p.rec, h, cfg, cache)
        _write(cache, new)
        x_t = constrain_batch(x_t + y.to(x_t.dtype))
    else:
        y, cache = attention_decode(p.attn, h, cfg, cache, kv_len)
        x_t = constrain_batch(x_t + y)
    return _ffn(p, x_t, cfg)[0], cache


# ------------------------------------------------------------------ model ---


def _generator(rng, device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    if torch.device(device).type == "meta":
        return MetaGenerator().manual_seed(int(rng))
    return torch.Generator(device=device).manual_seed(int(rng))


def init_params(rng, cfg: ModelConfig, device="cuda") -> LM:
    """Random weights with the JAX package's scales, drawn on ``device`` from
    ``rng`` (a seed or a ``torch.Generator``)."""
    gen = _generator(rng, device)
    dtype = getattr(torch, cfg.dtype)
    layers = [init_block(gen, cfg, kind, dtype) for kind in layer_kinds(cfg)]
    head = None if cfg.tie_embeddings else embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    return LM(
        nn.Parameter(embed_init(gen, cfg.vocab_size, cfg.d_model, dtype), requires_grad=False),
        layers, _zeros(cfg.d_model, dtype, gen.device),
        None if head is None else nn.Parameter(head, requires_grad=False),
    )


def _embed(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
           patch_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings; a VLM's ``patch_embeds [B, P, d]`` (the vision
    stub's output) replace the first P positions.  On the card the gather's
    backward (``index_put_`` with accumulation) sorts the ids and adds each
    row's gradients in that order, without float atomics, so it has the same
    bits on every run.

    On a mesh (a ``DTensor`` table) the gather is vocab-parallel
    (``embed_rows``); its result is re-pinned to the data-parallel axes
    (``constrain_batch``, as the JAX package does)."""
    x = embed_rows(params.embed, tokens)
    x = constrain_batch(x)
    if cfg.family == "vlm" and patch_embeds is not None:
        P = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, P:]], dim=1)
    return x


def _logits(params: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """f32 logits; on a mesh the head is all-gathered over its FSDP axes
    first (its vocab split over 'model' stays), so the batch stays split."""
    head = params.embed if cfg.tie_embeddings else params.lm_head
    return (x @ gather_table(head).T).float()


def forward(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
            patch_embeds: torch.Tensor | None = None):
    """Teacher-forced full-sequence forward -> (logits f32[B,S,V], aux).
    ``aux`` holds the MoE losses summed over the layers, zero without MoE
    layers."""
    x = _embed(params, cfg, tokens, patch_embeds)
    aux = {k: torch.zeros((), device=x.device) for k in AUX_KEYS}
    for layer in params.layers:
        if cfg.seq_shard:
            x = maybe_shard_seq(x)
        x, layer_aux = remat(_layer_train, cfg, layer, x, cfg)
        if layer_aux is not None:
            aux = {k: aux[k] + layer_aux[k] for k in AUX_KEYS}
    x = rmsnorm(x, params.final_norm, eps=cfg.norm_eps)
    return _logits(params, cfg, x), aux


def _layer_train(layer: Block, x: torch.Tensor, cfg: ModelConfig):
    """One layer of the training forward, with the JAX package's constraints
    on a mesh (each the identity without one): under ``seq_shard`` the
    seq-sharded boundary is re-gathered for the tensor-parallel matmuls
    (``constrain_batch``), and under ``explicit_fsdp_gather`` the layer's
    parameters are all-gathered over the FSDP axes here, inside the remat
    region, so the backward pass gathers them again."""
    if cfg.seq_shard:
        x = constrain_batch(x)
    if cfg.explicit_fsdp_gather:
        layer = gather_block(layer)
    return block_train(layer, x, cfg)


def remat(fn, cfg: ModelConfig, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    ``cfg.remat`` is set and autograd records: the block keeps only its
    inputs, and the backward pass runs it again."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def loss_fn(params: LM, cfg: ModelConfig, batch: dict):
    """Next-token cross-entropy over ``loss_mask`` (all positions without
    one) plus the MoE aux losses, ``0.01 * moe_lb_loss + 1e-3 * moe_z_loss``
    -> (loss, metrics).  ``batch``: ``tokens``, ``loss_mask``?,
    ``patch_embeds``? (VLM)."""
    tokens = batch["tokens"]
    logits, aux = forward(params, cfg, tokens, batch.get("patch_embeds"))
    logits = logits[:, :-1]
    targets = tokens[:, 1:].long()
    mask = batch.get("loss_mask")
    mask = (torch.ones_like(targets, dtype=torch.float32) if mask is None
            else mask[:, 1:].float())
    logz = torch.logsumexp(logits, dim=-1)
    gold = gold_logits(logits, targets)
    nll = (logz - gold) * mask
    loss = nll.sum() / torch.maximum(mask.sum(), torch.ones((), device=mask.device))
    total = loss + 0.01 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
    return total, dict(aux, nll=loss)


def gold_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Each position's logit of its target.  On a mesh, where the vocab is
    split over 'model', a masked sum over the vocab: each rank sums its own
    columns and the partial sums add up (a gather would replicate them)."""
    if is_dtensor(logits):
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(vocab == targets[..., None], logits, 0.0).sum(-1)
    return torch.gather(logits, -1, targets[..., None])[..., 0]


# ---------------------------------------------------------------- serving ---


def _one_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype, device) -> dict:
    if kind == "ssm":
        return init_ssm_cache(cfg, batch, dtype, device)
    if kind == "rec":
        return init_rglru_cache(cfg, batch, dtype, device)
    return init_kv_cache(cfg, batch, max_len, dtype, device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> dict:
    """``{"len": 0}`` and, for the kinds of state the layers keep, stacked
    zeros in the model's dtype (the SSM and LRU states in f32): ``k``/``v``
    ``[n_att, B, Hkv, max_len, dh]``, ``ssm_conv``/``ssm_state``
    ``[n_ssm, ...]``, ``rec_conv``/``rec_h`` ``[n_rec, ...]``.  A ``max_len``
    no longer than the attention window makes the K/V a rolling buffer."""
    dtype = getattr(torch, cfg.dtype)
    kinds = layer_kinds(cfg)
    cache = {"len": 0}
    for kind in dict.fromkeys(kinds):
        n = sum(CACHE_ENTRIES[k] == CACHE_ENTRIES[kind] for k in kinds)
        for name, t in _one_cache(cfg, kind, batch, max_len, dtype, device).items():
            cache[CACHE_ENTRIES[kind][name]] = t[None].repeat(n, *([1] * t.dim()))
    return cache


def _layer_caches(cfg: ModelConfig, cache: dict) -> list[dict]:
    """Each layer's slice of the stacked cache (views: layers write in place)."""
    seen: dict = {}   # layers so far of each stack
    out = []
    for kind in layer_kinds(cfg):
        entries = CACHE_ENTRIES[kind]
        stack = next(iter(entries.values()))
        j = seen[stack] = seen.get(stack, -1) + 1
        out.append({name: cache[entry][j] for name, entry in entries.items()})
    return out


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
            patch_embeds: torch.Tensor | None = None):
    """Consume the prompt (a VLM's patches spliced over its first
    positions), fill the cache, return last-position logits."""
    x = _embed(params, cfg, tokens, patch_embeds)
    for layer, layer_cache in zip(params.layers, _layer_caches(cfg, cache)):
        if cfg.explicit_fsdp_gather:
            layer = gather_block(layer)
        x, _ = block_prefill(layer, x, cfg, layer_cache, 0)
    x = rmsnorm(x, params.final_norm, eps=cfg.norm_eps)
    cache["len"] = tokens.shape[1]
    return _logits(params, cfg, x[:, -1:]), cache


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, token: torch.Tensor, cache: dict):
    """token i32[B, 1] -> (logits f32[B, 1, V], the cache updated in place)."""
    x = embed_rows(params.embed, token)
    kv_len = cache["len"]
    for layer, layer_cache in zip(params.layers, _layer_caches(cfg, cache)):
        x, _ = block_decode(layer, x, cfg, layer_cache, kv_len)
    x = rmsnorm(x, params.final_norm, eps=cfg.norm_eps)
    cache["len"] = kv_len + 1
    return _logits(params, cfg, x), cache
