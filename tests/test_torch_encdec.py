"""The encoder-decoder (whisper) and VLM (internvl2) families in the port
against the JAX package's, on the CPU, with the JAX package's weights
carried across (``convert.params_from_numpy``).

whisper: ``encode``, ``forward``, ``loss_fn``, ``prefill`` (the decoder's
self K/V and every layer's cross K/V), each ``decode_step``, and greedy and
sampled ``generate``, with ``n_frames`` = 37 against a KV chunk of 16, so
the encoder's and the cross-attention's last chunk is ragged.  internvl2:
``forward``, ``prefill``, ``decode_step`` and ``generate`` with
``patch_embeds`` spliced over the prompt's first positions.  Tolerances
are ``tests/test_torch_lm_family.py``'s; in bfloat16 a first token may
differ from the reference's only where the reference's prefill logits tie
within that tolerance (whisper's seed-0 prompt has one: 0.6055 against
0.6094, one bf16 ulp, which the port rounds to a tie).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.serve.serve_step import generate as jax_generate  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import rng as prng  # noqa: E402
from repro_torch.models import build_model, encdec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.serve_step import generate  # noqa: E402
from test_torch_lm_family import (  # noqa: E402,F401
    B,
    CACHE,
    MAX_NEW,
    P,
    S,
    SAMPLE_SEED,
    TOL,
    check_decode,
    check_forward,
    check_generate,
    check_prefill,
    close,
    free_jax_executables,
    jax_cache_in_port_layout,
    tokens,
)

DTYPES = ["float32", "bfloat16"]
WHISPER = dict(n_frames=37, attn_chunk=16)   # 37 frames: a ragged last chunk


def extras(arch, cfg, seed=11):
    """The stub frontend's output: whisper's frames, internvl2's patches."""
    rng = np.random.default_rng(seed)
    if arch == "whisper-small":
        return {"frames": rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)}
    return {"patch_embeds": rng.standard_normal((B, cfg.n_patches, cfg.d_model))
            .astype(np.float32)}


def models(arch, dtype, **over):
    jcfg = jax_get_smoke(arch).replace(dtype=dtype, **over)
    cfg = get_smoke(arch).replace(dtype=dtype, **over)
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    return jm, jparams, tm, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def cache_entries(arch, jcfg, cache) -> dict:
    if arch != "whisper-small":
        return jax_cache_in_port_layout(jcfg, cache)
    return {"k": cache["self"]["k"], "v": cache["self"]["v"], "cross_k": cache["cross_k"],
            "cross_v": cache["cross_v"]}


def run(arch, dtype, **over) -> tuple:
    """(want, got): the JAX package's outputs and the port's on one smoke
    config, the same weights, tokens and frontend output."""
    jm, jparams, tm, tparams = models(arch, dtype, **over)
    tok = tokens(jm.cfg)
    ex = extras(arch, jm.cfg)
    jb = dict(ex, tokens=tok)
    tb = {k: torch.from_numpy(v) for k, v in jb.items()}
    jprompt, tprompt = dict(jb, tokens=tok[:, :P]), dict(tb, tokens=tb["tokens"][:, :P])
    want, got = {}, {}
    want["forward"], want["aux"] = jm.forward(jparams, jb)
    got["forward"], got["aux"] = tm.forward(tparams, tb)
    logits, cache = jm.prefill(jparams, jprompt, jm.init_cache(B, CACHE))
    want["prefill"], want["cache"] = logits, cache_entries(arch, jm.cfg, cache)
    tlogits, tcache = tm.prefill(tparams, tprompt, tm.init_cache(B, CACHE))
    got["prefill"] = tlogits
    got["cache"] = {k: v.float().numpy().copy() for k, v in tcache.items() if k != "len"}
    want["decode"], got["decode"] = [], []
    for i in range(P, S):
        logits, cache = jm.decode(jparams, tok[:, i:i + 1], cache)
        want["decode"].append(logits)
        tlogits, tcache = tm.decode(tparams, tb["tokens"][:, i:i + 1], tcache)
        got["decode"].append(tlogits)
    want["greedy"] = jax_generate(jm, jparams, jprompt, max_new=MAX_NEW, cache_len=CACHE)
    got["greedy"] = generate(tm, tparams, tprompt, max_new=MAX_NEW, cache_len=CACHE)
    want["sampled"] = jax_generate(jm, jparams, jprompt, max_new=MAX_NEW, cache_len=CACHE,
                                   rng=jax.random.PRNGKey(SAMPLE_SEED))
    got["sampled"] = generate(tm, tparams, tprompt, max_new=MAX_NEW, cache_len=CACHE,
                              rng=prng.PRNGKey(SAMPLE_SEED))
    return want, got


def check_first_tokens(want, got, dtype):
    """In bfloat16 the first token (the prefill's argmax) must be the
    reference's, or a token whose reference logit is within the logits'
    tolerance of the reference's largest (a near-tie that one bf16 rounding
    decides); every other check is ``check_generate``'s."""
    if dtype == "float32":
        return check_generate(want, got, dtype)
    logits = np.asarray(want["prefill"], np.float32)[:, -1]
    for mode in ("greedy", "sampled"):
        g, w = got[mode][:, 0].numpy(), np.asarray(want[mode])[:, 0]
        assert got[mode].dtype == torch.int32 and got[mode].shape == (B, MAX_NEW), mode
        for b in np.flatnonzero(g != w):
            gap = logits[b, w[b]] - logits[b, g[b]]
            assert gap <= TOL[dtype], (mode, b, w[b], g[b], gap)


@pytest.mark.parametrize("dtype", DTYPES)
def test_whisper_matches_jax(dtype):
    want, got = run("whisper-small", dtype, **WHISPER)
    check_forward(want, got, dtype)
    check_prefill(want, got, dtype)
    assert got["cache"]["cross_k"].shape == (2, B, 4, 37, 32)
    check_decode(want, got, dtype)
    check_first_tokens(want, got, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_whisper_encode_and_loss_match_jax(dtype):
    jm, jparams, tm, tparams = models("whisper-small", dtype, **WHISPER)
    ex = extras("whisper-small", jm.cfg)
    tok = tokens(jm.cfg)
    close(encdec.encode(tparams, tm.cfg, torch.from_numpy(ex["frames"])),
          jax_encdec.encode(jparams, jm.cfg, ex["frames"]), dtype, "encoder states")
    want, _ = jax_encdec.loss_fn(jparams, jm.cfg, dict(ex, tokens=tok))
    got, metrics = encdec.loss_fn(tparams, tm.cfg, {"tokens": torch.from_numpy(tok),
                                                    "frames": torch.from_numpy(ex["frames"])})
    close(got, want, dtype, "loss")
    assert torch.equal(metrics["nll"], got)


def test_whisper_prefill_refuses_frames_of_another_length():
    _, _, tm, tparams = models("whisper-small", "float32")
    batch = {"tokens": torch.zeros((B, 4), dtype=torch.int32),
             "frames": torch.zeros((B, 20, tm.cfg.d_model))}
    with pytest.raises(ValueError, match="n_frames"):
        tm.prefill(tparams, batch, tm.init_cache(B, 8))


@pytest.mark.parametrize("dtype", DTYPES)
def test_internvl2_matches_jax(dtype):
    want, got = run("internvl2-26b", dtype)
    check_forward(want, got, dtype)
    check_prefill(want, got, dtype)
    check_decode(want, got, dtype)
    check_first_tokens(want, got, dtype)


def test_internvl2_patches_splice():
    """Patches change the forward; zero patches leave the plain stack's."""
    _, _, tm, tparams = models("internvl2-26b", "float32")
    tok = torch.from_numpy(tokens(tm.cfg))
    pe = torch.from_numpy(extras("internvl2-26b", tm.cfg)["patch_embeds"])
    plain, _ = tm.forward(tparams, {"tokens": tok})
    with_p, _ = tm.forward(tparams, {"tokens": tok, "patch_embeds": pe})
    assert not torch.equal(plain, with_p)
    spliced, _ = tm.forward(tparams, {"tokens": tok, "patch_embeds": pe[:, :0]})
    assert torch.equal(plain, spliced)
