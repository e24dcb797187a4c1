"""The port's dense LM serving path against the JAX package's, on the CPU.

The JAX package draws the weights (``build_model(cfg).init``); they carry
across through ``repro_torch.models.convert.lm_params_from_numpy``, and the
same seeded tokens go through both.  Checked: ``forward`` logits, ``prefill``
last-position logits and the filled KV cache, every ``decode_step`` and
``generate``'s tokens.  Tolerances: 1e-4 abs and rel in float32, where the
greedy tokens must also be equal; 2e-2 in bfloat16, as
``tests/test_arch_smoke.py`` holds prefill to forward (the two frameworks
round bf16 intermediates at other places).  The bf16 KV cache is held to
2e-2 of its largest magnitude: its entries reach ~4, where one bf16 step is
2^-6, and the second layer's K/V already carry the first layer's rounding
differences.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serve.serve_step import generate as jax_generate  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke  # noqa: E402
from repro_torch.core.rng import PRNGKey  # noqa: E402
from repro_torch.models import build_model, param_count  # noqa: E402
from repro_torch.models.convert import lm_params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.serve.serve_step import generate, make_decode_step  # noqa: E402

from test_torch_lm_family import free_jax_executables  # noqa: E402, F401

SMOKE_ARCHS = ["deepseek-7b", "qwen2.5-32b", "nemotron-4-340b"]  # MHA; GQA + bias + 1e6; relu2
B, S, P, CACHE, MAX_NEW = 2, 24, 20, 32, 6
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _tokens(cfg, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module", params=[(a, d) for a in SMOKE_ARCHS for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    """One smoke config in one dtype: the JAX package's outputs and the
    port's, on the same weights and tokens."""
    arch, dtype = request.param
    cfg = jax_get_smoke(arch).replace(dtype=dtype)
    jm = jax_build_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tokens = _tokens(cfg)
    want = {"forward": jm.forward(jparams, {"tokens": tokens})[0]}
    logits, cache = jm.prefill(jparams, {"tokens": tokens[:, :P]}, jm.init_cache(B, CACHE))
    want["prefill"], want["cache_k"], want["cache_v"] = (
        logits, cache["seg0"]["k0"]["k"], cache["seg0"]["k0"]["v"])
    want["decode"] = []
    for i in range(P, S):
        logits, cache = jm.decode(jparams, tokens[:, i:i + 1], cache)
        want["decode"].append(logits)
    want["generate"] = jax_generate(jm, jparams, {"tokens": tokens[:, :P]}, max_new=MAX_NEW,
                                    cache_len=CACHE)

    tcfg = get_smoke(arch).replace(dtype=dtype)
    tm = build_model(tcfg, device="cpu")
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    ttok = torch.from_numpy(tokens)
    got = {"forward": tm.forward(tparams, {"tokens": ttok})[0]}
    logits, tcache = tm.prefill(tparams, {"tokens": ttok[:, :P]}, tm.init_cache(B, CACHE))
    got["prefill"], got["cache_k"], got["cache_v"] = logits, tcache["k"].clone(), tcache["v"].clone()
    got["decode"] = []
    for i in range(P, S):
        logits, tcache = tm.decode(tparams, ttok[:, i:i + 1], tcache)
        got["decode"].append(logits)
    got["generate"] = generate(tm, tparams, {"tokens": ttok[:, :P]}, max_new=MAX_NEW,
                               cache_len=CACHE)
    return dtype, want, got


def _close(got, want, dtype, msg="", scaled=False):
    want = np.asarray(want, np.float32)
    atol = TOL[dtype] * (np.abs(want).max() if scaled and dtype == "bfloat16" else 1.0)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype], atol=atol,
                               err_msg=msg)


def test_forward_logits_match_jax(case):
    dtype, want, got = case
    assert got["forward"].dtype == torch.float32 and got["forward"].shape == (B, S, 512)
    _close(got["forward"], want["forward"], dtype)


def test_prefill_logits_and_cache_match_jax(case):
    dtype, want, got = case
    assert got["prefill"].shape == (B, 1, 512)
    _close(got["prefill"], want["prefill"], dtype)
    _close(got["cache_k"], want["cache_k"], dtype, "cache k", scaled=True)
    _close(got["cache_v"], want["cache_v"], dtype, "cache v", scaled=True)


def test_decode_steps_match_jax(case):
    dtype, want, got = case
    for i, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        _close(g, w, dtype, f"decode step {P + i}")


def test_generate_matches_jax(case):
    dtype, want, got = case
    assert got["generate"].dtype == torch.int32 and got["generate"].shape == (B, MAX_NEW)
    if dtype == "float32":
        np.testing.assert_array_equal(got["generate"].numpy(), np.asarray(want["generate"]))
    else:  # near-tied bf16 logits may pick another token; the first pick is the prefill's
        np.testing.assert_array_equal(got["generate"][:, 0].numpy(),
                                      np.asarray(want["generate"])[:, 0])


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_port_prefill_and_decode_match_forward(arch, dtype, tol):
    """prefill(prompt) + decode_step == teacher-forced forward, in the port
    alone (``tests/test_arch_smoke.py``'s check; bf16 at its tolerance)."""
    cfg = get_smoke(arch).replace(dtype=dtype)
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    tokens = torch.from_numpy(_tokens(cfg, seed=7))
    full, _ = m.forward(params, {"tokens": tokens})
    logits, cache = m.prefill(params, {"tokens": tokens[:, :P]}, m.init_cache(B, S + 8))
    torch.testing.assert_close(logits[:, -1], full[:, P - 1], rtol=tol, atol=tol)
    for i in range(P, S):
        logits, cache = m.decode(params, tokens[:, i:i + 1], cache)
        torch.testing.assert_close(logits[:, 0], full[:, i], rtol=tol, atol=tol)


def test_rolling_window_cache_decode_matches_jax():
    """A cache no longer than the window is a rolling buffer: writes wrap and
    every live entry is attended."""
    cfg = jax_get_smoke("deepseek-7b").replace(dtype="float32", window=8)
    jm = jax_build_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    tokens = _tokens(cfg, seed=9)
    tm = build_model(get_smoke("deepseek-7b").replace(dtype="float32", window=8), device="cpu")
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tm.cfg, "cpu")
    jcache, tcache = jm.init_cache(B, 8), tm.init_cache(B, 8)
    for i in range(12):
        jl, jcache = jm.decode(jparams, tokens[:, i:i + 1], jcache)
        tl, tcache = tm.decode(tparams, torch.from_numpy(tokens[:, i:i + 1]), tcache)
        _close(tl, jl, "float32", f"step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for mine, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke(arch), jax_get_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
        assert mine.model_flops_per_token(backward=False) == ref.model_flops_per_token(
            backward=False)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


def test_param_count_and_sampling():
    cfg = get_smoke("deepseek-7b").replace(dtype="float32")
    m = build_model(cfg, device="cpu")
    jparams = jax_build_model(jax_get_smoke("deepseek-7b")).init(jax.random.PRNGKey(0))
    params = m.init(0)
    assert param_count(params) == sum(x.size for x in jax.tree.leaves(jparams))
    cache = m.init_cache(B, CACHE)
    logits, cache = m.prefill(params, {"tokens": torch.from_numpy(_tokens(cfg))[:, :P]}, cache)
    token = logits[:, -1].argmax(-1, keepdim=True).int()
    nxt, logits, _ = make_decode_step(m, sample=True)(params, token, cache, PRNGKey(1))
    assert nxt.shape == (B, 1) and nxt.dtype == torch.int32
    assert bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all())


def test_bfloat16_weights_carry_bit_for_bit():
    w = jax.random.normal(jax.random.PRNGKey(2), (5, 7), "bfloat16")
    t = tensor_from_numpy(np.asarray(w), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16))
