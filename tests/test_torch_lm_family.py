"""Shared helpers of the port's LM family tests (``test_torch_moe.py``,
``test_torch_ssm.py``, ``test_torch_hybrid.py``): one smoke config through
the JAX package's model and the port's, on the same weights and tokens.

The JAX package draws the weights; they carry across through
``repro_torch.models.convert.lm_params_from_numpy``.  Checked: ``forward``
logits and the MoE aux losses, ``prefill`` last-position logits and every
cached state, every ``decode_step``, and greedy and sampled ``generate``.
Tolerances are ``tests/test_torch_lm_serve.py``'s: 1e-4 abs and rel in
float32, where the tokens must also be equal, 2e-2 in bfloat16, where only
the first token (the prefill's argmax) must be.  Cached states are held to
the tolerance times their largest magnitude in bfloat16.
"""
import gc

import jax
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build_model
from repro.serve.serve_step import generate as jax_generate
from repro_torch.core import rng as prng
from repro_torch.models import build_model
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.models.transformer import CACHE_ENTRIES, plan_segments
from repro_torch.serve.serve_step import generate

B, S, P, CACHE, MAX_NEW = 2, 24, 20, 32, 6
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SAMPLE_SEED = 5


@pytest.fixture(autouse=True)
def free_jax_executables():
    """After each test, drop every program JAX has compiled in this process.
    Each compiled program keeps its code pages mapped; a test worker that
    keeps all of them reaches the kernel's limit on memory maps
    (``vm.max_map_count``, 65530 by default), and XLA then crashes in its
    next compile.  The modules that import this fixture compile the most."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module", autouse=True)
def clear_jax_caches_per_module():
    """``free_jax_executables`` once a module, for the port's other test
    modules that call JAX (each imports it by name): drop the programs JAX
    compiled for the module when it ends (ROADMAP Queue 3 E)."""
    yield
    jax.clear_caches()


def tokens(cfg, seed=3, length=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, length)).astype(np.int32)


def jax_cache_in_port_layout(cfg, cache) -> dict:
    """The JAX cache's ``seg{si}/k{ki}`` stacks, restacked in the port's layer
    order (segment, repeat, pattern slot) under the port's names."""
    out = {}
    for si, seg in enumerate(plan_segments(cfg)):
        for r in range(seg.repeats):
            for ki, kind in enumerate(seg.pattern):
                for name, port_name in CACHE_ENTRIES[kind].items():
                    out.setdefault(port_name, []).append(
                        np.asarray(cache[f"seg{si}"][f"k{ki}"][name][r], np.float32))
    return {k: np.stack(v) for k, v in out.items()}


def port_model(jparams, port_cfg):
    tm = build_model(port_cfg, device="cpu")
    return tm, lm_params_from_numpy(jax.tree.map(np.asarray, jparams), port_cfg, "cpu")


def run_case(jcfg, port_cfg, *, full: bool = True) -> tuple:
    """(want, got) of one config: the JAX package's outputs and the port's.
    Without ``full`` only the prefill and the first tokens are run."""
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tok = tokens(jcfg)
    tm, tparams = port_model(jparams, port_cfg)
    ttok = torch.from_numpy(tok)
    want, got = {}, {}
    if full:
        want["forward"], want["aux"] = jm.forward(jparams, {"tokens": tok})
        got["forward"], got["aux"] = tm.forward(tparams, {"tokens": ttok})
    logits, cache = jm.prefill(jparams, {"tokens": tok[:, :P]}, jm.init_cache(B, CACHE))
    want["prefill"], want["cache"] = logits, jax_cache_in_port_layout(jcfg, cache)
    tlogits, tcache = tm.prefill(tparams, {"tokens": ttok[:, :P]}, tm.init_cache(B, CACHE))
    got["prefill"] = tlogits
    got["cache"] = {k: v.float().numpy().copy() for k, v in tcache.items() if k != "len"}
    if full:
        want["decode"], got["decode"] = [], []
        for i in range(P, S):
            logits, cache = jm.decode(jparams, tok[:, i:i + 1], cache)
            want["decode"].append(logits)
            tlogits, tcache = tm.decode(tparams, ttok[:, i:i + 1], tcache)
            got["decode"].append(tlogits)
    prompt, tprompt = {"tokens": tok[:, :P]}, {"tokens": ttok[:, :P]}
    want["greedy"] = jax_generate(jm, jparams, prompt, max_new=MAX_NEW, cache_len=CACHE)
    got["greedy"] = generate(tm, tparams, tprompt, max_new=MAX_NEW, cache_len=CACHE)
    want["sampled"] = jax_generate(jm, jparams, prompt, max_new=MAX_NEW, cache_len=CACHE,
                                   rng=jax.random.PRNGKey(SAMPLE_SEED))
    got["sampled"] = generate(tm, tparams, tprompt, max_new=MAX_NEW, cache_len=CACHE,
                              rng=prng.PRNGKey(SAMPLE_SEED))
    return want, got


def close(got, want, dtype, msg="", scaled=False):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    atol = TOL[dtype] * (np.abs(want).max() if scaled and dtype == "bfloat16" else 1.0)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=atol, err_msg=msg)


def check_forward(want, got, dtype):
    close(got["forward"], want["forward"], dtype, "forward logits")
    assert got["forward"].dtype == torch.float32
    for k, v in want["aux"].items():
        close(got["aux"][k], v, dtype, k)


def check_prefill(want, got, dtype):
    close(got["prefill"], want["prefill"], dtype, "prefill logits")
    assert set(got["cache"]) == set(want["cache"])
    for name, w in want["cache"].items():
        assert got["cache"][name].shape == w.shape, name
        close(got["cache"][name], w, dtype, f"cache {name}", scaled=True)


def check_decode(want, got, dtype):
    for i, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        close(g, w, dtype, f"decode step {P + i}")


def check_generate(want, got, dtype):
    for mode in ("greedy", "sampled"):
        g, w = got[mode], np.asarray(want[mode])
        assert g.dtype == torch.int32 and g.shape == (B, MAX_NEW), mode
        if dtype == "float32":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=mode)
        else:  # near-tied bf16 logits may pick another token; the first is the prefill's
            np.testing.assert_array_equal(g[:, 0].numpy(), w[:, 0], err_msg=mode)
