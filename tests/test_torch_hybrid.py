"""The port's RG-LRU layer and the recurrentgemma hybrid against the JAX
package's, on the CPU.

``associative_scan`` follows ``jax.lax.associative_scan``'s odd/even
recursion and is held to it within 1e-6 on odd and even lengths;
``rglru_forward`` with its cache and ``rglru_decode`` within 1e-5 in
float32.  The recurrentgemma-2b smoke config (4 layers: a ``(rec, rec,
att)`` segment and a ``(rec,)`` remainder) runs through the model as
``test_torch_lm_family`` sets out, in float32 and bfloat16, and its rolling cache
(``cache_len = window``) decodes past the window as the reference's does.  A
prompt longer than the window, which the reference cannot write into a
rolling cache, leaves the port's next-token logits those of the reference's
full-length cache.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro.models.transformer import plan_segments as jax_plan_segments  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.convert import tensor_from_numpy  # noqa: E402
from repro_torch.models.transformer import layer_kinds, plan_segments  # noqa: E402

import test_torch_lm_family as fam  # noqa: E402
from test_torch_lm_family import free_jax_executables  # noqa: E402, F401

ARCH = "recurrentgemma-2b"


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 13, 64, 100])
def test_associative_scan_matches_jax(n):
    a = np.random.default_rng(n).uniform(0.5, 1.0, (2, n, 5)).astype(np.float32)
    u = _normal((2, n, 5), n + 1)

    def combine(c1, c2):
        return c1[0] * c2[0], c1[1] * c2[0] + c2[1]

    ja, ju = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(u)), axis=1)
    ta, tu = rglru.associative_scan(torch.from_numpy(a), torch.from_numpy(u))
    _close(ta, ja, 1e-6)
    _close(tu, ju, 1e-6)


def test_plan_segments_and_layer_order():
    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_smoke(ARCH), jax_get_smoke(ARCH))):
        assert [tuple(s) for s in plan_segments(cfg)] == [tuple(s) for s in
                                                         jax_plan_segments(jcfg)]
    assert [tuple(s) for s in plan_segments(get_config(ARCH))] == [
        (("rec", "rec", "att"), 8), (("rec", "rec"), 1)]
    kinds = layer_kinds(get_config(ARCH))
    assert len(kinds) == 26 and kinds.count("att") == 8 and kinds[-3:] == ["att", "rec", "rec"]
    assert layer_kinds(get_smoke(ARCH)) == ["rec", "rec", "att", "rec"]


def _layer(cfg, seed):
    jp = jax_rglru.init_rglru(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return jp, {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}


@pytest.mark.parametrize("S", [1, 24, 37])
def test_rglru_forward_and_decode_match_jax(S):
    cfg = jax_get_smoke(ARCH).replace(dtype="float32")
    jp, tp = _layer(cfg, S)
    x = _normal((2, S + 4, cfg.d_model), S)
    jy, jcache = jax_rglru.rglru_forward(jp, jnp.asarray(x[:, :S]), cfg)
    ty, tcache = rglru.rglru_forward(tp, torch.from_numpy(x[:, :S]), cfg)
    _close(ty, jy, msg="forward")
    for name in ("conv", "h"):
        _close(tcache[name], jcache[name], msg=f"cache {name}")
    for i in range(S, S + 4):
        jy, jcache = jax_rglru.rglru_decode(jp, jnp.asarray(x[:, i:i + 1]), cfg, jcache)
        ty, tcache = rglru.rglru_decode(tp, torch.from_numpy(x[:, i:i + 1]), cfg, tcache)
        _close(ty, jy, msg=f"decode {i}")
        for name in ("conv", "h"):
            _close(tcache[name], jcache[name], msg=f"decode {i} cache {name}")


def test_rglru_decode_from_zero_cache_equals_forward():
    cfg = get_smoke(ARCH).replace(dtype="float32")
    _, tp = _layer(jax_get_smoke(ARCH).replace(dtype="float32"), 3)
    x = torch.from_numpy(_normal((2, 10, cfg.d_model), 4))
    want, _ = rglru.rglru_forward(tp, x, cfg)
    cache = rglru.init_rglru_cache(cfg, 2, torch.float32, "cpu")
    for i in range(10):
        y, cache = rglru.rglru_decode(tp, x[:, i:i + 1], cfg, cache)
        torch.testing.assert_close(y[:, 0], want[:, i], rtol=1e-5, atol=1e-5)


# ------------------------------------------------ through the whole model ---


@pytest.fixture(scope="module", params=list(fam.TOL))
def case(request):
    dtype = request.param
    return dtype, fam.run_case(jax_get_smoke(ARCH).replace(dtype=dtype),
                               get_smoke(ARCH).replace(dtype=dtype))


def test_forward_matches_jax(case):
    dtype, (want, got) = case
    fam.check_forward(want, got, dtype)


def test_prefill_logits_and_cache_match_jax(case):
    dtype, (want, got) = case
    assert set(got["cache"]) == {"k", "v", "rec_conv", "rec_h"}
    assert got["cache"]["k"].shape[0] == 1 and got["cache"]["rec_h"].shape[0] == 3
    fam.check_prefill(want, got, dtype)


def test_decode_steps_match_jax(case):
    dtype, (want, got) = case
    fam.check_decode(want, got, dtype)


def test_greedy_and_sampled_generate_match_jax(case):
    dtype, (want, got) = case
    fam.check_generate(want, got, dtype)


def _models(seed=1):
    cfg = jax_get_smoke(ARCH).replace(dtype="float32")
    jm = jax_build_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm, tparams = fam.port_model(jparams, get_smoke(ARCH).replace(dtype="float32"))
    return cfg, jm, jparams, tm, tparams


def test_rolling_cache_decode_matches_jax():
    """cache_len = window (32): a 20-token prompt, then 18 decode steps whose
    K/V writes wrap around the buffer."""
    cfg, jm, jparams, tm, tparams = _models()
    tok = fam.tokens(cfg, seed=11, length=40)
    W = cfg.window
    jl, jcache = jm.prefill(jparams, {"tokens": tok[:, :20]}, jm.init_cache(fam.B, W))
    tl, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(tok[:, :20])},
                            tm.init_cache(fam.B, W))
    fam.close(tl, jl, "float32", "prefill")
    for i in range(20, 38):
        jl, jcache = jm.decode(jparams, tok[:, i:i + 1], jcache)
        tl, tcache = tm.decode(tparams, torch.from_numpy(tok[:, i:i + 1]), tcache)
        fam.close(tl, jl, "float32", f"decode step {i}")


def test_prompt_longer_than_rolling_cache():
    """A 44-token prompt into a 32-slot rolling cache keeps its last 32
    positions; the decode steps after it equal the reference's run with a
    64-slot cache, where the window masks the same positions."""
    cfg, jm, jparams, tm, tparams = _models(2)
    tok = fam.tokens(cfg, seed=12, length=48)
    jl, jcache = jm.prefill(jparams, {"tokens": tok[:, :44]}, jm.init_cache(fam.B, 64))
    tl, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(tok[:, :44])},
                            tm.init_cache(fam.B, cfg.window))
    assert tcache["k"].shape[3] == cfg.window
    fam.close(tl, jl, "float32", "prefill")
    for i in range(44, 48):
        jl, jcache = jm.decode(jparams, tok[:, i:i + 1], jcache)
        tl, tcache = tm.decode(tparams, torch.from_numpy(tok[:, i:i + 1]), tcache)
        fam.close(tl, jl, "float32", f"decode step {i}")
