"""The port's Mamba-2 (SSD) layer against the JAX package's, on the CPU.

The causal convolutions, ``ssd_scan`` (with a sequence that is not a
multiple of the chunk, so it pads, and with more than one group of B/C),
``ssm_forward`` with its cache and ``ssm_decode`` are held within 1e-5 in
float32 on the same seeded inputs and weights; ``softplus`` is
``jax.nn.softplus`` above ``F.softplus``'s threshold too.  The mamba2-130m
smoke config runs through the model as ``test_torch_lm_family`` sets out, in
float32 and bfloat16.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402
from repro_torch.models.convert import tensor_from_numpy  # noqa: E402

import test_torch_lm_family as fam  # noqa: E402
from test_torch_lm_family import free_jax_executables  # noqa: E402, F401

TOL = 1e-5


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=msg)


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("bias", [True, False])
def test_causal_conv1d_and_step_match_jax(K, bias):
    x, w = _normal((2, 11, 6), K), _normal((K, 6), 10 + K)
    b = _normal((6,), 3) if bias else None
    want = jax_layers.causal_conv1d(jnp.asarray(x), jnp.asarray(w), None if b is None else
                                    jnp.asarray(b))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    _close(layers.causal_conv1d(t(x), t(w), t(b)), want)
    state = _normal((2, K - 1, 6), 5)
    jy, jstate = jax_layers.causal_conv1d_step(jnp.asarray(x[:, 0]), jnp.asarray(state),
                                               jnp.asarray(w), None if b is None else
                                               jnp.asarray(b))
    ty, tstate = layers.causal_conv1d_step(t(x[:, 0]), t(state), t(w), t(b))
    _close(ty, jy)
    _close(tstate, jstate)


def test_causal_conv1d_bf16_sums_in_f32():
    x = _normal((1, 9, 4), 1)
    w = _normal((4, 4), 2)
    xb, wb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    want = jax_layers.causal_conv1d(xb, wb)
    got = layers.causal_conv1d(tensor_from_numpy(np.asarray(xb), "cpu"),
                               tensor_from_numpy(np.asarray(wb), "cpu"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))


def test_softplus_matches_jax_above_the_threshold():
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 20.5, 25.0, 60.0], np.float32)
    _close(layers.softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)))


@pytest.mark.parametrize("l,chunk,g", [(40, 16, 1), (32, 16, 1), (37, 8, 2), (5, 16, 1)])
def test_ssd_scan_matches_jax(l, chunk, g):
    b, h, p, n = 2, 4, 8, 6
    x = _normal((b, l, h, p), 1)
    dt = np.log1p(np.exp(_normal((b, l, h), 2))).astype(np.float32)
    A_log = np.log(np.arange(1, h + 1, dtype=np.float32))
    B, C = _normal((b, l, g, n), 3), _normal((b, l, g, n), 4)
    jy, jfinal = jax_ssm.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A_log, B, C)), chunk=chunk)
    ty, tfinal = ssm.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A_log, B, C)), chunk=chunk)
    assert ty.shape == (b, l, h, p) and tfinal.shape == (b, h, p, n)
    _close(ty, jy, "y")
    _close(tfinal, jfinal, "final state")


def _layer(cfg, seed):
    jp = jax_ssm.init_ssm(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}
    return jp, tp


@pytest.mark.parametrize("S", [40, 64, 7])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssm_forward_and_decode_match_jax(S, groups):
    """The prompt's forward and cache (40 and 7 tokens pad the 32-token
    chunk), then four decode steps from that cache."""
    cfg = jax_get_smoke("mamba2-130m").replace(dtype="float32", ssm_groups=groups)
    jp, tp = _layer(cfg, S + groups)
    x = _normal((2, S + 4, cfg.d_model), S)
    jy, jcache = jax_ssm.ssm_forward(jp, jnp.asarray(x[:, :S]), cfg)
    ty, tcache = ssm.ssm_forward(tp, torch.from_numpy(x[:, :S]), cfg)
    _close(ty, jy, "forward")
    for name in ("conv", "state"):
        _close(tcache[name], jcache[name], f"cache {name}")
    for i in range(S, S + 4):
        jy, jcache = jax_ssm.ssm_decode(jp, jnp.asarray(x[:, i:i + 1]), cfg, jcache)
        ty, tcache = ssm.ssm_decode(tp, torch.from_numpy(x[:, i:i + 1]), cfg, tcache)
        _close(ty, jy, f"decode {i}")
        for name in ("conv", "state"):
            _close(tcache[name], jcache[name], f"decode {i} cache {name}")


def test_ssm_decode_from_zero_cache_equals_forward():
    """The port alone: decoding token by token from the empty cache gives the
    prompt forward's outputs."""
    cfg = get_smoke("mamba2-130m").replace(dtype="float32")
    _, tp = _layer(jax_get_smoke("mamba2-130m").replace(dtype="float32"), 9)
    x = torch.from_numpy(_normal((2, 12, cfg.d_model), 8))
    want, _ = ssm.ssm_forward(tp, x, cfg)
    cache = ssm.init_ssm_cache(cfg, 2, torch.float32, "cpu")
    for i in range(12):
        y, cache = ssm.ssm_decode(tp, x[:, i:i + 1], cfg, cache)
        torch.testing.assert_close(y[:, 0], want[:, i], rtol=1e-4, atol=1e-5)


# ------------------------------------------------ through the whole model ---


@pytest.fixture(scope="module", params=list(fam.TOL))
def case(request):
    dtype = request.param
    return dtype, fam.run_case(jax_get_smoke("mamba2-130m").replace(dtype=dtype),
                               get_smoke("mamba2-130m").replace(dtype=dtype))


def test_forward_matches_jax(case):
    dtype, (want, got) = case
    fam.check_forward(want, got, dtype)


def test_prefill_logits_and_cache_match_jax(case):
    dtype, (want, got) = case
    assert set(got["cache"]) == {"ssm_conv", "ssm_state"}
    fam.check_prefill(want, got, dtype)


def test_decode_steps_match_jax(case):
    dtype, (want, got) = case
    fam.check_decode(want, got, dtype)


def test_greedy_and_sampled_generate_match_jax(case):
    dtype, (want, got) = case
    fam.check_generate(want, got, dtype)
