"""The log-sum-exp that the flash forward saves for its backward, and the plain
backward that takes it, against the JAX package on the CPU.

The same seeded numpy inputs go through JAX and the port, in float32.
Tolerances: the LSE within 2e-5 absolute (|lse| < 10 here; the two frameworks
sum the row in other orders, ~1e-6 relative); gradients within 5e-4 of each
row's largest (``dO V^T - rowsum(dO * O)`` cancels in rows that see few keys,
as ``tests/test_torch_train.py`` holds the plain backward to autograd).  A
row that keeps no key (more queries than keys under causality) has LSE +inf
in the port, so that ``exp(s - lse)`` is 0 there; ``jax.nn.logsumexp`` gives
-inf for it.  The kernels are held to these plain versions on the card
(``test_torch_kernels_cuda.py``, ``test_torch_train_cuda.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro_torch.kernels.flash_attention import attention_bwd_ref, attention_ref  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

LSE_CASES = [
    # (B, Hq, Hkv, S, Skv, D, causal, window)
    (1, 4, 2, 96, 96, 64, True, 0),       # causal, GQA 2
    (1, 2, 1, 80, 80, 32, True, 24),      # a window
    (2, 4, 4, 40, 100, 64, True, 0),      # q right-aligned (S < Skv)
    (1, 2, 2, 50, 77, 16, False, 0),      # non-causal, Skv not a multiple of a tile
    (1, 2, 1, 60, 45, 32, True, 0),       # S > Skv: the first 15 rows keep no key
]
BWD_CASES = [
    (1, 4, 2, 96, 96, 64, True, 0),       # D = 64, causal
    (1, 4, 1, 80, 80, 256, True, 32),     # D = 256, windowed, one KV head
    (1, 4, 2, 40, 100, 64, True, 0),      # q right-aligned
]


def _inputs(B, Hq, Hkv, S, Skv, D, seed):
    rng = np.random.default_rng(seed)
    shapes = ((B, Hq, S, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D), (B, Hq, S, D))
    return tuple(rng.standard_normal(sh, dtype=np.float32) for sh in shapes)


def _mask(S, Skv, causal, window):
    q_pos = np.arange(S)[:, None] + (Skv - S)
    kv_pos = np.arange(Skv)[None, :]
    mask = np.ones((S, Skv), bool)
    if causal:
        mask &= kv_pos <= q_pos
    if window > 0:
        mask &= kv_pos > q_pos - window
    return mask


def _row_error(got, want) -> float:
    got = np.asarray(got, np.float64).reshape(-1, got.shape[-1])
    want = np.asarray(want, np.float64).reshape(-1, want.shape[-1])
    scale = np.maximum(np.abs(want).max(-1), 1e-2 * np.abs(want).max() + 1e-30)
    return float((np.abs(got - want).max(-1) / scale).max())


@pytest.mark.parametrize("case", LSE_CASES)
def test_lse_matches_jax_logsumexp(case):
    B, Hq, Hkv, S, Skv, D, causal, window = case
    q, k, v, _ = _inputs(B, Hq, Hkv, S, Skv, D, S + D)
    scale = D ** -0.5
    G = Hq // Hkv
    logits = jnp.einsum("bhsd,bhtd->bhst", jnp.asarray(q), jnp.repeat(jnp.asarray(k), G, 1)) * scale
    logits = jnp.where(jnp.asarray(_mask(S, Skv, causal, window))[None, None], logits, -jnp.inf)
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    out, lse = attention_ref(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal,
                             window=window, return_lse=True)
    lse = lse.numpy()
    assert lse.dtype == np.float32 and lse.shape == (B, Hq, S)
    empty = ~_mask(S, Skv, causal, window).any(-1)
    assert np.array_equal(np.isneginf(want), np.broadcast_to(empty, want.shape))
    assert np.all(np.isposinf(lse[..., empty]))
    np.testing.assert_allclose(lse[..., ~empty], want[..., ~empty], rtol=0, atol=2e-5)
    # the output of a row that keeps no key is 0, as the kernels write it
    assert np.all(out.numpy()[..., empty, :] == 0)


@pytest.mark.parametrize("case", BWD_CASES)
def test_bwd_ref_with_lse_matches_jax_vjp(case):
    B, Hq, Hkv, S, Skv, D, causal, window = case
    q, k, v, do = _inputs(B, Hq, Hkv, S, Skv, D, 7 * S + D)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_ops.chunked_attention(
        q_, k_, v_, causal=causal, window=window, chunk=32), *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    o, lse = attention_ref(tq, tk, tv, causal=causal, window=window, return_lse=True)
    got = attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal, window=window, lse=lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert _row_error(g.numpy(), w) <= 5e-4, (name, _row_error(g.numpy(), w))


@pytest.mark.parametrize("case", LSE_CASES + BWD_CASES[1:2])
def test_bwd_ref_with_lse_matches_recompute(case):
    B, Hq, Hkv, S, Skv, D, causal, window = case
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(B, Hq, Hkv, S, Skv, D, 3 * S + D))
    o, lse = attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    got = attention_bwd_ref(q, k, v, o, do, causal=causal, window=window, lse=lse)
    want = attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _row_error(g.numpy(), w.numpy()) <= 5e-4, (name, _row_error(g.numpy(), w.numpy()))
    empty = torch.from_numpy(~_mask(S, Skv, causal, window).any(-1))
    assert torch.isfinite(got[0]).all()
    assert bool((got[0][..., empty, :] == 0).all())  # no key, zero gradient
