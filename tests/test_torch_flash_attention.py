"""The port's attention functions against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``repro.kernels.flash_attention`` and
``repro_torch.kernels.flash_attention``.  Tolerances: max abs and rel error
2e-5 in float32 (the two frameworks sum in other orders) and 2e-2 in bfloat16
(outputs round at 2^-8), as ``tests/test_kernels.py`` holds the Pallas kernel
to the oracle.  The Hopper kernel itself is held against the plain version on
the card in ``test_torch_kernels_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref,
    chunked_attention,
    decode_attention,
    flash_attention,
    qblock_attention,
)
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

FLASH_CASES = [
    # (B, Hq, Hkv, S, D, window, dtype): tests/test_kernels.py's FLASH_CASES
    (1, 4, 4, 256, 64, 0, "float32"),
    (2, 8, 2, 128, 64, 0, "float32"),      # GQA 4:1
    (1, 4, 1, 384, 128, 0, "float32"),     # MQA, ragged seq -> padding
    (1, 4, 2, 256, 64, 64, "float32"),     # sliding window
    (1, 8, 8, 256, 64, 0, "bfloat16"),
    (2, 4, 2, 200, 64, 96, "bfloat16"),    # window + padding
]


def _inputs(B, Hq, Hkv, S, D, dtype, seed, Skv=None):
    """Seeded f32 normals, rounded to ``dtype`` the same way in both frameworks."""
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    arrays = (rng.standard_normal((B, Hq, S, D), dtype=np.float32),
              rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32),
              rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32))
    jax_in = tuple(jnp.asarray(a, dtype=dtype) for a in arrays)
    torch_in = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    return jax_in, torch_in


def _close(got, want, dtype):
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,window,dtype", FLASH_CASES)
def test_attention_ref_matches_jax(B, Hq, Hkv, S, D, window, dtype):
    jx, tx = _inputs(B, Hq, Hkv, S, D, dtype, B * 131 + S)
    _close(attention_ref(*tx, causal=True, window=window),
           jax_attention_ref(*jx, causal=True, window=window), dtype)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,window,dtype", FLASH_CASES)
def test_chunked_attention_matches_jax(B, Hq, Hkv, S, D, window, dtype):
    jx, tx = _inputs(B, Hq, Hkv, S, D, dtype, B * 131 + S + 1)
    _close(chunked_attention(*tx, causal=True, window=window, chunk=128),
           jax_ops.chunked_attention(*jx, causal=True, window=window, chunk=128), dtype)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,window,dtype", FLASH_CASES)
def test_qblock_attention_matches_jax(B, Hq, Hkv, S, D, window, dtype):
    jx, tx = _inputs(B, Hq, Hkv, S, D, dtype, B * 131 + S + 2)
    _close(qblock_attention(*tx, causal=True, window=window, chunk=64, q_block=128),
           jax_ops.qblock_attention(*jx, causal=True, window=window, chunk=64, q_block=128),
           dtype)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,window,dtype", FLASH_CASES)
def test_flash_attention_plain_version_matches_pallas(B, Hq, Hkv, S, D, window, dtype):
    """On CPU tensors ``flash_attention`` runs the plain version; it holds the
    interpret-mode Pallas kernel on every causal case."""
    jx, tx = _inputs(B, Hq, Hkv, S, D, dtype, B * 131 + S)
    _close(flash_attention(*tx, causal=True, window=window),
           flash_attention_pallas(*jx, causal=True, window=window, interpret=True), dtype)


@pytest.mark.parametrize("fn", ["attention_ref", "chunked_attention"])
def test_non_causal_ragged_kv_matches_jax_oracle(fn):
    """``causal=False`` with Skv not a multiple of the tile: the port masks the
    padded keys (``col < Skv``), as JAX's ``attention_ref`` and
    ``chunked_attention`` do.  The Pallas kernel differs from its own oracle
    here: it attends to its zero-padded keys (0.107 max abs at this shape with
    its 64-wide blocks), so it is not the reference for this case."""
    jx, tx = _inputs(1, 2, 2, 100, 32, "float32", 11)
    got = (attention_ref(*tx, causal=False) if fn == "attention_ref"
           else chunked_attention(*tx, causal=False, chunk=64))
    _close(got, jax_attention_ref(*jx, causal=False), "float32")


@pytest.mark.parametrize("window", [0, 48])
def test_right_aligned_queries_match_jax(window):
    """S < Skv: q rows sit at the end of the KV (``kv_offset = Skv - S``)."""
    jx, tx = _inputs(2, 4, 2, 100, 64, "float32", 12, Skv=300)
    want = jax_attention_ref(*jx, causal=True, window=window)
    _close(attention_ref(*tx, causal=True, window=window), want, "float32")
    _close(chunked_attention(*tx, causal=True, window=window, chunk=128), want, "float32")
    _close(qblock_attention(*tx, causal=True, window=window, chunk=64, q_block=64), want,
           "float32")


@pytest.mark.parametrize("kv_len", [None, 37, (21, 64)])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(kv_len, window, dtype):
    jx, tx = _inputs(2, 8, 2, 1, 32, dtype, 13, Skv=64)
    jax_len = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    torch_len = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    _close(decode_attention(*tx, window=window, kv_len=torch_len),
           jax_ops.decode_attention(*jx, window=window, kv_len=jax_len), dtype)
