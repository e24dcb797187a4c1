"""The port's threefry keys against ``jax.random``: exact bits."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.core import rng  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

SEEDS = [0, 1, 42, 2**31 - 1, -5]


def _np(key_t):
    return key_t.numpy().astype(np.uint32)


def test_reference_vectors():
    assert _np(rng.PRNGKey(0)).tolist() == [0, 0]
    assert _np(rng.split(rng.PRNGKey(0), 4)[1]).tolist() == [928981903, 3453687069]
    u = rng.uniform(rng.PRNGKey(0), (3,)).numpy()
    np.testing.assert_array_equal(u, np.array([0.947667, 0.9785799, 0.33229148], np.float32))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(kj), _np(kt))
    for n in (1, 2, 4, 7):
        np.testing.assert_array_equal(np.asarray(jax.random.split(kj, n)), _np(rng.split(kt, n)))
    for d in (0, 1, 12345, 0x5B5D5, 2**31 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(kj, d)),
                                      _np(rng.fold_in(kt, d)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [
    ((1000,), 0.0, 1.0),
    ((37, 11), 0.0, 1.0),
    ((20000,), 0.05, 1.0),   # the engine's failure-fraction draw (one rounding: FMA)
    ((50, 3), -2.0, 3.5),
])
def test_uniform(seed, shape, lo, hi):
    a = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=lo, maxval=hi))
    b = rng.uniform(rng.PRNGKey(seed), shape, lo, hi).numpy()
    np.testing.assert_array_equal(a, b)


def test_split_key_chain_matches_engine_stream():
    """Ten rounds of the engine's ``split(key, 4)`` chain stay on JAX's stream."""
    kj, kt = jax.random.PRNGKey(7), rng.PRNGKey(7)
    for _ in range(10):
        kj, fj, _, _ = jax.random.split(kj, 4)
        kt, ft, _, _ = rng.split(kt, 4)
        np.testing.assert_array_equal(np.asarray(fj), _np(ft))
    np.testing.assert_array_equal(np.asarray(kj), _np(kt))
