"""The port's XLA-order float helpers against JAX on the CPU: exact bits."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.core.scan import cumsum_f32, fma_f32, segment_sum_f32  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_ref  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401


@pytest.mark.parametrize("n", [1, 16, 17, 60, 4097, 100_000])
def test_cumsum_matches_xla(n):
    rng = np.random.default_rng(n)
    x = (rng.lognormal(0.0, 2.0, n) * (rng.random(n) < 0.7)).astype(np.float32)
    a = np.asarray(jnp.cumsum(jnp.asarray(x)))
    b = cumsum_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,segs", [(1, 1), (60, 4), (600, 9), (5000, 51)])
def test_segment_sum_matches_xla(n, segs):
    rng = np.random.default_rng(n + segs)
    v = rng.lognormal(2.0, 1.5, n).astype(np.float32)
    seg = rng.integers(0, segs + 1, n).astype(np.int32)   # id == segs: dropped padding
    a = np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(seg), num_segments=segs + 1))
    b = segment_sum_f32(torch.from_numpy(v), torch.from_numpy(seg), segs).numpy()
    np.testing.assert_array_equal(a[:segs], b)


def test_segment_sum_int_stacked():
    rng = np.random.default_rng(3)
    v = rng.integers(-5, 9, (300, 3)).astype(np.int32)
    seg = rng.integers(-1, 8, 300).astype(np.int32)   # -1 and 7 lie outside [0, 7)
    out = segment_sum(torch.from_numpy(v), torch.from_numpy(seg), 7).numpy()
    want = np.zeros((7, 3), np.int64)
    for j in range(300):
        if 0 <= seg[j] < 7:
            want[seg[j]] += v[j]
    np.testing.assert_array_equal(out, want)
    assert out.dtype == np.int32


def test_segment_sum_ref_is_the_cpu_path():
    v = torch.arange(10, dtype=torch.float32)
    seg = torch.tensor([0, 1, 2, 0, 1, 2, 3, 3, 0, 5])
    torch.testing.assert_close(segment_sum(v, seg, 4), segment_sum_ref(v, seg, 4))


def test_fma_matches_xla_contraction():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.0, 0.05, 200_000).astype(np.float32)
    b = np.float32(7.0)
    c = np.float32(1.0)
    want = np.asarray(jax.jit(lambda x: 1.0 + x * 7.0)(jnp.asarray(a)))
    got = fma_f32(torch.from_numpy(a), float(b), float(c)).numpy()
    np.testing.assert_array_equal(want, got)
    # and the single rounding differs from two roundings somewhere here
    assert (want != a * b + c).any()


def test_fma_exact_on_float32_midpoints():
    # a * b = 2^-24 (1 - 2^-46): the float64 sum c + a * b lands exactly on the
    # float32 midpoint 1 + 3 * 2^-24, where ties-to-even would round up; the
    # exact value lies below it, so one rounding gives c itself
    a, b, c = 1.0 + 2.0**-23, 2.0**-24 * (1.0 - 2.0**-23), 1.0 + 2.0**-23
    assert np.float32(np.float64(c) + np.float64(a) * np.float64(b)) == np.float32(1.0 + 2.0**-22)
    got = fma_f32(torch.tensor([a], dtype=torch.float32), b, c)
    assert got.item() == c


def _engine_like_ids(kind, n, segs, rng):
    """Segment ids as the engine's scatters see them: id ``segs`` is the
    padding segment of the rows that take no part."""
    if kind == "mostly_padding":      # 95% of rows carry the padding id
        ids = rng.integers(0, segs, n)
        return np.where(rng.random(n) < 0.95, segs, ids).astype(np.int32)
    if kind == "one_large_segment":   # almost every row in segment 3
        ids = rng.integers(0, segs + 1, n)
        return np.where(rng.random(n) < 0.9, 3, ids).astype(np.int32)
    return rng.integers(0, segs + 1, n).astype(np.int32)


@pytest.mark.parametrize("kind", ["mostly_padding", "one_large_segment", "uniform"])
@pytest.mark.parametrize("n,segs", [(5000, 51), (20_000, 300)])
def test_segment_sum_ref_matches_site_sum_on_engine_mixes(kind, n, segs):
    from repro.core.engine import _site_sum

    rng = np.random.default_rng(n + segs + len(kind))
    ids = _engine_like_ids(kind, n, segs, rng)
    v = rng.uniform(1.6, 19.2, n).astype(np.float32)       # per-job memory, as in the engine
    want = np.asarray(_site_sum(jnp.asarray(v), jnp.asarray(ids), segs))
    got = segment_sum_ref(torch.from_numpy(v), torch.from_numpy(ids), segs).numpy()
    np.testing.assert_array_equal(want, got)
    wide = rng.integers(0, 9, (n, 3)).astype(np.int32)     # the stacked int columns
    want = np.asarray(_site_sum(jnp.asarray(wide), jnp.asarray(ids), segs))
    got = segment_sum_ref(torch.from_numpy(wide), torch.from_numpy(ids), segs).numpy()
    np.testing.assert_array_equal(want, got)


def test_segment_sum_ref_signed_zeros_match_jax():
    # segment 0: a lone -0.0; 1: -0.0 twice; 2: -0.0 then 1.0 then -1.0;
    # 3: empty; 4: the padding segment.  Every sum starts from +0.0.
    v = np.array([-0.0, -0.0, -0.0, -0.0, 1.0, -1.0, 5.0], np.float32)
    ids = np.array([0, 1, 1, 2, 2, 2, 4], np.int32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(ids), num_segments=5))[:4]
    got = segment_sum_ref(torch.from_numpy(v), torch.from_numpy(ids), 4).numpy()
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(np.signbit(want), np.signbit(got))
    assert not np.signbit(got).any()


@pytest.mark.parametrize("shape", [(2,), (32,), (33,), (100_000,), (40, 7), (1024, 300),
                                   (64, 2, 3)])
def test_sum_matches_xla_and_the_segment_form(shape):
    """``sum_f32`` over axis 0 against ``jnp.sum`` under ``jit`` (a masked
    column sum, as the replica catalog computes it), and the segment-sum form
    the GPU takes (run here through the CPU's row-order segment sum): the
    same bits, signed zeros included."""
    from repro_torch.core.scan import _sum_f32_segments, sum_f32

    rng = np.random.default_rng(sum(shape))
    x = (rng.lognormal(20.0, 1.0, shape) * (rng.random(shape) < 0.6)).astype(np.float32)
    x.reshape(-1)[:2] = [-0.0, 3.5]
    want = np.asarray(jax.jit(lambda v: jnp.sum(jnp.where(v != 0, v, 0.0), axis=0))(x))
    got = sum_f32(torch.from_numpy(x), 0).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    seg = _sum_f32_segments(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), seg.view(np.int32))
