"""The port's training pieces against the JAX package's, on the CPU: AdamW
and its 8-bit form, int8 error-feedback compression, the token pipeline, the
MoE router's clip, and the plain versions of the two backward kernels
(flash attention's and the router gate's) against autograd and finite
differences.

Tolerances: the optimizers' int8 codes and the pipeline's tokens exactly;
compression exactly (the same f32 operations in the same order); the
optimizers' parameters, moments, scales, ``lr`` and ``grad_norm`` within
rtol 1e-6 (the global norm sums in another order, and ``cos``/``pow`` may
round differently by an ulp).  The plain backward versions against autograd
in f32: the gate's within 1e-5 of each row's largest gradient, attention's
within 5e-4 (at least 1e-2 of the tensor's largest: a row whose gradient is
zero in exact arithmetic holds rounding only), since it takes
``rowsum(dO * O)`` from the forward's output, as a flash backward does, and
``dO V^T - rowsum`` cancels in rows that see few keys; exactness is held by
the finite-difference checks in f64 (``torch.autograd.gradcheck``'s
defaults, and rtol 1e-6 for the gate).
"""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.kernels.assign.ops import moe_route as jax_moe_route  # noqa: E402
from repro.train import compress as jax_compress  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline, prefetch  # noqa: E402
from repro_torch.kernels.assign import ops as assign_ops  # noqa: E402
from repro_torch.kernels.assign.ref import assign_ref, gate_backward_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref,
    attention_ref,
    flash_attention,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve.serve_step import generate  # noqa: E402
from repro_torch.train import compress, optimizer  # noqa: E402
from repro_torch.train.train_step import trainable  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402,F401

SHAPES = {"a": (4, 300), "b": (300,), "c": (2, 3, 513), "d": (64, 64)}
# lr steps 1, 2, 3: warmup (0.5), its end, then the cosine part
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=5)


def row_error(got, want) -> float:
    got, want = got.double().flatten(0, -2), want.double().flatten(0, -2)
    scale = want.abs().amax(-1).clamp_min(1e-2 * float(want.abs().max()) + 1e-30)
    return float(((got - want).abs().amax(-1) / scale).max())


def _close(got, want, rtol=1e-6, msg=""):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(), err_msg=msg)


# ------------------------------------------------------------- optimizer ---


@pytest.mark.parametrize("eight", [False, True], ids=["f32", "8bit"])
def test_adamw_matches_jax(eight):
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate = (jax_opt.init_opt_state_8bit if eight else jax_opt.init_opt_state)(jp)
    tstate = (optimizer.init_opt_state_8bit if eight else optimizer.init_opt_state)(tp)
    jupdate = jax.jit(lambda p, g, s: (jax_opt.adamw_update_8bit if eight else
                                       jax_opt.adamw_update)(jax_opt.AdamWConfig(**OPT), p, g, s))
    tupdate = optimizer.adamw_update_8bit if eight else optimizer.adamw_update
    for step in range(3):
        # small gradients (norm < 1, no clipping) and large ones (clipped)
        grads = {k: (rng.normal(size=s) * (3.0 if step % 2 else 0.01)).astype(np.float32)
                 for k, s in SHAPES.items()}
        jp, jstate, jm = jupdate(jp, {k: jnp.asarray(v) for k, v in grads.items()}, jstate)
        tp, tstate, tm = tupdate(optimizer.AdamWConfig(**OPT), tp,
                                 {k: torch.from_numpy(v) for k, v in grads.items()}, tstate)
        _close(tm["lr"], jm["lr"], msg="lr")
        _close(tm["grad_norm"], jm["grad_norm"], msg="grad_norm")
        assert int(tstate["count"]) == int(jstate["count"]) == step + 1
        for k in SHAPES:
            _close(tp[k], jp[k], msg=f"param {k} step {step}")
            for w in ("m", "v"):
                if eight:
                    np.testing.assert_array_equal(tstate[w][k]["q"].numpy(),
                                                  np.asarray(jstate[w][k]["q"]), err_msg=w + k)
                    _close(tstate[w][k]["scale"], jstate[w][k]["scale"], msg=f"{w} scale {k}")
                else:
                    _close(tstate[w][k], jstate[w][k], msg=f"{w} {k} step {step}")


def test_schedule_matches_jax():
    cfg = dict(lr=3e-4, warmup_steps=5, total_steps=20, min_lr_frac=0.1)
    for step in (0, 1, 4, 5, 6, 12, 20, 25):
        want = jax_opt.schedule(jax_opt.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32))
        got = optimizer.schedule(optimizer.AdamWConfig(**cfg),
                                 torch.tensor(step, dtype=torch.int32))
        _close(got, want, msg=f"step {step}")


def test_compress_grads_matches_jax():
    rng = np.random.default_rng(1)
    shapes = {"a": (7, 33), "b": (129,)}
    jerr = jax_compress.init_error_state({k: jnp.zeros(s) for k, s in shapes.items()})
    terr = compress.init_error_state({k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(5):
        grads = {k: rng.normal(size=s).astype(np.float32) * 10 ** rng.uniform(-3, 1)
                 for k, s in shapes.items()}
        jdeq, jerr = jax.jit(jax_compress.compress_grads)(
            {k: jnp.asarray(v) for k, v in grads.items()}, jerr)
        tdeq, terr = compress.compress_grads({k: torch.from_numpy(v) for k, v in grads.items()},
                                             terr)
        for k in shapes:
            np.testing.assert_array_equal(tdeq[k].numpy(), np.asarray(jdeq[k]))
            np.testing.assert_array_equal(terr[k].numpy(), np.asarray(jerr[k]))
    params = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    assert compress.compression_ratio({k: torch.from_numpy(v) for k, v in params.items()}) == \
        jax_compress.compression_ratio(params)


# -------------------------------------------------------------- pipeline ---


@pytest.mark.parametrize("host", [0, 1])
def test_token_pipeline_matches_jax(host):
    kw = dict(vocab_size=1000, seq_len=64, global_batch=4, seed=7, n_hosts=2, host_id=host,
              mean_doc_len=16)
    want = jax_pipeline.TokenPipeline(jax_pipeline.DataConfig(**kw))
    got = TokenPipeline(DataConfig(**kw), device="cpu")
    for step in range(3):
        w, g = np.asarray(want.batch_at(step)["tokens"]), got.batch_at(step)["tokens"]
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)
    streamed = prefetch(iter(got))
    for step in range(3):
        np.testing.assert_array_equal(next(streamed)["tokens"].numpy(),
                                      np.asarray(want.batch_at(step)["tokens"]))


def test_train_and_data_import_no_jax():
    """``repro_torch.train`` and ``repro_torch.data`` stand alone."""
    code = ("import sys, repro_torch.train, repro_torch.data\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


# ------------------------------------------------- flash backward, plain ---

ATTN_CASES = [
    # (B, Hq, Hkv, S, Skv, D, causal, window)
    (1, 2, 2, 64, 64, 64, True, 0),        # G = 1
    (2, 4, 2, 100, 100, 32, True, 0),      # G = 2, ragged
    (1, 8, 1, 77, 77, 128, True, 16),      # G = 8, a window
    (1, 2, 2, 50, 130, 64, False, 0),      # non-causal, Skv % 64 != 0
    (1, 2, 1, 40, 90, 32, True, 0),        # q right-aligned
    (1, 2, 2, 48, 48, 256, True, 20),      # D = 256, a window
]


def _qkv(B, Hq, Hkv, S, Skv, D, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, Hq, S, D, generator=g, dtype=dtype),
            torch.randn(B, Hkv, Skv, D, generator=g, dtype=dtype),
            torch.randn(B, Hkv, Skv, D, generator=g, dtype=dtype),
            torch.randn(B, Hq, S, D, generator=g, dtype=dtype))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_backward_plain_matches_autograd(case):
    B, Hq, Hkv, S, Skv, D, causal, window = case
    q, k, v, do = _qkv(B, Hq, Hkv, S, Skv, D, S + D)
    o, lse = attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    plain = attention_bwd_ref(q, k, v, o, do, causal=causal, window=window, lse=lse)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(attention_ref(*leaves, causal=causal, window=window), leaves, do)
    # flash_attention on CPU tensors that require grad: the plain forward, its
    # log-sum-exp and the plain backward
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    routed = torch.autograd.grad(flash_attention(*leaves, causal=causal, window=window),
                                 leaves, do)
    for p, a, r in zip(plain, auto, routed):
        assert row_error(p, a) <= 5e-4
        assert torch.equal(p, r)


@pytest.mark.parametrize("case", [(1, 4, 2, 12, 12, 16, True, 0), (1, 2, 1, 9, 20, 16, True, 5),
                                  (1, 2, 2, 10, 13, 16, False, 0)])
def test_attention_backward_plain_finite_differences(case):
    B, Hq, Hkv, S, Skv, D, causal, window = case
    q, k, v, _ = _qkv(B, Hq, Hkv, S, Skv, D, 3, torch.float64)
    fn = lambda q, k, v: flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
    assert torch.autograd.gradcheck(fn, [t.requires_grad_(True) for t in (q, k, v)])


# -------------------------------------------------- gate backward, plain ---


def _gate_case(N, E, k, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(N, E))
    scores[rng.random((N, E)) < 0.25] = -1e30       # infeasible entries
    scores[3] = -1e30                                # a row without a feasible bin
    scores = torch.from_numpy(scores).to(dtype)
    sizes = torch.ones(N)
    caps = torch.full((E,), max(1.0, N * k / E * 0.5))  # capacity drops
    idx, gate, admit, _ = assign_ref(scores.float(), sizes, caps, k=k, block_n=N)
    assert not bool(admit.all()) and bool((idx == -1).any())
    dgate = torch.from_numpy(rng.normal(size=tuple(gate.shape))).to(dtype)
    return scores, sizes, caps, idx, dgate


@pytest.mark.parametrize("k", [1, 2, 8])
def test_gate_backward_plain_matches_autograd(k):
    scores, sizes, caps, idx, dgate = _gate_case(96, 12, k, k)
    want = gate_backward_ref(scores, idx, dgate)
    leaf = scores.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad((assign_ref(leaf, sizes, caps, k=k, block_n=96)[1] * dgate)
                                  .sum(), leaf)
    leaf = scores.clone().requires_grad_(True)
    (routed,) = torch.autograd.grad((assign_ops.assign(leaf, sizes, caps, k=k, block_n=96)[1]
                                     * dgate).sum(), leaf)
    assert row_error(want, auto) <= 1e-5
    assert torch.equal(routed, want)
    assert bool((want[3] == 0).all()) and bool((want[scores <= -5e29] == 0).all())


@pytest.mark.parametrize("k", [1, 2, 8])
def test_gate_backward_plain_finite_differences(k):
    scores, _, _, idx, dgate = _gate_case(20, 10, k, 10 + k, torch.float64)
    feas = scores > -5e29
    scores = torch.where(feas, scores, torch.zeros((), dtype=torch.float64))
    ok = idx >= 0

    def gates(s):  # assign_ref's row softmax over the feasible bins, at the picks
        m = s.masked_fill(~feas, float("-inf")).amax(-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(feas, torch.exp(torch.where(feas, s, m) - m), 0.0)
        g = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
        return (g.gather(1, idx.clamp_min(0).long()) * ok * dgate).sum()

    leaf = scores.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(gates(leaf), leaf)
    fd = torch.zeros_like(scores)
    h = 1e-6
    for i, j in zip(*torch.nonzero(feas, as_tuple=True)):
        up, dn = scores.clone(), scores.clone()
        up[i, j] += h
        dn[i, j] -= h
        fd[i, j] = (gates(up) - gates(dn)) / (2 * h)
    want = gate_backward_ref(torch.where(feas, scores, -1e30), idx, dgate)
    np.testing.assert_allclose(want.numpy(), fd.numpy(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(want.numpy(), auto.numpy(), rtol=1e-9, atol=1e-12)


# -------------------------------------------------------- router's clip ---


def test_route_clip_gradient_at_the_bound(monkeypatch):
    """The combine weights' gradient with respect to the gates, at rows whose
    kept gates sum to exactly 1.0, 0.75 and 1.25: ``jnp.clip`` (the minimum
    of a maximum) gives the bound half the gradient, ``torch.clamp`` all of
    it.  The gates come straight from the inputs (a stand-in for ``assign``
    on both sides): through a real router the softmax's Jacobian sends a
    constant vector to zero, so at the logits the bound's share is rounding.
    The second half holds the real route at k = E against ``jax.grad``."""
    from repro.kernels.assign import ops as jax_assign_ops

    gates = np.array([[0.25, 0.25, 0.5], [0.25, 0.25, 0.25], [0.5, 0.5, 0.25]], np.float32)
    w = np.random.default_rng(4).normal(size=gates.shape).astype(np.float32)
    k, T = gates.shape[1], gates.shape[0]

    def jax_stub(scores, sizes, caps, *, k, block_n, use_kernel):
        n = scores.shape[0]
        return (jnp.tile(jnp.arange(k, dtype=jnp.int32), (n, 1)), scores[:, :k],
                jnp.ones((n, k), bool), jnp.zeros((n, k), jnp.float32))

    def port_stub(scores, sizes, caps, *, k, block_n):
        n = scores.shape[0]
        return (torch.arange(k, dtype=torch.int32).repeat(n, 1), scores[:, :k],
                torch.ones((n, k), dtype=torch.bool), torch.zeros((n, k)))

    monkeypatch.setattr(jax_assign_ops, "assign", jax_stub)
    route = getattr(jax_moe_route, "__wrapped__", jax_moe_route)
    want = np.asarray(jax.grad(lambda g: (route(g, k=k, capacity=T, use_kernel=False,
                                                block_n=T)[1] * w).sum())(jnp.asarray(gates)))
    leaf = torch.from_numpy(gates).requires_grad_(True)
    combine = assign_ops._route(port_stub, leaf, k, T, T)[1]
    (got,) = torch.autograd.grad((combine * torch.from_numpy(w)).sum(), leaf)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)

    # the parent's formula, clamp(0, 1) on the gates' sum: off at the bound only
    leaf = torch.from_numpy(gates).requires_grad_(True)
    total = leaf.sum(-1, keepdim=True)
    clamped = (leaf / total.clamp_min(1e-9) * total.clamp(0.0, 1.0) * torch.from_numpy(w)).sum()
    (old,) = torch.autograd.grad(clamped, leaf)
    assert not np.allclose(old.numpy()[0], want[0], rtol=1e-3)
    np.testing.assert_allclose(old.numpy()[1:], want[1:], rtol=1e-6, atol=1e-7)
    monkeypatch.undo()

    rng = np.random.default_rng(5)
    logits = rng.normal(size=(16, 4)).astype(np.float32)
    logits[::2] = 0.5                       # equal scores: the 4 gates sum to exactly 1.0
    w = rng.normal(size=(16, 4)).astype(np.float32)
    want = np.asarray(jax.grad(lambda lg: (jax_moe_route(lg, k=4, capacity=16, use_kernel=False,
                                                         block_n=16)[1] * w).sum())(logits))
    leaf = torch.from_numpy(logits).requires_grad_(True)
    (got,) = torch.autograd.grad((assign_ops.moe_route(leaf, k=4, capacity=16, block_n=16)[1]
                                  * torch.from_numpy(w)).sum(), leaf)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------ serving unchanged ---


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-1b-a400m"])
def test_trainable_params_serve_the_same(arch):
    """Parameters with gradients turned on (a ``TrainState``'s) serve the same
    tokens as untrainable ones, and logits within 1e-6 of the largest (a
    matmul with a weight that requires grad may take another CPU path, an ulp
    away), and serving builds no graph."""
    cfg = get_smoke(arch).replace(dtype="float32")
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16))
                           .astype(np.int32))
    before = m.prefill(params, {"tokens": tok}, m.init_cache(2, 24))[0]
    tokens_before = generate(m, params, {"tokens": tok}, max_new=4, cache_len=24)
    trainable(params)
    after, cache = m.prefill(params, {"tokens": tok}, m.init_cache(2, 24))
    assert not after.requires_grad and not any(
        t.requires_grad for t in cache.values() if isinstance(t, torch.Tensor))
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=0,
                               atol=1e-6 * float(before.abs().max()))
    assert torch.equal(generate(m, params, {"tokens": tok}, max_new=4, cache_len=24),
                       tokens_before)
