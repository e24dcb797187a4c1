"""The MoE router's gradient in the port against the JAX package's, on the
CPU.

``gate_backward_ref`` (the plain version of ``csrc/gate_backward.cu``) is held
against ``jax.vjp`` of the reference's gate, ``repro.kernels.assign.ref.
assign_ref(...)[1]``, dotted with the same ``dgate``, at k = 1, 2, 8 over
E = 7, 32, 384: scores with -1e30 entries, a row without a feasible bin, and
k > E (slots past the feasible bins are -1).  On that row the reference's
autodiff gives NaN (the cotangent 0 times ``exp(score - max) = exp(inf)`` of
the masked branch); the gate is 0 there whatever the scores, so the port's
gradient is held to exactly 0 and the reference is compared on the other
rows.  Then the gradient of the port's ``moe_route`` combine weights, through
``_AssignGate`` (``assign_ref`` forward, ``gate_backward_ref`` backward), is
held against ``jax.vjp`` of the reference's ``moe_route(use_kernel=False)``
at a granite-like ``[2, 300, 32]`` and a kimi-like ``[2, 64, 384]`` routing
problem, k = 8, row blocks of 256 and of a whole group.  The picks, slots and
keeps agree exactly first.

Inputs are drawn with numpy from a seed.  Tolerance, f32: each row's largest
error within 1e-5 of that row's largest gradient (at least 1e-2 of the
tensor's largest), since the two frameworks round ``exp`` and the softmax
sums differently by an ulp and the reference's gradient also runs through
the row maximum (whose contributions cancel only in exact arithmetic).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.assign.ops import moe_route as jax_moe_route  # noqa: E402
from repro.kernels.assign.ref import assign_ref as jax_assign_ref  # noqa: E402
from repro_torch.kernels.assign import moe_route  # noqa: E402
from repro_torch.kernels.assign.ref import gate_backward_ref  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402,F401

TOL = 1e-5


def row_error(got, want) -> float:
    """The largest error of a row over that row's largest magnitude (at
    least 1e-2 of the tensor's largest)."""
    got = np.asarray(got, np.float64).reshape(-1, np.shape(got)[-1])
    want = np.asarray(want, np.float64).reshape(-1, np.shape(want)[-1])
    scale = np.maximum(np.abs(want).max(-1), 1e-2 * np.abs(want).max() + 1e-30)
    return float((np.abs(got - want).max(-1) / scale).max())


def gate_case(N, E, k, seed):
    """Scores with 20% infeasible entries and row 3 without a feasible bin,
    unit sizes, capacities that drop claims, and a seeded ``dgate``."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(N, E)).astype(np.float32)
    scores[rng.random((N, E)) < 0.2] = -1e30
    scores[3] = -1e30
    sizes = np.ones(N, np.float32)
    caps = np.full(E, max(1.0, N * k / E * 0.6), np.float32)
    dgate = rng.normal(size=(N, k)).astype(np.float32)
    return scores, sizes, caps, dgate


@pytest.mark.parametrize("E", [7, 32, 384])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_gate_backward_ref_matches_jax_vjp(k, E):
    N = 64
    scores, sizes, caps, dgate = gate_case(N, E, k, 10 * k + E)

    def gate(s):
        return jax_assign_ref(s, jnp.asarray(sizes), jnp.asarray(caps), k=k, block_n=N)[1]

    idx = np.array(jax_assign_ref(jnp.asarray(scores), jnp.asarray(sizes), jnp.asarray(caps),
                                  k=k, block_n=N)[0])
    _, vjp = jax.vjp(gate, jnp.asarray(scores))
    want = np.asarray(vjp(jnp.asarray(dgate))[0])
    got = gate_backward_ref(torch.from_numpy(scores), torch.from_numpy(idx),
                            torch.from_numpy(dgate)).numpy()
    feasible_row = (scores > -5e29).any(-1)
    assert not feasible_row[3] and np.isfinite(want[feasible_row]).all()
    assert row_error(got[feasible_row], want[feasible_row]) <= TOL
    assert (got[3] == 0).all() and (got[scores <= -5e29] == 0).all()
    if k > E:
        assert (idx[:, E:] == -1).all()


ROUTE_CASES = [
    # (G, T, E, k, block_n): granite-like and kimi-like groups, row blocks of
    # 256 (T > 256: two blocks) and of the whole group
    (2, 300, 32, 8, 256),
    (2, 300, 32, 8, 300),
    (2, 64, 384, 8, 256),
]


@pytest.mark.parametrize("G,T,E,k,block_n", ROUTE_CASES)
def test_moe_route_gradient_matches_jax_vjp(G, T, E, k, block_n):
    rng = np.random.default_rng(G * T + E)
    # a router that favours the later experts, so that the capacity binds
    logits = (rng.normal(size=(G, T, E)) + np.linspace(0.0, 1.0, E)).astype(np.float32)
    w = rng.normal(size=(G, T, k)).astype(np.float32)
    capacity = max(1, int(math.ceil(T * k / E * 1.25)))   # moe_capacity's rule

    def combine(lg):
        route = lambda x: jax_moe_route(x, k=k, capacity=capacity, use_kernel=False,  # noqa: E731
                                        block_n=block_n)
        return jax.vmap(route)(lg)

    want_route, vjp = jax.vjp(lambda lg: combine(lg)[1], jnp.asarray(logits))
    want = np.asarray(vjp(jnp.asarray(w))[0])
    ref_idx, _, ref_slot, ref_keep = (np.asarray(x) for x in combine(jnp.asarray(logits)))

    leaf = torch.from_numpy(logits).requires_grad_(True)
    idx, comb, slot, keep = moe_route(leaf, k=k, capacity=capacity, block_n=block_n)
    (got,) = torch.autograd.grad((comb * torch.from_numpy(w)).sum(), leaf)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_array_equal(slot.numpy(), ref_slot)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    assert not keep.all(), "the capacity must drop some slots"
    np.testing.assert_allclose(comb.detach().numpy(), np.asarray(want_route), rtol=0, atol=1e-6)
    assert np.isfinite(want).all()
    assert row_error(got.numpy(), want) <= TOL
