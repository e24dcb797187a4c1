"""The port's MoE layer against the JAX package's, on the CPU.

``moe_route`` is held against the reference's ``moe_route`` (its jnp oracle,
and its Pallas kernel in interpret mode at a tiny size): ``idx``, ``slot``
and ``keep`` exactly, ``combine`` within 1e-6, for k = 1, 2, 8, row blocks
of 256 and of a whole group (Tg > 256), capacities that drop tokens, and
``[G, Tg, E]`` groups against ``jax.vmap``.  ``moe_forward`` is held within
1e-5 in float32 on the same inputs, aux losses included.

The granite-moe and kimi-k2 smoke configs run through the model as
``test_torch_lm_family`` sets out, in float32.  In bfloat16 the two frameworks'
residual streams differ by bf16 roundings (up to 0.03 at kimi-smoke's second
layer), which is enough to move a near-tied router pick.  On the seeded
tokens of the forward, the port routes token (0, 5) of kimi-smoke's second
layer to other experts than the reference's unrolled layers do, and with 8
slots an expert and 44% of the slots dropped, FIFO admission passes the
change on to token (0, 12).  The reference's own scanned and unrolled layers
differ by 0.18 in these logits (0.25 in the prefill's, where the scanned
layers route token (1, 5) of the first layer elsewhere).  So the bf16 MoE
cases are held at the layer level on identical inputs (every block of both
configs, and the MoE at a decode shape) at the bf16 tolerance, and through
the model in the prefill (logits, caches, first tokens) against the
reference's unrolled layers, whose row block is the same (one group of
fewer than 256 tokens).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.transformer as jax_transformer  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.kernels.assign.ops import moe_route as jax_moe_route  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.moe import moe_capacity as jax_moe_capacity  # noqa: E402
from repro.models.moe import moe_forward as jax_moe_forward  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.assign import moe_route, moe_route_ref  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import lm_params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.models.moe import moe_capacity, moe_forward  # noqa: E402

import test_torch_lm_family as fam  # noqa: E402
from test_torch_lm_family import free_jax_executables  # noqa: E402, F401

MOE_ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]

ROUTE_CASES = [
    # (G, T, E, k, capacity, block_n); G = 0 routes one [T, E] problem
    (0, 128, 8, 1, 12, 256),      # k = 1: FIFO admission whatever the block
    (0, 300, 16, 2, 30, 256),     # two row blocks, tight capacity
    (0, 300, 16, 2, 30, 300),     # one block of the whole group
    (0, 600, 32, 8, 130, 256),    # granite's k = 8 over E = 32, three blocks
    (0, 600, 32, 8, 130, 600),    # ... and one block: another result for k > 1
    (0, 520, 384, 8, 9, 256),     # kimi's E = 384, k = 8
    (3, 300, 16, 8, 110, 256),    # groups [G, Tg, E] against jax.vmap
    (3, 300, 16, 8, 110, 300),
    (2, 40, 384, 8, 1, 256),      # capacity 1: most slots dropped
]


def _logits(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_route(logits, k, capacity, block_n, use_kernel=False):
    fn = lambda lg: jax_moe_route(lg, k=k, capacity=capacity, use_kernel=use_kernel,  # noqa: E731
                                  block_n=block_n)
    lg = jnp.asarray(logits)
    return fn(lg) if logits.ndim == 2 else jax.vmap(fn)(lg)


def _check_route(want, got):
    idx, combine, slot, keep = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[0].numpy(), idx)
    np.testing.assert_array_equal(got[2].numpy(), slot)
    np.testing.assert_array_equal(got[3].numpy(), keep)
    np.testing.assert_allclose(got[1].numpy(), combine, rtol=0, atol=1e-6)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32
    assert got[3].dtype == torch.bool


@pytest.mark.parametrize("route", [moe_route, moe_route_ref], ids=["moe_route", "moe_route_ref"])
@pytest.mark.parametrize("G,T,E,k,cap,bn", ROUTE_CASES)
def test_moe_route_matches_jax(G, T, E, k, cap, bn, route):
    logits = _logits((G, T, E) if G else (T, E), G * 1000 + T + E + k)
    want = _jax_route(logits, k, cap, bn)
    got = route(torch.from_numpy(logits), k=k, capacity=cap, block_n=bn)
    _check_route(want, got)
    if k > 1:
        assert not np.asarray(want[3]).all(), "the capacity must drop some slots"


@pytest.mark.parametrize("G,T,E,k,cap,bn", [
    (0, 64, 8, 2, 8, 32),
    (0, 48, 16, 8, 20, 16),
    (2, 40, 8, 1, 3, 256),
])
def test_moe_route_matches_pallas_interpret(G, T, E, k, cap, bn):
    logits = _logits((G, T, E) if G else (T, E), 7 + T)
    want = _jax_route(logits, k, cap, bn, use_kernel=True)
    _check_route(want, moe_route(torch.from_numpy(logits), k=k, capacity=cap, block_n=bn))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("tokens", [1, 3, 48, 1000])
def test_moe_capacity_matches_jax(arch, tokens):
    cfg = jax_get_smoke(arch)
    assert moe_capacity(get_smoke(arch), tokens) == jax_moe_capacity(cfg, tokens)


def _moe_params(cfg, seed):
    """One MoE layer's parameters drawn by the JAX package, carried across."""
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(seed))
    layer = jax.tree.map(lambda a: np.asarray(a[0]), jparams["seg0"]["k0"]["moe"])
    tparams = torch.nn.ParameterDict({k: torch.nn.Parameter(tensor_from_numpy(v, "cpu"),
                                                            requires_grad=False)
                                      for k, v in layer.items()})
    return layer, tparams


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("variant", ["smoke", "k8", "unrolled"])
@pytest.mark.parametrize("shape", [(2, 24), (3, 1), (4, 40)])
def test_moe_forward_matches_jax(arch, variant, shape):
    """f32, within 1e-5: prefill-shaped (2 x 24 tokens in the config's
    groups), decode-shaped (3 tokens, one group) and 4 x 40 tokens; k = 8 of
    16 experts in 4 groups; and the unrolled layers' row block (one group)."""
    cfg = jax_get_smoke(arch).replace(dtype="float32")
    if variant == "k8":
        cfg = cfg.replace(n_experts=16, top_k=8, router_groups=4)
    if variant == "unrolled":
        cfg = cfg.replace(scan_layers=False)
    layer, tparams = _moe_params(cfg, 1)
    x = np.random.default_rng(sum(shape)).normal(size=(*shape, cfg.d_model)).astype(np.float32)
    jy, jaux = jax_moe_forward({k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(x), cfg)
    ty, taux = moe_forward(tparams, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(taux[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)


def test_moe_decode_without_aux_equals_with():
    cfg = jax_get_smoke("kimi-k2-1t-a32b").replace(dtype="float32")
    _, tparams = _moe_params(cfg, 2)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 1, cfg.d_model)).astype(
        np.float32))
    y, aux = moe_forward(tparams, x, cfg, with_aux=False)
    assert aux is None
    torch.testing.assert_close(y, moe_forward(tparams, x, cfg)[0], rtol=0, atol=0)


# ------------------------------------------------ through the whole model ---


@pytest.fixture(scope="module", params=MOE_ARCHS)
def f32_case(request):
    arch = request.param
    return fam.run_case(jax_get_smoke(arch).replace(dtype="float32"),
                        get_smoke(arch).replace(dtype="float32"))


def test_forward_and_aux_match_jax(f32_case):
    want, got = f32_case
    fam.check_forward(want, got, "float32")
    assert float(got["aux"]["moe_drop_frac"]) > 0


def test_prefill_logits_and_cache_match_jax(f32_case):
    want, got = f32_case
    assert set(got["cache"]) == {"k", "v"}
    fam.check_prefill(want, got, "float32")


def test_decode_steps_match_jax(f32_case):
    fam.check_decode(*f32_case, "float32")


def test_greedy_and_sampled_generate_match_jax(f32_case):
    want, got = f32_case
    fam.check_generate(want, got, "float32")
    assert not torch.equal(got["greedy"], got["sampled"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_prefill_and_first_tokens_match_jax(arch):
    unrolled = dict(dtype="bfloat16", scan_layers=False, remat=False)
    want, got = fam.run_case(jax_get_smoke(arch).replace(**unrolled),
                             get_smoke(arch).replace(**unrolled), full=False)
    fam.check_prefill(want, got, "bfloat16")
    fam.check_generate(want, got, "bfloat16")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_blocks_match_jax_on_identical_inputs(arch):
    """Every block of the bf16 smoke model, each fed the reference's own
    input to it, within the bf16 tolerance; then the MoE at a decode shape."""
    cfg = jax_get_smoke(arch).replace(dtype="bfloat16")
    tcfg = get_smoke(arch).replace(dtype="bfloat16")
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    x = jparams["embed"][fam.tokens(cfg)]
    for i, layer in enumerate(tparams.layers):
        p = jax.tree.map(lambda a: a[i], jparams["seg0"]["k0"])
        want, jaux = jax_transformer.block_train(p, x, cfg, "moe")
        got, taux = transformer.block_train(layer, tensor_from_numpy(np.asarray(x), "cpu"), tcfg)
        fam.close(got, want, "bfloat16", f"block {i}")
        for k, v in jaux.items():
            fam.close(taux[k], v, "bfloat16", f"block {i} {k}")
        x_t = want[:, -1:]
        jy, _ = jax_moe_forward(p["moe"], x_t, cfg)
        ty, _ = moe_forward(layer.moe, tensor_from_numpy(np.asarray(x_t), "cpu"), tcfg)
        fam.close(ty, jy, "bfloat16", f"block {i} decode-shaped MoE")
        x = want
