"""The port's train step against the JAX package's, on the CPU: three steps
of ``make_train_step`` on granite-moe's smoke config in f32, from the JAX
package's ``init_train_state`` carried across with
``train_state_from_numpy``, on batches of the JAX package's token pipeline
(the port's gives the same tokens), plain, with two microbatches, with int8
error-feedback compression and with 8-bit AdamW moments.

AdamW runs at its default rate, 3e-4; the schedule warms up over 2 steps
and decays over 5, so the 3 steps cross both parts.  Tolerances: the loss
within rtol 1e-5 each step in every form; after step 3 every parameter leaf
within 1e-4 of that leaf's largest magnitude, plain and microbatched.

Compression and 8-bit moments quantize (the gradient, the moments) to int8
codes, so a gradient an ulp away from the JAX package's moves a code at a
rounding boundary now and then (about one of granite's 3.6e5 smoke
parameters a step), and Adam turns one code into a step of up to ``lr`` (a
``v`` code of 0 against 1, into ``m / eps``).  Those two forms therefore
also take three steps on one gradient on both sides, a loss linear in the
parameters whose gradient is granite's own at step 0, where the 8-bit codes
must agree exactly, the carried error within 1e-6 of its leaf's largest
gradient (a jitted step rounds ``g + err`` and ``gf - q * scale`` as its
fusion has it, an ulp or two of the gradient; a code is 1/127 of the
largest) and the parameters as above.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import train_step as jax_train  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import leaves_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.train import AdamWConfig, make_eval_step, make_train_step  # noqa: E402
from repro_torch.train import train_state_from_numpy  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402,F401

ARCH = "granite-moe-1b-a400m"
OPT = dict(warmup_steps=2, total_steps=5)
DATA = dict(seq_len=32, global_batch=4, seed=1, mean_doc_len=8)
VARIANTS = {"plain": {}, "microbatches": dict(microbatches=2), "compress": dict(compress=True),
            "opt_8bit": dict(opt_8bit=True)}


def check_params(params, cfg, want_tree, tol=1e-4):
    got = jax.tree_util.tree_leaves_with_path(params_to_numpy(params, cfg))
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_steps_match_jax(variant):
    kw = VARIANTS[variant]
    jcfg = jax_get_smoke(ARCH).replace(dtype="float32")
    cfg = get_smoke(ARCH).replace(dtype="float32")
    jm, tm = jax_build_model(jcfg), build_model(cfg, device="cpu")
    init_kw = {k: v for k, v in kw.items() if k in ("compress", "opt_8bit")}
    jstate = jax_train.init_train_state(jm, jax.random.PRNGKey(0), **init_kw)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    jstep = jax.jit(jax_train.make_train_step(jm, jax_opt.AdamWConfig(**OPT), **kw))
    tstep = make_train_step(tm, AdamWConfig(**OPT), **kw)
    jpipe = JaxTokenPipeline(JaxDataConfig(vocab_size=jcfg.vocab_size, **DATA))
    tpipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, **DATA), device="cpu")
    for step in range(3):
        jstate, jmet = jstep(jstate, jpipe.batch_at(step))
        tstate, tmet = tstep(tstate, tpipe.batch_at(step))
        for key in ("loss", "nll", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-5,
                                       err_msg=f"{key} step {step}")
    assert int(tstate.opt["count"]) == int(jstate.opt["count"]) == 3
    if variant in ("plain", "microbatches"):
        check_params(tstate.params, cfg, jstate.params)
    if variant == "plain":
        jeval = jax_train.make_eval_step(jm)(jstate.params, jpipe.batch_at(5))
        teval = make_eval_step(tm)(tstate.params, tpipe.batch_at(5))
        np.testing.assert_allclose(float(teval["loss"]), float(jeval["loss"]), rtol=1e-5)


@pytest.mark.parametrize("variant", ["compress", "opt_8bit"])
def test_quantized_steps_match_jax_on_one_gradient(variant):
    kw = VARIANTS[variant]
    jcfg = jax_get_smoke(ARCH).replace(dtype="float32")
    cfg = get_smoke(ARCH).replace(dtype="float32")
    jm, tm = jax_build_model(jcfg), build_model(cfg, device="cpu")
    jstate = jax_train.init_train_state(jm, jax.random.PRNGKey(0), **kw)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    jpipe = JaxTokenPipeline(JaxDataConfig(vocab_size=jcfg.vocab_size, **DATA))
    _, jgrad = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jstate.params,
                                                                  jpipe.batch_at(0))
    tgrad = leaves_from_numpy(jax.tree.map(np.asarray, jgrad), tstate.params, cfg, "cpu")

    def jax_linear(params, batch):
        return sum(jnp.sum(p * g) for p, g in zip(jax.tree.leaves(params),
                                                   jax.tree.leaves(jgrad))), {}

    def port_linear(params, batch):
        return sum((p * tgrad[n]).sum() for n, p in params.named_parameters()), {}

    jstep = jax.jit(jax_train.make_train_step(jm._replace(loss=jax_linear),
                                              jax_opt.AdamWConfig(**OPT), **kw))
    tstep = make_train_step(tm._replace(loss=port_linear), AdamWConfig(**OPT), **kw)
    batch = jpipe.batch_at(0)
    for step in range(3):
        jstate, jmet = jstep(jstate, batch)
        tstate, tmet = tstep(tstate, {"tokens": torch.from_numpy(np.array(batch["tokens"]))})
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-6,
                                       err_msg=f"{key} step {step}")
    check_params(tstate.params, cfg, jstate.params)
    if variant == "compress":
        got = params_to_numpy(tstate.params, cfg, tstate.err)
        for (path, g), w, grad in zip(jax.tree_util.tree_leaves_with_path(got),
                                      jax.tree.leaves(jstate.err), jax.tree.leaves(jgrad)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                       atol=1e-6 * np.abs(np.asarray(grad)).max(),
                                       err_msg=jax.tree_util.keystr(path))
    else:
        for moment in ("m", "v"):
            got = params_to_numpy(tstate.params, cfg,
                                  {n: t["q"] for n, t in tstate.opt[moment].items()})
            want = jax.tree.map(lambda t: t, jstate.opt[moment])
            for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                                    [t["q"] for t in jax.tree.leaves(
                                        want, is_leaf=lambda t: set(t) == {"q", "scale"})]):
                np.testing.assert_array_equal(g, np.asarray(w),
                                              err_msg=f"{moment} {jax.tree_util.keystr(path)}")
