"""Loss and gradients of every LM family in the port against the JAX
package's, on the CPU: the port's ``Model.loss`` differentiated by
``torch.autograd`` against ``jax.value_and_grad`` of the JAX ``loss_fn``, on
the same weights (``convert.params_from_numpy``) and tokens, the gradients
compared leaf by leaf through ``convert.params_to_numpy``.

Smoke configs in f32 at 48 tokens: dense (deepseek), MoE (granite, kimi;
the router through ``_AssignGate`` and the gate's plain backward), SSM
(mamba2), hybrid (recurrentgemma, its window of 32 below the 48 tokens),
encoder-decoder (whisper, 37 frames against a KV chunk of 16) and VLM
(internvl2, with patches).  The port runs with ``remat`` off and on (each
block under ``torch.utils.checkpoint``); the JAX package once, with its
default ``remat``.  Tolerances: the loss within rtol 1e-5; each gradient leaf
within 1e-4 of that leaf's largest magnitude, plus 1e-7 (a whisper key
bias's gradient is zero in exact arithmetic: softmax ignores a constant
added to every key).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.train.train_step import trainable  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402,F401

ARCHS = ["deepseek-7b", "granite-moe-1b-a400m", "kimi-k2-1t-a32b", "mamba2-130m",
         "recurrentgemma-2b", "whisper-small", "internvl2-26b"]
EXTRA = {"whisper-small": dict(n_frames=37, attn_chunk=16)}
B, S = 2, 48


def batch_of(cfg, seed=3) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)) \
            .astype(np.float32)
    return batch


def port_loss_and_grads(tree, cfg, batch):
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(tree, cfg, "cpu")
    named = trainable(params)
    loss, metrics = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), metrics, params_to_numpy(params, cfg, dict(zip(named, grads)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg = jax_get_smoke(arch).replace(dtype="float32", **EXTRA.get(arch, {}))
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    batch = batch_of(jcfg)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jparams,
                                                                                   batch)
    tree = jax.tree.map(np.asarray, jparams)
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    for remat in (False, True):
        cfg = get_smoke(arch).replace(dtype="float32", remat=remat, **EXTRA.get(arch, {}))
        loss, metrics, grads = port_loss_and_grads(tree, cfg, batch)
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5, err_msg=f"loss remat={remat}")
        for key in ("nll", "moe_lb_loss", "moe_z_loss"):
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-5,
                                       atol=1e-7, err_msg=key)
        got = jax.tree_util.tree_leaves_with_path(grads)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, jax.tree_util.keystr(path)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-7,
                                       err_msg=f"{jax.tree_util.keystr(path)} remat={remat}")
