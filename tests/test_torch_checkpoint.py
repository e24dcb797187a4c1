"""The port's checkpoints against the JAX package's, on the CPU.

The JAX package's three checkpoint tests (``tests/test_substrate.py``) on
trees of tensors; a save followed by an in-place change of the saved tensors
(the port's train step updates in place); and granite-moe's smoke
``TrainState`` in bf16 (plain, 8-bit moments, int8 error feedback) across
the packages: a JAX-written checkpoint restores into the port leaf by leaf
exactly, a port-written one loads in ``repro.checkpoint.restore`` exactly,
and both packages write the same npz keys, the same manifest leaves and the
same arrays for the same state.  The new modules import no ``ml_dtypes``,
``jax`` or ``repro``, and a bf16 round trip needs none of them.
"""
import functools
import json
import os
import subprocess
import sys
import tempfile
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train import train_step as jax_train  # noqa: E402
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore, save  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import (init_train_state, train_state_from_numpy,  # noqa: E402
                               train_state_from_tree, train_state_to_tree)
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402,F401
from test_torch_ft import one_torch_thread  # noqa: E402,F401

ARCH = "granite-moe-1b-a400m"
VARIANTS = {"plain": {}, "opt_8bit": dict(opt_8bit=True), "compress": dict(compress=True)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tree_eq(a, b) -> bool:
    fa, fb = ckpt_mod._flatten(a), ckpt_mod._flatten(b)
    return list(fa) == list(fb) and all(
        fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]) for k in fa)


# ------------------------------------------- the JAX package's three tests ---


def test_checkpoint_roundtrip_and_gc():
    tree = {"a": torch.arange(8, dtype=torch.bfloat16), "b": {"c": torch.ones((3, 2))}}
    with tempfile.TemporaryDirectory() as d:
        for step in (1, 2, 3, 4):
            save(d, step, tree, keep_last=2)
        assert latest_step(d) == 4
        assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
        restored, step = restore(d, tree)
        assert step == 4
        assert tree_eq(tree, restored)
        assert restored["a"].dtype == torch.bfloat16


def test_async_checkpointer_overlap():
    tree = {"w": torch.ones((64, 64))}
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d)
        ck.save(10, tree)
        ck.save(20, {k: v * 2 for k, v in tree.items()})  # waits for the first
        ck.wait()
        restored, step = restore(d, tree)
        assert step == 20
        assert float(restored["w"][0, 0]) == 2.0
        assert len(ck.write_s) == 2


def test_checkpoint_atomicity_no_tmp_left():
    tree = {"w": torch.zeros(4)}
    with tempfile.TemporaryDirectory() as d:
        save(d, 7, tree)
        assert not any(f.endswith(".tmp") for f in os.listdir(d))


# ----------------------------------------------------------- the port's ---


def test_async_save_keeps_values_after_in_place_change():
    """The writer thread writes the values at the ``save`` call: the caller's
    in-place update right after it (with the writer held back until then)
    never reaches the checkpoint."""
    tree = {"w": torch.arange(1000, dtype=torch.float32), "s": (torch.ones(3, dtype=torch.int8),)}
    want = {"w": tree["w"].clone(), "s": (tree["s"][0].clone(),)}
    gate = threading.Event()
    real_save = ckpt_mod.save

    def held_save(*args, **kw):
        gate.wait()
        return real_save(*args, **kw)

    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d)
        ckpt_mod.save = held_save
        try:
            ck.save(1, tree)
            assert ck.in_flight()
            tree["w"].mul_(-3.0)
            tree["s"][0].add_(5)
            gate.set()
            ck.wait()
        finally:
            ckpt_mod.save = real_save
        restored, _ = restore(d, tree)
        assert tree_eq(restored, want)


def test_writer_error_raises_from_wait():
    with tempfile.TemporaryDirectory() as d:
        blocker = os.path.join(d, "file")
        open(blocker, "w").close()
        ck = AsyncCheckpointer(blocker)  # a file where the directory should be
        ck.save(1, {"w": torch.zeros(2)})
        with pytest.raises(OSError):
            ck.wait()
        ck.wait()  # the error is raised once


def test_restore_step_template_and_empty_dir():
    tree = (torch.zeros(3), [torch.arange(4, dtype=torch.int32), None], {"z": torch.ones(1)})
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            restore(d, tree)
        save(d, 1, (torch.ones(3), [torch.arange(4, dtype=torch.int32) * 2, None],
                    {"z": torch.zeros(1)}))
        save(d, 2, tree)
        os.makedirs(os.path.join(d, "step_00000009.tmp"))  # a write that never finished
        assert latest_step(d) == 2
        got, step = restore(d, tree, step=1)
        assert step == 1 and got[1][1] is None and isinstance(got[1], list)
        assert torch.equal(got[1][0], torch.arange(4, dtype=torch.int32) * 2)
        assert torch.equal(tree[0], torch.zeros(3))  # the template is as it was
        with open(os.path.join(d, "step_00000002", "manifest.json")) as f:
            assert sorted(json.load(f)["leaves"]) == ["0", "1/0", "2/z"]


# ---------------------------------------------------- across the packages ---


@functools.cache
def jax_state(variant: str, seed: int = 0):
    """The JAX package's smoke state (its leaves are immutable, so shared)."""
    cfg = jax_get_smoke(ARCH)
    return jax_train.init_train_state(jax_build_model(cfg), jax.random.PRNGKey(seed),
                                      **VARIANTS[variant])


def port_state(variant: str, seed: int = 5):
    """A port state of granite's smoke config (bf16), from its own seed."""
    cfg = get_smoke(ARCH)
    return init_train_state(build_model(cfg, device="cpu"), seed, **VARIANTS[variant]), cfg


def numpy_leaves(tree) -> dict:
    """The JAX package's checkpoint keys and values (bf16 as float32)."""
    out = {}
    for key, leaf in jax_ckpt.checkpoint._flatten(tree)[0].items():
        arr = np.asarray(jax.device_get(leaf))
        out[key] = arr.astype(np.float32) if arr.dtype == jnp.bfloat16 else arr
    return out


def port_leaves(tree) -> dict:
    return {key: ckpt_mod._to_numpy(leaf) for key, leaf in ckpt_mod._flatten(tree).items()}


def assert_same(got: dict, want: dict):
    assert list(got) == list(want)
    for key, (arr, dtype) in got.items():
        w = want[key]
        assert arr.shape == w.shape and arr.dtype == w.dtype, key
        np.testing.assert_array_equal(arr, w, err_msg=key)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_jax_checkpoint_restores_in_port(variant):
    jstate = jax_state(variant)
    state, cfg = port_state(variant)
    with tempfile.TemporaryDirectory() as d:
        jax_ckpt.save(d, 3, jstate)
        template = train_state_to_tree(state, cfg)
        tree, step = restore(d, template)
        # a template without values (no copy) restores the same leaves
        assert tree_eq(restore(d, train_state_to_tree(state, cfg, copy=False))[0], tree)
    assert step == 3
    train_state_from_tree(tree, state, cfg)
    got = port_leaves(train_state_to_tree(state, cfg))
    assert_same(got, numpy_leaves(jstate))
    for key, leaf in ckpt_mod._flatten(tree).items():
        tmpl = ckpt_mod._flatten(template)[key]
        assert leaf.dtype == tmpl.dtype and leaf.shape == tmpl.shape, key


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_port_checkpoint_restores_in_jax(variant):
    state, cfg = port_state(variant)
    template = jax_state(variant, seed=1)
    with tempfile.TemporaryDirectory() as d:
        save(d, 4, train_state_to_tree(state, cfg))
        restored, step = jax_ckpt.restore(d, template)
    assert step == 4
    want = port_leaves(train_state_to_tree(state, cfg))
    got = numpy_leaves(restored)
    assert_same(want, got)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(template)):
        assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_both_packages_write_the_same_files(variant):
    """The same state written by each package: the same npz keys, manifest
    leaves and arrays (the state carried into the port with
    ``train_state_from_numpy``)."""
    jstate = jax_state(variant)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), get_smoke(ARCH), "cpu")
    with tempfile.TemporaryDirectory() as dj, tempfile.TemporaryDirectory() as dt:
        jax_ckpt.save(dj, 0, jstate)
        ck = AsyncCheckpointer(dt)
        ck.save(0, train_state_to_tree(state, get_smoke(ARCH)))
        ck.wait()
        files = {}
        for name, d in (("jax", dj), ("port", dt)):
            path = os.path.join(d, "step_00000000")
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            with np.load(os.path.join(path, "arrays.npz")) as z:
                files[name] = (manifest, {k: z[k] for k in z.files})
    (mj, aj), (mt, at) = files["jax"], files["port"]
    assert mj["step"] == mt["step"] == 0
    assert mj["leaves"] == mt["leaves"]
    assert list(mj["leaves"]) == list(mt["leaves"])
    assert list(aj) == list(at)
    for k in aj:
        assert aj[k].dtype == at[k].dtype and aj[k].shape == at[k].shape, k
        np.testing.assert_array_equal(aj[k], at[k], err_msg=k)
    keys = set(mj["leaves"])
    assert ".params/seg0/k0/attn/wq" in keys and ".opt/count" in keys
    assert (".opt/v/seg0/k0/attn/wq/q" in keys) == (variant == "opt_8bit")
    assert any(k.startswith(".err/") for k in keys) == (variant == "compress")
    assert {v["dtype"] for v in mj["leaves"].values()} >= {"bfloat16", "float32", "int32"}


REFUSE = r"""
import importlib.abc, sys, tempfile

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"):
            raise ImportError(f"imported {name!r}")
        return None

sys.meta_path.insert(0, Refuse())
import torch
import repro_torch.checkpoint, repro_torch.ft, repro_torch.ft.__main__, repro_torch.parallel
from repro_torch.checkpoint import restore, save
tree = {"a": torch.randn(5).to(torch.bfloat16), "b": torch.arange(3, dtype=torch.int8)}
with tempfile.TemporaryDirectory() as d:
    save(d, 1, tree)
    got, _ = restore(d, tree)
assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"], tree["a"])
assert torch.equal(got["b"], tree["b"])
print("ok")
"""


def test_new_modules_import_no_ml_dtypes_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", REFUSE], env=env, capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]
