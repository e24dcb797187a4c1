"""The port's sharding rules against the JAX package's, on the CPU.

Every family's smoke config (``repro.configs.ARCHS``) on three meshes, the
JAX package's specs read on ``jax.sharding.AbstractMesh`` and the port's on
its ``AbstractMesh``: ``(2, 2, 2)`` over ``pod/data/model``, ``(2, 2)`` and
``(1, 3)`` over ``data/model`` (3 divides few widths, so ``_validate_spec``
drops axes there).  Exact, spec by spec: ``params_shardings`` of a
``TrainState`` with 8-bit moments and error feedback in the JAX package's
layout (``train_state_to_tree``), of the port's module (a layer's spec
without the stacked axis), ``cache_shardings`` of the port's cache (one
stack a kind of state, against the JAX cache's leaves of that stack) and
``batch_shardings``.  Placements, ``use_mesh`` and the constraints' pass
through.  A JAX-written checkpoint restored with ``shardings=`` on a 1-rank
gloo mesh in process, and on 4 spawned gloo ranks (``tests/torch_mesh_ranks.py``)
on a ``(2, 2)`` mesh: each rank holds exactly its slice of each leaf, and
``gather_fsdp``, ``constrain_batch`` and ``maybe_shard_seq`` redistribute
``DTensor``s to the reference's specs.
"""
import functools
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402

import torch_mesh_ranks as M  # noqa: E402
from repro import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.parallel import sharding as jax_sharding  # noqa: E402
from repro.train import train_step as jax_train  # noqa: E402
from repro_torch.checkpoint import restore  # noqa: E402
from repro_torch.checkpoint.checkpoint import _flatten, _key  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import param_paths  # noqa: E402
from repro_torch.models.transformer import CACHE_ENTRIES, plan_segments  # noqa: E402
from repro_torch.parallel import (AbstractMesh, NamedSharding, PartitionSpec,  # noqa: E402
                                  batch_shardings, cache_shardings, constrain_batch,
                                  gather_fsdp, maybe_shard_seq, params_shardings)
from repro_torch.parallel.sharding import ambient_axis_names  # noqa: E402
from repro_torch.train import init_train_state, train_state_to_tree  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402,F401
from test_torch_ft import one_torch_thread  # noqa: E402,F401

MESHES = {"pod2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "data2x2": ((2, 2), ("data", "model")),
          "data1x3": ((1, 3), ("data", "model"))}
CACHE_B, CACHE_LEN = 4, 12


def meshes(name):
    shape, names = MESHES[name]
    return JaxAbstractMesh(shape, names), AbstractMesh(shape, names)


def jax_specs(tree) -> dict:
    """``{checkpoint key: spec as a tuple}`` of a tree of JAX shardings."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {_key(path): tuple(s.spec) for path, s in leaves}


def port_specs(tree) -> dict:
    return {key: tuple(s.spec) for key, s in _flatten(tree).items()}


@functools.cache
def port_state(arch):
    cfg = get_smoke(arch)
    state = init_train_state(build_model(cfg, device="cpu"), 0, opt_8bit=True, compress=True)
    return cfg, state, train_state_to_tree(state, cfg)


@functools.cache
def jax_abstract(arch):
    jm = jax_build_model(jax_get_smoke(arch))
    state = jax.eval_shape(lambda: jax_train.init_train_state(
        jm, jax.random.PRNGKey(0), opt_8bit=True, compress=True))
    return state, jax.eval_shape(lambda: jm.init_cache(CACHE_B, CACHE_LEN))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_match_reference(arch, mesh):
    jmesh, tmesh = meshes(mesh)
    cfg, state, tree = port_state(arch)
    jstate, _ = jax_abstract(arch)
    want = jax_specs(jax_sharding.params_shardings(jstate, jmesh))
    got = port_specs(params_shardings(tree, tmesh))
    assert list(got) == list(want)
    assert got == want
    assert any(len(s) and s[0] is None and any(s) for s in got.values())  # a stacked leaf
    # the module form: a layer's spec without the stacked axis
    params = jax_specs(jax_sharding.params_shardings(jstate.params, jmesh))
    module = params_shardings(state.params, tmesh, cfg)
    for name, (path, layer) in param_paths(state.params, cfg).items():
        spec = params["/".join(path)]
        assert tuple(module[name].spec) == (spec if layer is None else spec[1:]), name
        assert len(module[name].spec) <= dict(state.params.named_parameters())[name].dim()
    with pytest.raises(TypeError):
        params_shardings(state.params, tmesh)


def port_cache_entry(cfg, names: list) -> str:
    """The port's cache stack that holds a JAX cache leaf."""
    if names[0].startswith("seg"):
        kind = plan_segments(cfg)[int(names[0][3:])].pattern[int(names[1][1:])]
        return CACHE_ENTRIES[kind][names[-1]]
    return names[-1]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(arch, mesh):
    jmesh, tmesh = meshes(mesh)
    cfg = port_state(arch)[0]
    _, jcache = jax_abstract(arch)
    cache = build_model(cfg, device="cpu").init_cache(CACHE_B, CACHE_LEN)
    for kw in ({}, dict(shard_len=False), dict(batch=None), dict(batch=("data",))):
        want = jax_sharding.cache_shardings(jcache, jmesh, **kw)
        got = port_specs(cache_shardings(cache, tmesh, **kw))
        seen = set()
        for path, s in jax.tree_util.tree_leaves_with_path(want):
            names = [getattr(k, "key", getattr(k, "name", str(k))) for k in path]
            entry = port_cache_entry(cfg, names)
            assert got[entry] == tuple(s.spec), (entry, kw)
            seen.add(entry)
        assert seen == set(got)
    batch = {"tokens": np.zeros((8, 16), np.int32), "frames": np.zeros((8, 3, 4), np.float32)}
    want = jax_specs(jax_sharding.batch_shardings(batch, jmesh))
    assert port_specs(batch_shardings({k: torch.from_numpy(v) for k, v in batch.items()},
                                      tmesh)) == want


def test_placements_shard_index_and_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    s = NamedSharding(mesh, PartitionSpec(("pod", "data"), "model", None))
    assert s.placements() == (Shard(0), Shard(0), Shard(1))
    assert NamedSharding(mesh, PartitionSpec()).placements() == (Replicate(),) * 3
    # pod major: position (pod 1, data 0) holds the third quarter of the rows
    assert s.shard_index((8, 4, 3), (1, 0, 1)) == (slice(4, 6), slice(2, 4), slice(0, 3))
    with pytest.raises(ValueError):
        NamedSharding(mesh, PartitionSpec(("data", "pod"))).placements()
    with pytest.raises(ValueError):
        s.shard_index((6, 4, 3), (0, 0, 0))


def test_ambient_mesh_and_pass_through():
    x = torch.ones(4, 6, 8)
    assert ambient_axis_names() == ()
    assert constrain_batch(x) is x and maybe_shard_seq(x) is x
    layer = {"attn": {"wq": torch.ones(8, 8)}}
    assert gather_fsdp(layer) is layer
    mesh = AbstractMesh((2, 2), ("data", "model"))
    with D.use_mesh(mesh):
        assert ambient_axis_names() == ("data", "model") and D.ambient_mesh() is mesh
        with D.use_mesh(AbstractMesh((4,), ("data",))):
            assert ambient_axis_names() == ("data",)
            assert gather_fsdp(layer) is layer  # no 'model' axis
        # plain tensors pass through under a mesh too
        assert constrain_batch(x) is x and maybe_shard_seq(x) is x
        assert gather_fsdp(layer)["attn"]["wq"] is layer["attn"]["wq"]
    assert D.ambient_mesh() is None


@functools.cache
def jax_state_8bit(arch: str):
    return jax_train.init_train_state(jax_build_model(jax_get_smoke(arch)),
                                      jax.random.PRNGKey(2), opt_8bit=True)


def jax_checkpoint(root, arch: str) -> tuple:
    """A JAX-written checkpoint of ``arch``'s smoke TrainState with 8-bit
    moments (step 5) under ``root`` and its numpy leaves by key (bf16 as
    float32)."""
    d = os.path.join(root, "ckpt")
    jax_ckpt.save(d, 5, jax_state_8bit(arch))
    with np.load(os.path.join(d, "step_00000005", "arrays.npz")) as z:
        leaves = {k.replace("__", "/"): z[k] for k in z.files}
    return d, leaves


def reference_slice(spec: tuple, shape: tuple, mesh_shape: dict, coord: dict) -> tuple:
    """The slice of a leaf that a mesh position holds under a JAX spec: a
    dimension over axes ``(a, b)`` splits into ``|a| * |b|`` blocks, block
    ``i_a * |b| + i_b``."""
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        idx, parts = 0, 1
        for a in axes:
            idx, parts = idx * mesh_shape[a] + coord[a], parts * mesh_shape[a]
        out.append(slice(idx * n // parts, (idx + 1) * n // parts))
    return tuple(out)


def as_numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def test_restore_with_shardings_on_one_rank(tmp_path):
    from torch.distributed.device_mesh import init_device_mesh

    arch = "granite-moe-1b-a400m"
    d, leaves = jax_checkpoint(tmp_path, arch)
    cfg = get_smoke(arch)
    template = train_state_to_tree(init_train_state(build_model(cfg, device="cpu"), 0,
                                                    opt_8bit=True), cfg)
    with M.one_rank_mesh(tmp_path):
        grid = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        tree, step = restore(d, template, shardings=params_shardings(template, grid))
        got = {k: (as_numpy(v.full_tensor()), v.dtype, type(v).__name__)
               for k, v in _flatten(tree).items()}
    assert step == 5 and list(got) == list(leaves)
    for key, (arr, dtype, kind) in got.items():
        assert kind == "DTensor" and dtype == _flatten(template)[key].dtype, key
        np.testing.assert_array_equal(arr, leaves[key], err_msg=key)


def test_four_ranks_restore_their_slices(tmp_path):
    arch = "granite-moe-1b-a400m"
    d, leaves = jax_checkpoint(tmp_path, arch)
    D.run_ranks(M.restore_sharded_rank, 4, (str(tmp_path), d, arch, True, (2, 2)),
                device_type="cpu")
    jmesh = JaxAbstractMesh((2, 2), ("data", "model"))
    specs = jax_specs(jax_sharding.params_shardings(jax_state_8bit(arch), jmesh))
    sizes = {"data": 2, "model": 2}
    coords = set()
    for r in range(4):
        rec = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        coord = dict(zip(("data", "model"), rec["coordinate"]))
        coords.add(tuple(rec["coordinate"]))
        assert rec["step"] == 5 and list(rec["leaves"]) == list(leaves)
        sharded = 0
        for key, (local, placements, shape) in rec["leaves"].items():
            want = leaves[key][reference_slice(specs[key], leaves[key].shape, sizes, coord)]
            assert shape == leaves[key].shape, key
            np.testing.assert_array_equal(as_numpy(local), want, err_msg=key)
            sharded += any(p.startswith("S") for p in placements)
        assert sharded > len(leaves) // 2
        # gather_fsdp keeps only 'model': the data dimension is Replicate
        for key, (placements, local, full, before) in rec["layer"].items():
            assert placements[0] == "R", key
            assert placements[1] == before[1], key
        wq = rec["layer"]["attn/wq"]
        assert wq[3] == ["S(0)", "S(1)"] and wq[0] == ["R", "S(1)"]
        assert wq[2].shape == (128, 4 * 32)
        # constrain_batch shards a replicated batch over data; maybe_shard_seq the seq over model
        assert rec["batch"][0] == ["S(0)", "R"] and rec["seq"][0] == ["S(0)", "S(1)"]
        tokens = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
        i, j = coord["data"], coord["model"]
        assert torch.equal(rec["batch"][1], tokens[2 * i:2 * i + 2])
        assert torch.equal(rec["seq"][1], tokens[2 * i:2 * i + 2, 3 * j:3 * j + 3])
        assert rec["plain"] and rec["plain_in_mesh"]
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
