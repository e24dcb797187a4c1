"""The port's ``launch/`` against the JAX package's, on the CPU.

Exact: every (arch, shape) ``get_plan``, every ``get_skips`` and
``runnable_cells``; ``build_cell`` of every runnable cell on 16x16,
2x16x16 and 1x1 meshes (the JAX package's read on a
``jax.sharding.AbstractMesh``, the port's on its ``AbstractMesh``: no
512-device process), field by field; ``model_flops_for_cell`` of every
runnable cell; ``parse_variant``/``_coerce``; ``_depths``/``_reduced``.
The counter (``roofline.Counter``) on deepseek-7b's smoke forward against
a count worked out here, on the CPU (the plain chunked attention) and on
meta tensors (the flash kernel's custom op and its registered formula), and
the roofline terms of a record.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch import hillclimb as jax_hillclimb  # noqa: E402
from repro.launch import measure as jax_measure  # noqa: E402
from repro.launch import roofline as jax_roofline  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import attention_live_pairs, flash_flops  # noqa: E402
from repro_torch.launch import hillclimb, measure, mesh as launch_mesh, roofline, specs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.parallel import AbstractMesh  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402, F401

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
CELLS = jax_configs.runnable_cells()


def test_plans_skips_and_cells_equal_the_reference():
    assert configs.ARCHS == jax_configs.ARCHS
    assert list(configs.SHAPES) == list(jax_configs.SHAPES)
    for arch in configs.ARCHS:
        assert configs.get_skips(arch) == jax_configs.get_skips(arch)
        for shape in configs.SHAPES:
            assert dataclasses.asdict(configs.get_plan(arch, shape)) == dataclasses.asdict(
                jax_configs.get_plan(arch, shape)), (arch, shape)
    assert configs.runnable_cells() == CELLS
    assert dataclasses.asdict(configs.shapes.default_plan("train")) == dataclasses.asdict(
        jax_configs.shapes.default_plan("train"))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_build_cell_equals_the_reference(mesh_name):
    shape, names = MESHES[mesh_name]
    for arch, cell_shape in CELLS:
        got = specs.build_cell(arch, cell_shape, AbstractMesh(shape, names))
        want = jax_specs.build_cell(arch, cell_shape, JaxAbstractMesh(shape, names))
        assert (got.arch, got.shape, got.kind, got.microbatches) == (
            want.arch, want.shape, want.kind, want.microbatches), (arch, cell_shape)
        assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg), (arch, cell_shape)
        assert dataclasses.asdict(got.plan) == dataclasses.asdict(want.plan)
        assert got.cfg.vocab_size % max(16, dict(zip(names, shape)).get("model", 1)) == 0


def test_model_flops_for_cell_exact():
    mesh = AbstractMesh((16, 16), ("data", "model"))
    jmesh = JaxAbstractMesh((16, 16), ("data", "model"))
    for arch, shape in CELLS:
        got = specs.build_cell(arch, shape, mesh)
        want = jax_specs.build_cell(arch, shape, jmesh)
        assert roofline.model_flops_for_cell(got.cfg, configs.SHAPES[shape], got.kind) == \
            jax_roofline.model_flops_for_cell(want.cfg, jax_configs.SHAPES[shape], want.kind)


VARIANTS = ["baseline", "qblock:attention_impl=qblock", "bigchunk:attn_chunk=2048",
            "mb:mb=16", "plan:plan.opt_8bit=true,plan.seq_shard=False",
            "mix:remat=False,capacity_factor=1.5,mb=4,plan.notes=x,dtype=float32",
            "neg:attn_q_block=-3,rope_theta=5e5"]


@pytest.mark.parametrize("spec", VARIANTS)
def test_parse_variant_exact(spec):
    assert hillclimb.parse_variant(spec) == jax_hillclimb.parse_variant(spec)


@pytest.mark.parametrize("value", ["True", "true", "False", "false", "3", "-7", "2.5", "1e-3",
                                   "nan", "qblock", "", "0x10"])
def test_coerce_exact(value):
    got, want = hillclimb._coerce(value), jax_hillclimb._coerce(value)
    assert type(got) is type(want) and (got == want or got != got and want != want)


def test_depths_and_reduced_exact():
    for arch in configs.ARCHS:
        cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
        assert measure._depths(cfg) == jax_measure._depths(jcfg)
        L1, L2, _ = measure._depths(cfg)
        for L in (L1, L2):
            assert dataclasses.asdict(measure._reduced(cfg, L)) == dataclasses.asdict(
                jax_measure._reduced(jcfg, L))


def test_h100_constants():
    assert (launch_mesh.PEAK_FLOPS_BF16, launch_mesh.HBM_BW, launch_mesh.ICI_BW) == (
        989e12, 3.35e12, 450e9)
    assert roofline._COST_FACTOR == jax_roofline._COST_FACTOR


B, S = 2, 24


def _dense_forward_count(device: str) -> tuple:
    """deepseek-7b's smoke forward on ``device`` under the counter, and the
    FLOPs worked out here: every projection and the logits, 2 a
    multiply-add, and the attention either as the plain chunked form
    computes it (every query against every key) or as the kernel's formula
    (``4 B Hq D`` a live causal pair)."""
    cfg = get_smoke("deepseek-7b").replace(dtype="float32", attention_impl="chunked",
                                          attn_chunk=8)
    model = build_model(cfg, device=device)
    params = model.init(0)
    tokens = torch.zeros((B, S), dtype=torch.int32, device=device)
    with roofline.Counter() as c:
        model.forward(params, {"tokens": tokens})
    d, hq, hkv, dh, ff, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
                             cfg.vocab_size)
    proj = 2 * B * S * (d * hq * dh + 2 * d * hkv * dh + hq * dh * d + 3 * d * ff)
    if device == "cpu":
        attn = 4 * B * hq * S * S * dh
    else:
        attn = 4 * B * hq * dh * attention_live_pairs(S, S, True, 0)
        assert attn == flash_flops((B, hq, S, dh), (B, hkv, S, dh), True, 0)
    return c, cfg.n_layers * (proj + attn) + 2 * B * S * d * V


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_dense_forward_equals_the_analytic_count(device):
    c, want = _dense_forward_count(device)
    assert c.get_total_flops() == want
    rec = c.record()
    assert rec["flops"] == want and rec["bytes"] > 0 and rec["coll_bytes"] == 0
    assert ("repro_torch::flash_fwd" in c.ops) == (device == "meta")


def test_counter_sees_the_kernel_ops_backward_on_meta():
    cfg = get_smoke("granite-moe-1b-a400m")
    model = build_model(cfg, device="meta")
    params = model.init(0)
    for p in params.parameters():
        p.requires_grad_(True)
    with roofline.Counter() as c:
        loss, _ = model.loss(params, {"tokens": torch.zeros((2, 16), dtype=torch.int32,
                                                            device="meta")})
        torch.autograd.grad(loss, list(params.parameters()))
    for op in ("flash_fwd", "flash_bwd", "assign", "gate_backward"):
        assert c.ops[f"repro_torch::{op}"] > 0, op
    assert c.record()["peak_bytes"] > 0


def test_analyze_terms():
    rec = {"flops": 989e12, "bytes": 2 * 3.35e12, "coll_breakdown": {
        "all-gather": 450e9, "all-reduce": 450e9, "reduce-scatter": 0, "all-to-all": 0,
        "collective-permute": 0}, "peak_bytes": 5.0}
    rf = roofline.analyze(arch="a", shape="train_4k", mesh_name="16x16", n_devices=256,
                          counts=rec, model_flops_total=256 * 989e12 / 2)
    assert (rf.compute_s, rf.memory_s, rf.collective_s) == (1.0, 2.0, 3.0)
    assert rf.bottleneck == "collective" and rf.step_s == 3.0 and rf.coll_bytes == 3 * 450e9
    assert rf.roofline_frac == pytest.approx(0.5 / 3.0) and rf.useful_ratio == 0.5
    assert rf.peak_bytes_per_device == 5.0


def test_module_docstrings_name_the_parsers():
    doc = roofline.__doc__
    for name in ("_shape_bytes", "collective_bytes(hlo_text)", "_collective_bytes_corrected",
                 "_fusion_adjusted_bytes"):
        assert name in doc


def test_registering_the_ops_builds_nothing():
    """Importing the port (every op registered, the models and launch/)
    loads no kernel library, and a CPU tensor runs the plain version."""
    import subprocess
    import sys

    code = ("import torch, repro_torch.launch.dryrun, repro_torch.models, repro_torch._build as b;"
            "q = torch.randn(1, 2, 8, 16); o, l = torch.ops.repro_torch.flash_fwd("
            "q, q, q, True, 0, None, True); assert not b._LOADED, b._LOADED; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(__import__("os").environ,
                                               PYTHONPATH=str(__import__("pathlib").Path(
                                                   __file__).resolve().parents[1] / "src")))
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]
