"""The port's cells on a fake mesh and on spawned gloo ranks, on the CPU.

One test, whose two parts run side by side.  The counterpart of
``test_dryrun_mini.py``: in one subprocess (the fake default process
group would stay in a pytest worker), a fake ``(2, 2, 2)``
mesh over ``pod/data/model`` of 512 fake ranks; for deepseek-7b, kimi-k2,
mamba2 and recurrentgemma's smoke configs the train step traced on meta
``DTensor``s counts FLOPs and collective bytes, the hand-written kernels'
ops among them, and the decode step against a cache split over 'model'
traces.

Then granite-moe's f32 smoke config on 4 spawned gloo ranks
(``tests/torch_mesh_ranks.py``), a ``(2, 2)`` ``("data", "model")`` mesh,
against the same calls in one process: the constraint call sites, the
vocab-parallel embedding, the MoE layer's split routing and
expert-parallel matmuls, and the decode step against a cache whose
positions are split over 'model'.

- The train step's loss within rtol 1e-6.
- Every gradient the step hands AdamW within 1e-5 of its leaf's largest
  magnitude: the backward of every constraint site (the router's gradient
  summed over 'data', the embedding's over the vocab shards, the experts'
  over their ranks).
- Every parameter after the step within 1e-6.  AdamW's epsilon is 1 there,
  so that a parameter's step follows its gradient (with 1e-8, a gradient of
  1e-30 against 0 flips a step of lr).
- A prefill and four decode steps, without and with an attention window of
  4, whose ``kv_len`` crosses the cache's shard boundary, and a prefill
  that fills the whole cache: every step's logits and the whole cache
  afterwards within 1e-5.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ranks as M  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import AdamWConfig, init_train_state  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("deepseek-7b", "kimi-k2-1t-a32b", "mamba2-130m", "recurrentgemma-2b")

SCRIPT = textwrap.dedent('''
    import json, sys
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import ShapeSpec, get_plan, get_smoke
    from repro_torch.launch import specs
    from repro_torch.launch.measure import traced
    from repro_torch.launch.mesh import init_fake_world
    from repro_torch.launch.specs import Cell, input_specs, trace_mesh

    torch.set_num_threads(1)
    init_fake_world(512)
    mesh = trace_mesh(DeviceMesh("cpu", torch.arange(8).view(2, 2, 2),
                                 mesh_dim_names=("pod", "data", "model")))
    # smoke-sized shapes: 8 sequences of 16 tokens
    specs.SHAPES = {"train_4k": ShapeSpec("train_4k", 16, 8, "train"),
                    "decode_32k": ShapeSpec("decode_32k", 16, 8, "decode")}
    out = {}
    for arch in sys.argv[1:]:
        cfg = get_smoke(arch)
        out[arch] = {}
        for shape, spec in specs.SHAPES.items():
            cell = Cell(arch, shape, cfg, get_plan(arch, shape), spec.kind, 1)
            fn, args, donate = input_specs(cell, mesh)
            rec = traced(fn, args, mesh)
            out[arch][shape] = dict(flops=rec["flops"], coll=rec["coll_bytes"],
                                    bytes=rec["bytes"], donate=list(donate))
            if shape == "decode_32k":
                out[arch][shape]["cache_split"] = [
                    str(p) for p in args[2]["k"].placements] if "k" in args[2] else []
    print(json.dumps(out))
''')


def start_fake_mesh_traces() -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, "-c", SCRIPT, *ARCHS], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def check_fake_mesh_traces(proc: subprocess.Popen) -> None:
    try:
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    out = json.loads(stdout.strip().splitlines()[-1])
    assert set(out) == set(ARCHS)
    for arch, rec in out.items():
        train, decode = rec["train_4k"], rec["decode_32k"]
        assert train["flops"] > 0 and train["coll"] > 0 and train["bytes"] > 0, arch
        assert train["donate"] == [0] and decode["donate"] == [2], arch
        assert decode["flops"] > 0 and decode["bytes"] > 0, arch
        if decode["cache_split"]:   # attention layers: positions split over 'model'
            assert decode["cache_split"][-1] == "S(3)", arch


ARCH, SHAPE, MICROBATCHES, WINDOWS = "granite-moe-1b-a400m", (2, 2), 2, (0, 4)


def one_process():
    """The same step and decode runs on plain CPU tensors."""
    cfg = get_smoke(ARCH).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    tokens = M.launch_train_batch(cfg)["tokens"]
    step, grads = M.recorded_train_step(model, AdamWConfig(warmup_steps=1, eps=1.0),
                                        MICROBATCHES)
    state, met = step(init_train_state(model, 0), {"tokens": tokens})
    rec = {"loss": float(met["loss"]), "grads": dict(grads),
           "params": {n: p.detach() for n, p in state.params.named_parameters()}}
    runs = {f"decode{w}": (w, {}) for w in WINDOWS}
    runs["prefill_full"] = (0, dict(prompt=M.DECODE_CACHE_LEN, new=0))
    for name, (window, kw) in runs.items():
        wmodel = build_model(cfg.replace(window=window), device="cpu")
        logits, cache = M.launch_decode(wmodel, wmodel.init(0), tokens, **kw)
        rec[name] = (logits, {k: v for k, v in cache.items() if isinstance(v, torch.Tensor)})
    return rec


def _close(got: dict, want: dict, rel: float, what: str) -> None:
    assert set(got) == set(want), what
    for name, w in want.items():
        bound = rel * max(float(w.abs().max()), 1e-30)
        err = float((got[name].float() - w.float()).abs().max())
        assert err <= bound, (what, name, err, bound)


def test_cells_on_a_fake_mesh_and_four_gloo_ranks(tmp_path):
    """The fake mesh's traces run in their subprocess beside the ranks."""
    traces = start_fake_mesh_traces()
    try:
        D.run_ranks(M.launch_rank, 4, (str(tmp_path), ARCH, SHAPE, MICROBATCHES, WINDOWS),
                    device_type="cpu")
    except BaseException:
        traces.kill()
        raise
    check_fake_mesh_traces(traces)
    want = one_process()
    for r in range(4):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
        _close(got["grads"], want["grads"], 1e-5, f"rank {r} gradient")
        for name, p in want["params"].items():
            err = float((got["params"][name] - p).abs().max())
            assert err <= 1e-6, (r, name, err)
        for name in want:
            if not (name.startswith("decode") or name == "prefill_full"):
                continue
            (g_logits, g_cache), (w_logits, w_cache) = got[name], want[name]
            assert len(g_logits) == len(w_logits), name
            _close(dict(enumerate(g_logits)), dict(enumerate(w_logits)), 1e-5,
                   f"rank {r} {name} logits")
            _close(g_cache, w_cache, 1e-5, f"rank {r} {name} cache")
