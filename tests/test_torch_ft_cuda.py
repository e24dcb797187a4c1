"""Checkpoints and restart-safe training on the card.  Marked ``cuda``: they
skip where no GPU is present.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ft_cuda.py

``AsyncCheckpointer.save`` of tensors on the card takes its host copy before
it returns, so an in-place change right after it (the train step's) never
reaches the checkpoint; ``restore`` puts each leaf on its template leaf's
device; and granite-moe's smoke config, trained on the card through the flash
kernels and the router's kernels, replays the clean run's losses and ends on
its parameters bit for bit after an injected failure.
"""
import os
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

from repro_torch.checkpoint import AsyncCheckpointer, restore, save  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.ft import FailureInjector, train_with_restarts  # noqa: E402
from repro_torch.kernels.assign import assign_cuda, gate_backward_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import AdamWConfig  # noqa: E402

COUNTERS = (flash_attention_cuda, flash_attention_bwd_cuda, assign_cuda, gate_backward_cuda)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda", 0)


def test_async_save_of_card_tensors_keeps_values_after_in_place_change(dev):
    tree = {"w": torch.randn(4096, 256, device=dev).to(torch.bfloat16),
            "count": torch.tensor(3, dtype=torch.int32, device=dev)}
    want = {k: v.cpu().clone() for k, v in tree.items()}
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
            tree["w"].mul_(2).add_(1)
            tree["count"].add_(1)
            gate.set()
            ck.wait()
        finally:
            ckpt_mod.save = real_save
        got, _ = restore(d, {k: v.cpu() for k, v in tree.items()})
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_restore_places_leaves_on_the_template_device(dev):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": [torch.ones(2)]}
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, tree)
        template = {"a": tree["a"].to(dev), "b": [torch.zeros(2)]}
        got, step = restore(d, template)
    assert step == 1 and got["a"].device == dev and got["b"][0].device.type == "cpu"
    assert torch.equal(got["a"].cpu(), tree["a"]) and torch.equal(got["b"][0], tree["b"][0])
    assert torch.equal(template["b"][0], torch.zeros(2))  # the template is as it was


def test_restart_replays_bit_for_bit_on_the_card(dev):
    cfg = get_smoke("granite-moe-1b-a400m")
    model = build_model(cfg, device=dev)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=4),
                         device=dev)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6)
    finals = {}
    reports = {}
    for name, injector in (("clean", None), ("faulty", FailureInjector(at_steps=(3,)))):
        for mod in COUNTERS:
            mod.launches = 0
        with tempfile.TemporaryDirectory() as d:
            reports[name] = train_with_restarts(model, pipe, total_steps=6, ckpt_dir=d,
                                                ckpt_every=2, opt_cfg=opt, injector=injector,
                                                microbatches=2)
            assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004", "step_00000006"]
            with np.load(os.path.join(d, "step_00000006", "arrays.npz")) as z:
                finals[name] = {k: z[k] for k in z.files}
        assert all(mod.launches > 0 for mod in COUNTERS), [m.launches for m in COUNTERS]
    clean, faulty = reports["clean"], reports["faulty"]
    assert faulty.restarts == 1 and faulty.steps_done == 6
    assert faulty.losses == clean.losses[:3] + clean.losses[2:]
    assert list(finals["clean"]) == list(finals["faulty"])
    for k, v in finals["clean"].items():
        np.testing.assert_array_equal(v, finals["faulty"][k], err_msg=k)

