"""The port's fault-tolerant training driver against the JAX package's, on the
CPU.

``FailureInjector(prob=)`` fails at the JAX package's steps; the JAX
package's ``test_restart_resumes_deterministically`` on the port, where the
replayed steps give the clean run's losses bit for bit; across the packages,
granite-moe's smoke config in f32 from one JAX-written ``step_00000000`` (the
JAX package's initial state) in each package's checkpoint directory, 6 steps
with a checkpoint every 2 and a failure at step 3: the same restarts, steps
and number of losses, the losses within rtol 1e-5 (the train step's own
tolerance against the JAX package, ``tests/test_torch_train_step.py``, which
holds over these 6 steps too); and ``python -m repro_torch.ft`` in process.
"""
import os
import shutil
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jax_ckpt  # noqa: E402
from repro import ft as jax_ft  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import train_step as jax_train  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.ft import FailureInjector, InjectedFailure, train_with_restarts  # noqa: E402
from repro_torch.ft.__main__ import main  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import AdamWConfig  # noqa: E402
from test_torch_lm_family import clear_jax_caches_per_module  # noqa: E402,F401


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The smoke models' ops are tiny: one thread runs them fastest, and
    several test workers that each spin eight threads on the same cores slow
    each other down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def failing_steps(injector, steps: int = 50) -> list:
    out = []
    for step in range(steps):
        try:
            injector.maybe_fail(step)
        except Exception as e:  # noqa: BLE001 - each package's own InjectedFailure
            out.append((step, str(e)))
    return out


@pytest.mark.parametrize("prob,seed", [(0.1, 0), (0.3, 7)])
def test_failure_injector_fails_at_the_reference_steps(prob, seed):
    want = failing_steps(jax_ft.FailureInjector(at_steps=(4,), prob=prob, seed=seed))
    got = failing_steps(FailureInjector(at_steps=(4,), prob=prob, seed=seed))
    assert got == want and len(got) > 2
    with pytest.raises(InjectedFailure):
        FailureInjector(at_steps=(2,)).maybe_fail(2)


def test_restart_resumes_deterministically():
    cfg = get_smoke("mamba2-130m")
    m = build_model(cfg, device="cpu")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4),
                         device="cpu")
    opt = AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=10)
    with tempfile.TemporaryDirectory() as d1:
        clean = train_with_restarts(m, pipe, total_steps=10, ckpt_dir=d1, ckpt_every=2,
                                    opt_cfg=opt)
    with tempfile.TemporaryDirectory() as d2:
        faulty = train_with_restarts(m, pipe, total_steps=10, ckpt_dir=d2, ckpt_every=2,
                                     opt_cfg=opt, injector=FailureInjector(at_steps=(5,)))
        assert sorted(os.listdir(d2)) == ["step_00000006", "step_00000008", "step_00000010"]
    assert faulty.restarts == 1 and clean.restarts == 0
    assert clean.losses[-1] == pytest.approx(faulty.losses[-1], rel=1e-5)
    # steps 0-4, then the replay from the checkpoint of step 4: bit for bit
    assert faulty.steps_done == 10 and len(faulty.losses) == 11
    assert faulty.losses == clean.losses[:5] + clean.losses[4:]
    assert len(faulty.restore_s) == 1 and not clean.restore_s
    assert len(clean.save_copy_s) == len(clean.write_s) == 5
    assert len(faulty.save_in_flight) == len(faulty.losses)


def test_restart_across_packages():
    """Both drivers from one JAX-written initial checkpoint, in f32: equal
    restarts, steps and losses within rtol 1e-5."""
    jcfg = jax_get_smoke("granite-moe-1b-a400m").replace(dtype="float32")
    cfg = get_smoke("granite-moe-1b-a400m").replace(dtype="float32")
    jm, tm = jax_build_model(jcfg), build_model(cfg, device="cpu")
    data = dict(seq_len=32, global_batch=4, seed=1, mean_doc_len=8)
    opt = dict(warmup_steps=2, total_steps=6)
    run = dict(total_steps=6, ckpt_every=2)
    with tempfile.TemporaryDirectory() as root:
        seed_dir = os.path.join(root, "seed")
        jax_ckpt.save(seed_dir, 0, jax_train.init_train_state(jm, jax.random.PRNGKey(0)))
        dirs = {}
        for name in ("jax", "port"):
            dirs[name] = os.path.join(root, name)
            shutil.copytree(seed_dir, dirs[name])
        want = jax_ft.train_with_restarts(
            jm, JaxTokenPipeline(JaxDataConfig(vocab_size=jcfg.vocab_size, **data)),
            ckpt_dir=dirs["jax"], opt_cfg=jax_opt.AdamWConfig(**opt),
            injector=jax_ft.FailureInjector(at_steps=(3,)), **run)
        got = train_with_restarts(
            tm, TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, **data), device="cpu"),
            ckpt_dir=dirs["port"], opt_cfg=AdamWConfig(**opt),
            injector=FailureInjector(at_steps=(3,)), **run)
        for d in dirs.values():
            assert latest_step(d) == 6
    assert (got.restarts, got.steps_done, len(got.losses)) == (want.restarts, want.steps_done,
                                                               len(want.losses)) == (1, 6, 7)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5, atol=0)
    assert got.losses[2] == got.losses[3]  # step 2 replayed from step 2's checkpoint


def test_entry_point_in_process(capsys):
    with tempfile.TemporaryDirectory() as d:
        report = main(["--small", "--steps", "10", "--inject", "5", "--device", "cpu",
                       "--seq", "64", "--batch", "4", "--ckpt-dir", d])
        assert latest_step(d) == 10
    out = capsys.readouterr().out
    assert "restarts=1" in out and "steps=10" in out and f"ckpt={d}" in out
    assert report.restarts == 1 and report.losses[-1] < report.losses[0]
