"""End-to-end training driver: data pipeline -> model -> fault-tolerant loop
with asynchronous checkpointing (and optional failure injection), on the card
unless ``--device cpu`` asks for the CPU.

Default: a ~100M-parameter mamba2-family model for a few hundred steps.

    PYTHONPATH=src python -m repro_torch.ft --steps 300            # full
    PYTHONPATH=src python -m repro_torch.ft --small --steps 10     # smoke
    PYTHONPATH=src python -m repro_torch.ft --arch deepseek-7b --small
    PYTHONPATH=src python -m repro_torch.ft --inject 50,120        # chaos
    PYTHONPATH=src python -m repro_torch.ft --small --device cpu
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs import get_config, get_smoke
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.ft import FailureInjector, train_with_restarts
from repro_torch.models import build_model, param_count
from repro_torch.train.optimizer import AdamWConfig


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.ft")
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--small", action="store_true", help="reduced smoke config")
    ap.add_argument("--inject", default="", help="comma-separated failure steps")
    ap.add_argument("--compress", action="store_true", help="int8 grad compression")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.small else get_config(args.arch)
    if args.arch == "mamba2-130m" and not args.small:
        # ~100M-param training target: trim depth, keep the family
        cfg = cfg.replace(n_layers=12)
    model = build_model(cfg, device=args.device)
    pipe = TokenPipeline(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch),
        device=args.device,
    )
    injector = None
    if args.inject:
        injector = FailureInjector(at_steps=tuple(int(s) for s in args.inject.split(",")))

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    print(f"arch={cfg.name} steps={args.steps} ckpt={ckpt_dir}")
    report = train_with_restarts(
        model,
        pipe,
        total_steps=args.steps,
        ckpt_dir=ckpt_dir,
        ckpt_every=max(args.steps // 10, 5),
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                            total_steps=args.steps),
        compress=args.compress,
        injector=injector,
    )
    n_params = param_count(model.init(0))
    losses = np.asarray(report.losses)
    print(
        f"\nparams={n_params:,}  steps={report.steps_done}  restarts={report.restarts}\n"
        f"loss: first={losses[0]:.3f} min={losses.min():.3f} last={losses[-1]:.3f}\n"
        f"step time: median={np.median(report.step_times):.2f}s  "
        f"slow-step watchdog hits={report.slow_steps}"
    )
    assert losses[-1] < losses[0], "training did not reduce the loss"
    return report


if __name__ == "__main__":
    main()
