"""Fault-tolerant training driver, the JAX package's ``ft/driver.py``.

Checkpoint/restart loop for the whole run: any step may raise (node loss,
preemption — injectable for tests); the loop restores the latest checkpoint
and replays from there.  The data pipeline is a pure function of the step, so
recovery is bit-deterministic.  Straggler mitigation at this layer is
step-time watchdogging (log + optional abort->restart); in the simulator
layer it is PanDA-style resubmission (engine retries).

Checkpoints hold the state in the JAX package's layout
(``train_state_to_tree``), so either package resumes the other's run.  A save
takes that host snapshot on the training thread and writes it on a writer
thread while the next steps run.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np

from ..checkpoint.checkpoint import AsyncCheckpointer, latest_step, restore
from ..data.pipeline import TokenPipeline
from ..train.train_step import (init_train_state, make_train_step, train_state_from_tree,
                                train_state_to_tree)

log = logging.getLogger("repro_torch.ft")


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministically fail at given steps (tests) or with probability p."""

    at_steps: tuple = ()
    prob: float = 0.0
    seed: int = 0
    _failed_once: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.at_steps and step not in self._failed_once:
            self._failed_once.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")
        if self.prob > 0:
            if np.random.default_rng((self.seed, step)).random() < self.prob:
                if step not in self._failed_once:
                    self._failed_once.add(step)
                    raise InjectedFailure(f"injected stochastic failure at step {step}")


@dataclass
class RunReport:
    steps_done: int = 0
    restarts: int = 0
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    slow_steps: int = 0
    # checkpoint costs: each step whether a write was in flight as it began;
    # each save's wait for the previous write and its host snapshot, on the
    # training thread (s); each write on the writer thread (s); each restore (s)
    save_in_flight: list = field(default_factory=list)
    save_wait_s: list = field(default_factory=list)
    save_copy_s: list = field(default_factory=list)
    write_s: list = field(default_factory=list)
    restore_s: list = field(default_factory=list)
    state: object = None   # the final TrainState


def train_with_restarts(
    model,
    pipeline: TokenPipeline,
    *,
    total_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 20,
    opt_cfg=None,
    microbatches: int = 1,
    compress: bool = False,
    injector: FailureInjector | None = None,
    max_restarts: int = 10,
    straggler_factor: float = 3.0,
    rng_seed: int = 0,
) -> RunReport:
    """Run to ``total_steps`` surviving failures via checkpoint/restart."""
    from ..train.optimizer import AdamWConfig

    opt_cfg = opt_cfg or AdamWConfig(total_steps=total_steps)
    step_fn = make_train_step(model, opt_cfg, microbatches=microbatches, compress=compress)
    ckpt = AsyncCheckpointer(ckpt_dir)
    report = RunReport()

    restarts = 0
    while True:
        # ---- (re)initialize or restore --------------------------------------
        state = init_train_state(model, rng_seed, compress=compress)
        start = 0
        if latest_step(ckpt_dir) is not None:
            t0 = time.perf_counter()
            tree, start = restore(ckpt_dir, train_state_to_tree(state, model.cfg, copy=False))
            train_state_from_tree(tree, state, model.cfg)
            del tree
            report.restore_s.append(time.perf_counter() - t0)
            log.info("restored checkpoint at step %d", start)
        try:
            step_ema = None
            for step in range(start, total_steps):
                if injector is not None:
                    injector.maybe_fail(step)
                report.save_in_flight.append(ckpt.in_flight())
                t0 = time.perf_counter()
                batch = pipeline.batch_at(step)
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                report.losses.append(loss)
                report.step_times.append(dt)
                report.steps_done = step + 1
                # straggler watchdog
                if step_ema is not None and dt > straggler_factor * step_ema:
                    report.slow_steps += 1
                    log.warning("straggler step %d: %.2fs vs ema %.2fs", step, dt, step_ema)
                step_ema = dt if step_ema is None else 0.9 * step_ema + 0.1 * dt
                if (step + 1) % ckpt_every == 0 or step + 1 == total_steps:
                    t0 = time.perf_counter()
                    ckpt.wait()
                    t1 = time.perf_counter()
                    ckpt.save(step + 1, train_state_to_tree(state, model.cfg), copy=False)
                    report.save_wait_s.append(t1 - t0)
                    report.save_copy_s.append(time.perf_counter() - t1)
            ckpt.wait()
            report.restarts = restarts
            report.write_s = list(ckpt.write_s)
            report.state = state
            return report
        except InjectedFailure as e:
            restarts += 1
            log.warning("%s — restarting (%d/%d)", e, restarts, max_restarts)
            ckpt.wait()
            state = None  # free the lost state before the next one is built
            if restarts > max_restarts:
                raise
