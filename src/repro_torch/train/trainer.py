"""Training orchestrator of the PyTorch port (counterpart of
``repro.train.trainer``): checkpoint/restart fault tolerance, straggler
watchdog, deterministic data resume.

* **Crash/restart**: the loop checkpoints every ``ckpt_interval`` steps
  (atomic rename, see ``checkpoint/``), and a new ``Trainer`` begins by
  restoring the latest snapshot (parameters, optimizer state, residuals)
  into its model in place; the data pipeline is step-indexed, so the
  restored run replays identical batches and ends bitwise equal to an
  uninterrupted one (on CUDA under ``torch.use_deterministic_algorithms``:
  the backward of a gather adds with atomics otherwise).
* **Straggler mitigation**: a step-time EMA watchdog flags steps slower
  than ``straggler_factor`` × the running mean; ``on_straggler`` is
  called with the trainer, the step and its time. A step is timed to a
  ``torch.cuda.synchronize`` of its device (to the loss's value on the
  CPU).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import AsyncWriter, restore, save
from repro_torch.train.steps import init_residuals, make_train_step, \
    named_params


class SimulatedFailure(RuntimeError):
    """Raised by the failure-injection hook to exercise the restart path."""


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_interval: int = 20
    ckpt_keep: int = 3
    async_ckpt: bool = True
    log_interval: int = 10
    microbatch: Optional[int] = None
    compression: str = "none"
    straggler_factor: float = 3.0
    straggler_warmup: int = 5


class StepWatchdog:
    """EMA step-time tracker; flags stragglers."""

    def __init__(self, factor: float, warmup: int):
        self.factor = factor
        self.warmup = warmup
        self.ema = None
        self.count = 0
        self.events = []

    def observe(self, step: int, dt: float) -> bool:
        self.count += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = (self.count > self.warmup
                        and dt > self.factor * self.ema)
        if is_straggler:
            self.events.append((step, dt, self.ema))
        else:  # don't poison the EMA with straggler steps
            self.ema = 0.9 * self.ema + 0.1 * dt
        return is_straggler


def _wait(loss: torch.Tensor) -> None:
    if loss.is_cuda:
        torch.cuda.synchronize(loss.device)
    else:
        loss.item()


class Trainer:
    def __init__(self, loss_fn, optimizer, params, data, cfg: TrainerConfig,
                 on_straggler: Optional[Callable] = None,
                 failure_at_step: Optional[int] = None):
        self.cfg = cfg
        self.data = data
        self.step_fn = make_train_step(
            loss_fn, optimizer, microbatch=cfg.microbatch,
            compression=cfg.compression)
        self.params = params
        self.opt_state = optimizer.init(named_params(params))
        self.residuals = init_residuals(params, cfg.compression)
        self.start_step = 0
        self.watchdog = StepWatchdog(cfg.straggler_factor,
                                     cfg.straggler_warmup)
        self.on_straggler = on_straggler
        self.failure_at_step = failure_at_step
        self.writer = (AsyncWriter(cfg.ckpt_dir, cfg.ckpt_keep)
                       if cfg.ckpt_dir and cfg.async_ckpt else None)
        self.history = []
        self._maybe_restore()

    # ------------------------------------------------------------- restore
    def _state(self):
        return {"params": named_params(self.params), "opt": self.opt_state,
                "residuals": self.residuals}

    def _maybe_restore(self):
        if not self.cfg.ckpt_dir:
            return
        state, step = restore(self.cfg.ckpt_dir, self._state())
        if state is not None:
            with torch.no_grad():
                for k, p in named_params(self.params).items():
                    p.copy_(state["params"][k])
            self.opt_state = state["opt"]
            self.residuals = state["residuals"]
            self.start_step = step
            print(f"[trainer] restored checkpoint at step {step}")

    def _checkpoint(self, step: int):
        if not self.cfg.ckpt_dir:
            return
        if self.writer is not None:
            self.writer.submit(step, self._state())
        else:
            save(self.cfg.ckpt_dir, step, self._state(), self.cfg.ckpt_keep)

    # ----------------------------------------------------------------- run
    def run(self):
        step = self.start_step
        while step < self.cfg.total_steps:
            batch = self.data.batch_at(step)
            if self.failure_at_step is not None \
                    and step == self.failure_at_step:
                self.failure_at_step = None    # fail exactly once
                raise SimulatedFailure(f"injected failure at step {step}")
            t0 = time.perf_counter()
            self.params, self.opt_state, self.residuals, metrics = \
                self.step_fn(self.params, self.opt_state, self.residuals,
                             batch)
            _wait(metrics["loss"])
            dt = time.perf_counter() - t0
            step += 1
            if self.watchdog.observe(step, dt) and self.on_straggler:
                self.on_straggler(self, step, dt)
            if step % self.cfg.log_interval == 0 or step == 1:
                loss = float(metrics["loss"])
                self.history.append((step, loss))
                print(f"[trainer] step {step} loss {loss:.4f} "
                      f"({dt * 1e3:.1f} ms)")
            if step % self.cfg.ckpt_interval == 0:
                self._checkpoint(step)
        self._checkpoint(self.cfg.total_steps)
        if self.writer:
            self.writer.wait()
        return self.params


def run_with_restarts(make_trainer: Callable[[], Trainer],
                      max_restarts: int = 3):
    """Production driver: (re)build the trainer, which restores the
    latest checkpoint, after every failure, up to ``max_restarts``."""
    for attempt in range(max_restarts + 1):
        trainer = make_trainer()
        try:
            return trainer.run(), trainer
        except SimulatedFailure as e:
            # drain the failed incarnation's in-flight async checkpoint
            # before rebuilding: a submit() the trainer already accepted
            # must be durable by the time the restart restores
            if trainer.writer is not None:
                trainer.writer.wait()
            print(f"[trainer] {e}; restarting ({attempt + 1})")
    raise RuntimeError("exceeded max restarts")
