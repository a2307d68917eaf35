"""Fault-tolerant training loop.

* checkpoint/restart: periodic async checkpoints; on a (simulated or real)
  worker failure the loop restores the latest checkpoint and replays: the
  data pipeline is keyed by step, so replay is bit-exact (tested, on the
  CPU and on the card).
* straggler watchdog: EWMA of step times; a step slower than
  ``threshold x ewma`` is flagged (surfaced in metrics and logs).
* restore onto any device or mesh: without a ``restore_fn`` each restored
  leaf is placed as the live leaf it replaces was (its device, or its
  mesh and placements: ``ckpt.load_pytree(shardings=...)``), so a crash on
  a mesh replays bit-exactly too.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..ckpt import CheckpointManager

log = logging.getLogger("repro_torch.runtime")


class StragglerWatchdog:
    """EWMA step-time monitor; flags outliers."""

    def __init__(self, alpha: float = 0.1, threshold: float = 3.0,
                 warmup: int = 5, clock: Callable[[], float] = time.monotonic):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.clock = clock
        self.ewma: Optional[float] = None
        self.count = 0
        self.flagged_steps: List[int] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = self.clock()

    def stop(self, step: int) -> bool:
        dt = self.clock() - self._t0
        self.count += 1
        flagged = False
        if self.ewma is None:
            self.ewma = dt
        else:
            if self.count > self.warmup and dt > self.threshold * self.ewma:
                flagged = True
                self.flagged_steps.append(step)
                log.warning("straggler: step %d took %.3fs (ewma %.3fs)",
                            step, dt, self.ewma)
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return flagged


class FailureInjector:
    """Deterministic crash injection for restart tests."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected worker failure at step {step}")


@dataclass
class TrainLoop:
    """Drives (step_fn, data_fn) with checkpointing + fault tolerance.

    step_fn(params, opt_state, batch) -> (params, opt_state, metrics)
    data_fn(step) -> batch                      (step-keyed => replayable)

    Each step's metrics are read on the host (``float``), one sync per
    metric and step, as in the reference.
    """

    step_fn: Callable
    data_fn: Callable[[int], Any]
    ckpt: CheckpointManager
    ckpt_every: int = 50
    watchdog: StragglerWatchdog = field(default_factory=StragglerWatchdog)
    injector: Optional[FailureInjector] = None
    max_restarts: int = 3

    def run(self, params, opt_state, n_steps: int, start_step: int = 0,
            restore_fn: Optional[Callable] = None):
        """Returns (params, opt_state, history).  On failure, restores the
        latest checkpoint (via restore_fn(tree) -> (params, opt_state), or
        placed as the live tree is) and continues; gives up after
        max_restarts."""
        history: List[Dict] = []
        step = start_step
        restarts = 0
        while step < n_steps:
            try:
                while step < n_steps:
                    batch = self.data_fn(step)
                    self.watchdog.start()
                    if self.injector:
                        self.injector.maybe_fail(step)
                    params, opt_state, metrics = self.step_fn(
                        params, opt_state, batch)
                    rec = {k: float(v) for k, v in metrics.items()}
                    flagged = self.watchdog.stop(step)
                    rec.update(step=step, straggler=flagged)
                    history.append(rec)
                    step += 1
                    if step % self.ckpt_every == 0:
                        self.ckpt.save({"params": params, "opt": opt_state},
                                       step, extra={"step": step})
            except RuntimeError as e:
                restarts += 1
                log.warning("worker failure (%s); restart %d/%d",
                            e, restarts, self.max_restarts)
                if restarts > self.max_restarts:
                    raise
                if restore_fn is not None:
                    tree, manifest = self.ckpt.restore()
                    params, opt_state = restore_fn(tree)
                else:
                    tree, manifest = self.ckpt.restore(shardings={
                        "params": params, "opt": opt_state})
                    params, opt_state = tree["params"], tree["opt"]
                step = manifest["extra"]["step"]
        self.ckpt.wait()
        return params, opt_state, history
