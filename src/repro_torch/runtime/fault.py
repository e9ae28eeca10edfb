"""Step-level fault tolerance, checkpoint/restart and straggler
detection: the port of ``repro/runtime/fault.py``.

* ``StragglerWatchdog`` — wall-clock budget per step, derived from a
  running P50; a step exceeding ``factor × P50`` fires the straggler
  callback (on a cluster: re-dispatch the step or evict the slow host —
  here: recorded and surfaced).
* ``FaultTolerantLoop`` — runs steps; on an exception it restores the last
  checkpoint and replays from there (the data pipeline is step-indexed, so
  the replayed batches are the same); after ``max_retries`` consecutive
  failures it re-raises.  Unlike the reference it first waits for a save
  still in flight, so the step it restores is the last one saved.  The
  replayed steps are the same arithmetic on the same data; on the card
  PyTorch does not promise a deterministic backward, so their results may
  differ in the last bits (ROADMAP C25).
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional

from ..checkpoint.manager import CheckpointManager


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0, warmup_steps: int = 3,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.factor = factor
        self.warmup = warmup_steps
        self.on_straggler = on_straggler
        self.durations: List[float] = []
        self.straggler_steps: List[int] = []

    def observe(self, step: int, duration: float) -> bool:
        """Returns True if this step was a straggler."""
        is_straggler = False
        if len(self.durations) >= self.warmup:
            med = sorted(self.durations)[len(self.durations) // 2]
            if duration > self.factor * med:
                is_straggler = True
                self.straggler_steps.append(step)
                if self.on_straggler:
                    self.on_straggler(step, duration)
        self.durations.append(duration)
        if len(self.durations) > 64:
            self.durations.pop(0)
        return is_straggler


class FaultTolerantLoop:
    """Drives ``step_fn(state, batch) -> state`` with checkpoint/restart."""

    def __init__(self, ckpt: CheckpointManager, *, save_every: int = 50,
                 max_retries: int = 3,
                 watchdog: Optional[StragglerWatchdog] = None):
        self.ckpt = ckpt
        self.save_every = save_every
        self.max_retries = max_retries
        self.watchdog = watchdog or StragglerWatchdog()
        self.restarts = 0

    def run(self, state: Any, step_fn, batch_at, n_steps: int,
            start_step: int = 0, on_step=None) -> Any:
        step = start_step
        retries = 0
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                state = step_fn(state, batch_at(step))
                dt = time.perf_counter() - t0
                self.watchdog.observe(step, dt)
                if on_step:
                    on_step(step, state, dt)
                step += 1
                retries = 0
                if step % self.save_every == 0:
                    self.ckpt.save(step, state)
            except Exception:
                retries += 1
                self.restarts += 1
                if retries > self.max_retries:
                    raise
                # a save still in flight is the latest checkpoint
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is not None:
                    step, state = self.ckpt.restore(latest, state)
                else:
                    step = start_step   # no checkpoint yet: replay from 0
        self.ckpt.save(step, state, blocking=True)
        self.ckpt.wait()
        return state
