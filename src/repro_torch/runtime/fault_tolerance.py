"""Fault tolerance: checkpoint/restart orchestration — counterpart of
:mod:`repro.runtime.fault_tolerance`.

* :class:`FaultTolerantLoop` wraps the train step: periodic async
  checkpoints, exception-driven restore (a retry budget per incident,
  exponential backoff), deterministic data replay (the data pipeline is
  keyed by (seed, step, shard), so resuming at step N regenerates the
  batches the lost run would have seen);
* an injectable ``failure_hook`` simulates device loss at a chosen step;
  ``on_restore`` maps a restored state (e.g. onto the device).
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable

from repro_torch.checkpoint import Checkpointer

log = logging.getLogger(__name__)


class StepFailure(RuntimeError):
    """Raised by the failure hook / caught from the backend."""


class FaultTolerantLoop:
    def __init__(
        self,
        *,
        step_fn: Callable[[Any, int], Any],       # state, step -> state
        checkpointer: Checkpointer,
        checkpoint_every: int = 50,
        max_retries: int = 3,
        backoff_s: float = 0.1,
        failure_hook: Callable[[int], None] | None = None,
        on_restore: Callable[[Any], Any] | None = None,
    ) -> None:
        self.step_fn = step_fn
        self.ckpt = checkpointer
        self.checkpoint_every = checkpoint_every
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.failure_hook = failure_hook
        self.on_restore = on_restore
        self.retries_used = 0
        self.restores = 0
        # The retry budget is *per incident*: once the loop makes real
        # progress past the failing step after a restore, the counter
        # rearms; replayed steps before the failure point do not, so a
        # step that fails deterministically still exhausts it.
        self._reset_pending = False
        self._failed_step: int | None = None

    def run(self, state: Any, *, start_step: int, num_steps: int) -> Any:
        step = start_step
        end = start_step + num_steps
        initial = state
        while step < end:
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)
                state = self.step_fn(state, step)
                if self._reset_pending and step >= self._failed_step:
                    self.retries_used = 0
                    self._reset_pending = False
                step += 1
                if step % self.checkpoint_every == 0:
                    self.ckpt.save_async(step, state)
            except Exception as e:  # noqa: BLE001 - the restart boundary
                self.retries_used += 1
                self._failed_step = step
                if self.retries_used > self.max_retries:
                    raise RuntimeError(
                        f"retry budget exhausted at step {step}") from e
                log.warning("step %d failed (%s); restoring", step, e)
                time.sleep(self.backoff_s * (2 ** (self.retries_used - 1)))
                # drain an in-flight async save first, so the restore
                # cannot miss the newest checkpoint
                self.ckpt.wait()
                restored = self.ckpt.restore_latest(state)
                if restored is None:
                    # no checkpoint yet: restart from the initial state
                    step = start_step
                    state = initial
                else:
                    step, state = restored
                if self.on_restore is not None:
                    state = self.on_restore(state)
                self.restores += 1
                self._reset_pending = True
        self.ckpt.wait()
        return state
