"""Runtime fault tolerance: supervisor loop, heartbeats, straggler watchdog.

On a real cluster each of these hooks binds to the pod runtime (GKE/Borg
health checks, ICI link monitors).  Here they are implemented against the
local filesystem + wall clock so the mechanisms are fully exercised by the
test-suite:

* ``Supervisor.run`` — catches step failures (including injected ones),
  restores from the last complete checkpoint and replays the data pipeline
  to the restored step: crash-consistent training.
* ``Heartbeat`` — periodic liveness file with host/step metadata; a missing
  or stale heartbeat is how an external orchestrator decides to reschedule.
* ``StragglerDetector`` — per-step wall times in a ring buffer; a step
  slower than ``k x`` the running median marks the worker a straggler
  (at pod scale: triggers checkpoint-and-reassign instead of stalling the
  collective for everyone).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Callable


class Heartbeat:
    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval = interval_s
        self._last = 0.0

    def beat(self, step: int, **info) -> None:
        now = time.time()
        if now - self._last < self.interval:
            return
        self._last = now
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)  # may beat before the first save
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"time": now, "step": step, **info}, f)
        os.replace(tmp, self.path)

    @staticmethod
    def is_alive(path: str, timeout_s: float = 60.0) -> bool:
        try:
            with open(path) as f:
                hb = json.load(f)
            return time.time() - hb["time"] < timeout_s
        except (OSError, ValueError, KeyError):
            return False


class StragglerDetector:
    def __init__(self, window: int = 64, threshold: float = 3.0):
        self.times: deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.flagged = 0

    def record(self, step_time_s: float) -> bool:
        """Record a step time; True if this step was a straggler."""
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            slow = step_time_s > self.threshold * med
        else:
            slow = False
        self.times.append(step_time_s)
        if slow:
            self.flagged += 1
        return slow

    @property
    def median(self) -> float:
        if not self.times:
            return 0.0
        return sorted(self.times)[len(self.times) // 2]


@dataclasses.dataclass
class SupervisorReport:
    steps_done: int
    restarts: int
    straggler_steps: int


class Supervisor:
    """Restart-on-failure training driver.

    ``make_state()`` builds fresh state; ``save_state(step, state)`` /
    ``restore_state()`` -> (state, step) bind to the checkpointer;
    ``step_fn(state, step)`` -> state runs one step and may raise.
    """

    def __init__(self, *, make_state: Callable[[], object],
                 step_fn: Callable[[object, int], object],
                 save_state: Callable[[int, object], None],
                 restore_state: Callable[[], tuple[object, int] | None],
                 checkpoint_every: int = 50,
                 max_restarts: int = 10,
                 heartbeat: Heartbeat | None = None,
                 straggler: StragglerDetector | None = None):
        self.make_state = make_state
        self.step_fn = step_fn
        self.save_state = save_state
        self.restore_state = restore_state
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.heartbeat = heartbeat
        self.straggler = straggler or StragglerDetector()

    def run(self, total_steps: int, log=print) -> SupervisorReport:
        restarts = 0
        restored = self.restore_state()
        state, step = restored if restored else (self.make_state(), 0)
        while step < total_steps:
            try:
                t0 = time.time()
                state = self.step_fn(state, step)
                dt = time.time() - t0
                if self.straggler.record(dt):
                    log(f"[straggler] step {step} took {dt:.3f}s "
                        f"(median {self.straggler.median:.3f}s)")
                if self.heartbeat:
                    self.heartbeat.beat(step)
                step += 1
                if step % self.checkpoint_every == 0 or step == total_steps:
                    self.save_state(step, state)
            except Exception as e:  # noqa: BLE001 - any step failure
                restarts += 1
                log(f"[supervisor] step {step} failed ({type(e).__name__}: {e}); "
                    f"restart {restarts}/{self.max_restarts}")
                if restarts > self.max_restarts:
                    raise
                restored = self.restore_state()
                state, step = restored if restored else (self.make_state(), 0)
        return SupervisorReport(steps_done=step, restarts=restarts,
                                straggler_steps=self.straggler.flagged)
