"""Straggler / hang detection for the training loop.

At 1000+ nodes, slow hosts dominate tail latency. The watchdog keeps an EWMA
of step times; a step exceeding ``threshold x EWMA`` is flagged (logged and
counted). ``HangWatchdog`` arms a timer around blocking sections (collective
hangs, data stalls) and invokes a callback — in production that callback
triggers the preemption/restart path; tests inject a fake clock.

A copy of the JAX package's ``distributed/watchdog.py`` (pure Python and
threads; nothing here touches the device).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

__all__ = ["StragglerMonitor", "HangWatchdog"]


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, ewma: float = 0.9,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.ewma_decay = ewma
        self.clock = clock
        self.ewma: Optional[float] = None
        self.slow_steps: List[int] = []
        self.step_idx = 0
        self._t0: Optional[float] = None

    def start_step(self):
        self._t0 = self.clock()

    def end_step(self) -> bool:
        """Returns True if this step was a straggler."""
        assert self._t0 is not None, "start_step not called"
        dt = self.clock() - self._t0
        self._t0 = None
        slow = False
        if self.ewma is not None and dt > self.threshold * self.ewma:
            self.slow_steps.append(self.step_idx)
            slow = True
            # do not fold outliers into the EWMA — keeps the baseline honest
        else:
            self.ewma = dt if self.ewma is None else (
                self.ewma_decay * self.ewma + (1 - self.ewma_decay) * dt
            )
        self.step_idx += 1
        return slow

    @property
    def straggler_fraction(self) -> float:
        return len(self.slow_steps) / max(self.step_idx, 1)


class HangWatchdog:
    """Fires ``on_hang`` if ``pet()`` is not called within ``timeout`` s."""

    def __init__(self, timeout: float, on_hang: Callable[[], None]):
        self.timeout = timeout
        self.on_hang = on_hang
        self._timer: Optional[threading.Timer] = None
        self.fired = False

    def _fire(self):
        self.fired = True
        self.on_hang()

    def arm(self):
        self.disarm()
        self._timer = threading.Timer(self.timeout, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def pet(self):
        self.arm()

    @property
    def armed(self) -> bool:
        return self._timer is not None

    def disarm(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def __enter__(self):
        self.arm()
        return self

    def __exit__(self, *exc):
        self.disarm()
        return False
