"""Controllable virtual clock.

Every lease expiry, learning-mode window, election TTL and parent-lease
deadline in the stack is computed against an injectable `clock`
callable; a chaos run hands all of them THIS clock and advances it one
tick_interval per runner tick, so time-driven behavior (lease lapse,
lock expiry, learning-mode exit) is deterministic and runs at whatever
speed the host can tick — a 60-virtual-second outage costs milliseconds
of wall clock.

Port of doorman_tpu/chaos/clock.py: a copy apart from import paths.
"""

from __future__ import annotations


class ChaosClock:
    """Callable like time.time, advanced explicitly by the runner."""

    def __init__(self, start: float = 1_000_000.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("time only moves forward")
        self._now += dt
