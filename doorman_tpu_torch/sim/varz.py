"""Simulation metrics: counters and min/max/avg gauges with timers
(capability parity with reference simulation/varz.py, but registry-scoped
per Sim instead of process-global)."""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Iterator


class Counter:
    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    def __init__(self, name: str, clock: Callable[[], float] = time.monotonic):
        # The timer clock is injectable so a Sim's gauges measure on its
        # virtual axis (deterministic reports) while a standalone Gauge
        # keeps wall time.
        self.name = name
        self.value = 0.0
        self.n = 0
        self.min_value = math.inf
        self.max_value = -math.inf
        self.average = 0.0
        self._clock = clock
        self._timer_start = 0.0

    def set(self, value: float) -> None:
        self.value = value
        self.min_value = min(self.min_value, value)
        self.max_value = max(self.max_value, value)
        self.n += 1
        self.average += (value - self.average) / self.n

    def start_timer(self) -> None:
        self._timer_start = self._clock()

    def stop_timer(self) -> None:
        self.set(self._clock() - self._timer_start)
        self._timer_start = 0.0


class Varz:
    """Per-simulation metric registry."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._clock = clock

    def counter(self, name: str) -> Counter:
        if name not in self._counters:
            self._counters[name] = Counter(name)
        return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        if name not in self._gauges:
            self._gauges[name] = Gauge(name, clock=self._clock)
        return self._gauges[name]

    def counters(self) -> Iterator[Counter]:
        return iter(self._counters.values())

    def gauges(self) -> Iterator[Gauge]:
        return iter(self._gauges.values())
