"""Simulation kernel: virtual clock + discrete-event scheduler +
pseudo-threads (capability parity with reference simulation/scheduler.py
and utils.py, instance-scoped)."""

from __future__ import annotations

import heapq
import itertools
import logging
import random
from typing import Callable, Dict, List, Optional, Protocol

from doorman_tpu_torch.sim.varz import Varz

log = logging.getLogger("doorman_tpu_torch.sim")


class SimClock:
    """Monotonic virtual clock starting at 0."""

    def __init__(self):
        self.time = 0.0

    def __call__(self) -> float:
        return self.time

    def get_time(self) -> float:
        return self.time

    def set_time(self, t: float) -> None:
        assert t >= self.time, "the clock can only move forward"
        self.time = t


class Thread(Protocol):
    """A pseudo-thread: thread_continue() runs one step and returns the
    interval until its next step."""

    def thread_continue(self) -> float: ...


class Scheduler:
    """Single-threaded discrete-event scheduler over a SimClock: absolute/
    relative one-shot actions, pseudo-threads, and exit finalizers."""

    def __init__(self, clock: SimClock):
        self.clock = clock
        self._heap: List = []  # (time, seq, callable)
        self._seq = itertools.count()
        self._threads: Dict[object, float] = {}  # thread -> next run time
        self._finalizers: List[Callable[[], None]] = []

    def add_absolute(self, when: float, action: Callable[[], None]) -> None:
        if when < self.clock.get_time():
            # Run late instead of trying to move the clock backwards.
            log.warning("scheduling action in the past (t=%s)", when)
            when = self.clock.get_time()
        heapq.heappush(self._heap, (when, next(self._seq), action))

    def add_relative(self, delay: float, action: Callable[[], None]) -> None:
        self.add_absolute(self.clock.get_time() + delay, action)

    def add_thread(self, thread: Thread, delay: float = 0.0) -> None:
        self.update_thread(thread, delay)

    def update_thread(self, thread: Thread, delay: float) -> None:
        self._threads[thread] = self.clock.get_time() + delay

    def add_finalizer(self, fn: Callable[[], None]) -> None:
        self._finalizers.append(fn)

    def _next_time(self) -> Optional[float]:
        times = []
        if self._heap:
            times.append(self._heap[0][0])
        if self._threads:
            times.append(min(self._threads.values()))
        return min(times) if times else None

    def loop(self, duration: float) -> None:
        """Run until the virtual clock advances by `duration`, then run the
        finalizers."""
        until = self.clock.get_time() + duration
        while self.clock.get_time() < until:
            t = self._next_time()
            if t is None:
                break
            t = min(t, until)
            self.clock.set_time(t)
            while self._heap and self._heap[0][0] <= t:
                _, _, action = heapq.heappop(self._heap)
                action()
            for thread, when in list(self._threads.items()):
                if when <= t and thread in self._threads:
                    self.update_thread(thread, thread.thread_continue())
        self.clock.set_time(until)
        for fn in self._finalizers:
            fn()


class Sim:
    """One simulation world: clock, scheduler, metrics, RNG, registries."""

    def __init__(self, seed: int = 0):
        self.clock = SimClock()
        self.scheduler = Scheduler(self.clock)
        # Gauge timers measure on the virtual axis: a sim report is a
        # pure function of (seed, scenario), never of host speed.
        self.varz = Varz(clock=self.clock)
        self.random = random.Random(seed)
        # Populated by the model layer.
        self.server_jobs: List = []
        self.clients: List = []
        # Name sequence numbers for servers/clients, scoped to this Sim so
        # repeated runs in one process stay deterministic.
        self.name_counters: Dict[str, int] = {}

    def next_name(self, kind: str, base: str) -> str:
        key = f"{kind}:{base}"
        self.name_counters[key] = self.name_counters.get(key, 0) + 1
        return f"{base}:{self.name_counters[key]}"

    def random_client(self):
        return self.random.choice(self.clients)

    def random_server_job(self):
        return self.random.choice(self.server_jobs)
