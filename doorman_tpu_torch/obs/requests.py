"""In-memory request sampling: the /debug/requests page.

The reference gets request sampling for free from gRPC's /debug/requests
on the debug port (reference doc/loadtest/README.md:322-324); here a
small ring buffer per server records the most recent RPCs — method,
caller, resources touched, total wants, duration, outcome — and the
debug server renders them. Cheap enough to be always on (a deque append
per RPC), like the reference's sampling."""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Sequence


@dataclass(frozen=True)
class RequestSample:
    when: float  # wall-clock seconds
    method: str
    caller: str
    resources: Sequence[str]
    wants: float
    duration: float  # seconds
    error: bool


@dataclass
class RequestLog:
    """Fixed-size ring of recent requests; thread-safe.

    `clock` is the injectable time seam (the server hands in its own,
    so chaos-driven servers stamp samples in virtual time)."""

    capacity: int = 256
    clock: Callable[[], float] = time.time
    _entries: Deque[RequestSample] = field(init=False)
    _lock: threading.Lock = field(init=False)

    def __post_init__(self) -> None:
        self._entries = deque(maxlen=self.capacity)  # guarded-by: self._lock
        self._lock = threading.Lock()

    def record(
        self,
        method: str,
        caller: str,
        resources: Sequence[str],
        wants: float,
        duration: float,
        error: bool,
        when: float | None = None,
    ) -> None:
        sample = RequestSample(
            when=self.clock() if when is None else when,
            method=method,
            caller=caller,
            resources=tuple(resources),
            wants=wants,
            duration=duration,
            error=error,
        )
        with self._lock:
            self._entries.append(sample)

    def snapshot(self, limit: int = 0) -> List[RequestSample]:
        """Most recent first."""
        with self._lock:
            entries = list(self._entries)
        entries.reverse()
        return entries[:limit] if limit else entries
