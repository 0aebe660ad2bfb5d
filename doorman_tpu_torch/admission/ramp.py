"""Establishment ramp: grid-aligned micro-batching for WatchCapacity
establishment, the streaming twin of the GetCapacity coalescer.

A storm of stream establishments is the front-end's worst arrival
shape: each one is a gate check plus a full-snapshot decide pass, and
under the single-loop server every arrival was its own loop wakeup.
The ramp parks concurrent establishment thunks into the same
grid-aligned window discipline as admission/coalesce.py — every window
is anchored to the ramp's start, so a burst arriving together resolves
together in ONE loop callback, in arrival order (the registry's
establishment-order contract is preserved: `order` is assigned inside
the thunk, at resolution, and resolution replays arrival order).

The frontend listener workers forward establishments to the tick
process; the ramp is where those forwarded arrivals amortize — N
workers' storms become O(windows) loop wakeups on the device-owning
process instead of O(establishments).

``window <= 0`` disables parking: submit() runs the thunk inline —
the chaos runner and the stepped workload harness stay synchronous
and deterministic.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["EstablishmentRamp"]


class EstablishmentRamp:
    def __init__(
        self,
        *,
        window: float,
        on_window: Optional[Callable[[int, float], None]] = None,
    ):
        self.window = float(window)
        self._on_window = on_window
        self._pending: List[Tuple[Callable[[], Any], asyncio.Future]] = []
        self._flush_handle = None
        # Wall clock by design: the window grid paces a real event
        # loop. Chaos/workload keep determinism by running window <= 0
        # (inline submit), so this timing never fires there.
        self._anchor = time.monotonic()  # doorman: allow[seeded-determinism]
        self.flushes = 0
        self.batched = 0  # establishments that shared a window
        self.total = 0
        self.max_occupancy = 0

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    async def submit(self, establish: Callable[[], Any]) -> Any:
        """Run one establishment thunk at the next window boundary.
        The thunk is synchronous (gate check + registry subscribe — no
        awaits); its result or exception propagates to the caller."""
        self.total += 1
        if self.window <= 0:
            return establish()
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((establish, fut))
        if self._flush_handle is None:
            # Grid alignment: fire at the next boundary since the
            # anchor, not `window` after THIS arrival — late arrivals
            # in a window ride the same flush.
            elapsed = time.monotonic() - self._anchor  # doorman: allow[seeded-determinism]
            delay = self.window - (elapsed % self.window)
            self._flush_handle = loop.call_later(delay, self._flush)
        return await fut

    def _flush(self) -> None:
        self._flush_handle = None
        batch, self._pending = self._pending, []
        if not batch:
            return
        t0 = time.perf_counter()
        self.flushes += 1
        self.max_occupancy = max(self.max_occupancy, len(batch))
        if len(batch) > 1:
            self.batched += len(batch)
        for establish, fut in batch:
            if fut.cancelled():
                continue
            try:
                fut.set_result(establish())
            except Exception as exc:  # propagate to the awaiting handler
                fut.set_exception(exc)
        if self._on_window is not None:
            self._on_window(len(batch), time.perf_counter() - t0)

    def close(self) -> None:
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        # Resolve stragglers inline rather than leaving them parked
        # forever on a closing server.
        self._flush()

    def status(self) -> dict:
        return {
            "window": self.window,
            "total": self.total,
            "flushes": self.flushes,
            "batched": self.batched,
            "max_occupancy": self.max_occupancy,
            "queue_depth": self.queue_depth,
        }
