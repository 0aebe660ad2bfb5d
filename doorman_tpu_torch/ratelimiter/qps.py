"""QPS rate limiter: converts a resource's capacity (queries per second)
into a blocking `wait()` (port of doorman_tpu/ratelimiter/qps.py).

Capability parity with reference go/ratelimiter/ratelimiter.go:65-231:
  * capacity < 0 -> unlimited (wait returns immediately)
  * capacity == 0 -> blocked (wait blocks until capacity changes)
  * capacity <= 10 -> one release per 1000/capacity ms
  * capacity > 10 -> the 1-second interval is divided into subintervals of
    at least 20 ms (at most `rate` of them) and the rate is spread across
    them, with the integer remainder distributed one-per-subinterval — this
    reproduces the reference's burstiness smoothing exactly.

Releases do not accumulate: a subinterval's unconsumed budget expires with
it (the reference's unbuffered unfreeze channel has the same property).
"""

from __future__ import annotations

import asyncio
from typing import Optional

from doorman_tpu_torch.client.client import ClientResource


class RateLimiterClosed(Exception):
    pass


class QPSRateLimiter:
    def __init__(self, resource: ClientResource):
        self._resource = resource
        self._rate = 0  # releases per subinterval; -1 unlimited, 0 blocked
        self._interval = 1.0  # subinterval length, seconds
        self._subintervals = 1
        self._leftover = 0
        self._budget = 0
        self._released_subintervals = 0
        self._leftover_remaining = 0
        self._cond = asyncio.Condition()
        self._closed = False
        self._task = asyncio.create_task(self._run())

    # -- configuration ---------------------------------------------------

    def _recalculate(self, rate: int, interval_ms: int) -> None:
        self._subintervals = 1
        self._leftover = 0
        new_rate, new_interval_ms = rate, interval_ms
        if rate > 1 and interval_ms >= 20:
            self._subintervals = min(rate, interval_ms // 20)
            new_rate = rate // self._subintervals
            self._leftover = rate % self._subintervals
            new_interval_ms = int(new_rate * interval_ms / rate)
        self._rate = new_rate
        self._interval = new_interval_ms / 1000.0

    def _update(self, capacity: float) -> None:
        if capacity < 0:
            self._rate = -1
        elif capacity == 0:
            self._rate = 0
        elif capacity <= 10:
            self._recalculate(1, int(1000.0 / capacity))
        else:
            self._recalculate(int(capacity), 1000)
        self._released_subintervals = 0
        self._leftover_remaining = self._leftover
        # Permits computed under the old capacity must not survive the
        # change (the reference's unbuffered unfreeze channel cannot carry
        # permits across an update either).
        self._budget = 0

    @property
    def unlimited(self) -> bool:
        return self._rate < 0

    @property
    def blocked(self) -> bool:
        return self._rate == 0

    # -- main loop -------------------------------------------------------

    async def _run(self) -> None:
        capacity_q = self._resource.capacity()
        while True:
            if self.blocked or self.unlimited:
                # Nothing to time; wait for a capacity change.
                capacity = await capacity_q.get()
                async with self._cond:
                    self._update(capacity)
                    self._cond.notify_all()
                continue
            # Timed subinterval; a capacity update interrupts it.
            try:
                capacity = await asyncio.wait_for(
                    capacity_q.get(), timeout=self._interval
                )
                async with self._cond:
                    self._update(capacity)
                    self._cond.notify_all()
                continue
            except asyncio.TimeoutError:
                pass
            async with self._cond:
                budget = self._rate
                if self._released_subintervals < self._subintervals:
                    if self._leftover_remaining > 0:
                        step = self._leftover_remaining // self._rate + 1
                        budget += step
                        self._leftover_remaining -= step
                    self._released_subintervals += 1
                else:
                    self._released_subintervals = 0
                    self._leftover_remaining = self._leftover
                # Budget does not accumulate across subintervals.
                self._budget = budget
                self._cond.notify_all()

    async def wait(self, timeout: Optional[float] = None) -> None:
        """Block until this operation may run. Raises RateLimiterClosed
        after close(), asyncio.TimeoutError on timeout."""

        async def acquire() -> None:
            async with self._cond:
                while True:
                    if self._closed:
                        raise RateLimiterClosed()
                    if self.unlimited:
                        return
                    if not self.blocked and self._budget > 0:
                        self._budget -= 1
                        return
                    await self._cond.wait()

        if timeout is None:
            await acquire()
        else:
            await asyncio.wait_for(acquire(), timeout)

    async def close(self) -> None:
        self._closed = True
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
        async with self._cond:
            self._cond.notify_all()


def new_qps(resource: ClientResource) -> QPSRateLimiter:
    return QPSRateLimiter(resource)
