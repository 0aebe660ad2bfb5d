"""Adaptive QPS rate limiter: derives `wants` from the observed rate of
wait() calls (port of doorman_tpu/ratelimiter/adaptive.py).

Capability parity with reference go/ratelimiter/adaptive_ratelimiter.go:
every `window` seconds (default 10) the recorded wait() entry times are
aggregated per second and recency-weighted (most recent second has weight
N, the oldest weight 1; the weighted sum is normalized by N(N+1)/2 scaled
by the entry count) and the result is sent to resource.ask().
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, List, Optional

from doorman_tpu_torch.client.client import ClientResource
from doorman_tpu_torch.ratelimiter.qps import QPSRateLimiter

log = logging.getLogger(__name__)

DEFAULT_WINDOW = 10.0


def wants_estimate(entries: List[float], window: float, now: float) -> float:
    """Recency-weighted wants estimate over entry timestamps
    (adaptive_ratelimiter.go:131-156). Mutates nothing; expired entries
    should already be cleared by the caller."""
    live = [t for t in entries if now - t < window]
    if not live:
        return 0.0
    n = int(window)
    frequency = {}
    for t in live:
        age = int(now - t)
        frequency[age] = frequency.get(age, 0) + 1
    weighted = sum(
        frequency.get(age, 0) * (n - age) for age in range(n)
    )
    k = len(live)
    return weighted / (k * (k + 1) / 2)


class AdaptiveQPSRateLimiter:
    def __init__(
        self,
        resource: ClientResource,
        window: float = DEFAULT_WINDOW,
        clock: Callable[[], float] = time.time,
    ):
        # `clock` is the injectable time seam (chaos hands every
        # component its virtual ChaosClock); entry timestamps and window
        # expiry both read it so a replayed run ages entries identically.
        self._resource = resource
        self._limiter = QPSRateLimiter(resource)
        self._window = window
        self._clock = clock
        self._entries: List[float] = []
        self._task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self._window)
            now = self._clock()
            self._entries = [t for t in self._entries if now - t < self._window]
            wants = wants_estimate(self._entries, self._window, now)
            if wants > 0:
                try:
                    await self._resource.ask(wants)
                except Exception:
                    log.exception("resource.ask failed")

    async def wait(self, timeout: Optional[float] = None) -> None:
        self._entries.append(self._clock())
        await self._limiter.wait(timeout)

    async def close(self) -> None:
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
        await self._limiter.close()


def new_adaptive_qps(
    resource: ClientResource,
    window: float = DEFAULT_WINDOW,
    clock: Callable[[], float] = time.time,
) -> AdaptiveQPSRateLimiter:
    return AdaptiveQPSRateLimiter(resource, window, clock=clock)
