"""The reference's rate limiter cases (tests/test_ratelimiter.py) on the
port's ratelimiters, with a hand-fed fake resource: blocked at capacity
0, ~100ms waits at capacity 10, unlimited at capacity -1, no stale
budget across updates, and the adaptive wants estimator, which must also
equal the JAX package's on seeded entry times."""

import asyncio
import time

import numpy as np
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu.ratelimiter.adaptive import wants_estimate as j_estimate
from doorman_tpu_torch.ratelimiter import new_qps
from doorman_tpu_torch.ratelimiter.adaptive import wants_estimate


class FakeResource:
    """Implements the ClientResource surface the limiter needs, with a
    hand-fed capacity queue (mirrors the reference's fakeResource)."""

    def __init__(self):
        self._capacity = asyncio.Queue(maxsize=32)
        self.asked = []

    def capacity(self):
        return self._capacity

    async def ask(self, wants):
        self.asked.append(wants)

    async def feed(self, value):
        await self._capacity.put(value)


def run(coro):
    return asyncio.run(coro)


def test_blocked_at_zero_capacity():
    async def body():
        res = FakeResource()
        rl = new_qps(res)
        await res.feed(0.0)
        await asyncio.sleep(0.05)
        with pytest.raises(asyncio.TimeoutError):
            await rl.wait(timeout=0.2)
        await rl.close()

    run(body())


def test_unlimited_never_blocks():
    async def body():
        res = FakeResource()
        rl = new_qps(res)
        await res.feed(-1.0)
        await asyncio.sleep(0.05)
        start = time.monotonic()
        for _ in range(100):
            await rl.wait(timeout=1)
        assert time.monotonic() - start < 0.5
        await rl.close()

    run(body())


def test_capacity_10_paces_to_100ms():
    async def body():
        res = FakeResource()
        rl = new_qps(res)
        await res.feed(10.0)
        await asyncio.sleep(0.05)
        start = time.monotonic()
        n = 4
        for _ in range(n):
            await rl.wait(timeout=5)
        elapsed = time.monotonic() - start
        # ~100ms per permit (first may come within the first subinterval).
        assert 0.15 <= elapsed <= 1.5
        await rl.close()

    run(body())


def test_capacity_update_unblocks_waiters():
    async def body():
        res = FakeResource()
        rl = new_qps(res)
        await res.feed(0.0)
        await asyncio.sleep(0.05)

        async def release_later():
            await asyncio.sleep(0.1)
            await res.feed(-1.0)

        task = asyncio.create_task(release_later())
        await rl.wait(timeout=2)
        await task
        await rl.close()

    run(body())


def test_budget_does_not_accumulate():
    async def body():
        res = FakeResource()
        rl = new_qps(res)
        await res.feed(5.0)  # one permit per 200ms
        # Sleep 1s without consuming: budget must not pile up.
        await asyncio.sleep(1.0)
        start = time.monotonic()
        # 5 waits need >= 4 timer ticks (>= 0.6s): an accumulated burst
        # would finish almost instantly.
        for _ in range(5):
            await rl.wait(timeout=5)
        elapsed = time.monotonic() - start
        assert elapsed >= 0.55
        await rl.close()

    run(body())


def test_capacity_drop_discards_stale_budget():
    async def body():
        res = FakeResource()
        rl = new_qps(res)
        await res.feed(1000.0)  # large per-subinterval budget
        await asyncio.sleep(0.15)  # budget accrues
        await res.feed(0.0)  # capacity revoked
        await asyncio.sleep(0.05)
        # No stale permits may leak through after the revocation.
        with pytest.raises(asyncio.TimeoutError):
            await rl.wait(timeout=0.2)
        await rl.close()

    run(body())


def test_wants_estimate_recency_weighting():
    now = 1000.0
    # 10 calls in the most recent second: weighted sum = 10*10=100,
    # normalizer k(k+1)/2 = 55.
    entries = [now - 0.5] * 10
    assert wants_estimate(entries, 10.0, now) == pytest.approx(100 / 55)
    # Old entries outside the window are ignored.
    entries = [now - 20.0] * 10
    assert wants_estimate(entries, 10.0, now) == 0.0


def test_wants_estimate_equals_the_reference_on_seeded_entries():
    rng = np.random.default_rng(5)
    now = 1000.0
    for window in (3.0, 10.0, 30.0):
        for n in (0, 1, 17, 400):
            entries = list(now - rng.uniform(0.0, 2 * window, size=n))
            assert wants_estimate(entries, window, now) == j_estimate(
                entries, window, now
            )
