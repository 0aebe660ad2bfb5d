"""Deadline-aware admission: fast-fail requests that cannot make it.

A request whose gRPC deadline is shorter than the latency the admission
path is currently delivering would park in a coalescing window, consume
a decision slot, and then miss its deadline anyway — the worst of both
worlds (work done, goodput zero). The tracker below keeps an EWMA of
observed decision latency (park -> resolved); the expected latency for
a NEW arrival is one full coalescing window (the worst-case park) plus
that EWMA. A request with less remaining deadline than that fast-fails
with the same RESOURCE_EXHAUSTED + retry-after contract as an overload
shed (one client-side handling path), before it costs anything.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["DecisionLatency", "fast_fail_reason"]


class DecisionLatency:
    """EWMA of admission decision latency in seconds (submit to
    response, coalescing park included)."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.value = 0.0
        self.samples = 0

    def observe(self, seconds: float) -> None:
        self.samples += 1
        if self.samples == 1:
            self.value = seconds
        else:
            self.value += self.alpha * (seconds - self.value)


def expected_latency(window: float, latency: DecisionLatency) -> float:
    """Worst-case expected admission latency for a new arrival."""
    return max(window, 0.0) + latency.value


def fast_fail_reason(
    context, window: float, latency: DecisionLatency
) -> Optional[str]:
    """A human-readable fast-fail reason when the RPC's remaining
    deadline cannot cover the expected admission latency; None when the
    request should proceed (no deadline, or enough headroom)."""
    if context is None:
        return None
    try:
        remaining = context.time_remaining()
    except Exception:
        return None
    if remaining is None:
        return None
    expected = expected_latency(window, latency)
    if remaining < expected:
        return (
            f"deadline {remaining:.3f}s shorter than expected admission "
            f"latency {expected:.3f}s; fast-failing instead of queueing"
        )
    return None
