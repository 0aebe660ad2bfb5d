"""Exponential backoff (capability parity with reference
go/timeutil/timeutil.go:26-37: factor 1.3, clamped to [base, max]) with
opt-in FULL jitter.

The deterministic 1.3^n ladder has a fleet-scale failure mode: every
client that failed together retries together, forever — an outage ends
and the whole population storms the recovering master in lockstep. Full
jitter (AWS style: the delay is drawn uniformly from [0, ladder value])
decorrelates the wave; the client refresh retry path and the storm
drivers opt in via ``jitter=``.
"""

from __future__ import annotations

import random

_FACTOR = 1.3

# Shared retry/refresh timing defaults (reference server.go:82-90 and
# connection.go:30-38 use the same values).
MIN_BACKOFF = 1.0
MAX_BACKOFF = 60.0
VERY_LONG_TIME = 60.0 * 60

_JITTER_RNG = random.Random()  # doorman: allow[seeded-determinism]


def backoff(base: float, maximum: float, retries: int, *,
            jitter=None) -> float:
    """Delay in seconds growing exponentially with `retries` from `base`,
    clamped to `maximum`.

    ``jitter`` opts into full jitter: pass a ``random.Random`` for a
    seeded stream (tests, storm drivers), or ``True`` for the module
    RNG; the returned delay is then uniform in [0, ladder value]. The
    default (None) keeps the reference's deterministic ladder."""
    delay = float(base)
    while delay < maximum and retries > 0:
        delay *= _FACTOR
        retries -= 1
    delay = min(delay, maximum)
    if jitter:
        rng = jitter if isinstance(jitter, random.Random) else _JITTER_RNG
        return rng.uniform(0.0, delay)
    return delay
