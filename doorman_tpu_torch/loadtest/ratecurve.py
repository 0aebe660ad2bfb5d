"""Piecewise-linear offered-rate schedules, shared by the storm driver
(`--rate-curve`) and the workload generators (diurnal arrival curves).

A curve is a list of ``(t, rate)`` knots; the rate at any time is the
linear interpolation between the surrounding knots (clamped to the end
values outside the knot span). The text form accepted on the command
line and in workload specs is ``"t:rate,t:rate,..."`` — e.g.
``"0:5,30:50,60:5"`` ramps 5 -> 50 rps over the first 30 seconds and
back down over the next 30.

`ArrivalSampler` turns a curve into per-step integer arrival counts:
the expected count over a step is the trapezoid integral of the curve,
an optional seeded jitter perturbs it multiplicatively, and the
fractional remainder carries into the next step so long-run arrivals
track the curve's integral exactly. With the same seed the sampled
sequence replays identically — the property every workload scenario's
byte-stable event log rests on.

Port of doorman_tpu/loadtest/ratecurve.py: a copy apart from import paths.
"""

from __future__ import annotations

import random
from typing import Iterable, List, Optional, Sequence, Tuple

__all__ = ["RateCurve", "ArrivalSampler", "parse_rate_curve"]


class RateCurve:
    """Piecewise-linear rate(t) over sorted ``(t, rate)`` knots."""

    def __init__(self, knots: Iterable[Tuple[float, float]]):
        pts = [(float(t), float(r)) for t, r in knots]
        if not pts:
            raise ValueError("a rate curve needs at least one knot")
        for _, r in pts:
            if r < 0:
                raise ValueError(f"negative rate in curve: {r}")
        if sorted(t for t, _ in pts) != [t for t, _ in pts]:
            raise ValueError("curve knots must be sorted by time")
        for (t0, _), (t1, _) in zip(pts, pts[1:]):
            if t0 == t1:
                raise ValueError(f"duplicate knot time {t0}")
        self.knots: List[Tuple[float, float]] = pts

    @classmethod
    def parse(cls, text: str) -> "RateCurve":
        """Parse the ``"t:rate,t:rate"`` text form."""
        knots = []
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                t, r = part.split(":")
                knots.append((float(t), float(r)))
            except ValueError:
                raise ValueError(
                    f"malformed rate-curve knot {part!r} "
                    '(expected "t:rate")'
                ) from None
        return cls(knots)

    def rate_at(self, t: float) -> float:
        pts = self.knots
        if t <= pts[0][0]:
            return pts[0][1]
        if t >= pts[-1][0]:
            return pts[-1][1]
        for (t0, r0), (t1, r1) in zip(pts, pts[1:]):
            if t0 <= t <= t1:
                frac = (t - t0) / (t1 - t0)
                return r0 + (r1 - r0) * frac
        return pts[-1][1]  # unreachable: the scan covers [t0, t_last]

    def integral(self, t0: float, t1: float) -> float:
        """Expected arrivals over [t0, t1] (trapezoid over the clamped
        piecewise-linear curve; exact because the curve is linear
        between knots and every knot in the span is a sample point)."""
        if t1 <= t0:
            return 0.0
        times = [t0] + [
            t for t, _ in self.knots if t0 < t < t1
        ] + [t1]
        total = 0.0
        for a, b in zip(times, times[1:]):
            total += (self.rate_at(a) + self.rate_at(b)) / 2.0 * (b - a)
        return total

    @property
    def end_time(self) -> float:
        return self.knots[-1][0]

    def __repr__(self) -> str:
        knots = ",".join(f"{t:g}:{r:g}" for t, r in self.knots)
        return f"RateCurve({knots!r})"


def parse_rate_curve(text: str) -> RateCurve:
    return RateCurve.parse(text)


class ArrivalSampler:
    """Deterministic arrivals from a curve: trapezoid expectation per
    step, multiplicative seeded jitter, fractional carry."""

    def __init__(
        self,
        curve: RateCurve,
        *,
        jitter: float = 0.0,
        rng: Optional[random.Random] = None,
        period: Optional[float] = None,
    ):
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        if period is not None and period <= 0:
            raise ValueError(f"period must be > 0, got {period}")
        self.curve = curve
        self.jitter = float(jitter)
        self.rng = rng if rng is not None else random.Random(0)
        # A periodic curve repeats its knot span (diurnal days); an
        # aperiodic one clamps to its end rate.
        self.period = period
        self._carry = 0.0

    def _expected(self, t0: float, t1: float) -> float:
        if self.period is None:
            return self.curve.integral(t0, t1)
        total = 0.0
        t = t0
        while t < t1 - 1e-12:
            base = (t // self.period) * self.period
            seg_end = min(t1, base + self.period)
            total += self.curve.integral(t - base, seg_end - base)
            t = seg_end
        return total

    def take(self, t0: float, t1: float) -> int:
        """Integer arrivals for the step [t0, t1)."""
        expected = self._expected(t0, t1)
        if self.jitter:
            expected *= 1.0 + self.jitter * (2.0 * self.rng.random() - 1.0)
        total = expected + self._carry
        n = int(total)
        self._carry = total - n
        return max(n, 0)
