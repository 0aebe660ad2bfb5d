"""Statistics over all samples of a window (no chunk medians)."""

from __future__ import annotations

from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of all samples (loadtest/storm.py's
    `percentile`, on unsorted input); None without samples."""
    if not len(values):
        return None
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return float(s[idx])


def rate(work: float, seconds: float) -> float:
    """All of a window's work over all of its time."""
    if seconds <= 0:
        raise ValueError("a window of no time has no rate")
    return float(work) / float(seconds)
