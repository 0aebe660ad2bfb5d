"""AIMD overload controller: per-priority-band admit probabilities.

The front door's counterpart of the tick's "solve in aggregate" lesson:
instead of letting a client storm grind the event loop, the controller
watches cheap aggregate signals and sheds whole bands of traffic before
the queues melt. Signals (each scaled by its configured target, the max
of the ratios is the *pressure*):

  * offered arrival rate vs ``max_rps`` (when configured) — the only
    signal that reacts *within* the window it spikes in: arrivals past
    the window's budget are shed on the spot (the hard cap), so a storm
    cannot land a full window of damage before the EWMAs notice;
  * admission decision latency EWMA vs ``target_latency_s``;
  * coalescing queue depth EWMA vs ``target_queue``;
  * tick lag EWMA (tick duration / tick interval) vs ``target_tick_lag``
    — a device solve falling behind its cadence is overload even when
    the RPC path still looks healthy.

At each window boundary the admit *level* moves AIMD-style: pressure
above 1.0 multiplies it by ``md_factor``; a healthy window adds
``ai_step`` back (clamped to [``min_level``, 1]). The level maps onto
per-band admit probabilities so the LOWEST bands shed first: with B
bands sorted ascending and band rank j (0 = lowest priority),

    p_j = clamp((level - (B - 1 - j) / B) * B, 0, 1)

i.e. the level sweeps band segments from the bottom of the priority
order — at level 1 everything is admitted, each 1/B of level lost
extinguishes one more band from the bottom. The top band is NEVER shed
while lower bands exist (the goodput floor the chaos `client_storm`
plan pins); a single-band population has no lower band to sacrifice and
degrades to uniform level-probability shedding instead.

Determinism: the clock and RNG are injectable. The chaos harness passes
its virtual clock and the plan's seeded RNG, so a storm replay makes
byte-identical shed decisions.
"""

from __future__ import annotations

import bisect
import random
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["AimdController"]


class _Ewma:
    """Exponentially-weighted moving average that decays toward zero on
    idle control windows (a stale latency spike must not keep shedding
    an hour later)."""

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.value = 0.0

    def observe(self, x: float) -> None:
        self.value += self.alpha * (x - self.value)

    def decay(self) -> None:
        self.value *= 1.0 - self.alpha


class AimdController:
    def __init__(
        self,
        *,
        window: float = 1.0,
        clock: Callable[[], float] = time.time,
        rng: Optional[random.Random] = None,
        max_rps: Optional[float] = None,
        target_latency_s: float = 0.1,
        target_queue: float = 256.0,
        target_tick_lag: float = 3.0,
        md_factor: float = 0.6,
        ai_step: float = 0.1,
        min_level: float = 0.05,
        ewma_alpha: float = 0.3,
        max_retry_after: float = 60.0,
    ):
        if window <= 0:
            raise ValueError(f"control window must be > 0, got {window}")
        self.window = float(window)
        self._clock = clock
        self.rng = rng if rng is not None else random.Random()
        self.max_rps = float(max_rps) if max_rps else None
        self.target_latency_s = target_latency_s
        self.target_queue = target_queue
        self.target_tick_lag = target_tick_lag
        self.md_factor = md_factor
        self.ai_step = ai_step
        self.min_level = min_level
        self.max_retry_after = max_retry_after

        self.level = 1.0
        # Predictive leg (workload forecaster seam): an externally
        # supplied demand forecast in offered RPS for the NEXT window.
        # None (the default) leaves the controller purely reactive.
        self.forecast_rps: Optional[float] = None
        self._bands: List[int] = []  # sorted ascending wire priority
        self._arrivals = 0           # this window, shed included
        self._last_rate = 0.0        # previous closed window, per second
        self._window_end: Optional[float] = None
        self._lat = _Ewma(ewma_alpha)
        self._queue = _Ewma(ewma_alpha)
        self._tick_lag = _Ewma(ewma_alpha)
        self.windows = 0
        self.overloaded_windows = 0

    # -- signal feeds ----------------------------------------------------

    def observe_rpc(self, seconds: float) -> None:
        self._lat.observe(seconds)

    def observe_queue(self, depth: float) -> None:
        self._queue.observe(depth)

    def observe_tick_lag(self, ratio: float) -> None:
        self._tick_lag.observe(ratio)

    def set_forecast(self, rps: Optional[float]) -> None:
        """Feed a demand forecast (offered RPS expected in the next
        window) from a predictive model. The forecast joins the
        pressure max scaled by ``max_rps`` like the measured rate, so
        a predicted storm multiplies the level DOWN at the boundary
        *entering* the spike instead of the one after it. Requires
        ``max_rps`` to be configured (there is no budget to scale
        against otherwise); pass None to drop back to reactive-only."""
        self.forecast_rps = None if rps is None else float(rps)

    # -- the control loop ------------------------------------------------

    def pressure(self) -> float:
        """Max of the signal ratios; > 1.0 means overloaded."""
        p = 0.0
        if self.max_rps is not None:
            p = self._last_rate / self.max_rps
            if self.forecast_rps is not None:
                p = max(p, self.forecast_rps / self.max_rps)
        p = max(p, self._lat.value / self.target_latency_s)
        p = max(p, self._queue.value / self.target_queue)
        p = max(p, self._tick_lag.value / self.target_tick_lag)
        return p

    def _roll(self, now: float) -> None:
        if self._window_end is None:
            self._window_end = now + self.window
            return
        while now >= self._window_end:
            self._last_rate = self._arrivals / self.window
            self._arrivals = 0
            if self.pressure() > 1.0:
                self.level = max(self.min_level, self.level * self.md_factor)
                self.overloaded_windows += 1
            else:
                self.level = min(1.0, self.level + self.ai_step)
            # Idle windows decay the EWMAs so stale pressure cannot
            # pin the level down after the load is gone.
            self._lat.decay()
            self._queue.decay()
            self._tick_lag.decay()
            self.windows += 1
            self._window_end += self.window

    # -- admit decisions -------------------------------------------------

    def _note_band(self, priority: int) -> None:
        i = bisect.bisect_left(self._bands, priority)
        if i == len(self._bands) or self._bands[i] != priority:
            self._bands.insert(i, priority)

    def band_probability(self, priority: int) -> float:
        """Admit probability for this band at the current level (the
        segment mapping in the module docstring)."""
        if not self._bands:
            return 1.0
        bands = self._bands
        b = len(bands)
        # Rank from the bottom; an unseen priority slots at its sorted
        # insertion point (so it sheds like its nearest-lower neighbor).
        j = bisect.bisect_right(bands, priority) - 1
        j = max(j, 0)
        lo = (b - 1 - j) / b
        return min(max((self.level - lo) * b, 0.0), 1.0)

    def admit(self, priority: int) -> Tuple[bool, Optional[float]]:
        """One admit decision for a sheddable request in this band.
        Returns (admitted, retry_after_seconds_or_None)."""
        now = self._clock()
        self._roll(now)
        self._arrivals += 1
        self._note_band(priority)
        top = self._bands[-1]
        multi_band = len(self._bands) > 1
        if multi_band and priority >= top:
            # The goodput floor: the top band is never shed while lower
            # bands exist to shed first.
            return True, None
        if (
            self.max_rps is not None
            and self._arrivals > self.max_rps * self.window
        ):
            # Hard per-window cap: reacts inside the spiking window,
            # before the AIMD level has had a boundary to move at.
            return False, self.retry_after(priority)
        p = self.band_probability(priority)
        if p >= 1.0:
            return True, None
        if p <= 0.0 or self.rng.random() >= p:
            return False, self.retry_after(priority)
        return True, None

    def admit_many(self, priorities):
        """Vectorized twin of calling `admit` once per entry of
        ``priorities`` (in input order) at a single clock reading;
        returns the boolean admitted mask as a numpy array.

        Exactness contract (the vector population engine's parity pin
        rides on it): the window rolls once — within one batch only the
        first sequential call could have moved it; every arrival counts
        toward the hard cap at its 1-based global index; band discovery
        happens at each unseen priority's first occurrence, so the
        batch is split there and the band set / top band / probability
        mapping is static within each segment; and `self.rng.random()`
        is drawn in input order for exactly the positions whose band
        probability is fractional — the same draws, in the same order,
        the sequential loop would have made.
        """
        import numpy as np  # deferred: keep the module import-light

        prio = np.asarray(priorities, dtype=np.int64)
        n = int(prio.size)
        out = np.zeros(n, dtype=bool)
        if n == 0:
            return out
        self._roll(self._clock())
        a0 = self._arrivals
        self._arrivals += n

        uniq, first = np.unique(prio, return_index=True)
        known = set(self._bands)
        new_at = {
            int(ix): int(v)
            for v, ix in zip(uniq.tolist(), first.tolist())
            if int(v) not in known
        }
        cuts = sorted({0, n, *new_at})
        cap = (
            None if self.max_rps is None else self.max_rps * self.window
        )
        for s, e in zip(cuts[:-1], cuts[1:]):
            if s in new_at:
                self._note_band(new_at[s])
            seg = prio[s:e]
            bands = self._bands
            b = len(bands)
            top = bands[-1]
            if b > 1:
                # The goodput floor: top band admitted outright, exempt
                # even from the hard cap (checked first in `admit`).
                top_mask = seg >= top
            else:
                top_mask = np.zeros(e - s, dtype=bool)
            admitted = top_mask.copy()
            rest = ~top_mask
            if cap is not None:
                arrival_index = a0 + np.arange(
                    s + 1, e + 1, dtype=np.float64
                )
                rest &= ~(arrival_index > cap)
            if rest.any():
                j = np.searchsorted(bands, seg, side="right") - 1
                j = np.maximum(j, 0)
                lo = (b - 1 - j) / b
                p = np.clip((self.level - lo) * b, 0.0, 1.0)
                admitted |= rest & (p >= 1.0)
                frac = np.flatnonzero(rest & (p > 0.0) & (p < 1.0))
                for i in frac.tolist():
                    admitted[i] = self.rng.random() < p[i]
            out[s:e] = admitted
        return out

    def retry_after(self, priority: int) -> float:
        """Pacing hint for a shed response: heavier overload and deeper
        bands wait longer (spreading the retry wave down-band)."""
        if self._bands:
            rank_from_top = len(self._bands) - 1 - max(
                bisect.bisect_right(self._bands, priority) - 1, 0
            )
        else:
            rank_from_top = 0
        hint = self.window * (1.0 / max(self.level, 0.1)) * (1 + rank_from_top)
        return min(max(hint, self.window), self.max_retry_after)

    # -- introspection ---------------------------------------------------

    def status(self) -> Dict:
        return {
            "level": round(self.level, 6),
            "window_s": self.window,
            "max_rps": self.max_rps,
            "pressure": round(self.pressure(), 6),
            "offered_rps_last_window": round(self._last_rate, 3),
            "forecast_rps": (
                None if self.forecast_rps is None
                else round(self.forecast_rps, 3)
            ),
            "latency_ewma_s": round(self._lat.value, 6),
            "queue_ewma": round(self._queue.value, 3),
            "tick_lag_ewma": round(self._tick_lag.value, 6),
            "windows": self.windows,
            "overloaded_windows": self.overloaded_windows,
            "bands": {
                str(b): round(self.band_probability(b), 6)
                for b in self._bands
            },
        }
