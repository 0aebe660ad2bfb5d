"""Device-batched seasonal demand forecaster for predictive admission
(port of doorman_tpu/workload/forecast.py).

A Holt–Winters additive-seasonal model over per-band offered-rate
history (the flight recorder's per-tick series): one EWMA level per
series plus a seasonal correction per slot of a fixed period. Each
``observe(x)`` folds in one tick's rates and returns the forecast for
the NEXT tick, clamped to the min/max envelope of everything seen so
far — a forecast is a claim about recurring traffic, not an
extrapolation license:

    level'        = level + alpha * ((x - season[slot]) - level)
    season[slot]' = season[slot] + beta * ((x - level') - season[slot])
    forecast      = clip(level' + season[next_slot], hist_min, hist_max)

The update is elementwise over the batch of series (bands). The device
step is torch ops on an explicit device, in the oracle's order of
operations, with the state kept on that device between steps (one
upload of the tick's rates, one download of the forecast). The numpy
`host_step` is the ORACLE and the device step is pinned bit-identical
to it (tests/test_torch_forecast.py on the CPU, chip_smoke.py on the
card). Bit parity holds because the gains ``alpha``/``beta`` are
constrained to powers of two, so every multiply in the delta-form update
scales by a power of two and is EXACT in float32: each elementwise op
rounds once, in the same place numpy's does, and a fused multiply-add
could not round differently either.

Two invariants hold by construction:

  * the forecast never leaves the historical [min, max] envelope
    (the final clip);
  * constant traffic is a fixpoint: after the first observation of a
    constant series the forecast equals the constant exactly (level
    initializes to x, every seasonal correction stays 0).

Engines: "device" and "auto" run the torch step on `device` ("cuda"
by default; without a GPU they raise unless ``device="cpu"`` is
passed). The reference's "auto" drops to the host when jax is missing;
the port never drops to the host on its own. "host" is the numpy
oracle, chosen on purpose.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from doorman_tpu_torch.utils.backend import resolve_device

__all__ = ["SeasonalForecaster", "device_step", "host_step", "init_state"]

# State tuple: (level[B], season[B, P], hist_min[B], hist_max[B],
# seen[B] as float32 0/1). Everything float32: the device path computes
# in f32 and the oracle must match it bit for bit.
State = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _dyadic(gain: float) -> bool:
    """True for 0 or a power of two in (0, 1] — the gains whose f32
    products are exact (see module docstring)."""
    if gain == 0.0:
        return True
    if not 0.0 < gain <= 1.0:
        return False
    return math.frexp(gain)[0] == 0.5


def init_state(series: int, period: int) -> State:
    if series < 1:
        raise ValueError(f"series must be >= 1, got {series}")
    if period < 1:
        raise ValueError(f"period must be >= 1, got {period}")
    return (
        np.zeros(series, np.float32),
        np.zeros((series, period), np.float32),
        np.zeros(series, np.float32),
        np.zeros(series, np.float32),
        np.zeros(series, np.float32),
    )


def host_step(
    state: State, x: np.ndarray, slot: int, nxt: int,
    alpha: float, beta: float,
) -> Tuple[State, np.ndarray]:
    """One numpy oracle step: fold in x (float32[B]) at seasonal slot
    `slot`, forecast for slot `nxt`. The device step mirrors these
    expressions operation for operation."""
    level, season, hist_min, hist_max, seen = state
    a = np.float32(alpha)
    b = np.float32(beta)
    s = season[:, slot]
    level2 = np.where(seen > 0, level + a * ((x - s) - level), x)
    season_slot = np.where(
        seen > 0, s + b * ((x - level2) - s), s
    )
    hist_min2 = np.where(seen > 0, np.minimum(hist_min, x), x)
    hist_max2 = np.where(seen > 0, np.maximum(hist_max, x), x)
    season2 = season.copy()
    season2[:, slot] = season_slot
    forecast = np.clip(level2 + season2[:, nxt], hist_min2, hist_max2)
    seen2 = np.ones_like(seen)
    return (
        (level2, season2, hist_min2, hist_max2, seen2),
        forecast.astype(np.float32),
    )


def device_step(state, x: torch.Tensor, slot: int, nxt: int,
                alpha: float, beta: float):
    """The oracle's step as torch ops on the tensors' device, same
    expressions in the same order, f32 throughout. `state` is the
    five-tensor tuple; returns (new state, forecast). The season table
    is updated in place (its slot column), as the reference's
    `.at[:, slot].set` is after XLA's donation."""
    level, season, hist_min, hist_max, seen = state
    # Python floats are weak scalars: the products stay f32, and a
    # dyadic gain makes each one exact.
    a = float(np.float32(alpha))
    b = float(np.float32(beta))
    s = season[:, slot]
    warm = seen > 0
    level2 = torch.where(warm, level + a * ((x - s) - level), x)
    season_slot = torch.where(warm, s + b * ((x - level2) - s), s)
    hist_min2 = torch.where(warm, torch.minimum(hist_min, x), x)
    hist_max2 = torch.where(warm, torch.maximum(hist_max, x), x)
    season[:, slot] = season_slot
    forecast = torch.minimum(
        torch.maximum(level2 + season[:, nxt], hist_min2), hist_max2
    )
    seen2 = torch.ones_like(seen)
    return (level2, season, hist_min2, hist_max2, seen2), forecast


class SeasonalForecaster:
    """Batched Holt–Winters forecaster over `series` parallel rate
    series with seasonal period `period` (in ticks).

    alpha/beta must be 0 or a power of two in (0, 1] (the bit-parity
    constraint in the module docstring); beta=0 disables the seasonal
    leg and leaves a plain EWMA.

    engine: "auto" or "device" (the torch step on `device`, "cuda"
    unless the caller passes "cpu"; raises without a GPU), or "host"
    (the numpy oracle)."""

    def __init__(
        self,
        series: int,
        period: int,
        *,
        alpha: float = 0.5,
        beta: float = 0.25,
        engine: str = "auto",
        device="cuda",
    ):
        if alpha == 0.0 or not _dyadic(alpha):
            raise ValueError(
                f"alpha must be a power of two in (0, 1], got {alpha}"
            )
        if not _dyadic(beta):
            raise ValueError(
                f"beta must be 0 or a power of two in (0, 1], "
                f"got {beta}"
            )
        if engine not in ("auto", "host", "device"):
            raise ValueError(f"unknown engine {engine!r}")
        self.series = int(series)
        self.period = int(period)
        self.alpha = float(alpha)
        self.beta = float(beta)
        state = init_state(self.series, self.period)
        self._t = 0
        if engine == "auto":
            engine = "device"
        self.engine = engine
        self.device = None
        if engine == "device":
            self.device = resolve_device(device)
            self._state = tuple(
                torch.from_numpy(v).to(self.device) for v in state
            )
        else:
            self._state = state

    @property
    def ticks_observed(self) -> int:
        return self._t

    def state(self) -> State:
        """The model state as host float32 arrays (the oracle's tuple)."""
        if self.engine == "device":
            return tuple(v.cpu().numpy() for v in self._state)
        return self._state

    def warm_start(
        self,
        history,
        *,
        field: str = "offered",
        tier: int = 0,
        interval: float = 1.0,
    ) -> int:
        """Prime the model from a flight-record history before serving
        live traffic: replay the per-tick offered-rate stream through
        ``observe`` so a restarted process starts with the previous
        run's level/seasonal state instead of a cold model.

        ``history`` is an ``obs.history.HistoryStore`` (or any iterable
        of record dicts / scalars, oldest first). Each record's
        ``field`` value is divided by ``interval`` (counts -> rates,
        same arithmetic as the live harness) and broadcast across the
        batch. Because this IS ``observe``, the resulting state is
        bit-identical to having watched the same stream live — the
        restart-spanning twin of the oracle discipline. Returns the
        number of ticks folded in."""
        if hasattr(history, "records"):
            records = history.records(tier=tier)
        else:
            records = history
        fed = 0
        for rec in records:
            v = rec.get(field) if isinstance(rec, dict) else rec
            if v is None:
                continue
            x = np.full(
                self.series, np.float32(float(v) / interval), np.float32
            )
            self.observe(x)
            fed += 1
        return fed

    def observe(self, x: Sequence[float]) -> np.ndarray:
        """Fold in one tick's per-series rates; return float32[B]
        forecast for the next tick."""
        arr = np.asarray(x, np.float32)
        if arr.shape != (self.series,):
            raise ValueError(
                f"expected {self.series} rates, got shape {arr.shape}"
            )
        slot = self._t % self.period
        nxt = (self._t + 1) % self.period
        if self.engine == "device":
            xt = torch.from_numpy(arr).to(self.device)
            self._state, forecast = device_step(
                self._state, xt, slot, nxt, self.alpha, self.beta
            )
            forecast = forecast.cpu().numpy()
        else:
            self._state, forecast = host_step(
                self._state, arr, slot, nxt, self.alpha, self.beta
            )
        self._t += 1
        return forecast

    def status(self) -> dict:
        level, _, hist_min, hist_max, seen = self.state()
        return {
            "engine": self.engine,
            "device": str(self.device) if self.device is not None else None,
            "period": self.period,
            "ticks_observed": self._t,
            "level": [round(float(v), 3) for v in level],
            "hist_min": [round(float(v), 3) for v in hist_min],
            "hist_max": [round(float(v), 3) for v in hist_max],
            "seen": bool(seen.any()),
        }
