"""Online anomaly detection over flight-record / history streams.

Per watched field the detector keeps a trailing window and an EWMA and
scores each new observation with a **robust z**:

    z = 0.6745 * |x - median(window)| / MAD(window)

(median absolute deviation, scaled so z is comparable to a normal
z-score). Medians and MADs shrug off the very outliers being hunted,
so a single tick spike cannot drag the baseline after it. A detection
fires when the window holds at least ``min_samples`` points and
``z > threshold``. Optional **floors** encode pinned steady-state
expectations (the fused tick's dispatches/host_syncs per tick): the
field is flagged the moment it exceeds its floor, no warmup — a fused
tick that silently grew a host round-trip trips the floor on the first
bad tick.

Everything is plain Python arithmetic over ``sorted()`` — bit-stable
across runs, which is what lets chaos verdicts embed windowed detector
output and stay byte-identical under seeded replay. ``observe``
consumes live records (server tick loop); ``scan`` replays a record
list (history segments, chaos rings) with dotted-path field access
(``"admission.s0.level"``).

Detections are plain dicts; the server turns them into
``detect.anomaly`` trace instants, an ``anomalies`` chrome-overlay
counter track, and a machine-readable SLO verdict via
``detector_anomaly_spec``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Sequence

__all__ = ["AnomalyDetector", "DEFAULT_FIELDS", "robust_z"]

# The server streams watched by default: tick wall time, the fused
# tick's dispatch accounting (vs pinned floors when given), the scoped
# solve's per-tick scope, and the admission level.
DEFAULT_FIELDS = (
    "wall_ms",
    "dispatches",
    "host_syncs",
    "scoped_rows",
    "admission_level",
)

# Normal-consistency constant: MAD * 1.4826 estimates sigma, so
# 0.6745/MAD-scaled deviations read like z-scores.
_MAD_SCALE = 0.6745


def _median(ordered: Sequence[float]) -> float:
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return ordered[mid]
    return 0.5 * (ordered[mid - 1] + ordered[mid])


def robust_z(value: float, window: Sequence[float]) -> float:
    """Robust z-score of ``value`` against ``window`` (which need not
    contain it). Zero MAD (constant window) scores any deviation as
    +inf and an exact match as 0."""
    ordered = sorted(window)
    if not ordered:
        return 0.0
    med = _median(ordered)
    mad = _median(sorted(abs(v - med) for v in ordered))
    dev = abs(value - med)
    if mad == 0.0:
        return 0.0 if dev == 0.0 else float("inf")
    return _MAD_SCALE * dev / mad


class _FieldState:
    __slots__ = ("window", "ewma", "detections")

    def __init__(self, capacity: int):
        self.window: deque = deque(maxlen=capacity)
        self.ewma: Optional[float] = None
        self.detections = 0


def _field_value(rec: dict, field: str):
    """Dotted-path field access: "admission.s0.level" walks nested
    dicts (the chaos runner's per-tick admission blocks)."""
    cur = rec
    for part in field.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


class AnomalyDetector:
    """Windowed robust-z + EWMA detector over named record fields."""

    def __init__(
        self,
        fields: Sequence[str] = DEFAULT_FIELDS,
        *,
        window: int = 64,
        min_samples: int = 16,
        threshold: float = 6.0,
        ewma_alpha: float = 0.25,
        floors: Optional[Dict[str, float]] = None,
    ):
        if window <= 1:
            raise ValueError("window must be > 1")
        self.fields = tuple(fields)
        self.window = int(window)
        self.min_samples = max(2, int(min_samples))
        self.threshold = float(threshold)
        self.ewma_alpha = float(ewma_alpha)
        self.floors = dict(floors or {})
        self._lock = threading.Lock()
        self._state: Dict[str, _FieldState] = {
            f: _FieldState(self.window) for f in self.fields
        }
        self.anomalies = 0

    # -- online ---------------------------------------------------------

    def observe(self, rec: dict) -> List[dict]:
        """Score one record; returns the detections it fired (possibly
        empty). Updates window/EWMA state either way."""
        out: List[dict] = []
        with self._lock:
            for field in self.fields:
                v = _field_value(rec, field)
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                x = float(v)
                st = self._state[field]
                det = self._score_locked(field, st, x, rec)
                if det is not None:
                    out.append(det)
                # The anomaly does NOT poison the baseline: a flagged
                # point still enters the window (median/MAD absorb it),
                # and the EWMA tracks it so a level *shift* stops
                # firing once the window catches up.
                st.window.append(x)
                st.ewma = (
                    x
                    if st.ewma is None
                    else st.ewma + self.ewma_alpha * (x - st.ewma)
                )
        return out

    def _score_locked(
        self, field: str, st: _FieldState, x: float, rec: dict
    ) -> Optional[dict]:
        floor = self.floors.get(field)
        reasons = []
        z = robust_z(x, st.window)
        if len(st.window) >= self.min_samples and z > self.threshold:
            reasons.append("robust_z")
        if floor is not None and x > floor:
            reasons.append("floor")
        if not reasons:
            return None
        st.detections += 1
        self.anomalies += 1
        ordered = sorted(st.window)
        det = {
            "field": field,
            "value": x,
            "z": (round(z, 4) if z != float("inf") else "inf"),
            "median": _median(ordered) if ordered else None,
            "ewma": None if st.ewma is None else round(st.ewma, 6),
            "floor": floor,
            "reasons": reasons,
            "window": len(st.window),
        }
        for key in ("tick", "hseq", "t", "seq"):
            if key in rec:
                det[key] = rec[key]
        return det

    # -- batch ----------------------------------------------------------

    @classmethod
    def scan_records(
        cls,
        records: Sequence[dict],
        fields: Sequence[str] = DEFAULT_FIELDS,
        **kwargs,
    ) -> dict:
        """Replay a record list through a fresh detector (chaos
        verdicts, cmd.obs): returns {"anomalies": n, "detections":
        [...], "per_field": {field: n}} — deterministic for a
        deterministic record list."""
        det = cls(fields, **kwargs)
        detections: List[dict] = []
        for rec in records:
            detections.extend(det.observe(rec))
        return {
            "anomalies": det.anomalies,
            "detections": detections,
            "per_field": {
                f: det._state[f].detections
                for f in det.fields
                if det._state[f].detections
            },
        }

    def status(self) -> dict:
        with self._lock:
            return {
                "fields": list(self.fields),
                "window": self.window,
                "threshold": self.threshold,
                "anomalies": self.anomalies,
                "floors": dict(self.floors),
                "per_field": {
                    f: {
                        "n": len(st.window),
                        "ewma": st.ewma,
                        "detections": st.detections,
                    }
                    for f, st in self._state.items()
                },
            }
