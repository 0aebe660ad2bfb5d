"""Per-phase tick telemetry: one recorder that fans each measured phase
lap out to every consumer at once.

The solvers used to keep private write-only `phase_s` dicts that only
bench.py ever read; a tick's time breakdown (upload vs. solve vs.
download vs. apply) was invisible at runtime. A PhaseRecorder keeps the
cumulative dict (bench.py and /debug/status still read it) and
additionally publishes every lap as:

  * a histogram sample in the DEFAULT metrics registry
    (`doorman_tick_phase_seconds{component,phase}`) — scrape /metrics
    for per-phase distributions;
  * a last-tick gauge (`doorman_tick_phase_last_seconds{component,
    phase}`) — the most recent tick's breakdown at a glance;
  * a span in the trace ring (category `phase`) when the tracer is
    enabled, parented to whatever span is current (the server's tick
    span propagates into the executor thread via copy_context), so a
    Perfetto timeline shows the tick with its phase children.

Buckets are tuned for sub-tick phases (tens of microseconds to one
second); the default request buckets start at 5 ms and would flatten
every phase into the first bucket.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

from doorman_tpu_torch.obs import metrics as metrics_mod
from doorman_tpu_torch.obs import trace as trace_mod

__all__ = ["PHASE_BUCKETS", "PhaseRecorder", "last_shard_bytes"]

# (component, direction) -> per-shard payload bytes of the most recent
# mesh-sharded tick. The gauges carry the same numbers for /metrics;
# this plain snapshot lets the flight recorder embed them in its
# per-tick records without reparsing the registry.
_last_shard_bytes: Dict[Tuple[str, str], Tuple[int, ...]] = {}


def last_shard_bytes() -> Dict[Tuple[str, str], Tuple[int, ...]]:
    """Most recent per-shard payload bytes, keyed (component, direction)."""
    return dict(_last_shard_bytes)

PHASE_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0,
)


def _phase_metrics() -> Tuple[metrics_mod.Histogram, metrics_mod.Gauge]:
    reg = metrics_mod.default_registry()
    hist = reg.histogram(
        "doorman_tick_phase_seconds",
        "Duration of one tick phase (upload/solve/download/apply, ...).",
        labels=("component", "phase"),
        buckets=PHASE_BUCKETS,
    )
    last = reg.gauge(
        "doorman_tick_phase_last_seconds",
        "Most recent tick's duration per phase.",
        labels=("component", "phase"),
    )
    return hist, last


def _shard_metrics() -> Tuple[metrics_mod.Gauge, metrics_mod.Gauge]:
    """Per-shard host-link traffic of one mesh-resident tick, for
    spotting an unbalanced delivery. The bytes reported are the REAL
    payloads (dirty slots, delivered rows); the wire additionally ships
    each shard's block padded to the max shard's bucketed width, so the
    skew ratio also reads as that padding's waste."""
    reg = metrics_mod.default_registry()
    per = reg.gauge(
        "doorman_tick_shard_bytes",
        "Per-shard host-link payload bytes of the last mesh-sharded "
        "tick (direction: upload/download).",
        labels=("component", "direction", "shard"),
    )
    skew = reg.gauge(
        "doorman_tick_shard_skew",
        "max/mean ratio of per-shard payload bytes for the last "
        "mesh-sharded tick (1.0 = perfectly balanced).",
        labels=("component", "direction"),
    )
    return per, skew


class PhaseRecorder:
    """Times consecutive laps of one tick for one component.

    `totals` is the solver's cumulative phase_s dict (seconds); lap()
    measures since the previous lap (or construction) and record()
    takes an externally measured duration. Construction reads the
    clock, so build it right where the first phase starts.
    """

    __slots__ = ("_component", "_totals", "_hist", "_last", "_t0")

    def __init__(self, component: str, totals: Dict[str, float]):
        self._component = component
        self._totals = totals
        self._hist, self._last = _phase_metrics()
        self._t0 = time.perf_counter()

    def reset(self) -> None:
        """Restart the lap clock without recording (rare resyncs, e.g.
        after a rebuild that is timed as its own phase)."""
        self._t0 = time.perf_counter()

    def lap(self, phase: str) -> float:
        t1 = time.perf_counter()
        dt = t1 - self._t0
        self._t0 = t1
        self._record(phase, dt, t1)
        return dt

    def record(self, phase: str, seconds: float) -> None:
        """Record an interval that ended now (measured by the caller)."""
        self._record(phase, seconds, time.perf_counter())

    def shard_bytes(self, direction: str, per_shard) -> None:
        """Per-shard payload bytes of one mesh-sharded tick. Lands as
        `doorman_tick_shard_bytes{component,direction,shard}` gauges
        plus a skew gauge (max/mean), and — when the tracer is on — a
        `shard.<direction>` instant on the timeline, so an unbalanced
        delivery shows up in /debug/traces right next to the tick's
        phase spans."""
        per = [int(b) for b in per_shard]
        if not per:
            return
        _last_shard_bytes[(self._component, direction)] = tuple(per)
        per_g, skew_g = _shard_metrics()
        for d, b in enumerate(per):
            per_g.set(b, self._component, direction, str(d))
        mean = sum(per) / len(per)
        skew = (max(per) / mean) if mean > 0 else 1.0
        skew_g.set(skew, self._component, direction)
        tracer = trace_mod.default_tracer()
        if tracer.enabled:
            tracer.instant(
                f"shard.{direction}",
                cat=f"phase:{self._component}",
                args={"bytes": per, "skew": round(skew, 3)},
            )

    def _record(self, phase: str, seconds: float, end: float) -> None:
        self._totals[phase] = self._totals.get(phase, 0.0) + seconds
        self._hist.observe(seconds, self._component, phase)
        self._last.set(seconds, self._component, phase)
        tracer = trace_mod.default_tracer()
        if tracer.enabled:
            tracer.add_complete(
                phase,
                ts_us=trace_mod.perf_to_us(end - seconds),
                dur_us=seconds * 1e6,
                cat=f"phase:{self._component}",
            )
