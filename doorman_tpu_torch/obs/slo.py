"""Declarative SLOs with a small evaluation engine and a round-over-round
trajectory comparator.

The paper's contract is behavioral, not just fast: leases obey the
capacity window, top-band clients keep goodput under overload, masters
reconverge after flaps. Until now only tick wall-time reached the BENCH
artifacts — everything else lived in prose. This module turns the
contract into machine-readable verdicts:

  * `SloSpec` — one declarative objective: a name, a bound kind
    ("max": observed <= target, "min": observed >= target), the target,
    and a SOURCE descriptor naming the stream the observation comes
    from — a named sample stream (flight-recorder tick wall times), a
    histogram in a metrics Registry (RPC latency quantiles via
    Prometheus-style bucket interpolation), a scalar (reconvergence
    ticks, restore staleness), or the admission per-band tallies (the
    top-band goodput floor).
  * `SloEngine.evaluate(inputs)` — every spec against one `SloInputs`
    bundle, producing verdict dicts with status "pass" / "fail" /
    "no_data" (a missing stream is reported, never silently dropped:
    the r04/r05 lesson is that absent data must be loud).
  * `TrajectoryComparator` — reads the prior rounds' BENCH_r*.json
    artifacts committed at the repo root and computes deltas for metric
    rows (`delta`) and embedded SLO verdicts (`slo_delta`), so every
    new measurement states how it moved against the last round that
    measured the same thing. Diagnostics rows (unit == "error", e.g.
    the r05 `backend_unreachable` entry) are never ingested as metrics.

Consumers: CapacityServer.evaluate_slos() (the /debug/slo page and
status()), the chaos runner's verdict (reconvergence + top-band floor
over the deterministic tallies), and bench.py (every emitted metric row
carries a verdict and its delta vs the previous round).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from doorman_tpu_torch.obs import metrics as metrics_mod

__all__ = [
    "SloEngine",
    "SloInputs",
    "SloSpec",
    "TrajectoryComparator",
    "audit_divergence_spec",
    "bench_verdict",
    "detector_anomaly_spec",
    "histogram_quantile",
    "population_scaling_verdict",
    "predictive_goodput_verdict",
    "reconvergence_spec",
    "sample_quantile",
    "server_slos",
    "storm_slo_verdicts",
    "top_band_goodput_spec",
    "tpu_tick_budget_spec",
    "tpu_tick_verdict",
    "workload_slos",
]

# The north-star tick budget (BASELINE.md): recompute every lease of the
# 1M x 10k table in under 100 ms.
TICK_BUDGET_MS = 100.0

# The one-chip accelerator target (ROADMAP "Sub-10 ms TPU tick"): the
# fused one-launch tick at the 1M-lease bench shape, p50, on real TPU
# hardware. A STANDING spec: bench.py attaches its verdict to the fused
# server-tick row whenever the round runs on an accelerator, so the
# next hardware round reports pass/fail automatically instead of
# re-deriving the target (CPU-fallback rounds record it as no_data —
# the target is a hardware claim, and a fail verdict from a CPU box
# would poison the trajectory comparator's deltas).
TPU_TICK_BUDGET_MS = 10.0


@dataclass(frozen=True)
class SloSpec:
    """One declarative objective.

    `source` describes where the observation comes from:
      {"type": "samples",   "stream": name, "quantile": q, "scale": s}
      {"type": "histogram", "metric": name, "labels": (...),
                            "quantile": q, "scale": s}
      {"type": "scalar",    "key": name, "scale": s}
      {"type": "band_goodput"}   # admitted/(admitted+shed) of the top
                                 # band in SloInputs.band_tallies
    `scale` multiplies the raw observation (1000.0 turns histogram
    seconds into ms targets). `kind` is "max" (observed <= target) or
    "min" (observed >= target).
    """

    name: str
    kind: str  # "max" | "min"
    target: float
    source: Dict
    unit: str = ""
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("max", "min"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")


@dataclass
class SloInputs:
    """Everything one evaluation pass may observe. All fields optional;
    a spec whose stream is absent yields a "no_data" verdict."""

    registry: Optional[metrics_mod.Registry] = None
    # name -> sample list (e.g. "tick_ms" from the flight recorder ring)
    samples: Dict[str, Sequence[float]] = field(default_factory=dict)
    # name -> scalar observation (reconvergence ticks, restore age, ...)
    scalars: Dict[str, float] = field(default_factory=dict)
    # priority band -> {"admitted": n, "shed": n, "fast_fail": n}
    # (admission's deterministic GetCapacity tallies)
    band_tallies: Dict[int, Dict[str, int]] = field(default_factory=dict)


def sample_quantile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank quantile of a sample stream (None when empty); the
    same rule loadtest.storm reports, so verdicts and storm stats agree."""
    if not values:
        return None
    ordered = sorted(values)
    idx = min(
        len(ordered) - 1,
        max(0, int(round(q * (len(ordered) - 1)))),
    )
    return float(ordered[idx])


def histogram_quantile(
    hist: metrics_mod.Histogram, q: float, label_values: Sequence[str] = ()
) -> Optional[float]:
    """Prometheus-style quantile from a Histogram's cumulative buckets:
    linear interpolation inside the bucket the rank lands in; a rank in
    the +Inf bucket reports the highest finite bound (the histogram
    cannot resolve beyond it). None when the series has no samples."""
    key = tuple(str(v) for v in label_values)
    with hist._lock:
        counts = list(hist._counts.get(key, ()))
        total = hist._totals.get(key, 0)
    if total <= 0 or not counts:
        return None
    rank = q * total
    prev_cum, prev_bound = 0, 0.0
    for cum, bound in zip(counts, hist.buckets):
        if cum >= rank and cum > prev_cum:
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + max(0.0, min(frac, 1.0)) * (bound - prev_bound)
        prev_cum, prev_bound = cum, bound
    return float(hist.buckets[-1])


class SloEngine:
    """Evaluates a spec list against one SloInputs bundle."""

    def __init__(self, specs: Sequence[SloSpec]):
        self.specs = list(specs)

    def evaluate(self, inputs: SloInputs) -> List[dict]:
        return [self._one(spec, inputs) for spec in self.specs]

    # ------------------------------------------------------------------

    def _one(self, spec: SloSpec, inputs: SloInputs) -> dict:
        observed, detail = self._observe(spec, inputs)
        verdict = {
            "slo": spec.name,
            "kind": spec.kind,
            "target": spec.target,
            "unit": spec.unit,
            "observed": None if observed is None else round(observed, 6),
            "status": "no_data",
            "margin": None,
        }
        if spec.description:
            verdict["description"] = spec.description
        if observed is not None:
            ok = (
                observed <= spec.target
                if spec.kind == "max"
                else observed >= spec.target
            )
            verdict["status"] = "pass" if ok else "fail"
            # Positive margin = headroom, negative = by how much it blew.
            margin = (
                spec.target - observed
                if spec.kind == "max"
                else observed - spec.target
            )
            verdict["margin"] = round(margin, 6)
        if detail:
            verdict["detail"] = detail
        return verdict

    def _observe(
        self, spec: SloSpec, inputs: SloInputs
    ) -> Tuple[Optional[float], Optional[dict]]:
        src = spec.source
        kind = src.get("type")
        scale = float(src.get("scale", 1.0))
        if kind == "scalar":
            v = inputs.scalars.get(src["key"])
            return (None if v is None else float(v) * scale), None
        if kind == "samples":
            values = inputs.samples.get(src["stream"]) or ()
            v = sample_quantile(values, float(src.get("quantile", 0.5)))
            if v is None:
                return None, None
            return v * scale, {"samples": len(values)}
        if kind == "histogram":
            if inputs.registry is None:
                return None, None
            metric = next(
                (
                    m
                    for m in inputs.registry.metrics()
                    if m.name == src["metric"]
                ),
                None,
            )
            if not isinstance(metric, metrics_mod.Histogram):
                return None, None
            labels = tuple(src.get("labels", ()))
            v = histogram_quantile(
                metric, float(src.get("quantile", 0.99)), labels
            )
            if v is None:
                return None, None
            return v * scale, {"count": metric.count(*labels)}
        if kind == "band_goodput":
            tallies = inputs.band_tallies
            if not tallies:
                return None, None
            top = max(tallies)
            counts = tallies[top]
            detail = {
                "band": top,
                "per_band": {
                    str(b): dict(c) for b, c in sorted(tallies.items())
                },
            }
            total = counts.get("admitted", 0) + counts.get("shed", 0)
            if total == 0:
                return None, detail
            return counts.get("admitted", 0) / total, detail
        raise ValueError(f"unknown SLO source type {kind!r}")


# ----------------------------------------------------------------------
# Standard spec sets
# ----------------------------------------------------------------------


def top_band_goodput_spec(
    target: float = 0.99, name: str = "top_band_goodput"
) -> SloSpec:
    """The overload contract's floor: the highest priority band's
    admitted ratio. The chaos invariant pins the stronger form (zero
    shed while lower bands exist); the SLO keeps a numeric trajectory."""
    return SloSpec(
        name=name,
        kind="min",
        target=target,
        source={"type": "band_goodput"},
        unit="ratio",
        description=(
            "admitted/(admitted+shed) for the top priority band under "
            "overload — shedding walks up from the bottom band"
        ),
    )


def reconvergence_spec(budget_ticks: float, name: str = "reconverge_ticks"
                       ) -> SloSpec:
    """Post-heal reconvergence bound, in ticks (the chaos runner's
    converged-after-heal measurement vs the plan's budget)."""
    return SloSpec(
        name=name,
        kind="max",
        target=float(budget_ticks),
        source={"type": "scalar", "key": "reconverge_ticks"},
        unit="ticks",
        description="ticks after heal until allocations match baseline",
    )


def server_slos(
    *,
    tick_p50_ms: float = TICK_BUDGET_MS,
    tick_p99_ms: float = 2.5 * TICK_BUDGET_MS,
    rpc_p99_ms: float = 50.0,
    top_band_target: float = 0.99,
    restore_staleness_s: float = 60.0,
) -> List[SloSpec]:
    """The standing server-side spec set evaluated by
    CapacityServer.evaluate_slos() over the flight-recorder ring
    (tick_ms samples), a metrics registry (RPC histograms), the
    admission tallies, and the last restore summary."""
    return [
        SloSpec(
            "tick_budget_p50_ms", "max", tick_p50_ms,
            {"type": "samples", "stream": "tick_ms", "quantile": 0.5},
            unit="ms",
            description="north-star tick budget over the recorder window",
        ),
        SloSpec(
            "tick_budget_p99_ms", "max", tick_p99_ms,
            {"type": "samples", "stream": "tick_ms", "quantile": 0.99},
            unit="ms",
            description="tick tail over the recorder window",
        ),
        SloSpec(
            "get_capacity_p99_ms", "max", rpc_p99_ms,
            {
                "type": "histogram",
                "metric": "doorman_server_requests_durations",
                "labels": ("GetCapacity",),
                "quantile": 0.99,
                "scale": 1000.0,
            },
            unit="ms",
            description="GetCapacity p99 from the request histograms",
        ),
        top_band_goodput_spec(top_band_target),
        SloSpec(
            "restore_staleness_s", "max", restore_staleness_s,
            {"type": "scalar", "key": "restore_staleness_s"},
            unit="s",
            description=(
                "age of the state a warm takeover restored (journal "
                "freshness; bounded by the lease window)"
            ),
        ),
    ]


def audit_divergence_spec(name: str = "audit_divergence") -> SloSpec:
    """The standing shadow-oracle audit gate: the sampled fixpoint
    replay of every store through the numpy host oracles
    (obs/audit.py) must have found ZERO divergences. Any nonzero count
    is a live bit-identity violation — the production form of the
    per-lane parity pins."""
    return SloSpec(
        name=name,
        kind="max",
        target=0.0,
        source={"type": "scalar", "key": "audit_divergence"},
        unit="divergences",
        description=(
            "shadow-oracle audit divergences (store of record vs numpy "
            "oracle fixpoint, two-strike confirmed) — must stay zero"
        ),
    )


def detector_anomaly_spec(
    target: float = 0.0, name: str = "detector_anomalies"
) -> SloSpec:
    """The online anomaly detector's gate (obs/detect.py): robust-z /
    pinned-floor detections over the watched history streams. Default
    target zero — a steady run should not trip the detector."""
    return SloSpec(
        name=name,
        kind="max",
        target=float(target),
        source={"type": "scalar", "key": "detector_anomalies"},
        unit="detections",
        description=(
            "EWMA+MAD robust-z and pinned-floor detections over the "
            "flight-record history streams"
        ),
    )


def bench_verdict(row: dict) -> Optional[dict]:
    """The standing per-row bench SLO: any *_wall_ms metric is held to
    the north-star tick budget. Returns a verdict dict or None when the
    row has no applicable SLO (qps rows carry storm verdicts instead)."""
    metric = row.get("metric", "")
    value = row.get("value")
    if not metric.endswith("_wall_ms") or not isinstance(value, (int, float)):
        return None
    spec = SloSpec(
        f"{metric}:tick_budget", "max", TICK_BUDGET_MS,
        {"type": "scalar", "key": "v"}, unit="ms",
        description="north-star: <100 ms per tick",
    )
    return SloEngine([spec]).evaluate(
        SloInputs(scalars={"v": float(value)})
    )[0]


def tpu_tick_budget_spec(name: str = "tpu_tick_p50_ms") -> SloSpec:
    """The standing <10 ms one-chip accelerator target for the fused
    1M-lease server tick (see TPU_TICK_BUDGET_MS)."""
    return SloSpec(
        name=name,
        kind="max",
        target=TPU_TICK_BUDGET_MS,
        source={"type": "scalar", "key": "tick_p50_ms"},
        unit="ms",
        description=(
            "fused 1M-lease tick p50 on one accelerator chip — the "
            "ROADMAP 'Sub-10 ms TPU tick' target"
        ),
    )


def tpu_tick_verdict(p50_ms: float, *, cpu_fallback: bool) -> dict:
    """Evaluate the standing TPU tick budget for one bench round.
    CPU-fallback rounds yield an honest no_data verdict (the scalar is
    withheld — the target is a hardware claim); accelerator rounds
    report pass/fail automatically."""
    spec = tpu_tick_budget_spec()
    scalars = {} if cpu_fallback else {"tick_p50_ms": float(p50_ms)}
    verdict = SloEngine([spec]).evaluate(SloInputs(scalars=scalars))[0]
    if cpu_fallback:
        verdict["detail"] = {
            "reason": "cpu_fallback: hardware target not measurable",
            "cpu_p50_ms": round(float(p50_ms), 3),
        }
    return verdict


def storm_slo_verdicts(
    off: dict,
    on: dict,
    *,
    goodput_floor_ratio: float = 0.7,
    top_band_target: float = 0.99,
    p99_headroom: float = 1.25,
    name_prefix: str = "server_rpc_storm",
) -> List[dict]:
    """SLO verdicts for an admission off/on storm pair (loadtest.storm
    stats dicts): the top-band goodput floor over the admission-on
    tallies, per-band p99 ceilings (the admission-on tail must stay
    within `p99_headroom` of the admission-off tail for that band), and
    the goodput floor (on-goodput >= floor_ratio x off-goodput, the
    budget the controller was given to defend)."""
    bands = sorted(
        {int(b) for b in on.get("ok_by_band", {})}
        | {int(b) for b in on.get("shed_by_band", {})}
    )
    tallies = {
        b: {
            "admitted": int(on.get("ok_by_band", {}).get(b, 0)),
            "shed": int(on.get("shed_by_band", {}).get(b, 0)),
            "fast_fail": 0,
        }
        for b in bands
    }
    scalars: Dict[str, float] = {"goodput_qps": float(on["goodput_qps"])}
    specs = [
        top_band_goodput_spec(
            top_band_target, name=f"{name_prefix}:top_band_goodput"
        ),
        SloSpec(
            f"{name_prefix}:goodput_floor", "min",
            round(float(off["goodput_qps"]) * goodput_floor_ratio, 1),
            {"type": "scalar", "key": "goodput_qps"}, unit="qps",
            description=(
                f"admission-on goodput >= {goodput_floor_ratio:.0%} of "
                "admission-off"
            ),
        ),
    ]
    off_p99 = off.get("p99_s_by_band", {})
    on_p99 = on.get("p99_s_by_band", {})
    for b in bands:
        if b in off_p99 and b in on_p99:
            key = f"p99_ms_band{b}"
            scalars[key] = float(on_p99[b]) * 1000.0
            specs.append(SloSpec(
                f"{name_prefix}:{key}", "max",
                round(float(off_p99[b]) * 1000.0 * p99_headroom, 3),
                {"type": "scalar", "key": key}, unit="ms",
                description=(
                    "admission-on p99 must not exceed the admission-off "
                    f"tail for band {b} (x{p99_headroom:g} headroom)"
                ),
            ))
    return SloEngine(specs).evaluate(
        SloInputs(scalars=scalars, band_tallies=tallies)
    )


# The workload harness's gate vocabulary: gate name -> how it is
# observed. Each entry is (kind, source, unit, description); the
# scenario's spec.gates mapping picks gates by name and sets targets.
_WORKLOAD_GATES: Dict[str, tuple] = {
    "top_band_satisfaction": (
        "min",
        {"type": "scalar", "key": "top_band_satisfaction"},
        "ratio",
        "mean granted/wanted for the top band over measured ticks",
    ),
    "stress_satisfaction": (
        "min",
        {"type": "scalar", "key": "top_band_satisfaction_stress"},
        "ratio",
        "top-band satisfaction over the scenario's stress ticks "
        "(e.g. later flash-crowd windows)",
    ),
    "satisfaction": (
        "min",
        {"type": "scalar", "key": "satisfaction_overall"},
        "ratio",
        "mean granted/wanted across all bands over measured ticks",
    ),
    "top_band_goodput": (
        "min",
        {"type": "band_goodput"},
        "ratio",
        "admitted/(admitted+shed) of the top band (admission tallies)",
    ),
    "get_capacity_p99_ms": (
        "max",
        {"type": "samples", "stream": "get_capacity_wall_ms",
         "quantile": 0.99},
        "ms",
        "wall-clock GetCapacity p99 over the run (loopback)",
    ),
    "refresh_virtual_p99_ms": (
        "max",
        {"type": "samples", "stream": "refresh_virtual_ms",
         "quantile": 0.99},
        "ms",
        "virtual refresh latency p99 incl. the region RTT model",
    ),
    "reconverge_ticks": (
        "max",
        {"type": "scalar", "key": "reconverge_ticks"},
        "ticks",
        "ticks after the disturbance ends until base-client "
        "allocations match their baseline snapshot",
    ),
    "completions": (
        "min",
        {"type": "scalar", "key": "completions"},
        "jobs",
        "elastic jobs that reached total_work",
    ),
    "preemptions": (
        "min",
        {"type": "scalar", "key": "preemptions"},
        "jobs",
        "elastic preemption events (the scenario must exercise them)",
    ),
    "peak_population": (
        "min",
        {"type": "scalar", "key": "peak_population"},
        "clients",
        "max concurrent client population (the curve visibly moved)",
    ),
    "master_changes": (
        "min",
        {"type": "scalar", "key": "master_changes"},
        "changes",
        "mastership handovers observed (deploys visibly happened)",
    ),
    "refresh_ok_ratio": (
        "min",
        {"type": "scalar", "key": "refresh_ok_ratio"},
        "ratio",
        "successful refreshes / attempted, whole run",
    ),
    "fed_capacity_violations": (
        "max",
        {"type": "scalar", "key": "fed_capacity_violations"},
        "violations",
        "federated capacity-sum invariant violations (must be 0)",
    ),
    "epoch_changes": (
        "min",
        {"type": "scalar", "key": "epoch_changes"},
        "changes",
        "fleet routing-epoch changes applied (resharding visibly "
        "happened)",
    ),
    "stream_pushes": (
        "min",
        {"type": "scalar", "key": "stream_pushes"},
        "pushes",
        "lease deltas pushed to WatchCapacity subscribers",
    ),
    "frontend_frames": (
        "min",
        {"type": "scalar", "key": "frontend_frames"},
        "frames",
        "ring frames pumped through the frontend worker pool "
        "(the serving plane visibly carried the stream traffic)",
    ),
    "frontend_held": (
        "min",
        {"type": "scalar", "key": "frontend_held"},
        "streams",
        "WatchCapacity streams held by frontend workers at run end",
    ),
}


def workload_slos(
    gates: Dict[str, float], *, name_prefix: str
) -> List[SloSpec]:
    """Build the spec list for a workload scenario from its gate map
    (gate name -> target). Unknown gate names raise — a typo'd gate
    must fail the scenario author, not silently pass the run."""
    specs = []
    for gate, target in sorted(gates.items()):
        if gate not in _WORKLOAD_GATES:
            raise ValueError(
                f"unknown workload gate {gate!r} "
                f"(known: {sorted(_WORKLOAD_GATES)})"
            )
        kind, source, unit, description = _WORKLOAD_GATES[gate]
        specs.append(SloSpec(
            name=f"{name_prefix}:{gate}",
            kind=kind,
            target=float(target),
            source=dict(source),
            unit=unit,
            description=description,
        ))
    return specs


def predictive_goodput_verdict(
    predictive: float,
    reactive: float,
    *,
    name: str = "workload:flash_crowd_predictive:predictive_over_reactive",
) -> dict:
    """The standing predictive-vs-reactive head-to-head verdict: the
    predictive run's stressed top-band satisfaction must be at least
    the reactive run's (same scenario, same seed, forecaster on/off).
    The reactive observation IS the target, so the verdict and its
    round-over-round delta track the predictive margin directly."""
    spec = SloSpec(
        name=name,
        kind="min",
        target=round(float(reactive), 6),
        source={"type": "scalar", "key": "predictive"},
        unit="ratio",
        description=(
            "predictive top-band satisfaction over the stressed flash-"
            "crowd windows vs the reactive controller's (the target)"
        ),
    )
    verdict = SloEngine([spec]).evaluate(
        SloInputs(scalars={"predictive": float(predictive)})
    )[0]
    verdict["detail"] = {
        "predictive": round(float(predictive), 6),
        "reactive": round(float(reactive), 6),
    }
    return verdict


def population_scaling_verdict(
    exponent: float,
    *,
    target: float = 0.3,
    name: str = "workload_population_scaling:sublinear",
) -> dict:
    """The vector population engine's driver-cost SLO: the log-log
    slope of per-tick driver wall time vs population size over the
    measured tiers must stay under ``target`` (0.3 — near-flat, since
    the refresh spread holds the due set per tick roughly constant
    while the resident population grows three orders of magnitude).
    An exponent of 1.0 is the per-client path's linear walk; the array
    engine's whole point is that parked rows cost nothing."""
    spec = SloSpec(
        name=name,
        kind="max",
        target=float(target),
        source={"type": "scalar", "key": "exponent"},
        unit="exponent",
        description=(
            "log-log slope of per-tick vector-population driver wall "
            "time vs resident population size"
        ),
    )
    verdict = SloEngine([spec]).evaluate(
        SloInputs(scalars={"exponent": float(exponent)})
    )[0]
    return verdict


# ----------------------------------------------------------------------
# Trajectory comparator over the committed BENCH_r*.json rounds
# ----------------------------------------------------------------------

# Numeric row fields the comparator diffs when both rounds carry them.
_DELTA_FIELDS = (
    "value", "best_ms", "median_ms", "mean_ms", "p50_ms", "p90_ms",
    "p99_ms",
)

_ROUND_RE = re.compile(r"BENCH_r(\d+)\.json$")


class TrajectoryComparator:
    """Reads the prior rounds' BENCH_r*.json artifacts and answers
    "how did this metric / this SLO move since the last round that
    measured it?". Each artifact is {"n": round, "tail": "<stdout
    tail>", ...}; metric rows are the tail's JSON lines carrying
    numeric "metric"/"value" pairs (diagnostics — unit "error" — are
    excluded, the r05 backend_unreachable trap). Rows that embed "slo"
    verdicts are indexed by verdict name too, so verdict-level deltas
    start flowing the round after verdicts first ship."""

    def __init__(self, root: Optional[str] = None):
        base = Path(root) if root else self.default_root()
        # round -> {metric: row}; rounds ascending.
        self.rounds: List[Tuple[int, Dict[str, dict]]] = []
        paths = sorted(base.glob("BENCH_r*.json")) if base.is_dir() else []
        for path in paths:
            m = _ROUND_RE.search(path.name)
            if not m:
                continue
            try:
                data = json.loads(path.read_text())
            except (OSError, ValueError):
                continue
            n = int(data.get("n", int(m.group(1))))
            rows = self._parse_rows(data)
            if rows:
                self.rounds.append((n, rows))
        self.rounds.sort(key=lambda kv: kv[0])

    @staticmethod
    def default_root() -> Path:
        """The repo root (BENCH artifacts live beside bench.py)."""
        return Path(__file__).resolve().parents[2]

    @staticmethod
    def _parse_rows(data: dict) -> Dict[str, dict]:
        rows: Dict[str, dict] = {}
        candidates: List[dict] = []
        for line in str(data.get("tail", "")).splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict):
                candidates.append(obj)
        if isinstance(data.get("parsed"), dict):
            candidates.append(data["parsed"])
        for obj in candidates:
            metric = obj.get("metric")
            if (
                isinstance(metric, str)
                and isinstance(obj.get("value"), (int, float))
                and obj.get("unit") != "error"
                and "diagnostic" not in obj
            ):
                rows.setdefault(metric, obj)
        return rows

    # ------------------------------------------------------------------

    def previous(self, metric: str) -> Optional[Tuple[int, dict]]:
        """The LATEST prior round carrying this metric (rounds that
        degraded to diagnostics simply don't carry it)."""
        for n, rows in reversed(self.rounds):
            if metric in rows:
                return n, rows[metric]
        return None

    def delta(self, row: dict) -> Optional[dict]:
        """Field-by-field deltas of a metric row vs the last round that
        measured it; None when no prior round did."""
        prev = self.previous(str(row.get("metric", "")))
        if prev is None:
            return None
        n, prow = prev
        out: dict = {"round": n}
        for f in _DELTA_FIELDS:
            a, b = row.get(f), prow.get(f)
            if isinstance(a, (int, float)) and isinstance(b, (int, float)):
                out[f] = {
                    "prev": b,
                    "delta": round(a - b, 6),
                    "ratio": round(a / b, 4) if b else None,
                }
        return out

    def slo_delta(self, verdict: dict) -> Optional[dict]:
        """Delta of one SLO verdict vs the last round that embedded a
        verdict of the same name in any metric row."""
        name = verdict.get("slo")
        observed = verdict.get("observed")
        for n, rows in reversed(self.rounds):
            for prow in rows.values():
                embedded = prow.get("slo")
                if isinstance(embedded, dict):
                    embedded = [embedded]
                if not isinstance(embedded, list):
                    continue
                for pv in embedded:
                    if not (
                        isinstance(pv, dict) and pv.get("slo") == name
                    ):
                        continue
                    out = {"round": n, "prev_status": pv.get("status")}
                    pobs = pv.get("observed")
                    if isinstance(observed, (int, float)) and isinstance(
                        pobs, (int, float)
                    ):
                        out["prev_observed"] = pobs
                        out["delta_observed"] = round(observed - pobs, 6)
                    return out
        return None
