"""The declarative workload spec: everything a scenario run needs,
as plain data.

A WorkloadSpec is the workload harness's counterpart of a chaos
FaultPlan: topology (servers, algorithm, capacity, admission,
federation), the base client population (per-band wants), the
composable generators that move load during the run (GeneratorSpec
rows, built by `generators.build`), and the SLO gates the verdict is
judged against. Specs are frozen and JSON-round-trippable
(`as_dict`/`from_dict`) so a scenario is reproducible from its
serialized form alone — same spec + same seed, same event log bytes.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, replace
from typing import Any, Dict, Mapping, Optional, Tuple

__all__ = ["GeneratorSpec", "WorkloadSpec"]


def _freeze(value):
    """Dicts/lists -> tuples of sorted pairs / tuples, recursively, so
    frozen specs hash and compare structurally."""
    if isinstance(value, Mapping):
        return tuple(
            (k, _freeze(v)) for k, v in sorted(value.items())
        )
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    return value


def _thaw(value):
    if isinstance(value, tuple):
        if value and all(
            isinstance(v, tuple) and len(v) == 2
            and isinstance(v[0], str) for v in value
        ):
            return {k: _thaw(v) for k, v in value}
        return [_thaw(v) for v in value]
    return value


@dataclass(frozen=True)
class GeneratorSpec:
    """One load shape: a `generators` registry kind plus its params."""

    kind: str
    params: tuple = ()  # frozen mapping (see _freeze)

    @classmethod
    def make(cls, kind: str, **params) -> "GeneratorSpec":
        return cls(kind=kind, params=_freeze(params))

    def as_params(self) -> Dict[str, Any]:
        out = _thaw(self.params)
        return out if isinstance(out, dict) else {}


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    ticks: int
    seed: int = 0
    tick_interval: float = 1.0
    # -- topology -------------------------------------------------------
    servers: int = 1
    election_ttl: float = 3.0
    capacity: float = 100.0
    safe_capacity: Optional[float] = None
    algorithm: str = "PROPORTIONAL_SHARE"
    algorithm_variant: Optional[str] = None
    lease_length: float = 60.0
    refresh_interval: float = 1.0
    learning_mode_duration: float = 0.0
    resource: str = "r0"
    # Admission controller kwargs (None: no admission front-end).
    admission: tuple = ()
    # Federated topology: {"straddle": [rid...], "client_shards": [...]}
    # (each server becomes a shard with its own election lock).
    federated: tuple = ()
    # -- population -----------------------------------------------------
    # Base clients as (band, wants) pairs, attached before tick 0.
    base_clients: tuple = ()
    # Compact base population as (count, band, wants) rows — the
    # million-client form of base_clients (a spec listing 1e6 pairs
    # would dwarf the run it describes). Expanded after base_clients,
    # in row order.
    base_population: tuple = ()
    # Population engine: "clients" steps one real Client per macro
    # client per tick (the reference harness path); "vector" holds the
    # population as arrays (workload.population) and refreshes it in
    # batched grouped passes against the same servers. At small scale
    # the two produce byte-identical event logs (the parity pin in
    # tests/test_torch_workload_population.py).
    population_engine: str = "clients"
    # Vector engine only: refresh each client every N ticks (deadline
    # wheel staggered by row). 1 refreshes everyone every tick — the
    # per-client path's cadence and the parity default. Million-client
    # scenarios raise it so a tick's due set is population/N.
    refresh_spread: int = 1
    # Back every server's resources with the native C++ store engine
    # (falls back to the Python store when the build is unavailable).
    native_store: bool = False
    # Streaming clients as (band, wants) pairs (WatchCapacity leg).
    stream_clients: tuple = ()
    # Serving-plane pool (doorman_tpu_torch/frontend/): N listener workers
    # fanning WatchCapacity pushes through per-worker shared-memory
    # rings; 0 keeps the single-process in-server streaming path.
    frontend_workers: int = 0
    # Per-worker ring capacity in bytes (only read when workers > 0).
    frontend_ring: int = 1 << 20
    # Stream-shard count (stable client hash -> shard -> worker); >1 is
    # what spreads streams across the pool's workers.
    stream_shards: int = 1
    # -- load shapes ----------------------------------------------------
    generators: Tuple[GeneratorSpec, ...] = ()
    # -- predictive admission -------------------------------------------
    # {"period": P, "alpha": a, "beta": b, "engine": "auto"}; None keeps
    # the controller purely reactive.
    predictive: tuple = ()
    # -- measurement ----------------------------------------------------
    # Reconvergence: snapshot base clients at baseline_tick, expect the
    # snapshot to match again by heal_tick + the gate's budget. None
    # disables the reconvergence leg.
    baseline_tick: Optional[int] = None
    heal_tick: Optional[int] = None
    # Ticks whose top-band satisfaction feeds the "stress" scalar
    # (e.g. the crowd windows of later flash-crowd cycles).
    stress_ticks: tuple = ()
    # SLO gates: {gate_name: target}; see harness._build_specs for the
    # known gate names.
    gates: tuple = ()

    # -- accessors (thawed views of the frozen fields) ------------------

    def admission_kwargs(self) -> Dict[str, Any]:
        out = _thaw(self.admission)
        return out if isinstance(out, dict) else {}

    def federated_config(self) -> Optional[Dict[str, Any]]:
        out = _thaw(self.federated)
        return out if isinstance(out, dict) and out else None

    def predictive_config(self) -> Optional[Dict[str, Any]]:
        out = _thaw(self.predictive)
        return out if isinstance(out, dict) and out else None

    def gate_targets(self) -> Dict[str, float]:
        out = _thaw(self.gates)
        return out if isinstance(out, dict) else {}

    def with_(self, **changes) -> "WorkloadSpec":
        """replace() with the spec's freezing applied to dict-valued
        fields, so scenario factories can stay readable."""
        for key in (
            "admission", "federated", "predictive", "gates",
        ):
            if key in changes and isinstance(changes[key], Mapping):
                changes[key] = _freeze(changes[key])
        if "generators" in changes:
            changes["generators"] = tuple(changes["generators"])
        for key in (
            "base_clients", "base_population", "stream_clients",
            "stress_ticks",
        ):
            if key in changes:
                changes[key] = _freeze(changes[key])
        return replace(self, **changes)

    @classmethod
    def make(cls, name: str, ticks: int, **kw) -> "WorkloadSpec":
        return cls(name=name, ticks=int(ticks)).with_(**kw)

    def as_dict(self) -> Dict[str, Any]:
        out = asdict(self)
        for key in (
            "admission", "federated", "predictive", "gates",
        ):
            out[key] = _thaw(out[key]) or {}
        for key in (
            "base_clients", "base_population", "stream_clients",
            "stress_ticks",
        ):
            out[key] = _thaw(out[key]) or []
        out["generators"] = [
            {"kind": g.kind, "params": _thaw(g.params) or {}}
            for g in self.generators
        ]
        return out

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "WorkloadSpec":
        data = dict(data)
        gens = tuple(
            GeneratorSpec.make(g["kind"], **(g.get("params") or {}))
            for g in data.pop("generators", [])
        )
        name = data.pop("name")
        ticks = data.pop("ticks")
        return cls.make(name, ticks, **data).with_(generators=gens)
