"""Fault plans: the replayable artifact of a chaos run.

A FaultPlan is a seeded, timestamped (in TICKS of virtual time) list of
fault events plus the topology the run is driven against. Everything a
run needs is IN the plan — seed, topology, fault schedule, convergence
budget — so a failing run's plan serializes to JSON, ships in a bug
report, and replays byte-identically (tests/test_chaos_plan.py pins the
round trip; the runner pins the replayed event log).

Event model: an event STARTS a fault at `at_tick` for `duration_ticks`
ticks (0 = a one-shot action applied immediately, e.g. expiring the
election lock). Count-limited faults ("drop the next N calls") carry
the budget in params["calls"]; the injector consumes it. `target`
scopes the fault to one injector ("s0" — server s0's KV; "link:root" —
the intermediate<->root gRPC hop); "*" matches every injector of that
kind.

Port of doorman_tpu/chaos/plan.py: a copy apart from import paths.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List

# Fault kinds the injectors understand (doorman_tpu_torch/chaos/injectors.py).
KINDS = frozenset(
    {
        # election / lease-KV seam (ChaosLeaseKV)
        "kv_drop",          # every KV round-trip raises (transport fault)
        "kv_delay",         # params: {"seconds": s} real delay per call
        "kv_expire_lock",   # action: drop the lock as if its TTL lapsed
        # etcd gateway seam (ChaosEtcdGateway over the real HTTP dialect)
        "etcd_drop",        # params: {"calls": n} drop the next n round-trips
                            # (omit for "all while active")
        "etcd_delay",       # params: {"seconds": s}
        "etcd_watch_stall", # watches hang until their timeout
        # gRPC seam (ChaosGrpcProxy between client<->server hops)
        "grpc_drop",        # abort UNAVAILABLE
        "grpc_delay",       # params: {"seconds": s}
        "grpc_not_master",  # spurious NOT_MASTER: params: {"master": addr}
        # solver / backend seam (SolverInjector)
        "solver_error",     # device solve raises (tunnel down)
        "solver_slow",      # params: {"seconds": s} per solve
        "resident_overflow",# params: {"calls": n} ResidentOverflow per step
        "grant_corrupt",    # silently scale one row of the solve's
                            # grants; params: {"row": i, "factor": f}
                            # — the shadow auditor's prey
        # host seam
        "port_bind",        # action: bind a loopback port (stale server)
        "backend_probe_fail",  # utils.backend probe argv fails
        # client seam (driven by the runner, not an injector): a swarm
        # of extra clients hammers GetCapacity refreshes every tick
        # while active; params: {"clients": n, "wants": w,
        # "priority": band}. Storm clients release on heal.
        "client_storm",
        # federation seam (driven by the runner's federated beat):
        # target shard server (e.g. "s1") is unreachable from the
        # straddle reconciler while active — its share stops renewing,
        # coasts to its ttl, then the shard decays to zero capacity.
        "shard_partition",
        # fleet seam (setup["federated"]["fleet"] arms a
        # FleetController over the provisioned servers): action —
        # publish a new routing epoch serving params["to"] shards of
        # the pool. Grow re-splits the straddle shares to include the
        # new shard; shrink freezes the departed shard's share and
        # drains it through expiry + lease length (the deliberate
        # partition). params: {"to": m}.
        "fleet_reshard",
        # serving-plane seam (setup["frontend_workers"] arms an inline
        # frontend pool; doorman_tpu_torch/frontend/):
        # a listener worker dies while active — its WatchCapacity
        # streams reset to a redirect (never a silent lapse), its
        # stream shards reassign to survivors; the worker restarts at
        # heal with a fresh ring cursor (no replay). params:
        # {"worker": i}.
        "worker_crash",
        # a worker's ring pump freezes while active (the worker is
        # alive but not draining its ring); a long enough stall laps
        # the reader and the resume pump resets every held stream
        # loudly. params: {"worker": i}.
        "ring_stall",
    }
)


@dataclass(frozen=True)
class FaultEvent:
    at_tick: int
    kind: str
    target: str = "*"
    duration_ticks: int = 1  # 0 = instantaneous action
    params: Dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.at_tick < 0 or self.duration_ticks < 0:
            raise ValueError("at_tick/duration_ticks must be >= 0")


@dataclass(frozen=True)
class FaultPlan:
    """A complete, self-contained chaos scenario."""

    name: str
    seed: int
    # Topology + config the runner builds (see runner.ChaosRunner):
    #   servers: int            root election candidates (>=1)
    #   clients: int            client count
    #   wants: [float]          per-client demand (len == clients)
    #   capacity: float         the one resource's capacity
    #   safe_capacity: float    optional
    #   mode: "immediate"|"batch"
    #   lease_length/refresh_interval/learning_mode_duration: seconds
    #   election_ttl: float     virtual seconds
    #   intermediate: bool      add an intermediate hop clients attach to
    #   persist: bool           shared snapshot+journal backend across
    #                           the candidates (warm master takeover)
    #   snapshot_interval: float  virtual seconds between snapshots
    setup: Dict
    events: List[FaultEvent] = field(default_factory=list)
    warmup_ticks: int = 5      # fault-free ticks before the first event;
                               # the baseline allocation snapshots here
    total_ticks: int = 30      # ticks driven with the fault schedule
    reconverge_ticks: int = 10 # post-heal budget to match the baseline
    tick_interval: float = 1.0 # virtual seconds per tick

    def __post_init__(self):
        for ev in self.events:
            if ev.at_tick < self.warmup_ticks:
                raise ValueError(
                    f"event {ev.kind!r} at tick {ev.at_tick} lands inside "
                    f"the warmup ({self.warmup_ticks} ticks): the baseline "
                    "snapshot must be fault-free"
                )

    # -- schedule helpers ----------------------------------------------

    def events_at(self, tick: int) -> List[FaultEvent]:
        return [ev for ev in self.events if ev.at_tick == tick]

    @property
    def heal_tick(self) -> int:
        """First tick with every fault expired (actions count as their
        start tick)."""
        end = self.warmup_ticks
        for ev in self.events:
            end = max(end, ev.at_tick + ev.duration_ticks)
        return end

    # -- serialization --------------------------------------------------
    # Canonical form: sorted keys, no whitespace variance. to_json is a
    # fixpoint of from_json∘to_json — the replay artifact is byte-stable.

    def to_dict(self) -> Dict:
        d = asdict(self)
        d["events"] = [asdict(ev) for ev in self.events]
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":")) + "\n"

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultPlan":
        d = dict(d)
        d["events"] = [FaultEvent(**ev) for ev in d.get("events", [])]
        return cls(**d)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())
