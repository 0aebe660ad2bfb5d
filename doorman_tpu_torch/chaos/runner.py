"""The chaos runner: drive the real stack through a FaultPlan.

Everything runs in-process, but nothing is mocked:
real CapacityServer instances serve real gRPC on loopback (through
ChaosGrpcProxy hops), real Client instances refresh leases, the
election runs the real TTL-lock protocol over a LeaseKV, and batch
servers run the real device solve. What makes a run DETERMINISTIC is
that no component owns a timer: the runner advances one shared
ChaosClock tick by tick and explicitly steps every periodic loop
(election renewal, parent refresh, batch tick, client refresh) in a
fixed order, so the same plan + seed replays the same event log
byte-for-byte.

Stepping an election rather than running KVElection's sleep-based loops
keeps the protocol (campaign with acquire, renew every ttl/3, lose on
failed renewal, broadcast the holder) and the EtcdKV renewal-retry
tolerance (one transient transport failure retries; definite losses
never do) while moving the cadence into virtual time.

Port of doorman_tpu/chaos/runner.py: a copy apart from import paths,
`device` and `_log_restores`.
  * The reference's servers ran on JAX's default platform. Here every
    CapacityServer the runner builds (the candidates and the
    intermediate) takes the runner's `device`: "cuda" unless the caller
    asks for "cpu", raising through `resolve_device` without a GPU.
  * `_log_restores` tells a new restore summary from the one it logged
    by identity. The reference keys its logged summaries by `id()`; a
    summary freed at the next mastership flip can hand its id to the
    next one, whose restore then goes unlogged, so the event log of a
    warm-takeover plan could differ between two runs of one seed.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import random
from typing import Dict, List, Optional

from doorman_tpu_torch.chaos.clock import ChaosClock
from doorman_tpu_torch.chaos.injectors import (
    ChaosGrpcProxy,
    ChaosLeaseKV,
    FaultInjected,
    FaultState,
    PortInjector,
    SolverInjector,
)
from doorman_tpu_torch.chaos.invariants import InvariantChecker, Violation
from doorman_tpu_torch.chaos.plan import FaultPlan
from doorman_tpu_torch.client.client import Client
from doorman_tpu_torch.client.connection import Connection
from doorman_tpu_torch.obs import metrics as metrics_mod
from doorman_tpu_torch.obs import slo as slo_mod
from doorman_tpu_torch.obs import trace as trace_mod
from doorman_tpu_torch.obs.detect import AnomalyDetector
from doorman_tpu_torch.obs.flightrec import FlightRecorder, store_digest
from doorman_tpu_torch.obs.history import HistoryStore
from doorman_tpu_torch.server.config import parse_yaml_config
from doorman_tpu_torch.server.election import (
    Election,
    InMemoryKV,
    TrivialElection,
    shard_lock_key,
)
from doorman_tpu_torch.server.server import CapacityServer
from doorman_tpu_torch.utils.backend import resolve_device

LOCK = "/chaos/master"
RESOURCE = "r0"
# Events of these kinds happen once when applied, instead of arming a
# fault window on the switchboard.
ACTIONS = frozenset({"kv_expire_lock", "port_bind", "fleet_reshard"})


class SteppedElection(Election):
    """KVElection's TTL-lock state machine, driven by explicit step()
    calls in virtual time (see module docstring)."""

    def __init__(self, kv, lock: str, *, ttl: float, clock):
        self._kv = kv
        self._lock = lock
        self._ttl = ttl
        self._clock = clock
        self._id: Optional[str] = None
        self._cb_master = None
        self._cb_current = None
        self.is_master = False
        self._next_renew = 0.0
        self._last_current: Optional[str] = None

    def __str__(self) -> str:
        return f"stepped kv lock: {self._lock} (ttl {self._ttl}s)"

    async def run(self, id, on_is_master, on_current) -> None:
        self._id = id
        self._cb_master = on_is_master
        self._cb_current = on_current

    async def step(self, *, campaign: bool = True) -> None:
        now = self._clock()
        if self.is_master:
            if now >= self._next_renew:
                if await self._refresh_with_retry():
                    self._next_renew = now + self._ttl / 3.0
                else:
                    self.is_master = False
                    await self._cb_master(False)
        elif campaign:
            try:
                won = await self._kv.acquire(self._lock, self._id, self._ttl)
            except FaultInjected:
                won = False
            if won:
                self.is_master = True
                self._next_renew = now + self._ttl / 3.0
                await self._cb_master(True)
        # The watcher half: broadcast the current holder. A dropped
        # read keeps the last known value (exactly what a partitioned
        # watcher would believe).
        try:
            current = await self._kv.get(self._lock) or ""
        except FaultInjected:
            current = self._last_current or ""
        if current != self._last_current:
            self._last_current = current
            await self._cb_current(current)

    async def abdicate(self) -> None:
        """Graceful step-down (a rolling deploy's drain): flip the
        mastership state and tell the server, without touching the KV —
        the caller decides whether the lock is also released (expire)
        or left to lapse. With step(campaign=False) the candidate stays
        out of the next election until it rejoins."""
        if self.is_master:
            self.is_master = False
            await self._cb_master(False)

    async def _refresh_with_retry(self) -> bool:
        """One transient transport failure retries within the renewal
        window (the stepped mirror of EtcdKV.refresh's tolerance); a
        second failure — or a definite loss — reads as mastership
        lost."""
        for attempt in range(2):
            try:
                return await self._kv.refresh(self._lock, self._id, self._ttl)
            except FaultInjected:
                pass
        return False


async def _cancel_background(server: CapacityServer) -> None:
    """The runner owns all cadence: server-internal timer loops (batch
    tick, parent updater) must not race the stepped schedule."""
    for t in server._tasks:
        t.cancel()
    for t in server._tasks:
        try:
            await t
        except (asyncio.CancelledError, Exception):
            pass
    server._tasks.clear()


class ChaosRunner:
    """Builds the plan's topology, drives it tick by tick, and returns
    a JSON-able verdict."""

    def __init__(self, plan: FaultPlan, device="cuda"):
        self.plan = plan
        # Resolved now, so a CUDA request without a GPU raises before
        # any server or socket exists.
        self.device = resolve_device(device)
        self.clock = ChaosClock()
        self.state = FaultState(plan.seed)
        self.ports = PortInjector()
        self.bound_ports: List[int] = []
        self.servers: Dict[str, CapacityServer] = {}
        self.proxies: Dict[str, ChaosGrpcProxy] = {}
        self.elections: Dict[str, SteppedElection] = {}
        self.clients: List[Client] = []
        # Streaming leg (setup["streams"]): WatchCapacity subscribers
        # stepped deterministically each tick (stream_step: drain the
        # pushes already in flight, poll fallback when the stream is
        # down or silent); they ride every invariant check but stay out
        # of the baseline/convergence snapshots like the storm swarm.
        self.stream_clients: List[Client] = []
        # Storm swarm (client_storm events): created when the storm
        # arms, refreshed every storm tick AFTER the base clients,
        # closed (releasing) when it clears.
        self.storm_clients: List[Client] = []
        # Serving-plane pools (setup["frontend_workers"]): an inline
        # frontend pool per streaming server — pushes ride per-worker
        # rings and a worker-core pump on the virtual clock, so the
        # worker_crash / ring_stall fault kinds drive the same code the
        # real listener processes run, byte-stably.
        self.frontends: Dict[str, object] = {}
        self._fe_crashed: Dict[str, set] = {}
        self._fe_stalled: Dict[str, set] = {}
        self._frontend_final: Dict[str, dict] = {}
        self._attach: str = ""
        self._admission_last: Dict[str, tuple] = {}
        self.kv: Optional[InMemoryKV] = None
        # Shared persistence backend (setup["persist"]): every election
        # candidate snapshots/journals to the SAME store, modeling the
        # shared filesystem / etcd prefix a real warm-takeover
        # deployment needs.
        self.persist_backend = None
        # Federated topology (setup["federated"]): each server is a
        # root shard with its OWN election lock (shard_lock_key) and
        # its own persist namespace; the coordinator runs the straddle
        # reconciliation beat in the stepped schedule, and the
        # shard_partition fault kind blocks one shard from it.
        self.federation = None  # Optional[federation.FederatedRoots]
        self._shard_backends: Dict[int, object] = {}
        # Blast-radius guard: healthy clients' capacities snapshotted
        # at partition start; a healthy client dropping below it while
        # the fault is active is a shard_blast_radius violation.
        self._fed_guard: Optional[Dict[str, float]] = None
        self._fed_last_shares: Dict[str, dict] = {}
        # The last restore summary logged per server, held so that a
        # new summary is told apart by identity (an id() of a freed
        # summary can be reused by the next one).
        self._logged_restores: Dict[str, dict] = {}
        self.log: List[list] = []
        self.violations: List[Violation] = []
        # The run's black box: one record per VIRTUAL tick, built only
        # from deterministic fields (virtual time, masters, admission
        # tallies, store digests) so a violation dump is byte-stable
        # across replays of the same seeded plan. Dumped on the FIRST
        # violation (the trigger that needs explaining); the dump lands
        # in the verdict as `flightrec_dump`.
        self.flightrec = FlightRecorder(
            capacity=plan.total_ticks + 8,
            component=f"chaos:{plan.name}",
            clock=self.clock,
        )
        self.flight_dump: Optional[dict] = None
        # The same per-tick records flow into an in-memory history
        # store (no directory: ring + decimated tiers only), so the
        # verdict can carry the anomaly detector's windowed view of
        # the run — deterministic, because the records are.
        self.history = HistoryStore(
            ring=plan.total_ticks + 8,
            component=f"chaos:{plan.name}",
            clock=self.clock,
        )
        # Last shadow-audit divergence count seen per server, for
        # event-log deltas the tick they fire.
        self._audit_last: Dict[str, int] = {}
        # Fault / violation tallies in the default registry, so a chaos
        # run's damage shows on the same /metrics surface as everything
        # else (and soaks can assert on them).
        reg = metrics_mod.default_registry()
        self._faults_counter = reg.counter(
            "doorman_chaos_faults_injected",
            "Fault events applied by the chaos runner, by kind.",
            labels=("kind",),
        )
        self._violations_counter = reg.counter(
            "doorman_chaos_invariant_violations",
            "Invariant violations observed by the chaos runner.",
            labels=("invariant",),
        )

    def _record_violation(self, v: Violation) -> None:
        self.violations.append(v)
        self._violations_counter.inc(v.invariant)

    # -- setup ----------------------------------------------------------

    def _config_yaml(self) -> str:
        s = self.plan.setup
        safe = s.get("safe_capacity")
        safe_line = f"  safe_capacity: {safe}\n" if safe is not None else ""
        # algorithm_variant selects a portfolio lane sharing a wire
        # kind (e.g. FAIR_SHARE + maxmin -> MAX_MIN_FAIR); it rides the
        # config's `variant` parameter like any real deployment would.
        variant = s.get("algorithm_variant")
        variant_part = (
            ", parameters: [{name: variant, value: "
            f"{variant}" "}]"
            if variant
            else ""
        )
        return (
            "resources:\n"
            f"- identifier_glob: \"*\"\n"
            f"  capacity: {s.get('capacity', 100)}\n"
            + safe_line
            + "  algorithm: {"
            + f"kind: {s.get('algorithm', 'PROPORTIONAL_SHARE')}, "
            + f"lease_length: {s.get('lease_length', 60)}, "
            + f"refresh_interval: {s.get('refresh_interval', 1)}, "
            + f"learning_mode_duration: {s.get('learning_mode_duration', 3)}"
            + variant_part
            + "}\n"
        )

    async def _setup(self) -> None:
        s = self.plan.setup
        self.kv = InMemoryKV(clock=self.clock)
        config = parse_yaml_config(self._config_yaml())
        if s.get("persist"):
            from doorman_tpu_torch.persist.backend import MemoryBackend

            self.persist_backend = MemoryBackend()
        fed = s.get("federated")
        for i in range(int(s.get("servers", 1))):
            name = f"s{i}"
            proxy = ChaosGrpcProxy(self.state, link=f"link:{name}")
            await proxy.start()
            # Federated: each server IS a shard and campaigns for its
            # own shard-suffixed lock — N concurrent masters by design.
            lock = shard_lock_key(LOCK, i) if fed else LOCK
            election = SteppedElection(
                ChaosLeaseKV(self.kv, self.state, name),
                lock, ttl=float(s.get("election_ttl", 3.0)),
                clock=self.clock,
            )
            persist = None
            backend = self.persist_backend
            if backend is not None and fed:
                # Per-shard durability namespace: candidates of one
                # shard share a backend; shards never share.
                from doorman_tpu_torch.persist.backend import MemoryBackend

                backend = self._shard_backends.setdefault(
                    i, MemoryBackend()
                )
            if backend is not None:
                from doorman_tpu_torch.persist import PersistManager

                persist = PersistManager(
                    backend,
                    snapshot_interval=float(
                        s.get("snapshot_interval", 3.0)
                    ),
                    flush_interval=self.plan.tick_interval,
                    clock=self.clock,
                )
            admission = None
            if s.get("admission"):
                from doorman_tpu_torch.admission import Admission

                a = dict(s["admission"])
                # The plan's seeded RNG is the run's ONLY randomness
                # (FaultState docstring); admission's admit draws come
                # from it so shed decisions replay byte-identically.
                admission = Admission(
                    coalesce_window=float(a.pop("coalesce_window", 0.0)),
                    clock=self.clock,
                    rng=self.state.rng,
                    **a,
                )
            server = CapacityServer(
                proxy.address, election,
                mode=s.get("mode", "immediate"),
                tick_interval=self.plan.tick_interval,
                minimum_refresh_interval=0.0,
                clock=self.clock,
                native_store=bool(s.get("native_store", False)),
                persist=persist,
                admission=admission,
                # Streaming leg: every candidate serves WatchCapacity
                # (the runner drives the fanout beat explicitly).
                stream_push=bool(s.get("streams")),
                stream_shards=int(s.get("stream_shards", 1)),
                shard=i if fed else None,
                # Shadow audit (setup["audit_sample"]): comparisons run
                # INLINE on the virtual clock so divergence counts land
                # on deterministic ticks and the verdict stays
                # byte-stable across replays.
                audit_sample=int(s.get("audit_sample", 0)),
                audit_inline=True,
                device=self.device,
            )
            SolverInjector(self.state, name).install(server)
            await server.start(0, host="127.0.0.1")
            await _cancel_background(server)
            proxy.backend = server
            await server.load_config(config)
            if s.get("frontend_workers") and s.get("streams"):
                self.frontends[name] = server.attach_frontend(
                    int(s["frontend_workers"]),
                    ring_bytes=int(s.get("frontend_ring", 1 << 20)),
                )
                self._fe_crashed[name] = set()
                self._fe_stalled[name] = set()
            self.servers[name] = server
            self.proxies[name] = proxy
            self.elections[name] = election

        if fed and fed.get("fleet"):
            # Fleet runtime: every configured server is PROVISIONED,
            # only the first `active` serve the beat; fleet_reshard
            # events move the boundary live.
            from doorman_tpu_torch.fleet import FleetController

            self.federation = FleetController(
                {
                    i: self.servers[f"s{i}"]
                    for i in range(int(s.get("servers", 1)))
                },
                straddle=fed.get("straddle", ()),
                overrides=fed.get("overrides"),
                active=fed.get("active"),
                share_ttl=float(fed.get("share_ttl", 2.0)),
                clock=self.clock,
            )
        elif fed:
            from doorman_tpu_torch.federation import FederatedRoots, ShardRouter

            router = ShardRouter(
                int(s.get("servers", 1)),
                straddle=fed.get("straddle", ()),
                overrides=fed.get("overrides"),
            )
            self.federation = FederatedRoots(
                router,
                {
                    i: self.servers[f"s{i}"]
                    for i in range(router.n_shards)
                },
                share_ttl=float(fed.get("share_ttl", 2.0)),
                clock=self.clock,
            )

        attach = self.proxies["s0"].address
        if s.get("intermediate"):
            proxy = ChaosGrpcProxy(self.state, link="link:inter")
            await proxy.start()
            inter = CapacityServer(
                proxy.address, TrivialElection(),
                parent_addr=self.proxies["s0"].address,
                mode="immediate",
                minimum_refresh_interval=0.0,
                clock=self.clock,
                device=self.device,
            )
            # Bounded parent refreshes: the runner retries next tick
            # instead of letting the connection retry-forever inside one.
            inter._parent_conn = Connection(
                inter.parent_addr, minimum_refresh_interval=0.0,
                max_retries=0,
            )
            await inter.start(0, host="127.0.0.1")
            await _cancel_background(inter)
            proxy.backend = inter
            if s.get("skip_intermediate_learning", True):
                # The self-config default template carries a 20s
                # learning window; an intermediate that just booted
                # (not failed over) has no state to relearn.
                inter.became_master_at -= 10_000.0
            self.servers["inter"] = inter
            self.proxies["inter"] = proxy
            attach = proxy.address

        wants = s.get("wants") or [
            10.0 * (i + 1) for i in range(int(s.get("clients", 3)))
        ]
        priorities = s.get("priorities") or [0] * len(wants)
        # Federated: clients place onto shards per the plan (the
        # straddling resource is served by EVERY shard; which one a
        # client talks to is its locality).
        client_shards = (fed or {}).get("client_shards") or [None] * len(
            wants
        )
        self._attach = attach
        self._client_shard: Dict[str, Optional[int]] = {}
        for i, (w, p) in enumerate(zip(wants, priorities)):
            addr = attach
            shard = client_shards[i]
            if shard is not None:
                addr = self.proxies[f"s{int(shard)}"].address
            client = Client(
                addr, f"c{i}", minimum_refresh_interval=0.0,
                max_retries=0, clock=self.clock,
            )
            self._client_shard[client.id] = (
                int(shard) if shard is not None else None
            )
            await client.resource(RESOURCE, float(w), priority=int(p))
            self.clients.append(client)
        stream_wants = s.get("stream_wants") or [
            10.0 for _ in range(int(s.get("streams", 0)))
        ]
        for i, w in enumerate(stream_wants[: int(s.get("streams", 0))]):
            # Seeded retry jitter: shed/backoff pacing replays exactly.
            client = Client(
                attach, f"w{i}", minimum_refresh_interval=0.0,
                max_retries=0, clock=self.clock, stream=True,
                retry_rng=random.Random(self.plan.seed * 1000 + i),
            )
            await client.resource(RESOURCE, float(w))
            self.stream_clients.append(client)

    async def _teardown(self) -> None:
        # Snapshot serving-plane status before the pools close (their
        # ring buffers are released by server.stop()).
        self._frontend_final = {
            name: pool.status()
            for name, pool in sorted(self.frontends.items())
        }
        for client in self.clients + self.stream_clients + self.storm_clients:
            try:
                await client.close()
            except Exception:
                pass
        for proxy in self.proxies.values():
            await proxy.stop()
        for server in self.servers.values():
            try:
                await server.stop()
            except Exception:
                pass
        self.ports.release_all()

    # -- the drive ------------------------------------------------------

    def _apply_event(self, ev, tick: int) -> None:
        if ev.kind == "kv_expire_lock":
            self.kv.expire(LOCK)
        elif ev.kind == "port_bind":
            self.bound_ports.append(self.ports.bind())
        elif ev.kind == "fleet_reshard":
            # Live reshard: publish the new epoch now; this tick's
            # reconcile beat (which runs after events apply) already
            # sees the new active set.
            change = self.federation.reshard(int(ev.params["to"]))
            self.log.append([tick, "fleet_epoch", change.as_log()])
        else:
            self.state.start(ev)
        self._faults_counter.inc(ev.kind)
        self.log.append(
            [tick, "fault", ev.kind, ev.target, ev.duration_ticks]
        )

    def _log_restores(self, tick: int) -> None:
        """Surface each master-takeover restore in the event log (once
        per summary object), keeping the entry deterministic: mode,
        lease count, journal completeness and learning outcomes only —
        no wall-clock or backend specifics."""
        for name, server in self.servers.items():
            lr = getattr(server, "last_restore", None)
            if lr is None or self._logged_restores.get(name) is lr:
                continue
            self._logged_restores[name] = lr
            learning = sorted(
                [rid, info["learning"]]
                for rid, info in lr.get("resources", {}).items()
            )
            self.log.append([
                tick, "restore", name, lr["mode"],
                lr["leases_restored"], bool(lr["clean_down"]), learning,
            ])

    async def _drive_storm(self, tick: int) -> None:
        """The client_storm seam: while the event is active, a swarm of
        extra clients refreshes every tick (after the base clients, so
        the baseline population is first through each admission
        window); when it clears, the swarm closes — releasing its
        leases through the never-shed ReleaseCapacity path."""
        params = self.state.active("client_storm", "*")
        if params is not None:
            if not self.storm_clients:
                n = int(params.get("clients", 10))
                wants = float(params.get("wants", 10.0))
                priority = int(params.get("priority", 0))
                for i in range(n):
                    client = Client(
                        self._attach, f"storm{i}",
                        minimum_refresh_interval=0.0,
                        max_retries=0, clock=self.clock,
                    )
                    await client.resource(
                        RESOURCE, wants, priority=priority
                    )
                    self.storm_clients.append(client)
                self.log.append([tick, "storm_start", n])
            admitted = 0
            for client in self.storm_clients:
                if await client.refresh_once():
                    admitted += 1
            self.log.append(
                [tick, "storm", admitted, len(self.storm_clients)]
            )
        elif self.storm_clients:
            swarm, self.storm_clients = self.storm_clients, []
            for client in swarm:
                await client.close()
            self.log.append([tick, "storm_end", len(swarm)])

    def _drive_frontend(self, tick: int) -> None:
        """The serving-plane fault seam: translate active worker_crash
        / ring_stall events into inline-pool faults, and heal them when
        the events clear. A crash drops the worker's streams to
        redirects the same tick (the clients' next stream_step chases
        them); a restore brings the worker back with a fresh ring
        cursor. A stall freezes the worker's pump; the resume pump
        surfaces the lap and resets loudly (logged by _drive_streams'
        pump entry)."""
        for name, pool in self.frontends.items():
            crashed = self._fe_crashed[name]
            params = self.state.active("worker_crash", name)
            if params is not None:
                worker = int(params.get("worker", 0))
                if worker not in crashed:
                    crashed.add(worker)
                    dropped = pool.crash(worker)
                    self.log.append(
                        [tick, "worker_crash", name, worker, dropped]
                    )
            elif crashed:
                for worker in sorted(crashed):
                    pool.restore(worker)
                    self.log.append(
                        [tick, "worker_restore", name, worker]
                    )
                crashed.clear()
            stalled = self._fe_stalled[name]
            params = self.state.active("ring_stall", name)
            if params is not None:
                worker = int(params.get("worker", 0))
                if worker not in stalled:
                    stalled.add(worker)
                    pool.stall(worker)
                    self.log.append([tick, "ring_stall", name, worker])
            elif stalled:
                for worker in sorted(stalled):
                    pool.unstall(worker)
                    self.log.append([tick, "ring_resume", name, worker])
                stalled.clear()

    async def _drive_streams(self, tick: int) -> None:
        """The streaming leg's per-tick beat: the master fans out lease
        deltas at the tick edge (the runner owns the cadence — server
        background loops are cancelled), then each stream client takes
        one deterministic stream_step (drain pushes, chase redirects,
        fall back to a poll while the stream is down or silent). One
        event-log entry per client per tick where anything happened, so
        the flap's terminate→redirect→poll→re-establish arc is pinned
        byte-for-byte by the determinism check. With a frontend pool
        attached, the fanout's ring frames are pumped to subscribers
        here (where a real worker's poll loop would have woken); pump
        anomalies — laps, deadline-wheel resets — get their own log
        entry."""
        if not self.stream_clients:
            return
        for server in self.servers.values():
            server.push_streams()
        for name, pool in self.frontends.items():
            stats = pool.pump_all()
            if stats["lapped"] or stats["corrupt"] or stats["stalled"]:
                self.log.append([
                    tick, "frontend_pump", name, stats["frames"],
                    stats["lapped"], stats["corrupt"], stats["stalled"],
                ])
        for client in self.stream_clients:
            out = await client.stream_step(drain_timeout=0.05)
            if out["events"] or out["pushes"]:
                self.log.append([
                    tick, "stream", client.id,
                    ",".join(out["events"]) or "push",
                    out["pushes"],
                ])

    def _drive_federation(self, tick: int) -> None:
        """The federated beat: translate active shard_partition faults
        into the coordinator's blocked set, run one reconciliation, and
        log share movements deterministically. Also arms/checks the
        blast-radius guard: while a partition is active, no client of a
        HEALTHY shard may fall below its pre-fault capacity — the whole
        point of per-shard mastership is that one shard's failure is
        one shard's outage."""
        if self.federation is None:
            return
        blocked = {
            shard
            for shard in range(self.federation.router.n_shards)
            if self.state.active("shard_partition", f"s{shard}")
            is not None
        }
        if blocked and not self.federation.blocked:
            # Partition begins: mark the timeline (the trace ring is
            # outside the verdict digests, so replays stay byte-stable)
            # and snapshot the healthy population.
            trace_mod.default_tracer().instant(
                "federation.partition", cat="chaos",
                args={"tick": tick, "shards": sorted(blocked)},
            )
            self._fed_guard = {
                key: value
                for key, value in self._snapshot().items()
                if self._client_shard.get(key.split("/", 1)[0])
                not in blocked
            }
        elif not blocked:
            self._fed_guard = None
        self.federation.blocked = blocked
        installed = self.federation.reconcile_once()
        for rid, shares in sorted(installed.items()):
            rounded = [
                [shard, round(value, 6)]
                for shard, value in sorted(shares.items())
            ]
            if self._fed_last_shares.get(rid) != rounded:
                self._fed_last_shares[rid] = rounded
                self.log.append([tick, "straddle", rid, rounded])

    def _check_blast_radius(self, tick: int) -> List[Violation]:
        """Healthy-shard clients must ride through a sibling shard's
        partition untouched (checked AFTER this tick's refreshes, like
        every other invariant)."""
        if self._fed_guard is None:
            return []
        out = []
        for key, value in self._snapshot().items():
            baseline = self._fed_guard.get(key)
            if baseline is not None and value < baseline - 1e-9:
                out.append(Violation(
                    tick, "shard_blast_radius", key,
                    f"healthy-shard client fell {baseline:.6f} -> "
                    f"{value:.6f} during a sibling shard's partition",
                ))
        return out

    def _log_admission(self, tick: int) -> None:
        """One deterministic event-log entry per server per tick where
        admission activity moved: GetCapacity admitted/shed deltas plus
        the controller level (rounded — the level is exact binary
        arithmetic on plan constants)."""
        for name, server in self.servers.items():
            adm = getattr(server, "_admission", None)
            if adm is None:
                continue
            admitted = shed = 0
            for (method, _band), counts in adm.tallies.items():
                if method == "GetCapacity":
                    admitted += counts["admitted"]
                    shed += counts["shed"]
            last = self._admission_last.get(name, (0, 0))
            if (admitted, shed) != last:
                self._admission_last[name] = (admitted, shed)
                self.log.append([
                    tick, "admission", name,
                    admitted - last[0], shed - last[1],
                    round(adm.controller.level, 6),
                ])

    def _flight_record(self, tick: int, masters: tuple,
                       violations: List[Violation]) -> None:
        """One deterministic black-box record per virtual tick, and the
        violation-triggered dump (first violation only: that is the
        failure the dump exists to explain; later ones are in the ring
        of the same dump or the event log)."""
        rec: dict = {
            "t": self.clock(),
            "tick": tick,
            "masters": list(masters),
            "digests": {
                name: store_digest(server.resources)
                for name, server in sorted(self.servers.items())
            },
        }
        admission = {}
        persist_seq = {}
        for name, server in sorted(self.servers.items()):
            adm = getattr(server, "_admission", None)
            if adm is not None:
                admitted = 0
                shed_by_band: Dict[str, int] = {}
                for (method, band), counts in adm.tallies.items():
                    if method != "GetCapacity":
                        continue
                    admitted += counts["admitted"]
                    if counts["shed"]:
                        shed_by_band[str(band)] = counts["shed"]
                admission[name] = {
                    "level": round(adm.controller.level, 6),
                    "admitted": admitted,
                    "shed_by_band": shed_by_band,
                }
            if server._persist is not None:
                persist_seq[name] = server._persist.journal.seq
        streams = {}
        for name, server in sorted(self.servers.items()):
            if server._streams is not None:
                # Per-tick stream-push load (registry counters reset on
                # read; chaos servers never run tick_once's recorder,
                # so this is the only consumer): deterministic ints —
                # message bytes are protobuf-serialized plan state.
                st = server._streams.take_tick_stats()
                streams[name] = {
                    "subscribers": st["subscribers"],
                    "deltas_pushed": st["deltas_pushed"],
                    "push_bytes": st["push_bytes"],
                }
        if admission:
            rec["admission"] = admission
        if streams:
            rec["streams"] = streams
        if self.frontends:
            # The serving plane on the black box: held streams and
            # crash/restore counts per pool (counters of virtual-clock
            # events, so byte-stable).
            rec["frontend"] = {
                name: {
                    "held": pool.held(),
                    "crashes": pool.crashes,
                    "restores": pool.restores,
                }
                for name, pool in sorted(self.frontends.items())
            }
        if self.federation is not None:
            # The federation beat on the black box: each shard's
            # installed straddle capacity (deterministic plan
            # arithmetic) — a partition reads as one shard's value
            # freezing and then vanishing while the others hold.
            rec["straddle_capacity"] = {
                name: round(
                    server.fed_stats["straddle_capacity"], 6
                )
                for name, server in sorted(self.servers.items())
                if getattr(server, "shard", None) is not None
            }
        if persist_seq:
            rec["persist_seq"] = persist_seq
        audited = [
            server.shadow_audit
            for _, server in sorted(self.servers.items())
            if getattr(server, "shadow_audit", None) is not None
        ]
        if audited:
            rec["audit_divergence"] = sum(a.divergences for a in audited)
        if violations:
            rec["violations"] = [v.as_log() for v in violations]
        self.flightrec.record(**rec)
        self.history.append(dict(rec))
        if violations and self.flight_dump is None:
            self.flight_dump = self.flightrec.dump(
                f"invariant:{violations[0].invariant}"
            )

    def _slo_block(self, converged_at: Optional[int],
                   heal_tick: int) -> dict:
        """Machine-readable SLO verdicts for the run: reconvergence
        ticks vs the plan's budget, and — on admission-enabled plans —
        the top-band goodput floor with the per-band tallies embedded.
        Deltas vs prior rounds come from the trajectory comparator
        (None until a prior BENCH round embedded the same verdict)."""
        plan = self.plan
        specs = [slo_mod.reconvergence_spec(
            plan.reconverge_ticks, name=f"{plan.name}:reconverge_ticks"
        )]
        band_tallies: Dict[int, Dict[str, int]] = {}
        for server in self.servers.values():
            adm = getattr(server, "_admission", None)
            if adm is None:
                continue
            for (method, band), counts in adm.tallies.items():
                if method != "GetCapacity":
                    continue
                entry = band_tallies.setdefault(
                    int(band), {"admitted": 0, "shed": 0, "fast_fail": 0}
                )
                for key in entry:
                    entry[key] += counts.get(key, 0)
        if band_tallies:
            specs.append(slo_mod.top_band_goodput_spec(
                name=f"{plan.name}:top_band_goodput"
            ))
        scalars = {}
        if converged_at is not None:
            scalars["reconverge_ticks"] = float(converged_at - heal_tick)
        verdicts = slo_mod.SloEngine(specs).evaluate(
            slo_mod.SloInputs(scalars=scalars, band_tallies=band_tallies)
        )
        for v in verdicts:
            if (
                v["slo"].endswith(":reconverge_ticks")
                and v["status"] == "no_data"
            ):
                # Never reconverged is a hard fail, not missing data.
                v["status"] = "fail"
                v["detail"] = {"note": "no reconvergence within the run"}
        comparator = slo_mod.TrajectoryComparator()
        for v in verdicts:
            v["delta_vs_prev"] = comparator.slo_delta(v)
        return {
            "ok": all(v["status"] != "fail" for v in verdicts),
            "verdicts": verdicts,
        }

    def _detect_block(self) -> Optional[dict]:
        """Replay the run's history records through the anomaly
        detector: a zero floor on the audit-divergence count (any
        nonzero value is anomalous, no warmup needed) plus a robust-z
        watch on each admission controller's level. Pure sorted-list
        arithmetic over deterministic records, so the block is
        byte-stable across replays. None when the plan arms neither
        the auditor nor admission."""
        recs = self.history.records()
        fields: List[str] = []
        if any("audit_divergence" in r for r in recs):
            fields.append("audit_divergence")
        adm_servers = sorted(
            {n for r in recs for n in r.get("admission", {})}
        )
        fields.extend(f"admission.{n}.level" for n in adm_servers)
        if not fields:
            return None
        return AnomalyDetector.scan_records(
            recs, tuple(fields), floors={"audit_divergence": 0.0}
        )

    def _snapshot(self) -> Dict[str, float]:
        return {
            f"{cl.id}/{rid}": res.current_capacity()
            for cl in self.clients
            for rid, res in cl.resources.items()
        }

    @staticmethod
    def _matches(a: Dict[str, float], b: Dict[str, float]) -> bool:
        return a.keys() == b.keys() and all(
            abs(a[k] - b[k]) <= 1e-9 for k in a
        )

    async def run(self) -> dict:
        plan = self.plan
        await self._setup()
        try:
            checker = InvariantChecker(
                self.clock,
                lease_length=float(plan.setup.get("lease_length", 60)),
            )
            if self.federation is not None:
                # Per-shard mastership: each shard campaigns for its
                # own lock, so each is its own single-master group.
                groups = [
                    [n] for n in self.servers if n.startswith("s")
                ]
            else:
                groups = [[n for n in self.servers if n.startswith("s")]]
            heal_tick = plan.heal_tick
            baseline: Optional[Dict[str, float]] = None
            converged_at: Optional[int] = None
            degraded = False
            last_masters: tuple = ()
            inter = self.servers.get("inter")

            for tick in range(plan.total_ticks):
                self.state.begin_tick(tick)
                for ev in plan.events_at(tick):
                    self._apply_event(ev, tick)
                if tick == heal_tick and plan.events:
                    self.log.append([tick, "heal"])

                for election in self.elections.values():
                    await election.step()
                self._log_restores(tick)
                masters = tuple(sorted(
                    n for n, srv in self.servers.items()
                    if n != "inter" and srv.is_master
                ))
                if masters != last_masters:
                    last_masters = masters
                    self.log.append([tick, "master", list(masters)])

                self._drive_federation(tick)

                if inter is not None:
                    await inter._perform_parent_requests(0)

                for name, server in self.servers.items():
                    if (
                        server.mode == "batch"
                        and server.is_master
                        and server.resources
                    ):
                        try:
                            await server.tick_once()
                        except Exception as e:
                            self.log.append(
                                [tick, "tick_error", name, str(e)]
                            )

                # Shadow-audit deltas land in the event log the tick
                # they fire (chaos auditors run inline, so counts are
                # current once tick_once returns): seeded replays pin
                # WHEN the auditor caught the corruption.
                for name, server in sorted(self.servers.items()):
                    aud = getattr(server, "shadow_audit", None)
                    if aud is None:
                        continue
                    if aud.divergences != self._audit_last.get(name, 0):
                        self._audit_last[name] = aud.divergences
                        self.log.append(
                            [tick, "audit_divergence", name,
                             aud.divergences]
                        )

                for client in self.clients:
                    await client.refresh_once()

                self._drive_frontend(tick)
                await self._drive_streams(tick)
                await self._drive_storm(tick)
                self._log_admission(tick)

                # The durability beat (journal flush + cadenced
                # snapshot) runs AFTER the tick's refreshes so this
                # tick's decides are on disk before the next tick — the
                # freshness bound warm takeover leans on.
                for server in self.servers.values():
                    server.persist_step()

                tick_violations = checker.check_tick(
                    tick, self.servers, groups,
                    # Active storm and stream clients are checked too:
                    # an admitted storm lease — or a pushed stream
                    # lease — is subject to lag-never-lead and the
                    # lease window like any other (baseline/convergence
                    # snapshots stay on the base population only).
                    self.clients + self.stream_clients
                    + self.storm_clients,
                )
                if self.federation is not None:
                    tick_violations = tick_violations + checker.check_federation(
                        tick, self.servers,
                        self.federation.straddle_capacities(),
                    ) + self._check_blast_radius(tick)
                for v in tick_violations:
                    self._record_violation(v)
                    self.log.append([tick] + v.as_log())

                if tick == plan.warmup_ticks - 1:
                    baseline = self._snapshot()
                if baseline is not None and not degraded:
                    # First tick where clients collectively hold LESS
                    # than the baseline: the fault visibly bit (plans
                    # assert this so they cannot pass vacuously).
                    total = sum(self._snapshot().values())
                    if total < sum(baseline.values()) - 1e-9:
                        degraded = True
                        self.log.append([tick, "degraded"])
                if (
                    baseline is not None
                    and converged_at is None
                    and tick >= heal_tick
                    and self._matches(self._snapshot(), baseline)
                ):
                    converged_at = tick
                    self.log.append(
                        [tick, "converged", tick - heal_tick]
                    )

                self._flight_record(tick, masters, tick_violations)
                self.clock.advance(plan.tick_interval)
        finally:
            await self._teardown()

        reconverged = converged_at is not None and (
            converged_at - heal_tick <= plan.reconverge_ticks
        )
        if converged_at is None and baseline is not None:
            self._record_violation(Violation(
                plan.total_ticks, "reconvergence", RESOURCE,
                f"no reconvergence within {plan.total_ticks - heal_tick} "
                f"post-heal ticks (budget {plan.reconverge_ticks})",
            ))
            self.log.append(
                [plan.total_ticks] + self.violations[-1].as_log()
            )
            # The end-of-run violation is a dump trigger like any other
            # (servers are stopped but their stores are still readable).
            self._flight_record(
                plan.total_ticks, last_masters, [self.violations[-1]]
            )
        log_bytes = json.dumps(
            self.log, sort_keys=True, separators=(",", ":")
        ).encode()
        # Final admission tallies per server (None when no server runs
        # the admission front-end): deterministic integers the storm
        # assertions read band by band.
        admission_tallies = {
            name: {
                f"{method}/{band}": dict(counts)
                for (method, band), counts in sorted(
                    server._admission.tallies.items()
                )
            }
            for name, server in self.servers.items()
            if getattr(server, "_admission", None) is not None
        } or None
        return {
            "plan": plan.name,
            "seed": plan.seed,
            "ok": not self.violations and reconverged,
            "ticks": plan.total_ticks,
            # For the Chrome-trace export: one virtual tick maps to this
            # many seconds of trace time (chaos.trace_export).
            "tick_interval": plan.tick_interval,
            "heal_tick": heal_tick,
            "converged_after_heal_ticks": (
                None if converged_at is None else converged_at - heal_tick
            ),
            "violations": [v.as_log() for v in self.violations],
            "admission": admission_tallies,
            # Serving-plane outcome per pooled server (None when the
            # plan arms no frontend pool): worker/ring counters and the
            # final stream placement — deterministic, virtual-clock
            # driven; snapshotted at teardown before the rings close.
            "frontend": self._frontend_final or None,
            # Shadow-audit outcome per audited server (None when the
            # plan doesn't arm the auditor): sample/divergence counts
            # and the bounded detail rows, byte-stable because chaos
            # auditors compare inline on virtual time.
            "audit": {
                name: server.shadow_audit.status()
                for name, server in sorted(self.servers.items())
                if getattr(server, "shadow_audit", None) is not None
            } or None,
            # The anomaly detector's windowed verdict over the run's
            # history records (None when there is nothing to watch).
            "detect": self._detect_block(),
            "history": self.history.status(),
            # Machine-readable SLO verdicts (reconvergence budget,
            # top-band goodput floor with per-band tallies), each with
            # its delta vs the last round that embedded the same verdict.
            "slo": self._slo_block(converged_at, heal_tick),
            # The black box: on any invariant violation the per-tick
            # ring is dumped here (None on a clean run) — its records
            # replay the last N ticks leading into the failure.
            "flightrec_dump": self.flight_dump,
            "event_log": self.log,
            "log_sha256": hashlib.sha256(log_bytes).hexdigest(),
        }


def run_plan(plan: FaultPlan, device="cuda") -> dict:
    """Synchronous convenience: build a runner, drive the plan, return
    the verdict."""
    return asyncio.run(ChaosRunner(plan, device=device).run())
