"""The capacity server (port of doorman_tpu/server/server.py: immediate
and batch mode, the Python and the native lease store, the resident
paths narrow and wide, fused and round-trip, the BatchSolver, streaming
lease push, and the capacity tree's root and intermediate roles).

Immediate mode (the default, as in the reference) answers each
GetCapacity with the scalar algorithm of its resource
(core.resource.decide): host-only, no device work and no tick loop.

Batch mode: requests only record demand (GetCapacity serves the last
solved grant, ReleaseCapacity drops the lease); a background tick
solves ALL resources at once on the device, and the grants land back in
the stores. On the native store, lane resources of up to DENSE_MAX_K
clients tick through the narrow resident solver
(solver.resident.ResidentDenseSolver), wider ones through the chunked
one (solver.resident_wide.WideResidentSolver); PRIORITY_BANDS
resources, with their capacity groups, tick through the BatchSolver
(solver.batch.BatchSolver) in the same executor call. When a narrow
resource outgrows its row mid-tick (ResidentOverflow), that tick runs
through the BatchSolver over every resource and the next one
re-partitions. On the Python store (the default) every resource ticks
through the BatchSolver: its pack and write-back stay on the event loop
and only the solve leaves it. Brand-new clients and resources in
learning mode are answered by the scalar first-response algorithm.
`fused_tick=False` runs the resident solvers' round-trip tick.

Stream push (`stream_push=True`): WatchCapacity holds one stream per
client and the tick edge pushes only the rows whose lease moved
(server/streams.py). On a native-store batch server the narrow resident
solver tracks deltas, and its changed rows are intersected on the device
with the subscription incidence (server/match.py); wide and
PRIORITY_BANDS rows, the Python store and immediate mode re-decide
their subscribers every tick.

The capacity tree: GetServerCapacity serves downstream servers. Each
(downstream server, priority band) is one sub-lease in the resource's
store (_band_key), so the batch tick solves bands as ordinary rows: K1/K2
over lane resources, K3 over PRIORITY_BANDS ones. A server built with
`parent_addr` is an intermediate: it starts from the default "*"
template (capacity 0), and its updater leases its capacity from the
parent with one GetServerCapacity per interval, aggregating its own
store by band, and re-templates its resources from the grants (each
resource's capacity falls to 0 once its parent lease expires).

What this port carries: both modes, both stores, the fused and the
round-trip tick (scoped by default), lane and PRIORITY_BANDS resources
of any width, capacity groups (batch mode only, as in the reference),
any Election (the trivial one, or server/election.py's KVElection over
etcd), durable lease state with warm master takeover (`persist=`, a
persist.PersistManager: every served lease and release is journaled,
the tick or a timer loop flushes and snapshots, and a new master
restores before it serves), the root and intermediate roles, a
federated root shard's seams (`shard=`, `set_straddle_share`, the flight
record's federation beat and `status()["federation"]`; the federation/
package drives them), RPC admission (`admission=`, an
admission.Admission: GetCapacity's coalescer, AIMD band shedding with
the retry-after trailer, deadline fast-fail, the WatchCapacity gate,
and with `fuse_admission` the coalescer's windows staging the resident
tick's rows), the serving-plane frontend pool (`attach_frontend`: the
push rings, listener workers and the establishment ramp), and the
Discovery / GetCapacity / GetServerCapacity / ReleaseCapacity /
WatchCapacity RPCs on the reference's wire service
(doorman_tpu.Capacity), and the reference's observability (obs/): the
RPC, tick, parent-exchange and fanout trace spans, the request hook and
request log, the per-tick flight recorder (on by default), the durable
history, the shadow audit, the anomaly detector, the SLO evaluation, the
debug pages' status, and a torch.profiler capture of the first
`profile_ticks` batch ticks (`profile_dir`), the fleet's epoch-aware
redirect (`set_fleet_routing`), and TLS on every hop: the gRPC port
(`start(tls_cert=, tls_key=)`), the frontend workers' public port
(`attach_frontend(tls_cert=, tls_key=)`) and the dial to the parent
(`parent_tls`, `parent_tls_ca`). Unlike the reference, asking for the
native store where it cannot be built is an error, not a switch to the
Python store.

Concurrency model: one asyncio loop owns all state; the tick's dispatch
and collect run in an executor thread (the native engine is
mutex-guarded; a Python-store tick sends only its solve there).
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import time
from typing import TYPE_CHECKING, Callable, Dict, List, Optional

import grpc
import numpy as np

from doorman_tpu_torch import native
from doorman_tpu_torch.admission.policy import RETRY_AFTER_KEY, Shed
from doorman_tpu_torch.algorithms import Request
from doorman_tpu_torch.algorithms.kinds import AlgoKind
from doorman_tpu_torch.client.connection import Connection
from doorman_tpu_torch.core.resource import Resource, algo_kind_for
from doorman_tpu_torch.obs import metrics as metrics_mod
from doorman_tpu_torch.obs import phases as phases_mod
from doorman_tpu_torch.obs import slo as slo_mod
from doorman_tpu_torch.obs import trace as trace_mod
from doorman_tpu_torch.obs.audit import ShadowAuditor
from doorman_tpu_torch.obs.detect import AnomalyDetector
from doorman_tpu_torch.obs.flightrec import FlightRecorder, digest_stores
from doorman_tpu_torch.obs.history import HistoryStore
from doorman_tpu_torch.obs.requests import RequestLog
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto import doorman_stream_pb2 as spb
from doorman_tpu_torch.proto.grpc_api import (
    CapacityServicer,
    add_capacity_servicer,
)
from doorman_tpu_torch.server import config as config_mod
from doorman_tpu_torch.server.election import Election
from doorman_tpu_torch.server.match import SubscriptionMatcher
from doorman_tpu_torch.solver import batch as batch_mod
from doorman_tpu_torch.solver.batch import BatchSolver
from doorman_tpu_torch.solver.engine import PipelinedTicker
from doorman_tpu_torch.solver.resident import (
    ResidentDenseSolver,
    ResidentOverflow,
)
from doorman_tpu_torch.solver.resident_wide import WideResidentSolver
from doorman_tpu_torch.utils import dispatch as dispatch_mod
from doorman_tpu_torch.utils.backend import device_info, resolve_device
from doorman_tpu_torch.utils.backoff import (
    MAX_BACKOFF,
    MIN_BACKOFF,
    VERY_LONG_TIME,
    backoff,
)

if TYPE_CHECKING:
    from doorman_tpu_torch.server.streams import StreamRegistry

log = logging.getLogger(__name__)

DEFAULT_PRIORITY = 1
# Matching reference defaults (server.go:42-90).
DEFAULT_INTERVAL = 1.0
# How often (at most) GetServerCapacity scans for vanished downstream
# servers' band-composition entries.
BAND_SWEEP_INTERVAL = 10.0

# Separator for per-band sub-lease keys. Control characters are rejected
# by request validation (config.validate_*), so band keys never collide
# with real clients; \x01 (not NUL) keeps the key a valid C string for
# the native store engine's interning table.
_BAND_SEP = "\x01band\x01"


def _band_key(server_id: str, priority: int) -> str:
    """Store key for one priority band of a downstream server's aggregate.

    The reference keeps the full band list on each server record
    (simulation/server.py:300-306); this design flattens each band into its
    own sub-lease so the batched solver sees bands as ordinary rows."""
    return f"{server_id}{_BAND_SEP}{priority}"


def default_resource_template() -> pb.ResourceTemplate:
    """The "*" template an intermediate server starts from
    (server.go:53-63)."""
    return pb.ResourceTemplate(
        identifier_glob="*",
        capacity=0.0,
        safe_capacity=0.0,
        algorithm=pb.Algorithm(
            kind=pb.Algorithm.FAIR_SHARE,
            refresh_interval=int(DEFAULT_INTERVAL),
            lease_length=20,
            learning_mode_duration=20,
        ),
    )


class CapacityServer(CapacityServicer):
    """A doorman server, immediate or batch mode, on the Python or the
    native lease store, with its batch tick on `device` ("cuda" by
    default; "cpu" only when asked): a root if `parent_addr` is empty,
    else an intermediate."""

    def __init__(
        self,
        server_id: str,
        election: Election,
        *,
        parent_addr: str = "",
        parent_tls: bool = False,
        parent_tls_ca: Optional[str] = None,
        mode: str = "immediate",  # "immediate" | "batch"
        tick_interval: float = 1.0,
        clock: Callable[[], float] = time.time,
        native_store: bool = False,
        solver_dtype: str = "f64",
        persist=None,  # Optional[doorman_tpu_torch.persist.PersistManager]
        fused_tick: bool = True,
        scoped_solve: bool = True,
        tick_pipeline_depth: int = 1,
        minimum_refresh_interval: float = 5.0,
        stream_push: bool = False,
        max_streams_per_band: int = 0,
        stream_shards: int = 1,
        profile_dir: Optional[str] = None,
        profile_ticks: int = 8,
        flightrec_capacity: int = 512,
        flightrec_dir: Optional[str] = None,
        history_dir: Optional[str] = None,
        history_capacity: int = 4096,
        audit_sample: int = 0,
        audit_inline: bool = False,
        detect: bool = False,
        shard: Optional[int] = None,
        admission=None,  # Optional[doorman_tpu_torch.admission.Admission]
        fuse_admission: bool = False,
        device="cuda",
        mesh=None,  # Optional[doorman_tpu_torch.parallel.Mesh]
    ):
        if mode not in ("immediate", "batch"):
            raise ValueError(f"unknown mode {mode!r}")
        if solver_dtype not in ("f32", "f64"):
            raise ValueError(f"unknown solver dtype {solver_dtype!r}")
        self.device = resolve_device(device)
        # Optional device mesh for the resident solvers: table rows
        # shard over its shards (solver.resident_mesh); store contents
        # stay byte-identical to the single-device tick.
        self._solver_mesh = mesh
        if native_store and not native.native_available():
            raise RuntimeError(
                "native store engine unavailable (g++ build failed?)"
            )
        self.id = server_id
        # Federation identity: which root shard this server is (None =
        # unsharded deployment). The shard index rides status() and
        # every flight-recorder tick record, so a federated fleet's
        # dumps and debug pages say which slice of the resource space
        # they describe. The shard's election lock and persist namespace
        # are the CALLER's job (election.shard_lock_key /
        # persist.parse_backend(namespace=...)); this field is identity,
        # not enforcement.
        self.shard = shard
        # Federation counters (the reconciler and the federated
        # intermediate's upstream exchange bump these): straddle-share
        # installs, the capacity those shares currently sum to, and
        # upstream RPCs issued, and the fleet's epoch-aware redirects
        # (GetCapacity answered with the new owner's address).
        self.fed_stats: Dict[str, float] = {
            "straddle_updates": 0,
            "straddle_capacity": 0.0,
            "upstream_rpcs": 0,
            "fleet_redirects": 0,
        }
        # resource id -> this shard's currently installed share (feeds
        # fed_stats["straddle_capacity"] as the sum over resources).
        self._straddle_shares: Dict[str, float] = {}
        # Fleet routing: resources an epoch moved AWAY from this shard,
        # mapped to the new owner's address ("" when unknown — the
        # client falls back to discovery). Replaced whole per epoch by
        # set_fleet_routing, so a resource that moves back simply
        # drops out of the table.
        self._fleet_routing: Dict[str, str] = {}
        self._fleet_epoch = 0
        self.election = election
        self.mode = mode
        self.tick_interval = tick_interval
        self.minimum_refresh_interval = minimum_refresh_interval
        self._clock = clock
        self.solver_dtype = solver_dtype
        self._native_store = bool(native_store)
        self._fused_tick = bool(fused_tick)
        self._scoped_solve = bool(scoped_solve)
        # Admission-fused staging: the coalescer's windows pre-pack their
        # touched rows into the resident solver's staging cache, moving
        # the store pack off the tick's critical path (engine.FusedStaging;
        # requires admission coalescing to be the write path).
        self._fuse_admission = bool(fuse_admission)
        # The Python store keeps both None: every Resource makes its own
        # core.store.LeaseStore.
        self._store_engine = None
        self._store_factory = None
        self._reset_store_engine()
        self.resources: Dict[str, Resource] = {}
        # Band composition of each downstream server's last request,
        # keyed (resource_id, server_id) -> set of wire priorities; used
        # to release band sub-leases the server stopped reporting (the
        # reference replaces the whole band list per request,
        # simulation/server.py:303-306).
        self._server_bands: Dict[tuple, set] = {}
        self._last_band_sweep = 0.0
        self.is_master = False
        self.became_master_at: float = 0.0
        # Counts every mastership transition (either direction); the
        # flight recorder stamps it on each tick record so a dump reader
        # can see exactly which ticks straddle a flip.
        self.mastership_epoch = 0
        # Durable lease-state snapshots + journal (persist/); None keeps
        # the reference's wipe-and-relearn behavior. The request path
        # journals every decide/release, the tick pipeline (or the
        # immediate-mode timer loop) flushes and snapshots, and
        # _on_is_master(True) restores for a warm takeover.
        self._persist = persist
        # Summary dict of the last takeover restore (status pages read
        # it); None when this server never restored or is not master.
        self.last_restore: Optional[dict] = None
        self.current_master = ""
        self.config: Optional[pb.ResourceRepository] = None
        # find_template's answers for self.config, set with it.
        self._templates: Optional[config_mod.TemplateIndex] = None
        self.is_configured = asyncio.Event()
        self.parent_addr = parent_addr
        self.parent_tls = parent_tls
        self.parent_tls_ca = parent_tls_ca
        # The updater's channel to the parent (created at its first
        # exchange).
        self._parent_conn: Optional[Connection] = None
        self._tasks: List[asyncio.Task] = []
        # At most one tick in flight (see tick_once).
        self._tick_lock = asyncio.Lock()
        # The resident solver and its in-flight tick pipeline: up to
        # `tick_pipeline_depth` ticks in flight, so tick N's delivery
        # download overlaps the staging and solve of the ticks after it.
        self._tick_pipeline_depth = max(int(tick_pipeline_depth), 1)
        self._resident: Optional[ResidentDenseSolver] = None
        self._resident_pipe = PipelinedTicker(self._tick_pipeline_depth)
        # The chunked solver of lane resources wider than DENSE_MAX_K,
        # with its own pipeline.
        self._resident_wide: Optional[WideResidentSolver] = None
        self._resident_wide_pipe = PipelinedTicker(self._tick_pipeline_depth)
        # The BatchSolver (lazily created): the PRIORITY_BANDS resources
        # every tick, every resource on an overflow tick. The tick's
        # narrow / wide / priority partition is recomputed when the
        # config epoch or the resource count moves, or after an
        # overflow (which clears the key).
        self._solver: Optional[BatchSolver] = None
        self._partition_key = None
        self._partition: "tuple[list, list, list]" = ([], [], [])
        self._wide_ids: set = set()
        # Bumped whenever templates / learning windows change outside the
        # stores; the resident solver caches its config reads against it.
        self._config_epoch = 0
        self._grpc_server: Optional[grpc.aio.Server] = None
        # The serving loop (set by start): the debug pages and the
        # metrics collector snapshot state on it (metrics.call_on_loop).
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.port: Optional[int] = None

        # RPC admission control (admission/): micro-batched GetCapacity
        # decisions, AIMD overload shedding by priority band, deadline
        # fast-fail. None serves every request inline — the reference's
        # only defense is client refresh cadence.
        self._admission = (
            admission.bind(self) if admission is not None else None
        )

        # Streaming lease push (server/streams.py): clients hold one
        # WatchCapacity stream instead of polling, and the tick-edge
        # fanout pushes only the rows whose lease moved. Off by default
        # (WatchCapacity answers UNIMPLEMENTED and clients fall back to
        # polling).
        self._streams: Optional[StreamRegistry] = None
        if stream_push:
            # Imported here, as in the reference: streams.py imports the
            # federation package (its stable shard hash), whose
            # aggregate.py subclasses this module's CapacityServer.
            from doorman_tpu_torch.server.streams import StreamRegistry

            self._streams = StreamRegistry(
                self, max_streams_per_band=max_streams_per_band,
                shards=stream_shards,
            )
        # Frontend serving pool (frontend/): the multi-process
        # SO_REUSEPORT listener plane. attach_frontend wires an inline or
        # process pool; the control surface registers on the backend
        # gRPC server at start(); the establishment ramp micro-batches
        # forwarded stream establishments.
        self._frontend = None
        self._frontend_control = None
        self._frontend_ramp = None
        # Delta bookkeeping for the fanout: ticks whose changes have no
        # tracked source (Python store, overflow tick, wide/priority
        # solver parts, config epoch moves) force a full subscription
        # check instead of the engine's changed-rid filter.
        self._stream_check_all = True
        self._stream_force_ids: set = set()
        self._stream_epoch_seen = -1
        self._rid_map_key = None
        self._rid_map: Dict[int, str] = {}
        # Device-side changed-row -> subscriber matching (server/
        # match.py): the incidence structure, the slot -> subscription
        # map, and the membership key the bindings were last synced
        # against. Native-store batch servers only (the Python-store
        # fanout is check_all every tick anyway).
        self._stream_matcher: Optional[SubscriptionMatcher] = None
        self._stream_slots: Dict[int, object] = {}
        self._stream_match_key = None
        # Resources currently in learning mode: their scalar decisions
        # move without store deliveries, so they ride the changed set
        # every tick. Rebuilt on membership/epoch moves, pruned as
        # learning windows lapse.
        self._stream_learning_key = None
        self._stream_learning: set = set()

        # Per-tick flight recorder (obs/flightrec.py): one structured
        # record per tick_once, auto-dumped on an unhandled tick
        # exception; /debug/flightrec serves the ring on demand.
        # flightrec_capacity=0 disables.
        self.flightrec: Optional[FlightRecorder] = (
            FlightRecorder(
                flightrec_capacity,
                component=f"server:{server_id}",
                clock=clock,
                dump_dir=flightrec_dir,
            )
            if flightrec_capacity > 0
            else None
        )
        # Continuous telemetry, all off by default: the durable history
        # of the flight records, the shadow auditor (every store
        # replayed through the numpy host oracles every `audit_sample`
        # ticks and on solve-mode transitions, off the hot path) and the
        # anomaly detector (robust z / pinned floors over each record).
        self.history: Optional[HistoryStore] = (
            HistoryStore(
                history_dir,
                ring=history_capacity,
                component=f"server:{server_id}",
                clock=clock,
            )
            if history_dir is not None
            else None
        )
        self.shadow_audit: Optional[ShadowAuditor] = (
            ShadowAuditor(
                sample=audit_sample,
                inline=audit_inline,
                on_divergence=self._on_audit_divergence,
                clock=clock,
            )
            if audit_sample > 0
            else None
        )
        self.detector: Optional[AnomalyDetector] = (
            AnomalyDetector() if detect else None
        )
        self._flight_phase_prev: Dict[str, float] = {}
        # fed_stats at the last flight record (a shard's record carries
        # the deltas since).
        self._flight_fed_prev: Dict[str, float] = {}
        # Dispatch accounting baseline (utils.dispatch is process-global
        # and monotone; each tick record carries the delta).
        self._flight_dispatch_prev: Dict[str, int] = {}
        # Last SLO evaluation (evaluate_slos); status() and /debug/slo
        # read it. None until the first evaluation.
        self.last_slo: Optional[dict] = None
        # Metrics hook; obs.metrics.instrument_server replaces it.
        self.on_request: Callable[[str, float, bool], None] = lambda *a: None
        # Always-on request sampling for /debug/requests.
        self.request_log = RequestLog(clock=self._clock)
        # torch.profiler capture of the first `profile_ticks` batch
        # ticks into `profile_dir` (a Chrome trace; Perfetto loads it).
        self.profile_dir = profile_dir
        self.profile_ticks = profile_ticks
        self._profiler = None
        self._profile_done = False
        self.profile_trace: Optional[str] = None

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    async def start(self, port: int = 0, host: str = "[::]",
                    tick_loop: bool = True,
                    tls_cert: Optional[str] = None,
                    tls_key: Optional[str] = None,
                    updater_loop: bool = True) -> int:
        """Start serving gRPC and, in batch mode (unless `tick_loop` is
        False, for callers that drive tick_once themselves), the tick
        loop; returns the bound port. An intermediate also starts its
        updater, which exchanges with the parent on the wall clock,
        unless `updater_loop` is False (callers that drive
        _perform_parent_requests themselves). Passing a cert/key pair
        serves TLS (reference doorman_server.go:171-177); the frontend
        control surface rides the same port."""
        if (tls_cert or tls_key) and not (tls_cert and tls_key):
            raise ValueError("tls_cert and tls_key must both be set")
        self._loop = asyncio.get_running_loop()
        server = grpc.aio.server()
        add_capacity_servicer(server, self)
        if self._frontend_control is not None:
            # The frontend pool's control surface (Establish / Drop /
            # Heartbeat) rides the backend gRPC server; handlers must
            # register before the server starts.
            from doorman_tpu_torch.frontend.control import (
                add_frontend_control,
            )

            add_frontend_control(server, self._frontend_control)
        if tls_cert:
            with open(tls_key, "rb") as f:
                key = f.read()
            with open(tls_cert, "rb") as f:
                cert = f.read()
            creds = grpc.ssl_server_credentials([(key, cert)])
            self.port = server.add_secure_port(f"{host}:{port}", creds)
        else:
            self.port = server.add_insecure_port(f"{host}:{port}")
        await server.start()
        self._grpc_server = server
        if self.parent_addr:
            # Intermediate servers self-configure from parent grants
            # (server.go:575-586) and keep refreshing them.
            await self.load_config(
                pb.ResourceRepository(resources=[default_resource_template()]),
                {},
            )
            if updater_loop:
                self._tasks.append(
                    asyncio.create_task(self._updater_loop())
                )
        if self.mode == "batch":
            if tick_loop:
                self._tasks.append(asyncio.create_task(self._tick_loop()))
        elif self._persist is not None:
            # Batch servers flush/snapshot from the tick pipeline; an
            # immediate-mode server needs its own durability beat.
            self._tasks.append(asyncio.create_task(self._persist_loop()))
        if self._streams is not None and self.mode != "batch":
            # Batch servers push at tick edges (tick_once); an
            # immediate-mode server has no tick, so the fanout gets its
            # own beat at the same cadence.
            self._tasks.append(asyncio.create_task(self._stream_loop()))
        return self.port

    def attach_frontend(self, workers: int, *, ring_bytes: int = 1 << 20,
                        inline: bool = True, ramp_window: float = 0.0,
                        tls_cert: Optional[str] = None,
                        tls_key: Optional[str] = None):
        """Attach the serving-plane pool (frontend/): N listener
        workers over per-worker push rings, plus the establishment ramp.
        `inline=True` builds the deterministic same-process pool (tests;
        call `pump_all()` after push edges); `inline=False` builds the
        real process pool (construct BEFORE start(); its control surface
        registers on the backend gRPC server at start). A
        `tls_cert`/`tls_key` pair makes the real pool's workers terminate
        TLS on the public port; the backend hop stays plaintext. Returns
        the pool."""
        if self._streams is None:
            raise ValueError(
                "attach_frontend needs stream push enabled (stream_push)"
            )
        from doorman_tpu_torch.admission.ramp import EstablishmentRamp
        from doorman_tpu_torch.frontend.pool import (
            FrontendPool,
            InlineFrontendPool,
        )

        if inline:
            self._frontend = InlineFrontendPool(
                self, workers, ring_bytes=ring_bytes
            )
        else:
            self._frontend = FrontendPool(
                self, workers, ring_bytes=ring_bytes,
                tick_interval=self.tick_interval,
                tls_cert=tls_cert, tls_key=tls_key,
            )
        self._frontend_ramp = EstablishmentRamp(window=ramp_window)
        return self._frontend

    async def stop(self) -> None:
        self._stop_profiler()
        if self._frontend_ramp is not None:
            self._frontend_ramp.close()
            self._frontend_ramp = None
        if self._frontend is not None:
            closer = getattr(self._frontend, "stop", None)
            if closer is not None:
                await closer()
            else:
                self._frontend.close()
            self._frontend = None
        if self._streams is not None:
            self._streams.close()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        if self.shadow_audit is not None:
            self.shadow_audit.close()
        if self.history is not None:
            self.history.close()
        await self.election.stop()
        if self._parent_conn is not None:
            await self._parent_conn.close()
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=None)
            self._grpc_server = None

    async def wait_until_configured(self) -> None:
        await self.is_configured.wait()

    # ------------------------------------------------------------------
    # Config and election
    # ------------------------------------------------------------------

    async def load_config(
        self,
        repo: pb.ResourceRepository,
        expiry_times: Optional[Dict[str, float]] = None,
    ) -> "tuple[int, int]":
        """Install a new ResourceRepository (validating it); the first load
        also enters the election. Returns how many existing resources took
        their template by exact id and how many by a glob ((0, 0) on the
        first load, which has none)."""
        config_mod.validate_repository(repo)
        if repo.groups and self.mode != "batch":
            # Group caps are enforced only by the batch tick: a grouped
            # config on an immediate server would validate and then
            # overcommit its resources, so it is refused (the caller
            # keeps the last good config).
            raise config_mod.ConfigError(
                f"config defines {len(repo.groups)} capacity group(s) "
                f"but server mode is {self.mode!r}: group caps are "
                "enforced only by the batch tick — run the server in "
                "batch mode or remove the groups"
            )
        first_time = self.config is None
        self.config = repo
        self._templates = config_mod.TemplateIndex(repo)
        self._config_epoch += 1
        self._push_groups()
        if first_time:
            self.is_configured.set()
            await self.election.run(
                self.id, self._on_is_master, self._on_current_master
            )
            return 0, 0
        expiry_times = expiry_times or {}
        index = self._templates
        globbed = 0
        for resource_id, res in self.resources.items():
            tpl = index.exact.get(resource_id)
            if tpl is None:
                globbed += 1
                tpl = index.find_glob(resource_id)
            res.load_config(tpl, expiry_times.get(resource_id))
        return len(self.resources) - globbed, globbed

    def _reset_store_engine(self) -> None:
        """A fresh native engine: dropping the resources map must also
        drop the engine-held leases. The Python store has nothing to
        reset (its stores go with the resources map)."""
        if self._native_store:
            engine = native.StoreEngine(clock=self._clock)
            self._store_factory = engine.store
            self._store_engine = engine

    async def _on_is_master(self, is_master: bool) -> None:
        """Mastership changes wipe all lease state; a fresh master starts
        in learning mode (server.go:438-455) — unless persistence is
        configured, in which case the wiped state is rebuilt from the
        last snapshot + journal and learning mode is skipped or
        shortened per-resource (persist/restore.py)."""
        was_master = self.is_master
        self.is_master = is_master
        self.mastership_epoch += 1
        # Election transitions land on the trace timeline and in the
        # default registry: a mastership flip explains every gap or
        # learning-mode plateau around it.
        trace_mod.default_tracer().instant(
            "election.transition", cat="election",
            args={"server": self.id, "is_master": is_master},
        )
        metrics_mod.default_registry().counter(
            "doorman_server_mastership_transitions",
            "Mastership transitions observed, by the state entered.",
            labels=("server", "to"),
        ).inc(self.id, "master" if is_master else "standby")
        if is_master:
            log.info("%s: this server is now the master", self.id)
            self.became_master_at = self._clock()
        else:
            log.warning("%s: this server lost mastership", self.id)
            self.became_master_at = 0.0
            if self._streams is not None:
                # Every open capacity stream ends with a terminal
                # mastership redirect, the streaming analog of the
                # unary mastership response. Clients fall back to
                # polling and re-establish against the new master
                # (resuming from their has-baseline).
                self._streams.terminate_all(self._mastership())
            if was_master and self._persist is not None:
                # Flush the terminal step-down marker BEFORE the state
                # wipe: it certifies the journal as complete, which is
                # what lets the next master skip learning outright.
                self._persist.note_step_down()
        self.resources = {}
        self._server_bands = {}
        # Straddle shares die with the lease state: a fresh master (or
        # standby) holds no share until the reconciler grants one.
        self._straddle_shares = {}
        self.fed_stats["straddle_capacity"] = 0.0
        self._reset_store_engine()
        # The engine was replaced: the resident solver's device tables
        # and any in-flight ticks refer to the old one.
        self._config_epoch += 1
        self._resident = None
        self._resident_pipe.drop()
        self._resident_wide = None
        self._resident_wide_pipe.drop()
        self._stream_check_all = True
        self._rid_map_key = None
        # The matcher's rid bindings belong to the replaced engine; the
        # terminated subs unbind lazily (their slots die with the map).
        self._stream_matcher = None
        self._stream_slots = {}
        self._stream_match_key = None
        self._stream_learning_key = None
        self._stream_learning = set()
        self.last_restore = None
        if is_master and self._persist is not None and self.config is not None:
            # Warm takeover: rebuild the just-wiped state from the
            # backend. Synchronous on the event loop: nothing serves
            # concurrently with the rebuild, which is the atomicity the
            # restore needs, and the next tick's resident rebuild reads
            # the restored engine. Any corruption degrades to the cold
            # path inside restore().
            self.last_restore = self._persist.restore(self).as_dict()

    async def _on_current_master(self, master: str) -> None:
        if master != self.current_master:
            log.info("%s: current master is now %r", self.id, master)
            self.current_master = master

    def learning_mode_end(self, duration: float) -> float:
        """When a resource with the given learning-mode duration leaves
        learning mode (server.go:172-181)."""
        if duration <= 0:
            return 0.0
        return self.became_master_at + duration

    # ------------------------------------------------------------------
    # Resource registry
    # ------------------------------------------------------------------

    def get_or_create_resource(self, resource_id: str) -> Resource:
        res = self.resources.get(resource_id)
        if res is not None:
            return res
        template = self._templates.find(resource_id)
        algo = template.algorithm
        if algo.HasField("learning_mode_duration"):
            duration = float(algo.learning_mode_duration)
        else:
            duration = float(algo.lease_length)
        res = Resource(
            resource_id,
            template,
            learning_mode_end=self.learning_mode_end(duration),
            clock=self._clock,
            store_factory=self._store_factory,
        )
        self.resources[resource_id] = res
        return res

    # ------------------------------------------------------------------
    # The batch tick
    # ------------------------------------------------------------------

    def _get_solver(self) -> BatchSolver:
        """The batch solver (lazily created)."""
        if self._solver is None:
            dtype = np.float64 if self.solver_dtype == "f64" else np.float32
            self._solver = BatchSolver(
                clock=self._clock, dtype=dtype, device=self.device
            )
            self._push_groups()
        return self._solver

    def _push_groups(self) -> None:
        """Hand the config's capacity groups to the batch solver."""
        if self._solver is not None and self.config is not None:
            self._solver.set_groups(
                {g.name: g.capacity for g in self.config.groups}
            )

    def _partitioned(self, resources: List[Resource]):
        """(narrow lane, wide lane, PRIORITY_BANDS resources) in registry
        order. A PRIORITY_BANDS row never enters the resident tables:
        their lane solve has no priority lane and would grant it 0. Only
        lane resources partition by width: a lane resource wider than
        DENSE_MAX_K clients takes the chunked solver, so the resident
        path has no width limit."""
        key = (self._config_epoch, len(resources))
        if key != self._partition_key:
            prio = int(AlgoKind.PRIORITY_BANDS)
            lane = [r for r in resources if r._decide_kind != prio]
            cap = batch_mod.DENSE_MAX_K
            self._wide_ids = {r.id for r in lane if len(r.store) > cap}
            self._partition = (
                [r for r in lane if r.id not in self._wide_ids],
                [r for r in lane if r.id in self._wide_ids],
                [r for r in resources if r._decide_kind == prio],
            )
            self._partition_key = key
            if self._streams is not None:
                # Wide and priority rows solve outside the delta-tracked
                # narrow path: their subscribers are checked every tick
                # (the narrow rows keep the changed-rid filter).
                self._stream_force_ids = self._wide_ids | {
                    r.id for r in self._partition[2]
                }
        return self._partition

    def _resident_solver(self) -> ResidentDenseSolver:
        """The device-resident tick solver (lazily created)."""
        if self._resident is None:
            dtype = np.float64 if self.solver_dtype == "f64" else np.float32
            self._resident = ResidentDenseSolver(
                self._store_engine, dtype=dtype, clock=self._clock,
                device=self.device, mesh=self._solver_mesh,
                # Grant delivery rides the config's fastest refresh
                # cadence relative to this server's tick cadence.
                rotate_ticks=None, tick_interval=self.tick_interval,
                fused=self._fused_tick, scoped=self._scoped_solve,
            )
            if self._fuse_admission and self._admission is not None:
                # Admission-fused staging: the coalescer's windows
                # pre-pack their touched rows (engine.FusedStaging);
                # only meaningful when coalescing is the GetCapacity
                # write path — without admission every write is
                # untracked and the cache would just be invalidated.
                self._resident.attach_staging()
            if self._streams is not None:
                # Streaming lease push: the tick compares delivered rows
                # against a resident previous-grants table (K2's
                # epilogue on a full tick), so the fanout re-decides
                # only the subscribers of rows that actually moved.
                self._resident.enable_delta_tracking()
            if self.flightrec is not None:
                self._resident.on_anomaly = self._solver_anomaly
        return self._resident

    def _resident_wide_solver(self) -> WideResidentSolver:
        """The chunked resident solver of the wide lane resources
        (lazily created)."""
        if self._resident_wide is None:
            dtype = np.float64 if self.solver_dtype == "f64" else np.float32
            self._resident_wide = WideResidentSolver(
                self._store_engine, dtype=dtype, clock=self._clock,
                device=self.device, mesh=self._solver_mesh,
                rotate_ticks=None, tick_interval=self.tick_interval,
                fused=self._fused_tick, scoped=self._scoped_solve,
            )
            if self.flightrec is not None:
                self._resident_wide.on_anomaly = self._solver_anomaly
        return self._resident_wide

    def _solver_anomaly(self, kind: str, detail: dict) -> None:
        """Tick-engine anomaly hook: an engine-detected invariant at
        risk (e.g. an out-of-range dirty rid aliasing a live row) lands
        as a flight-recorder error record BEFORE the engine raises, so
        the dump explains the tick that died."""
        fr = self.flightrec
        if fr is None:
            return
        try:
            fr.record(
                t=self._clock(),
                tick=self._ticks_done,
                is_master=self.is_master,
                epoch=self.mastership_epoch,
                error=f"solver_anomaly:{kind}",
                detail=detail,
            )
        except Exception:
            log.exception("%s: anomaly record failed", self.id)

    @property
    def _ticks_done(self) -> int:
        """Applied batch ticks (the serving condition for store-backed
        grants). max, not sum: a mixed config advances both counters on
        every tick_once."""
        ticks = self._solver.ticks if self._solver is not None else 0
        for s in (self._resident, self._resident_wide):
            if s is not None:
                ticks = max(ticks, s.ticks)
        return ticks

    async def tick_once(self) -> None:
        """Run one batched solve over all resources. Serialized: two ticks
        in flight would interleave their in-place updates of the resident
        tables."""
        async with self._tick_lock:
            tick_start = self._clock()
            tracer = trace_mod.default_tracer()
            # The span covers all of the tick once the lock is held (the
            # reference's ends before the audit and the flight record),
            # so its children account for every part of it.
            with tracer.span(
                "server.tick", cat="tick",
                args={"server": self.id,
                      "resources": len(self.resources)},
            ) as span:
                try:
                    await self._tick_once_locked()
                    if span is not None:
                        # The flight record's solve_mode of this tick.
                        span.args["solve"] = self._solve_mode()
                    # The tick pipeline is the batch server's durability
                    # beat: flush this tick's journal deltas and take the
                    # cadenced snapshot inside the tick span.
                    self.persist_step()
                    # Tick-edge stream fanout: push lease deltas to the
                    # WatchCapacity subscribers of the rows this tick
                    # moved (the fanout's decides are journal deltas of
                    # the NEXT flush beat).
                    self.push_streams()
                except Exception as exc:
                    # The black box's trigger: an unhandled tick
                    # exception dumps the last N ticks before the error
                    # propagates.
                    self._flight_abort(tick_start, exc)
                    raise
                # Shadow audit BEFORE the flight record so an inline
                # auditor's fresh divergence count rides this very tick's
                # record (the executor-backed default may lag a tick; the
                # counter is cumulative either way).
                if self.shadow_audit is not None:
                    with tracer.span("server.audit", cat="tick"):
                        self._audit_step()
                with tracer.span("server.flight_record", cat="tick"):
                    self._flight_record_tick(tick_start)
                if self._admission is not None:
                    # Tick lag feeds the overload controller: a solve
                    # falling behind its cadence is overload even while
                    # the RPC path still looks healthy. Measured on the
                    # server clock so replays on a fake clock stay
                    # deterministic.
                    self._admission.controller.observe_tick_lag(
                        (self._clock() - tick_start)
                        / max(self.tick_interval, 1e-9)
                    )

    async def _tick_once_locked(self) -> None:
        if not self.resources:
            return
        self._start_profiler()
        try:
            await self._tick_body()
        finally:
            if (
                self._profiler is not None
                and self._ticks_done >= self.profile_ticks
            ):
                self._stop_profiler()

    def _start_profiler(self) -> None:
        """Open the one-shot profiler capture at the first batch tick.
        Best effort: capture trouble (another session active, no
        profiler) is logged and never blocks solving."""
        if not self.profile_dir or self._profiler or self._profile_done:
            return
        try:
            self._profiler = trace_mod.start_torch_capture(self.profile_dir)
        except Exception:
            log.exception("%s: profiler capture unavailable", self.id)
            self._profile_done = True

    def _stop_profiler(self) -> None:
        """Finish the one-shot capture and write its trace (also on
        shutdown, so a server stopped mid-window still writes it)."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        self._profile_done = True
        try:
            self.profile_trace = trace_mod.stop_torch_capture(
                prof, self.profile_dir
            )
            log.info(
                "%s: wrote a torch.profiler trace of %d ticks to %s",
                self.id, self._ticks_done, self.profile_trace,
            )
        except Exception:
            log.exception("%s: profiler capture failed", self.id)

    def _resident_step(self, solver, resources: List[Resource],
                       config_epoch: int) -> None:
        """One pipelined resident tick (runs in an executor thread):
        collect the oldest in-flight tick once the pipeline is full,
        dispatch the next. `solver`, `resources` and `config_epoch` are
        resolved by the caller on the event loop, so the three stay
        consistent under a mastership flip. `run_tick` calls this
        through `self`, so an instance-level wrap (a fault injector)
        takes effect."""
        self._resident_pipe.step(solver, resources, config_epoch)

    def _resident_wide_step(self, solver, resources: List[Resource],
                            config_epoch: int) -> None:
        """One pipelined wide (chunked) tick; same rules as
        _resident_step."""
        self._resident_wide_pipe.step(solver, resources, config_epoch)

    async def _tick_body(self) -> None:
        resources = list(self.resources.values())
        loop = asyncio.get_running_loop()
        if not self._native_store:
            # Python stores: the pack and the write-back stay on the
            # event loop, so no RPC handler ever sees a half-packed or
            # half-applied store; only the device solve leaves it.
            self._stream_check_all = True
            solver = self._get_solver()
            snap = solver.prepare(resources)
            ctx = contextvars.copy_context()
            gets = await loop.run_in_executor(None, ctx.run, solver.solve, snap)
            solver.apply(resources, snap, gets, return_grants=False)
            return
        narrow_res, wide_res, prio_res = self._partitioned(resources)
        # Resolved here, on the event loop, so solvers, resources and
        # epoch stay mutually consistent under a mastership flip.
        resident = self._resident_solver() if narrow_res else None
        wide = self._resident_wide_solver() if wide_res else None
        solver = self._get_solver()
        epoch = self._config_epoch
        pipe, wide_pipe = self._resident_pipe, self._resident_wide_pipe
        if not narrow_res:
            pipe.drop()
        if not wide_res:
            wide_pipe.drop()

        def batch_tick(res):
            snap = solver.prepare(res)
            gets = solver.solve(snap)
            solver.apply(res, snap, gets, return_grants=False)

        def run_tick():
            try:
                if narrow_res:
                    self._resident_step(resident, narrow_res, epoch)
                if wide_res:
                    # The wide lane resources: their own device tables;
                    # the two resident solves are independent.
                    self._resident_wide_step(wide, wide_res, epoch)
                if prio_res:
                    # PRIORITY_BANDS resources tick through the
                    # BatchSolver (group caps couple only these rows).
                    batch_tick(prio_res)
            except ResidentOverflow:
                # A narrow lane resource outgrew its row mid-tick: force
                # a re-partition (it lands in the wide set next tick)
                # and run this tick through the BatchSolver, which takes
                # any width. BOTH in-flight pipelines are dropped: a
                # pre-overflow wide handle collected after this tick
                # would overwrite its fresher grants with one-tick-stale
                # ones (the chunk-version guard catches membership
                # changes, not stale values). Dropping an uncollected
                # handle is benign. The write is serialized: the loop
                # awaits this call under _tick_lock, and the key is read
                # at the next tick's start.
                log.warning(
                    "%s: resident bucket overflow; re-partitioning wide "
                    "resources", self.id,
                )
                self._partition_key = None
                pipe.drop()
                wide_pipe.drop()
                # This tick applies grants with no delta tracking (and
                # the dropped handles lost theirs). Serialized like the
                # partition key.
                self._stream_check_all = True
                batch_tick(resources)

        ctx = contextvars.copy_context()
        await loop.run_in_executor(None, ctx.run, run_tick)

    async def flush_ticks(self) -> None:
        """Collect every tick still in flight (its grants land in the
        store)."""
        async with self._tick_lock:
            loop = asyncio.get_running_loop()
            for pipe in (self._resident_pipe, self._resident_wide_pipe):
                await loop.run_in_executor(None, pipe.flush)

    # ------------------------------------------------------------------
    # Flight recorder, shadow audit, SLO evaluation
    # ------------------------------------------------------------------

    def _solve_mode(self) -> Optional[str]:
        """The last tick's solve mode across the active resident paths
        ("scoped", "full", or "full:<reason>"; None before any resident
        tick), shared by the flight record and the audit sampler's
        transition trigger."""
        solvers = [
            s
            for s in (self._resident, self._resident_wide)
            if s is not None and s.ticks
        ]
        if not solvers:
            return None
        forced = [
            s.last_full_reason
            for s in solvers
            if s.last_solve_mode == "full" and s.last_full_reason
        ]
        if forced:
            return f"full:{forced[0]}"
        if any(s.last_solve_mode == "full" for s in solvers):
            return "full"
        return "scoped"

    def _audit_step(self) -> None:
        """Per-tick shadow-audit hook (tick lock held): a cheap
        predicate, a host-side snapshot when a sample is due, and the
        oracle replay on the audit executor (inline when asked). Never
        raises: the auditor observes the plane, it must not fly it."""
        aud = self.shadow_audit
        if aud is None or not self.resources:
            return
        try:
            aud.maybe_sample(
                self._ticks_done, self._solve_mode(), self.resources
            )
        except Exception:
            log.exception("%s: shadow audit sampling failed", self.id)

    def _on_audit_divergence(self, detail: dict) -> None:
        """A confirmed divergence: the counter, the trace instant, a
        flight-recorder error record and an auto-dump. Runs on the audit
        executor (or the tick loop when inline); everything touched here
        is thread-safe."""
        metrics_mod.default_registry().counter(
            "doorman_audit_divergence",
            "Confirmed shadow-oracle audit divergences (store of "
            "record vs numpy oracle fixpoint).",
            labels=("server", "resource"),
        ).inc(self.id, str(detail.get("rid", "?")))
        trace_mod.default_tracer().instant(
            "audit.divergence", cat="audit",
            args={
                "server": self.id,
                "resource": detail.get("rid"),
                "digest": detail.get("digest"),
            },
        )
        fr = self.flightrec
        if fr is not None:
            try:
                fr.record(
                    t=self._clock(),
                    tick=detail.get("tick"),
                    is_master=self.is_master,
                    epoch=self.mastership_epoch,
                    error=(
                        f"audit.divergence: {detail.get('rid')} store "
                        f"{detail.get('has')} vs oracle "
                        f"{detail.get('expected')}"
                    ),
                    audit=dict(detail),
                )
                fr.dump("audit_divergence")
            except Exception:
                log.exception(
                    "%s: audit divergence dump failed", self.id
                )

    def _flight_record_tick(self, tick_start: float) -> None:
        """One structured record per applied tick: wall time, per-phase
        lap deltas, solve mode and scope, dispatch deltas, the stream
        fanout's load, the audit and detector counters, and a store
        digest, and the persist journal's seq when persistence is on.
        O(#resources): the stores keep running sums. A root shard's
        record carries the federation beat (shard, straddle updates and
        upstream RPCs since the last record, the installed shares' sum).
        With admission on, the record carries the admit level and the
        GetCapacity tallies; with a frontend pool, its held streams and
        published frames."""
        fr = self.flightrec
        if fr is None and self.history is None and self.detector is None:
            return
        now = self._clock()
        totals = self._phase_totals()
        phases = {
            k: round((v - self._flight_phase_prev.get(k, 0.0)) * 1000.0, 3)
            for k, v in totals.items()
            if v - self._flight_phase_prev.get(k, 0.0) > 0
        }
        self._flight_phase_prev = totals
        with trace_mod.default_tracer().span(
            "server.store_digest", cat="tick"
        ) as span:
            digest, bulk = digest_stores(self.resources)
            if span is not None:
                span.args = dict(
                    span.args or (), resources=len(self.resources),
                    bulk=bulk,
                )
        rec = {
            "t": now,
            "tick": self._ticks_done,
            "wall_ms": round((now - tick_start) * 1000.0, 3),
            "is_master": self.is_master,
            "epoch": self.mastership_epoch,
            "resources": len(self.resources),
            "digest": digest,
        }
        if self.shard is not None:
            # Federation beat on the black box: which shard this is,
            # how much straddle traffic moved since the last tick
            # (share installs + upstream RPCs), and the capacity the
            # installed shares currently sum to.
            rec["shard"] = self.shard
            for key in ("straddle_updates", "upstream_rpcs"):
                delta = self.fed_stats[key] - self._flight_fed_prev.get(
                    key, 0
                )
                if delta:
                    rec[key] = int(delta)
            self._flight_fed_prev = dict(self.fed_stats)
            if self.fed_stats["straddle_capacity"]:
                rec["straddle_capacity"] = round(
                    self.fed_stats["straddle_capacity"], 6
                )
        if phases:
            rec["phases"] = phases
        if self._resident is not None:
            # Fused-window depth of the last resident dispatch.
            lf = self._resident.last_fused
            if lf.get("windows") or lf.get("rows"):
                rec["fused_windows"] = int(lf.get("windows", 0))
                rec["fused_rows"] = int(lf.get("rows", 0))
        # Scoped-solve shape of the last resident dispatch(es): narrow
        # and wide fold (a forced full solve on either is the record's
        # mode; the scope tallies sum).
        solvers = [
            s
            for s in (self._resident, self._resident_wide)
            if s is not None and s.ticks
        ]
        if solvers:
            rec["solve_mode"] = self._solve_mode()
            rec["scoped_rows"] = sum(
                int(s.last_scope.get("rows", 0)) for s in solvers
            )
            rec["scoped_resources"] = sum(
                int(s.last_scope.get("resources", 0)) for s in solvers
            )
        # Dispatch accounting: device dispatches and device->host syncs
        # this tick asked of the card (process-global counters, so the
        # narrow and wide paths fold into one delta).
        dcur = dispatch_mod.snapshot()
        if self._flight_dispatch_prev:
            rec["dispatches"] = (
                dcur["dispatches"]
                - self._flight_dispatch_prev["dispatches"]
            )
            rec["host_syncs"] = (
                dcur["host_syncs"]
                - self._flight_dispatch_prev["host_syncs"]
            )
        self._flight_dispatch_prev = dcur
        depth_used = max(
            len(self._resident_pipe), len(self._resident_wide_pipe)
        )
        if depth_used > 1:
            rec["pipeline_in_flight"] = depth_used
        if self._streams is not None:
            # Stream-push load of this tick.
            st = self._streams.take_tick_stats()
            rec["subscribers"] = st["subscribers"]
            rec["deltas_pushed"] = st["deltas_pushed"]
            rec["push_bytes"] = st["push_bytes"]
            rec["stream_shards"] = st["stream_shards"]
            rec["matched_pairs"] = st["matched_pairs"]
            rec["serialized_bytes"] = st["serialized_bytes"]
        if self._frontend is not None:
            # Serving-plane pool shape: streams held across listener
            # workers and the frames published to the rings — the triage
            # counters for "a worker fell behind its ring".
            rec["frontend_held"] = self._frontend.held() if hasattr(
                self._frontend, "held"
            ) else sum(
                self._frontend.control.worker_held.values()
            )
            rec["frontend_frames"] = (
                self._frontend.publisher.published_frames
            )
        if self._admission is not None:
            admitted = 0
            shed_by_band: Dict[str, int] = {}
            for (method, band), counts in self._admission.tallies.items():
                if method != "GetCapacity":
                    continue
                admitted += counts["admitted"]
                if counts["shed"]:
                    shed_by_band[str(band)] = counts["shed"]
            rec["admission_level"] = round(
                self._admission.controller.level, 6
            )
            rec["admitted_total"] = admitted
            if shed_by_band:
                rec["shed_by_band"] = shed_by_band
        if self._persist is not None:
            rec["persist_seq"] = self._persist.journal.seq
        shards = phases_mod.last_shard_bytes()
        if shards:
            rec["shard_bytes"] = {
                f"{c}/{d}": list(v) for (c, d), v in sorted(shards.items())
            }
        if self.shadow_audit is not None:
            # Cumulative confirmed divergences.
            rec["audit_divergence"] = self.shadow_audit.divergences
        if self.detector is not None:
            try:
                detections = self.detector.observe(rec)
            except Exception:
                detections = []
                log.exception("%s: anomaly detector failed", self.id)
            rec["anomalies"] = self.detector.anomalies
            if detections:
                rec["anomaly_detections"] = detections
                for det in detections:
                    trace_mod.default_tracer().instant(
                        "detect.anomaly", cat="detect",
                        args={"server": self.id, **det},
                    )
        if fr is not None:
            fr.record(**rec)
        if self.history is not None:
            # History gets its own copy: the recorder stamps seq on its
            # dict and history stamps hseq/run on this one.
            self.history.append(dict(rec))

    def _flight_abort(self, tick_start: float, exc: BaseException) -> None:
        """Record the failed tick and auto-dump the ring. Never raises:
        the black box must not mask the exception it documents."""
        fr = self.flightrec
        if fr is None:
            return
        try:
            now = self._clock()
            fr.record(
                t=now,
                tick=self._ticks_done,
                wall_ms=round((now - tick_start) * 1000.0, 3),
                is_master=self.is_master,
                epoch=self.mastership_epoch,
                error=f"{type(exc).__name__}: {exc}",
            )
            fr.dump("tick_exception")
        except Exception:
            log.exception("%s: flight-recorder dump failed", self.id)

    def evaluate_slos(self, registry=None) -> List[dict]:
        """Evaluate the standing SLO set (obs.slo.server_slos) over the
        flight-recorder window (the history's, when one is kept), the
        request histograms in `registry` (default: the process-global
        one) and the admission tallies. Caches the result in `last_slo` for status() and
        /debug/slo."""
        samples: Dict[str, list] = {}
        if self.history is not None:
            # The durable ring spans process lifetimes, so the tick
            # budget's window survives a restart.
            ticks = self.history.series("wall_ms")
        elif self.flightrec is not None:
            ticks = [
                r["wall_ms"]
                for r in self.flightrec.snapshot()
                if isinstance(r.get("wall_ms"), (int, float))
            ]
        else:
            ticks = []
        if ticks:
            samples["tick_ms"] = ticks
        scalars: Dict[str, float] = {}
        if self.last_restore is not None and self.last_restore.get(
            "mode"
        ) == "warm":
            scalars["restore_staleness_s"] = float(
                self.last_restore.get("age", 0.0)
            )
        band_tallies: Dict[int, dict] = {}
        if self._admission is not None:
            for (method, band), counts in self._admission.tallies.items():
                if method == "GetCapacity":
                    band_tallies[int(band)] = dict(counts)
        specs = slo_mod.server_slos()
        if self.shadow_audit is not None:
            # Any confirmed divergence fails the SLO block until the
            # process is replaced.
            scalars["audit_divergence"] = float(
                self.shadow_audit.divergences
            )
            specs.append(slo_mod.audit_divergence_spec())
        if self.detector is not None:
            scalars["detector_anomalies"] = float(self.detector.anomalies)
            specs.append(slo_mod.detector_anomaly_spec())
        inputs = slo_mod.SloInputs(
            registry=registry or metrics_mod.default_registry(),
            samples=samples,
            scalars=scalars,
            band_tallies=band_tallies,
        )
        verdicts = slo_mod.SloEngine(specs).evaluate(inputs)
        self.last_slo = {
            "at": self._clock(),
            "ok": all(v["status"] != "fail" for v in verdicts),
            "verdicts": verdicts,
        }
        return verdicts

    def set_straddle_share(
        self, resource_id: str, capacity: float, expiry: float
    ) -> None:
        """Federation hook: install this shard's reconciled share of a
        straddling resource's capacity as a parent-style lease — the
        local template's capacity becomes the share and `expiry` rides
        as the parent-lease expiry, so a shard the reconciler stops
        renewing decays to zero capacity on its own (the partition
        blast-radius story). Template-only: no store row moves here, so
        the fused-staging pack cache stays valid; the config epoch bump
        routes the new capacity through the resident solver's config
        mirror like any reload (the next resident tick is full)."""
        res = self.get_or_create_resource(resource_id)
        tpl = pb.ResourceTemplate()
        tpl.CopyFrom(res.template)
        tpl.capacity = float(capacity)
        res.load_config(tpl, float(expiry))
        self._config_epoch += 1
        self.fed_stats["straddle_updates"] += 1
        self._straddle_shares[resource_id] = float(capacity)
        self.fed_stats["straddle_capacity"] = float(
            sum(self._straddle_shares.values())
        )

    def set_fleet_routing(
        self, epoch: int, routed_away: Dict[str, str]
    ) -> None:
        """Fleet hook: install the epoch's redirect table — every
        resource this shard no longer owns, mapped to the new owner's
        dial address. The table REPLACES the previous epoch's (the
        fleet controller computes it from the full tracked set, so a
        resource that moved back is simply absent). A stale-epoch
        client refreshing a moved resource here gets a mastership
        redirect to the new owner instead of a silently wrong grant;
        its rows on this shard drain by plain lease expiry."""
        epoch = int(epoch)
        if epoch < self._fleet_epoch:
            # An out-of-order install from a slow controller RPC must
            # not roll the table back to an older epoch's map.
            return
        self._fleet_epoch = epoch
        self._fleet_routing = dict(routed_away)

    def persist_step(self) -> None:
        """One durability beat (journal flush + cadenced snapshot +
        compaction) when persistence is configured and this server is
        master. Driven by the batch tick or the immediate-mode timer
        loop. A dead backend must never take down serving: failures log
        and the next beat retries."""
        if self._persist is None or not self.is_master:
            return
        try:
            self._persist.step(self)
        except Exception:
            log.exception("%s: persistence step failed", self.id)

    async def _persist_loop(self) -> None:
        interval = self._persist.flush_interval
        while True:
            await asyncio.sleep(interval)
            self.persist_step()

    async def _tick_loop(self) -> None:
        while True:
            await asyncio.sleep(self.tick_interval)
            if not self.is_master:
                self._resident_pipe.drop()
                self._resident_wide_pipe.drop()
                continue
            try:
                await self.tick_once()
            except Exception:
                log.exception("%s: batched tick failed", self.id)

    # -- admission-fused staging hooks ---------------------------------
    # (the tracked-writer registry FUSED_TRACKED_WRITERS lives at module
    # level below the class; tests/test_torch_admission.py reads it)

    def _fused_stage(self, resource_ids) -> None:
        """Coalescer hook, called right after a window's grouped store
        writes: pre-pack the touched NARROW lane rows into the resident
        solver's staging cache, moving the pack off the next tick's
        critical path and into the RPC window that caused it. Runs
        wherever the grouped pass runs (loop or executor thread): the
        native pack call and the cache are both thread-safe, and the
        staging is host-only (a native pack into numpy under the cache's
        lock, no CUDA call; the tick's one upload stays on the tick's
        stream). The drained dirty set remains authoritative for WHICH
        rows upload; this only short-circuits packing their VALUES
        (engine.FusedStaging)."""
        solver = self._resident
        if (
            solver is None
            or solver.staging is None
            or not self.is_master
        ):
            return
        rids = []
        for resource_id in resource_ids:
            res = self.resources.get(resource_id)
            if (
                res is not None
                and resource_id not in self._wide_ids
                and algo_kind_for(res.template) != AlgoKind.PRIORITY_BANDS
            ):
                rids.append(res.store._rid)
        if rids:
            solver.stage_rids(rids)

    def _fused_invalidate(self, resource_id: Optional[str] = None) -> None:
        """Untracked-writer hook: a store write outside the coalescer's
        grouped pass (the stream establishment decide, release paths,
        GetServerCapacity's band sub-leases, band sweeps) must drop the
        touched row's staged pack — a stale entry would ship a pre-write
        value whose dirty flag the next drain consumes
        (engine.FusedStaging's freshness contract). resource_id=None
        drops the whole cache."""
        solver = self._resident
        if solver is None or solver.staging is None:
            return
        if resource_id is None:
            solver.staging.invalidate()
            return
        res = self.resources.get(resource_id)
        if res is not None:
            solver.staging.invalidate(res.store._rid)

    # ------------------------------------------------------------------
    # Streaming lease push (server/streams.py, server/match.py)
    # ------------------------------------------------------------------

    async def _stream_loop(self) -> None:
        """The immediate-mode fanout beat (batch servers push from
        tick_once instead)."""
        while True:
            await asyncio.sleep(self.tick_interval)
            if self.is_master:
                self.push_streams()

    def push_streams(self) -> None:
        """One tick-edge stream fanout: intersect the engine's changed
        rids with the device-resident subscription incidence and hand
        the registry exactly the matched (subscription, row) work — or
        check_all when no tracked delta source covered this tick. Runs
        on the event loop, driven by tick_once (batch mode), the
        _stream_loop beat (immediate mode) or a stepped harness. A
        fanout fault must not take down the tick: it is logged and
        counted in status()["streams"]["fanout_errors"]."""
        if self._streams is None or not self.is_master:
            return
        if not len(self._streams):
            # Still drain the delta set so stale rids cannot flood the
            # first subscriber's tick.
            self._stream_changed_rids()
            return
        try:
            with trace_mod.default_tracer().span(
                "stream.fanout", cat="server",
                args={"server": self.id,
                      "subscribers": len(self._streams),
                      "shards": len(self._streams.shards)},
            ):
                changed_rids, check_all = self._stream_changed_rids()
                matched = (
                    {} if check_all else self._stream_match(changed_rids)
                )
                self._streams.on_tick(check_all, matched)
        except Exception:
            # The changed rids were drained before the fault: re-decide
            # every subscription next tick so no shrunk grant is lost.
            self._stream_check_all = True
            self._streams.fanout_errors += 1
            log.exception("%s: stream fanout failed", self.id)

    def _stream_changed_rids(self):
        """(changed_rids, check_all) for this fanout: the delta-tracked
        engine's changed rids, plus the rows forced by untracked solver
        parts and the resources in learning mode (their scalar decisions
        move without store deliveries); check_all when anything made the
        filter unsound (config epoch move, overflow tick, Python store,
        immediate mode)."""
        check_all = self._stream_check_all or self.mode != "batch"
        self._stream_check_all = False
        if self._config_epoch != self._stream_epoch_seen:
            # Config moves change safe_capacity / algorithms without any
            # store delivery; recheck everything once.
            self._stream_epoch_seen = self._config_epoch
            check_all = True
        solver = self._resident
        if solver is None or not solver.delta_tracking:
            return None, True
        rids = set(solver.take_changed_rids())
        if check_all:
            return None, True
        for resource_id in (
            self._stream_force_ids | self._stream_learning_ids()
        ):
            res = self.resources.get(resource_id)
            if res is not None and hasattr(res.store, "_rid"):
                rids.add(res.store._rid)
        return rids, False

    def _stream_learning_ids(self) -> set:
        """Resource ids currently in learning mode. Rebuilt by one
        O(#resources) scan only when membership or config moved (the
        cadence _rid_resource_map recomputes at); otherwise only the
        current members are re-checked, so a quiet steady-state tick
        pays O(|learning|) — zero once every window lapsed."""
        key = (self._config_epoch, len(self.resources))
        if key != self._stream_learning_key:
            self._stream_learning_key = key
            self._stream_learning = {
                rid for rid, res in self.resources.items()
                if res.in_learning_mode
            }
        elif self._stream_learning:
            self._stream_learning = {
                rid for rid in self._stream_learning
                if (res := self.resources.get(rid)) is not None
                and res.in_learning_mode
            }
        return self._stream_learning

    def _stream_match(self, changed_rids) -> dict:
        """Matched fanout work for one tick edge: subscription -> exactly
        the changed resource ids it watches, through the device matcher.
        Rows per subscription come back in the subscription's line
        order, so push bytes are independent of match order."""
        matcher = self._stream_matcher_sync()
        if not changed_rids or matcher is None or not len(matcher):
            return {}
        pairs = matcher.match(sorted(changed_rids))
        if not len(pairs):
            return {}
        rid_map = self._rid_resource_map()
        hit: Dict[object, set] = {}
        for slot, rid in pairs:
            sub = self._stream_slots.get(int(slot))
            resource_id = rid_map.get(int(rid))
            if sub is not None and resource_id is not None:
                hit.setdefault(sub, set()).add(resource_id)
        return {
            sub: [r for r in sub.lines if r in rows]
            for sub, rows in hit.items()
        }

    def _stream_matcher_sync(self) -> Optional[SubscriptionMatcher]:
        """The subscription matcher, its bindings synced against the
        resource-membership key: a config reload or a mastership flip
        can remap engine rids, so the incidence rebuilds from the live
        subscriptions whenever the key moves (steady state: never —
        subscribe/unsubscribe update it incrementally). None on the
        Python store, whose fanout checks every subscription."""
        if not self._native_store:
            return None
        key = (self._config_epoch, len(self.resources))
        if self._stream_matcher is not None and key == self._stream_match_key:
            return self._stream_matcher
        matcher = SubscriptionMatcher(device=self.device)
        slots: Dict[int, object] = {}
        for sub in self._streams.iter_subs():
            if sub.terminated:
                continue
            slot = matcher.add(self._stream_sub_rids(sub))
            slots[slot] = sub
            sub.match_slot = slot
        self._stream_matcher = matcher
        self._stream_slots = slots
        self._stream_match_key = (self._config_epoch, len(self.resources))
        return matcher

    def _stream_sub_rids(self, sub) -> list:
        """Engine rids of one subscription's lines (creating any resource
        a sweep removed — its next decide would anyway)."""
        return [
            self.get_or_create_resource(resource_id).store._rid
            for resource_id in sub.lines
        ]

    def _stream_match_add(self, sub) -> None:
        """Establishment hook: bind the new subscription into the live
        incidence structure (point scatters; no rebuild)."""
        matcher = self._stream_matcher
        if matcher is None or not self._native_store:
            return
        slot = matcher.add(self._stream_sub_rids(sub))
        self._stream_slots[slot] = sub
        sub.match_slot = slot
        # Establishment may have created resources; keep the sync key
        # current so the incremental bind is not immediately rebuilt.
        self._stream_match_key = (self._config_epoch, len(self.resources))

    def _stream_match_remove(self, sub) -> None:
        """Stream-close hook: drop the subscription's incidence rows
        (idempotent; a matcher rebuilt since establishment reassigned
        slots, so only a still-current binding is removed)."""
        matcher = self._stream_matcher
        slot = sub.match_slot
        sub.match_slot = None
        if matcher is None or slot is None:
            return
        if self._stream_slots.get(slot) is sub:
            matcher.remove(slot)
            self._stream_slots.pop(slot, None)

    def _rid_resource_map(self) -> Dict[int, str]:
        """Engine rid -> resource id (native stores only), cached against
        the config epoch and resource count."""
        key = (self._config_epoch, len(self.resources))
        if key != self._rid_map_key:
            self._rid_map_key = key
            self._rid_map = {
                res.store._rid: rid
                for rid, res in self.resources.items()
                if hasattr(res.store, "_rid")
            }
        return self._rid_map

    # ------------------------------------------------------------------
    # RPC handlers
    # ------------------------------------------------------------------

    def _mastership(self) -> pb.Mastership:
        m = pb.Mastership()
        if self.current_master:
            m.master_address = self.current_master
        return m

    async def Discovery(self, request, context):
        out = pb.DiscoveryResponse(is_master=self.is_master)
        out.mastership.CopyFrom(self._mastership())
        return out

    def _rpc_span(self, method: str, context, caller: str):
        """A handler span, parented to the caller's span when the RPC
        carried trace metadata (the gRPC hop of the trace context)."""
        tracer = trace_mod.default_tracer()
        if not tracer.enabled:
            return trace_mod.NOOP_SPAN
        return tracer.span(
            f"server.{method}", cat="server",
            parent=trace_mod.parent_from_grpc_context(context),
            args={"server": self.id, "caller": caller,
                  "is_master": self.is_master},
        )

    async def GetCapacity(self, request, context):
        start = self._clock()
        out = pb.GetCapacityResponse()
        err = False
        adm = self._admission
        adm_observed = False
        with self._rpc_span("GetCapacity", context, request.client_id):
            try:
                if not self.is_master:
                    out.mastership.CopyFrom(self._mastership())
                    return out
                if self._fleet_routing:
                    # Epoch-aware redirect: a reshard moved one of the
                    # requested resources off this shard. Answer with a
                    # mastership redirect to the new owner (clients
                    # batch per shard, so a mixed batch is a stale
                    # router — chasing re-sorts it).
                    moved = next(
                        (req.resource_id for req in request.resource
                         if req.resource_id in self._fleet_routing),
                        None,
                    )
                    if moved is not None:
                        self.fed_stats["fleet_redirects"] += 1
                        addr = self._fleet_routing[moved]
                        if addr:
                            out.mastership.master_address = addr
                        return out
                msg = config_mod.validate_get_capacity_request(request)
                if msg is not None:
                    err = True
                    if adm is not None:
                        adm.observe_rpc(self._clock() - start)
                        adm_observed = True
                    await context.abort(grpc.StatusCode.INVALID_ARGUMENT, msg)
                if adm is not None:
                    shed = adm.check_get_capacity(request, context)
                    if shed is not None:
                        err = True
                        # Latency is observed BEFORE the abort: the
                        # abort's unwind races the client's resumption on
                        # the loop, so a finally-side measurement could
                        # land after a fake clock's next advance and feed
                        # the controller a bogus tick-length sample.
                        adm.observe_rpc(self._clock() - start)
                        adm_observed = True
                        # The retry-after hint rides trailing metadata (a
                        # non-OK status cannot carry a response message);
                        # semantically it is the admission path's
                        # refresh_interval — "come back in N seconds".
                        context.set_trailing_metadata((
                            (RETRY_AFTER_KEY, f"{shed.retry_after:.3f}"),
                        ))
                        await context.abort(
                            grpc.StatusCode.RESOURCE_EXHAUSTED, shed.reason
                        )
                    return await adm.serve_get_capacity(request)
                for req in request.resource:
                    has = req.has.capacity if req.HasField("has") else 0.0
                    lease, res = self._decide(
                        req.resource_id,
                        Request(request.client_id, has, req.wants, 1,
                                priority=req.priority),
                    )
                    resp = out.response.add()
                    resp.resource_id = req.resource_id
                    resp.gets.expiry_time = int(lease.expiry)
                    resp.gets.refresh_interval = int(lease.refresh_interval)
                    resp.gets.capacity = lease.has
                    resp.safe_capacity = res.safe_capacity()
                return out
            finally:
                dur = self._clock() - start
                if adm is not None and not adm_observed:
                    # Latency feed for the overload controller (shed
                    # requests are observed at the abort above).
                    adm.observe_rpc(dur)
                self.on_request("GetCapacity", dur, err)
                self.request_log.record(
                    "GetCapacity", request.client_id,
                    [r.resource_id for r in request.resource],
                    sum(r.wants for r in request.resource),
                    dur, err,
                )

    async def GetServerCapacity(self, request, context):
        """One downstream server's aggregated demand, one sub-lease per
        (server, priority band): each band is decided as a client of the
        resource and the response carries the sum of the band grants."""
        start = self._clock()
        out = pb.GetServerCapacityResponse()
        err = False
        with self._rpc_span(
            "GetServerCapacity", context, request.server_id
        ) as span:
            return await self._get_server_capacity(
                request, context, out, start, err, span
            )

    async def _get_server_capacity(self, request, context, out, start, err,
                                   span=None):
        # Bands decided by this request, one _decide each (the handler's
        # cost): the span's `bands` arg and the registry's band counter.
        decided = 0
        try:
            if not self.is_master:
                out.mastership.CopyFrom(self._mastership())
                return out
            msg = config_mod.validate_get_server_capacity_request(request)
            if msg is not None:
                err = True
                await context.abort(grpc.StatusCode.INVALID_ARGUMENT, msg)
            if self._admission is not None:
                # Never shed (one RPC carries a whole downstream
                # subtree's demand — the shed matrix's 'never' row);
                # tallied so the load is visible in the counters.
                self._admission.note_pass_through(
                    "GetServerCapacity",
                    max(
                        (band.priority for r in request.resource
                         for band in r.wants),
                        default=0,
                    ),
                )
            self._sweep_server_bands()
            for req in request.resource:
                # The store keeps the downstream server's band composition
                # (reference carries sr.wants as the full band list,
                # simulation/server.py:300-306), so a PRIORITY_BANDS
                # resource discriminates bands across the tree and this
                # server's own upstream aggregation re-emits them.
                bands = list(req.wants) or [
                    pb.PriorityBandAggregate(
                        priority=DEFAULT_PRIORITY, num_clients=1, wants=0.0
                    )
                ]
                wants_total = sum(band.wants for band in bands)
                has_total = req.has.capacity if req.HasField("has") else 0.0
                res = self.get_or_create_resource(req.resource_id)
                key = (req.resource_id, request.server_id)
                prios = {band.priority for band in bands}
                for stale in self._server_bands.get(key, set()) - prios:
                    bkey = _band_key(request.server_id, stale)
                    res.release(bkey)
                    if self._persist is not None:
                        self._persist.record_release(req.resource_id, bkey)
                self._server_bands[key] = prios
                granted, lease = 0.0, None
                for band in bands:
                    # Per-band has: this server granted the band's previous
                    # lease itself, so the stored value is exact; the
                    # wants-proportional split of the aggregate wire `has`
                    # only seeds bands it has no live record of (the wire
                    # carries one aggregate has per resource).
                    bkey = _band_key(request.server_id, band.priority)
                    prev = res.store.get(bkey)
                    # Missing bands return ZERO_LEASE (expiry 0), so one
                    # expiry check covers both absent and lapsed.
                    if prev.expiry >= self._clock():
                        has_band = prev.has
                    elif wants_total > 0:
                        has_band = has_total * (band.wants / wants_total)
                    else:
                        has_band = has_total / len(bands)
                    lease, res = self._decide(
                        req.resource_id,
                        Request(
                            bkey, has_band, band.wants,
                            max(band.num_clients, 1),
                            priority=band.priority,
                        ),
                    )
                    granted += lease.has
                    decided += 1
                # Untracked writes: the band sub-lease decides above bypass
                # the coalescer's stage (see _fused_invalidate).
                self._fused_invalidate(req.resource_id)
                resp = out.response.add()
                resp.resource_id = req.resource_id
                resp.gets.expiry_time = int(lease.expiry)
                resp.gets.refresh_interval = int(lease.refresh_interval)
                resp.gets.capacity = granted
                resp.algorithm.CopyFrom(res.template.algorithm)
                # The template's field, not Resource.safe_capacity(): a
                # downstream server gets no dynamic per-client fallback.
                resp.safe_capacity = (
                    res.template.safe_capacity
                    if res.template.HasField("safe_capacity")
                    else 0.0
                )
            return out
        finally:
            if decided:
                metrics_mod.default_registry().counter(
                    "doorman_server_capacity_bands",
                    "Downstream servers' priority bands decided by "
                    "GetServerCapacity.",
                    labels=("server",),
                ).inc(self.id, by=decided)
            if span is not None:
                span.args["lines"] = len(request.resource)
                span.args["bands"] = decided
            self.on_request("GetServerCapacity", self._clock() - start, err)
            self.request_log.record(
                "GetServerCapacity", request.server_id,
                [r.resource_id for r in request.resource],
                sum(
                    band.wants for r in request.resource
                    for band in r.wants
                ),
                self._clock() - start, err,
            )

    def _sweep_server_bands(self) -> None:
        """Drop (resource, server) band-composition entries whose
        sub-leases have all expired out of the store: downstream servers
        that vanished without a ReleaseCapacity would otherwise leak an
        entry forever. Time-gated: the underlying expiry state only
        changes as leases lapse, so scanning more than once per interval
        buys nothing."""
        now = self._clock()
        if now - self._last_band_sweep < BAND_SWEEP_INTERVAL:
            return
        self._last_band_sweep = now
        stale = []
        swept = set()
        for (resource_id, server_id), prios in self._server_bands.items():
            res = self.resources.get(resource_id)
            if res is not None and resource_id not in swept:
                # has_client counts expired leases as live; sweep them
                # out first so vanished servers actually disappear even
                # in immediate mode (where no batch tick cleans stores).
                res.store.clean()
                # Untracked removal (see _fused_invalidate).
                self._fused_invalidate(resource_id)
                swept.add(resource_id)
            if res is None or not any(
                res.store.has_client(_band_key(server_id, p)) for p in prios
            ):
                stale.append((resource_id, server_id))
        for key in stale:
            del self._server_bands[key]

    async def WatchCapacity(self, request, context):
        """Streaming lease push: one subscription request, a stream of
        tick-edge deltas. Establishment walks the same gate as a poll —
        mastership, validation, admission (AIMD band shed + per-band
        stream cap), through the establishment ramp when a frontend pool
        is attached — then the registry owns the stream until it ends
        with a terminal mastership redirect."""
        start = self._clock()
        err = True
        try:
            with self._rpc_span("WatchCapacity", context,
                                request.client_id):
                if self._streams is None:
                    await context.abort(
                        grpc.StatusCode.UNIMPLEMENTED,
                        "stream push is disabled on this server "
                        "(--stream-push)",
                    )
                if not self.is_master:
                    out = spb.WatchCapacityResponse()
                    out.mastership.CopyFrom(self._mastership())
                    err = False
                    yield out
                    return
                msg = config_mod.validate_get_capacity_request(request)
                if msg is not None:
                    await context.abort(
                        grpc.StatusCode.INVALID_ARGUMENT, msg
                    )
                band = max(
                    (rr.priority for rr in request.resource), default=0
                )

                def _establish():
                    """Gate + subscribe, in arrival order — ridden
                    directly or through the establishment ramp's
                    grid-aligned window (admission/ramp.py)."""
                    shed = None
                    if self._admission is not None:
                        shed = self._admission.check_watch(request)
                    if shed is None:
                        shed = self._streams.check_cap(band)
                    if shed is not None:
                        return shed
                    sub = self._streams.subscribe(request)
                    # Bind the new stream into the device matcher's
                    # incidence structure (a point scatter, not a
                    # rebuild).
                    self._stream_match_add(sub)
                    return sub

                if self._frontend_ramp is not None:
                    result = await self._frontend_ramp.submit(_establish)
                else:
                    result = _establish()
                if isinstance(result, Shed):
                    # Same wire contract as a shed poll: the pacing hint
                    # rides trailing metadata.
                    context.set_trailing_metadata((
                        (RETRY_AFTER_KEY, f"{result.retry_after:.3f}"),
                    ))
                    await context.abort(
                        grpc.StatusCode.RESOURCE_EXHAUSTED, result.reason
                    )
                sub = result
                err = False
        finally:
            dur = self._clock() - start
            self.on_request("WatchCapacity", dur, err)
            self.request_log.record(
                "WatchCapacity", request.client_id,
                [r.resource_id for r in request.resource],
                sum(r.wants for r in request.resource),
                dur, err,
            )
        try:
            while True:
                out = await sub.queue.get()
                yield out
                # Data pushes are pre-serialized bytes (the stream
                # serializer passes them through); a message OBJECT is
                # the terminal mastership redirect.
                if not isinstance(out, (bytes, bytearray)):
                    return
        finally:
            self._streams.unsubscribe(sub)
            self._stream_match_remove(sub)

    async def ReleaseCapacity(self, request, context):
        start = self._clock()
        out = pb.ReleaseCapacityResponse()
        err = False
        with self._rpc_span("ReleaseCapacity", context, request.client_id):
            return await self._release_capacity(
                request, context, out, start, err
            )

    async def _release_capacity(self, request, context, out, start, err):
        try:
            if not self.is_master:
                out.mastership.CopyFrom(self._mastership())
                return out
            msg = config_mod.validate_release_capacity_request(request)
            if msg is not None:
                err = True
                await context.abort(grpc.StatusCode.INVALID_ARGUMENT, msg)
            if self._admission is not None:
                # Never shed: releases shrink load; refusing one pins a
                # dead client's capacity and worsens the overload.
                self._admission.note_pass_through("ReleaseCapacity")
            for resource_id in request.resource_id:
                res = self.resources.get(resource_id)
                if res is None:
                    continue
                res.release(request.client_id)
                if self._persist is not None:
                    self._persist.record_release(
                        resource_id, request.client_id
                    )
                # A downstream *server* holds per-band sub-leases;
                # release them too and forget its band composition.
                key = (resource_id, request.client_id)
                for prio in self._server_bands.pop(key, set()):
                    bkey = _band_key(request.client_id, prio)
                    res.release(bkey)
                    if self._persist is not None:
                        self._persist.record_release(resource_id, bkey)
                # Untracked write: a staged pack of this row predates
                # the release (see _fused_invalidate).
                self._fused_invalidate(resource_id)
            return out
        finally:
            self.on_request("ReleaseCapacity", self._clock() - start, err)
            self.request_log.record(
                "ReleaseCapacity", request.client_id,
                list(request.resource_id), 0.0,
                self._clock() - start, err,
            )

    def _decide(self, resource_id: str, request: Request):
        """Produce a lease for one resource request. Immediate mode (and
        unknown clients, and learning mode) run the scalar per-request
        algorithm; batch mode serves the last tick's solved grant and
        records the new demand (one locked C call on the native store)."""
        res = self.get_or_create_resource(resource_id)
        lease = None
        if (
            self.mode == "batch"
            and not res.in_learning_mode
            and self._ticks_done > 0
        ):
            rg = res._refresh_grant
            if rg is not None:
                # Native store: None means the client is new.
                lease = rg(
                    request.client, res._lease_length,
                    res._refresh_interval, request.wants,
                    request.subclients, request.priority,
                )
            elif res.store.has_client(request.client):
                lease = res.store.assign(
                    request.client,
                    res._lease_length,
                    res._refresh_interval,
                    res.store.get(request.client).has,
                    request.wants,
                    request.subclients,
                    priority=request.priority,
                )
        if lease is None:
            lease = res.decide(request)
        if self._persist is not None:
            # Every served lease is a journal delta; replay over the
            # last snapshot reconstructs this exact store row.
            self._persist.record_assign(resource_id, request.client, lease)
        return lease, res

    def decide_bulk(
        self,
        resource_id: str,
        cids,
        has,
        wants,
        priorities,
        *,
        old_has,
        old_wants,
        new_mask,
        cid_handles=None,
        expected_count=None,
    ):
        """Bulk refresh entry for array-backed drivers: decide one
        resource's batch of single-resource requests in arrival order
        and return ``(grants, expiry, refresh_interval, safe,
        fast_rows)`` arrays. Tries the vectorized grouped pass first
        (`coalesce.decide_grouped_arrays`, grant-exact with the
        per-request path) and falls back to the sequential
        `decide_grouped` — identical responses either way, only
        ``fast_rows`` says how much of the batch went through arrays.
        Caller preconditions: this server is master, no stored lease is
        expired, and the mirror arrays describe the store's rows
        exactly. Must run on the event loop (the same discipline as the
        coalescer's inline window)."""
        from doorman_tpu_torch.admission import coalesce as coalesce_mod

        try:
            out = coalesce_mod.decide_grouped_arrays(
                self, resource_id, cids, has, wants, priorities,
                old_has=old_has, old_wants=old_wants, new_mask=new_mask,
                cid_handles=cid_handles, expected_count=expected_count,
            )
            if out is None:
                name_of = (
                    self._store_engine.client_name
                    if cids is None else None
                )
                work = []
                for i in range(len(wants)):
                    name = (
                        cids[i] if cids is not None
                        else name_of(int(cid_handles[i]))
                    )
                    work.append((resource_id, Request(
                        name, float(has[i]), float(wants[i]), 1,
                        priority=int(priorities[i]),
                    )))
                decided = coalesce_mod.decide_grouped(self, work)
                n = len(work)
                grants = np.empty(n, np.float64)
                expiry = np.empty(n, np.float64)
                refresh = np.empty(n, np.float64)
                safe = np.empty(n, np.float64)
                for i, (lease, _res, s) in enumerate(decided):
                    grants[i] = lease.has
                    expiry[i] = lease.expiry
                    refresh[i] = lease.refresh_interval
                    safe[i] = s
                out = (grants, expiry, refresh, safe, 0)
        except BaseException:
            # Same contract as the coalescer's window: a partially
            # applied batch can't prove staging freshness — drop the
            # fused cache and re-raise.
            self._fused_invalidate()
            raise
        self._fused_stage({resource_id})
        return out

    # ------------------------------------------------------------------
    # Intermediate-server updater (refresh capacity from the parent)
    # ------------------------------------------------------------------

    def _build_server_capacity_request(self) -> pb.GetServerCapacityRequest:
        """Aggregate every local resource into per-band aggregates.

        Clients and downstream servers' bands group by wire priority
        (simulation/server_state_wrapper.py:305-334), so band structure
        survives every upstream hop. The current parent lease rides
        along as `has` so the parent's algorithms see this server as a
        returning client."""
        out = pb.GetServerCapacityRequest(server_id=self.id)
        for resource_id, res in self.resources.items():
            if res.store.sum_wants > 0:
                rr = out.resource.add()
                rr.resource_id = resource_id
                if res.parent_expiry is not None and res.capacity > 0:
                    rr.has.capacity = res.capacity
                    rr.has.expiry_time = int(res.parent_expiry)
                # One aggregation call per resource (the native store
                # does it in C: a 1M-lease store must not be walked
                # per lease on the event loop).
                for priority, wants, num_clients in (
                    res.store.band_aggregates()
                ):
                    if wants <= 0:
                        continue
                    band = rr.wants.add()
                    band.priority = priority
                    band.num_clients = max(int(num_clients), 1)
                    band.wants = wants
        if not out.resource:
            # Probe request so the parent link stays warm (server.go:66-79).
            rr = out.resource.add()
            rr.resource_id = "*"
            band = rr.wants.add()
            band.priority = DEFAULT_PRIORITY
            band.num_clients = 1
            band.wants = 0.0
        return out

    async def _perform_parent_requests(self, retry_number: int):
        """One GetServerCapacity exchange with the parent: send the
        aggregated demand, re-template local resources from the grants
        (server.go:227-323). Returns (next_interval, next_retry_number).

        Traced as `server.parent_exchange` (arg `outcome`) around its
        three parts: `server.band_aggregate` (the request, args
        `resources` and `bands`), `server.parent_refresh` (the RPC) and
        `server.parent_install` (the grants' templates loaded, args
        `templates`, and `exact` and `globbed`: the resources that took
        their template by exact id and by a glob); the registry counts
        exchanges by outcome."""
        tracer = trace_mod.default_tracer()
        with tracer.span(
            "server.parent_exchange", cat="server",
            args={"server": self.id, "parent": self.parent_addr},
        ) as span:
            interval, retry, outcome = await self._parent_exchange(
                retry_number
            )
            if span is not None:
                span.args["outcome"] = outcome
        metrics_mod.default_registry().counter(
            "doorman_server_parent_exchanges",
            "Parent exchanges of an intermediate server, by outcome.",
            labels=("server", "outcome"),
        ).inc(self.id, outcome)
        return interval, retry

    async def _parent_exchange(self, retry_number: int):
        """_perform_parent_requests' body: (interval, retry number,
        outcome), the outcome "ok", "rpc_error" or "config_error"."""
        tracer = trace_mod.default_tracer()
        if self._parent_conn is None:
            self._parent_conn = Connection(
                self.parent_addr,
                minimum_refresh_interval=self.minimum_refresh_interval,
                tls=self.parent_tls,
                tls_ca=self.parent_tls_ca,
            )
        with tracer.span(
            "server.band_aggregate", cat="server", args={"server": self.id},
        ) as span:
            request = self._build_server_capacity_request()
            if span is not None:
                span.args["resources"] = len(request.resource)
                span.args["bands"] = sum(
                    len(rr.wants) for rr in request.resource
                )
        try:
            # The metadata is computed inside the lambda, at call time,
            # so each attempt carries the parent_refresh span context
            # over the GetServerCapacity hop.
            with tracer.span(
                "server.parent_refresh", cat="server",
                args={"server": self.id, "parent": self.parent_addr},
            ):
                out = await self._parent_conn.execute(
                    lambda stub: stub.GetServerCapacity(
                        request, metadata=trace_mod.grpc_metadata()
                    )
                )
        except Exception:
            log.exception("%s: GetServerCapacity to parent failed", self.id)
            return (
                backoff(MIN_BACKOFF, MAX_BACKOFF, retry_number),
                retry_number + 1,
                "rpc_error",
            )

        interval = VERY_LONG_TIME
        templates: List[pb.ResourceTemplate] = []
        expiry_times: Dict[str, float] = {}
        for pr in out.response:
            if pr.resource_id not in self.resources:
                if pr.resource_id != "*":
                    log.error(
                        "%s: response for unknown resource %r",
                        self.id, pr.resource_id,
                    )
                continue
            expiry_times[pr.resource_id] = float(pr.gets.expiry_time)
            tpl = pb.ResourceTemplate(
                identifier_glob=pr.resource_id,
                capacity=pr.gets.capacity,
                safe_capacity=pr.safe_capacity,
            )
            tpl.algorithm.CopyFrom(pr.algorithm)
            templates.append(tpl)
            interval = min(interval, float(pr.gets.refresh_interval))
        templates.append(default_resource_template())
        try:
            # Bumps the config epoch: the next resident tick solves the
            # whole table and the stream fanout checks every
            # subscription, as in the reference.
            with tracer.span(
                "server.parent_install", cat="server",
                args={"server": self.id, "templates": len(templates)},
            ) as span:
                exact, globbed = await self.load_config(
                    pb.ResourceRepository(resources=templates), expiry_times
                )
                if span is not None:
                    span.args["exact"] = exact
                    span.args["globbed"] = globbed
        except config_mod.ConfigError:
            log.exception("%s: loading parent-derived config failed", self.id)
            return (
                backoff(MIN_BACKOFF, MAX_BACKOFF, retry_number),
                retry_number + 1,
                "config_error",
            )
        if (
            interval < self.minimum_refresh_interval
            or interval == VERY_LONG_TIME
        ):
            interval = self.minimum_refresh_interval
        return interval, 0, "ok"

    async def _updater_loop(self) -> None:
        interval, retry = DEFAULT_INTERVAL, 0
        while True:
            await asyncio.sleep(interval)
            interval, retry = await self._perform_parent_requests(retry)

    # ------------------------------------------------------------------
    # Status
    # ------------------------------------------------------------------

    def _phase_totals(self) -> Dict[str, float]:
        """Cumulative per-phase seconds across every active solver path;
        the wide solver's keys are prefixed `wide.`, the BatchSolver's
        `batch.` and the stream matcher's `stream.`, so a mixed config
        reads unambiguously (the same breakdown /metrics carries as the
        doorman_tick_phase_seconds histograms)."""
        out: Dict[str, float] = {}
        if self._resident is not None:
            out.update(self._resident.phase_s)
        if self._resident_wide is not None:
            for k, v in self._resident_wide.phase_s.items():
                out[f"wide.{k}"] = v
        if self._solver is not None:
            for k, v in self._solver.phase_s.items():
                out[f"batch.{k}"] = v
        if self._stream_matcher is not None:
            # The stream fanout's staging/match/download laps.
            for k, v in self._stream_matcher.phase_s.items():
                if v:
                    out[f"stream.{k}"] = v
        return out

    def _last_tick_seconds(self) -> float:
        return max(
            (
                s.last_tick_seconds
                for s in (self._solver, self._resident, self._resident_wide)
                if s is not None
            ),
            default=0.0,
        )

    def _backend_platform(self) -> str:
        """The torch device type the ticks run on ("" before the first
        tick, as the reference)."""
        if self._ticks_done <= 0:
            return ""
        return self.device.type

    def status(self) -> dict:
        """The reference's status keys (the debug pages, the SLO engine
        and the flight record read them; parts not ported yet report
        None, as the reference does when they are off), plus the port's
        own: store and device, lease count, scope blocks, `phase_s` and
        the BatchSolver's `priority` block."""
        solver = self._resident
        wide = self._resident_wide
        prio = self._solver
        return {
            "id": self.id,
            "is_master": self.is_master,
            "election": str(self.election),
            "current_master": self.current_master,
            "mode": self.mode,
            "backend": self._backend_platform(),
            # Axis sizes of the resident solvers' device mesh (None:
            # single device).
            "mesh": (
                {str(k): int(v) for k, v in self._solver_mesh.shape.items()}
                if self._solver_mesh is not None
                else None
            ),
            "ticks": self._ticks_done,
            "tick_pipeline": {
                "depth": self._tick_pipeline_depth,
                "in_flight": (
                    len(self._resident_pipe) + len(self._resident_wide_pipe)
                ),
            },
            "fused_tick": self._fused_tick,
            "scoped_solve": self._scoped_solve,
            "solve_scope": {
                "narrow": (
                    solver.scope_status() if solver is not None else None
                ),
                "wide": wide.scope_status() if wide is not None else None,
            },
            "dispatch": dispatch_mod.snapshot(),
            "fused_staging": (
                solver.staging.status()
                if solver is not None and solver.staging is not None
                else None
            ),
            "idle_ticks": solver.idle_ticks if solver is not None else 0,
            "tick_phase_total_ms": {  # cumulative since start
                k: round(v * 1000.0, 3)
                for k, v in self._phase_totals().items()
            },
            "last_tick_ms": round(self._last_tick_seconds() * 1000.0, 3),
            "persist": (
                self._persist.status()
                if self._persist is not None
                else None
            ),
            "admission": (
                self._admission.status()
                if self._admission is not None
                else None
            ),
            # Streaming lease push (None: stream push off).
            "streams": (
                self._streams.status() if self._streams is not None else None
            ),
            # Serving-plane pool (None: single-process front-end).
            "frontend": (
                {
                    **self._frontend.status(),
                    "ramp": (
                        self._frontend_ramp.status()
                        if self._frontend_ramp is not None
                        else None
                    ),
                    "control": (
                        self._frontend_control.status()
                        if self._frontend_control is not None
                        else None
                    ),
                }
                if self._frontend is not None
                else None
            ),
            # Federation identity + traffic (None: unsharded server
            # with no federated activity).
            "federation": (
                {
                    "shard": self.shard,
                    "straddle_shares": dict(self._straddle_shares),
                    **self.fed_stats,
                }
                if self.shard is not None or any(self.fed_stats.values())
                else None
            ),
            "last_restore": self.last_restore,
            "flightrec": (
                self.flightrec.status() if self.flightrec is not None else None
            ),
            "history": (
                self.history.status() if self.history is not None else None
            ),
            "shadow_audit": (
                self.shadow_audit.status()
                if self.shadow_audit is not None
                else None
            ),
            "detector": (
                self.detector.status() if self.detector is not None else None
            ),
            "slo": self.last_slo,
            "resources": {
                rid: res.status() for rid, res in self.resources.items()
            },
            "config": (
                config_mod.repository_to_yaml(self.config)
                if self.config is not None
                else ""
            ),
            "native_store": self._native_store,
            "device": device_info(self.device),
            "solver_dtype": self.solver_dtype,
            "leases": (
                int(self._store_engine.total_leases)
                if self._store_engine is not None
                else sum(len(r.store) for r in self.resources.values())
            ),
            "scope": solver.scope_status() if solver is not None else None,
            "wide_scope": wide.scope_status() if wide is not None else None,
            "wide_resources": sorted(self._wide_ids),
            "phase_s": self._phase_totals(),
            "priority": None if prio is None else {
                "ticks": prio.ticks,
                "last_tick_seconds": prio.last_tick_seconds,
                "phase_s": dict(prio.phase_s),
            },
        }

    def resource_lease_status(self, resource_id: str):
        res = self.resources.get(resource_id)
        if res is None:
            return None
        return res.store.lease_status()


# ----------------------------------------------------------------------
# Fused-staging tracked-writer registry
# ----------------------------------------------------------------------
# The FusedStaging freshness contract (solver/engine.py): a window-time
# pack cache entry is valid only while no store write touched its row
# after staging. Every store-row writer in this file and
# admission/coalesce.py either calls _fused_invalidate (release paths,
# band sub-leases, band sweeps do) or appears here with the note saying
# who owns its staging obligation (tests/test_torch_admission.py checks
# both files against this list). Adding a writer to this list is a
# CONTRACT CLAIM — include the argument, like the entries below.
FUSED_TRACKED_WRITERS = frozenset({
    # The coalescer's grouped pass is THE tracked writer: it re-stages
    # everything it wrote via _fused_stage at window close and drops the
    # whole cache on a partially-applied window. (It calls both hooks
    # inline, so it self-certifies; listed for documentation.)
    "Coalescer._decide_batch",
    # The shared grouped-decide core (admission/coalesce.decide_grouped)
    # only dispatches to _decide; its CALLERS own the contract exactly
    # like _decide's own call sites below: Coalescer._decide_batch
    # re-stages via _fused_stage after the window's writes, and the
    # stream fanout's per-shard pass runs only steady-state refresh
    # decides — identical wants rewritten, packed bytes unchanged (the
    # StreamRegistry._decide argument).
    "decide_grouped",
    # _decide writes one row per call; its call sites own the contract:
    # Coalescer._decide_batch re-stages after the window's writes,
    # _get_server_capacity invalidates after the band loop, GetCapacity's
    # direct loop only runs with admission off (below), and the stream
    # registry (server/streams.py) invalidates on its establishment
    # decide — the only one of its decides that changes packed bytes.
    "CapacityServer._decide",
    # The direct per-request loop runs only when admission is None
    # (coalescing otherwise owns every GetCapacity decide), and fused
    # staging is attached iff fuse_admission AND admission coalescing
    # are active (_resident_solver) — so on this path the staging cache
    # provably does not exist.
    "CapacityServer.GetCapacity",
    # Mastership transitions swap the store engine and null the
    # resident solvers before persist.restore writes the fresh engine:
    # the staged cache dies with the old solver (engine handles are
    # meaningless across the swap), and a new cache cannot exist until
    # a new solver is built after this method returns.
    "CapacityServer._on_is_master",
    # The array decide pass (admission/coalesce.decide_grouped_arrays)
    # commits its grants in one bulk_assign; its sole caller,
    # CapacityServer.decide_bulk, owns the contract exactly like
    # Coalescer._decide_batch does for decide_grouped — it calls
    # _fused_stage after the batch's writes and _fused_invalidate on a
    # partially-applied batch (the exception path).
    "decide_grouped_arrays",
})
