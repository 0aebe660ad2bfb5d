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
the trivial election, the root and intermediate roles, and the
Discovery / GetCapacity / GetServerCapacity / ReleaseCapacity /
WatchCapacity RPCs on the reference's wire service
(doorman_tpu.Capacity). Cut seams: the parent exchange opens no trace
span and sends no trace metadata (obs/trace is not ported), and the
parent is dialed without TLS. Unlike the reference, asking for the
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
from typing import Callable, Dict, List, Optional

import grpc
import numpy as np

from doorman_tpu_torch import native
from doorman_tpu_torch.admission.policy import RETRY_AFTER_KEY, Shed
from doorman_tpu_torch.algorithms import Request
from doorman_tpu_torch.algorithms.kinds import AlgoKind
from doorman_tpu_torch.client.connection import Connection
from doorman_tpu_torch.core.resource import Resource
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto import doorman_stream_pb2 as spb
from doorman_tpu_torch.proto.grpc_api import (
    CapacityServicer,
    add_capacity_servicer,
)
from doorman_tpu_torch.server import config as config_mod
from doorman_tpu_torch.server.election import Election
from doorman_tpu_torch.server.match import SubscriptionMatcher
from doorman_tpu_torch.server.streams import StreamRegistry
from doorman_tpu_torch.solver import batch as batch_mod
from doorman_tpu_torch.solver.batch import BatchSolver
from doorman_tpu_torch.solver.engine import PipelinedTicker
from doorman_tpu_torch.solver.resident import (
    ResidentDenseSolver,
    ResidentOverflow,
)
from doorman_tpu_torch.solver.resident_wide import WideResidentSolver
from doorman_tpu_torch.utils.backend import device_info, resolve_device
from doorman_tpu_torch.utils.backoff import (
    MAX_BACKOFF,
    MIN_BACKOFF,
    VERY_LONG_TIME,
    backoff,
)

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
        mode: str = "immediate",  # "immediate" | "batch"
        tick_interval: float = 1.0,
        clock: Callable[[], float] = time.time,
        native_store: bool = False,
        solver_dtype: str = "f64",
        fused_tick: bool = True,
        scoped_solve: bool = True,
        tick_pipeline_depth: int = 1,
        minimum_refresh_interval: float = 5.0,
        stream_push: bool = False,
        max_streams_per_band: int = 0,
        stream_shards: int = 1,
        device="cuda",
    ):
        if mode not in ("immediate", "batch"):
            raise ValueError(f"unknown mode {mode!r}")
        if solver_dtype not in ("f32", "f64"):
            raise ValueError(f"unknown solver dtype {solver_dtype!r}")
        self.device = resolve_device(device)
        if native_store and not native.native_available():
            raise RuntimeError(
                "native store engine unavailable (g++ build failed?)"
            )
        self.id = server_id
        self.election = election
        self.mode = mode
        self.tick_interval = tick_interval
        self.minimum_refresh_interval = minimum_refresh_interval
        self._clock = clock
        self.solver_dtype = solver_dtype
        self._native_store = bool(native_store)
        self._fused_tick = bool(fused_tick)
        self._scoped_solve = bool(scoped_solve)
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
        self.mastership_epoch = 0
        self.current_master = ""
        self.config: Optional[pb.ResourceRepository] = None
        self.is_configured = asyncio.Event()
        self.parent_addr = parent_addr
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
        self.port: Optional[int] = None

        # Streaming lease push (server/streams.py): clients hold one
        # WatchCapacity stream instead of polling, and the tick-edge
        # fanout pushes only the rows whose lease moved. Off by default
        # (WatchCapacity answers UNIMPLEMENTED and clients fall back to
        # polling).
        self._streams: Optional[StreamRegistry] = None
        if stream_push:
            self._streams = StreamRegistry(
                self, max_streams_per_band=max_streams_per_band,
                shards=stream_shards,
            )
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

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    async def start(self, port: int = 0, host: str = "[::]",
                    tick_loop: bool = True) -> int:
        """Start serving gRPC and, in batch mode (unless `tick_loop` is
        False, for callers that drive tick_once themselves), the tick
        loop; returns the bound port."""
        server = grpc.aio.server()
        add_capacity_servicer(server, self)
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
            self._tasks.append(asyncio.create_task(self._updater_loop()))
        if tick_loop and self.mode == "batch":
            self._tasks.append(asyncio.create_task(self._tick_loop()))
        if self._streams is not None and self.mode != "batch":
            # Batch servers push at tick edges (tick_once); an
            # immediate-mode server has no tick, so the fanout gets its
            # own beat at the same cadence.
            self._tasks.append(asyncio.create_task(self._stream_loop()))
        return self.port

    async def stop(self) -> None:
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
    ) -> None:
        """Install a new ResourceRepository (validating it); the first load
        also enters the election."""
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
        self._config_epoch += 1
        self._push_groups()
        if first_time:
            self.is_configured.set()
            await self.election.run(
                self.id, self._on_is_master, self._on_current_master
            )
            return
        expiry_times = expiry_times or {}
        for resource_id, res in self.resources.items():
            res.load_config(
                config_mod.find_template(repo, resource_id),
                expiry_times.get(resource_id),
            )

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
        in learning mode."""
        self.is_master = is_master
        self.mastership_epoch += 1
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
        self.resources = {}
        self._server_bands = {}
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
        template = config_mod.find_template(self.config, resource_id)
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
                device=self.device,
                # Grant delivery rides the config's fastest refresh
                # cadence relative to this server's tick cadence.
                rotate_ticks=None, tick_interval=self.tick_interval,
                fused=self._fused_tick, scoped=self._scoped_solve,
            )
            if self._streams is not None:
                # Streaming lease push: the tick compares delivered rows
                # against a resident previous-grants table (K2's
                # epilogue on a full tick), so the fanout re-decides
                # only the subscribers of rows that actually moved.
                self._resident.enable_delta_tracking()
        return self._resident

    def _resident_wide_solver(self) -> WideResidentSolver:
        """The chunked resident solver of the wide lane resources
        (lazily created)."""
        if self._resident_wide is None:
            dtype = np.float64 if self.solver_dtype == "f64" else np.float32
            self._resident_wide = WideResidentSolver(
                self._store_engine, dtype=dtype, clock=self._clock,
                device=self.device,
                rotate_ticks=None, tick_interval=self.tick_interval,
                fused=self._fused_tick, scoped=self._scoped_solve,
            )
        return self._resident_wide

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
            await self._tick_once_locked()
            # Tick-edge stream fanout: push lease deltas to the
            # WatchCapacity subscribers of the rows this tick moved.
            self.push_streams()

    async def _tick_once_locked(self) -> None:
        if not self.resources:
            return
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
                    pipe.step(resident, narrow_res, epoch)
                if wide_res:
                    # The wide lane resources: their own device tables;
                    # the two resident solves are independent.
                    wide_pipe.step(wide, wide_res, epoch)
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
            changed_rids, check_all = self._stream_changed_rids()
            matched = {} if check_all else self._stream_match(changed_rids)
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

    async def GetCapacity(self, request, context):
        out = pb.GetCapacityResponse()
        if not self.is_master:
            out.mastership.CopyFrom(self._mastership())
            return out
        msg = config_mod.validate_get_capacity_request(request)
        if msg is not None:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, msg)
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

    async def GetServerCapacity(self, request, context):
        """One downstream server's aggregated demand, one sub-lease per
        (server, priority band): each band is decided as a client of the
        resource and the response carries the sum of the band grants.
        (The reference's admission tally and request log are not ported
        yet.)"""
        out = pb.GetServerCapacityResponse()
        if not self.is_master:
            out.mastership.CopyFrom(self._mastership())
            return out
        msg = config_mod.validate_get_server_capacity_request(request)
        if msg is not None:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, msg)
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
                res.release(_band_key(request.server_id, stale))
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
        mastership, validation, the per-band stream cap — then the
        registry owns the stream until it ends with a terminal
        mastership redirect. (The reference's admission gate and
        establishment ramp are not ported yet.)"""
        if self._streams is None:
            await context.abort(
                grpc.StatusCode.UNIMPLEMENTED,
                "stream push is disabled on this server (--stream-push)",
            )
        if not self.is_master:
            out = spb.WatchCapacityResponse()
            out.mastership.CopyFrom(self._mastership())
            yield out
            return
        msg = config_mod.validate_get_capacity_request(request)
        if msg is not None:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, msg)
        band = max((rr.priority for rr in request.resource), default=0)
        shed: Optional[Shed] = self._streams.check_cap(band)
        if shed is not None:
            # Same wire contract as a shed poll: the pacing hint rides
            # trailing metadata.
            context.set_trailing_metadata((
                (RETRY_AFTER_KEY, f"{shed.retry_after:.3f}"),
            ))
            await context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED, shed.reason
            )
        sub = self._streams.subscribe(request)
        # Bind the new stream into the device matcher's incidence
        # structure (a point scatter, not a rebuild).
        self._stream_match_add(sub)
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
        out = pb.ReleaseCapacityResponse()
        if not self.is_master:
            out.mastership.CopyFrom(self._mastership())
            return out
        msg = config_mod.validate_release_capacity_request(request)
        if msg is not None:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, msg)
        for resource_id in request.resource_id:
            res = self.resources.get(resource_id)
            if res is None:
                continue
            res.release(request.client_id)
            # A downstream *server* holds per-band sub-leases; release
            # them too and forget its band composition.
            key = (resource_id, request.client_id)
            for prio in self._server_bands.pop(key, set()):
                res.release(_band_key(request.client_id, prio))
            # Untracked write: a staged pack of this row predates the
            # release (see _fused_invalidate).
            self._fused_invalidate(resource_id)
        return out

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
        return lease, res

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
        (server.go:227-323). Returns (next_interval, next_retry_number)."""
        if self._parent_conn is None:
            self._parent_conn = Connection(
                self.parent_addr,
                minimum_refresh_interval=self.minimum_refresh_interval,
            )
        request = self._build_server_capacity_request()
        try:
            out = await self._parent_conn.execute(
                lambda stub: stub.GetServerCapacity(request)
            )
        except Exception:
            log.exception("%s: GetServerCapacity to parent failed", self.id)
            return (
                backoff(MIN_BACKOFF, MAX_BACKOFF, retry_number),
                retry_number + 1,
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
            await self.load_config(
                pb.ResourceRepository(resources=templates), expiry_times
            )
        except config_mod.ConfigError:
            log.exception("%s: loading parent-derived config failed", self.id)
            return (
                backoff(MIN_BACKOFF, MAX_BACKOFF, retry_number),
                retry_number + 1,
            )
        if (
            interval < self.minimum_refresh_interval
            or interval == VERY_LONG_TIME
        ):
            interval = self.minimum_refresh_interval
        return interval, 0

    async def _updater_loop(self) -> None:
        interval, retry = DEFAULT_INTERVAL, 0
        while True:
            await asyncio.sleep(interval)
            interval, retry = await self._perform_parent_requests(retry)

    # ------------------------------------------------------------------
    # Status
    # ------------------------------------------------------------------

    def _phase_totals(self) -> dict:
        """Cumulative per-phase seconds of the resident paths; the wide
        solver's keys are prefixed `wide.`, the stream matcher's
        `stream.` (the BatchSolver's ride in the `priority` block)."""
        out = {}
        if self._resident is not None:
            out.update(self._resident.phase_s)
        if self._resident_wide is not None:
            for k, v in self._resident_wide.phase_s.items():
                out[f"wide.{k}"] = v
        if self._stream_matcher is not None:
            # The stream fanout's staging/match/download laps.
            for k, v in self._stream_matcher.phase_s.items():
                if v:
                    out[f"stream.{k}"] = v
        return out

    def status(self) -> dict:
        solver = self._resident
        wide = self._resident_wide
        prio = self._solver
        return {
            "id": self.id,
            "mode": self.mode,
            "native_store": self._native_store,
            "fused_tick": self._fused_tick,
            "is_master": self.is_master,
            "current_master": self.current_master,
            "device": device_info(self.device),
            "solver_dtype": self.solver_dtype,
            "resources": len(self.resources),
            "leases": (
                int(self._store_engine.total_leases)
                if self._store_engine is not None
                else sum(len(r.store) for r in self.resources.values())
            ),
            "ticks": self._ticks_done,
            "idle_ticks": solver.idle_ticks if solver is not None else 0,
            "last_tick_seconds": (
                solver.last_tick_seconds if solver is not None else 0.0
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
            # Streaming lease push (None: stream push off).
            "streams": (
                self._streams.status()
                if self._streams is not None
                else None
            ),
        }
