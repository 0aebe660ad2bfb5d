"""The capacity server (port of doorman_tpu/server/server.py: immediate
and batch mode, the Python and the native lease store, the resident
paths narrow and wide, fused and round-trip, and the BatchSolver).

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

What this port carries: both modes, both stores, the fused and the
round-trip tick (scoped by default), lane and PRIORITY_BANDS resources
of any width, capacity groups (batch mode only, as in the reference),
the trivial election, and the Discovery / GetCapacity / ReleaseCapacity
RPCs on the reference's wire service (doorman_tpu.Capacity). Not yet
ported, and refused loudly rather than served another way: the
intermediate-server role (GetServerCapacity) and stream push
(WatchCapacity). Unlike the reference, asking for the native store
where it cannot be built is an error, not a switch to the Python store.

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
from doorman_tpu_torch.algorithms import Request
from doorman_tpu_torch.algorithms.kinds import AlgoKind
from doorman_tpu_torch.core.resource import Resource
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto.grpc_api import (
    CapacityServicer,
    add_capacity_servicer,
)
from doorman_tpu_torch.server import config as config_mod
from doorman_tpu_torch.server.election import Election
from doorman_tpu_torch.solver import batch as batch_mod
from doorman_tpu_torch.solver.batch import BatchSolver
from doorman_tpu_torch.solver.engine import PipelinedTicker
from doorman_tpu_torch.solver.resident import (
    ResidentDenseSolver,
    ResidentOverflow,
)
from doorman_tpu_torch.solver.resident_wide import WideResidentSolver
from doorman_tpu_torch.utils.backend import device_info, resolve_device

log = logging.getLogger(__name__)


class CapacityServer(CapacityServicer):
    """A doorman server, immediate or batch mode, on the Python or the
    native lease store, with its batch tick on `device` ("cuda" by
    default; "cpu" only when asked)."""

    def __init__(
        self,
        server_id: str,
        election: Election,
        *,
        mode: str = "immediate",  # "immediate" | "batch"
        tick_interval: float = 1.0,
        clock: Callable[[], float] = time.time,
        native_store: bool = False,
        solver_dtype: str = "f64",
        fused_tick: bool = True,
        scoped_solve: bool = True,
        tick_pipeline_depth: int = 1,
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
        self.is_master = False
        self.became_master_at: float = 0.0
        self.mastership_epoch = 0
        self.current_master = ""
        self.config: Optional[pb.ResourceRepository] = None
        self.is_configured = asyncio.Event()
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
        if tick_loop and self.mode == "batch":
            self._tasks.append(asyncio.create_task(self._tick_loop()))
        return self.port

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        await self.election.stop()
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
        self.resources = {}
        self._reset_store_engine()
        # The engine was replaced: the resident solver's device tables
        # and any in-flight ticks refer to the old one.
        self._config_epoch += 1
        self._resident = None
        self._resident_pipe.drop()
        self._resident_wide = None
        self._resident_wide_pipe.drop()

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

    async def _tick_once_locked(self) -> None:
        if not self.resources:
            return
        resources = list(self.resources.values())
        loop = asyncio.get_running_loop()
        if not self._native_store:
            # Python stores: the pack and the write-back stay on the
            # event loop, so no RPC handler ever sees a half-packed or
            # half-applied store; only the device solve leaves it.
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
        await context.abort(
            grpc.StatusCode.UNIMPLEMENTED,
            "not yet ported: the intermediate-server role",
        )

    async def WatchCapacity(self, request, context):
        await context.abort(
            grpc.StatusCode.UNIMPLEMENTED, "not yet ported: stream push"
        )
        yield  # pragma: no cover - makes this an async generator

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
            if res is not None:
                res.release(request.client_id)
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
    # Status
    # ------------------------------------------------------------------

    def _phase_totals(self) -> dict:
        """Cumulative per-phase seconds of the resident paths; the wide
        solver's keys are prefixed `wide.` (the BatchSolver's ride in
        the `priority` block)."""
        out = {}
        if self._resident is not None:
            out.update(self._resident.phase_s)
        if self._resident_wide is not None:
            for k, v in self._resident_wide.phase_s.items():
                out[f"wide.{k}"] = v
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
        }
