"""BatchSolver: the per-tick snapshot/solve/write-back cycle (port of
doorman_tpu/solver/batch.py, on the native store).

    pack:       native store -> lane snapshot + priority part  (host)
    solve:      the lane part and solve_priority on the device
    write-back: grants -> the store, one dm_apply call per part (host)

The lane part packs dense — one [R, K] row per resource, solved by
kernel K1 on CUDA (solver.dense_cuda, at f32 and f64 alike) — while
every resource fits DENSE_MAX_K clients; a wider resource drops the
tick to the edge-list layout (core.snapshot.pack_edge_arrays,
solver.kernels.solve_tick, plain PyTorch with fixed-order segment
sums). The priority part carries the PRIORITY_BANDS resources and their
capacity groups (solve_priority, kernel K3 on CUDA). The server ticks
its lane resources through the resident solvers and comes here for the
priority part, and for every resource on the tick after a resident
overflow.

Write-back is grants only: expiry and refresh advance when each client
itself refreshes, never on delivery, so a client that stops refreshing
expires after one lease length even while the server stays busy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

from doorman_tpu_torch.algorithms.kinds import AlgoKind
from doorman_tpu_torch.core.resource import Resource, algo_kind_for, static_param
from doorman_tpu_torch.core.snapshot import (
    ResourceSpec,
    Snapshot,
    _bucket,
    pack_edge_arrays,
)
from doorman_tpu_torch.native import NativeLeaseStore
from doorman_tpu_torch.solver.dense import DenseBatch
from doorman_tpu_torch.solver.dense_cuda import solve_dense_k1
from doorman_tpu_torch.solver.engine import PhaseLaps, place
from doorman_tpu_torch.solver.kernels import solve_tick
from doorman_tpu_torch.solver.lanes import ITERATIVE_KINDS
from doorman_tpu_torch.solver.priority import PriorityBatch, solve_priority
from doorman_tpu_torch.solver.resident import DENSE_MAX_K, _round_rows
from doorman_tpu_torch.utils.backend import resolve_device


def _rebuild_grant_map(
    engine,
    by_id: Dict[str, Resource],
    resource_ids: List[str],
    ridx: np.ndarray,
    cids: np.ndarray,
    applied: np.ndarray,
    flat: np.ndarray,
    keep_has: np.ndarray,
    out: Dict[str, Dict[str, float]],
) -> None:
    """Rebuild {resource: {client: grant}} from an engine.apply result;
    learning-mode (keep_has) segments report the store's live has."""
    name = engine.client_name
    for i in np.nonzero(applied)[0]:
        seg = int(ridx[i])
        resource_id = resource_ids[seg]
        client_id = name(int(cids[i]))
        if keep_has[seg]:
            grant = by_id[resource_id].store.get(client_id).has
        else:
            grant = float(flat[i])
        out.setdefault(resource_id, {})[client_id] = grant


@dataclass
class PrioritySnapshot:
    """The PRIORITY_BANDS resources of one tick in the dense layout
    (solver.priority), packed from the native store: the flat
    ridx/cids/pos handle arrays locate each lease in the [R, K] table,
    and write-back is one dm_apply call."""

    resource_ids: List[str]
    learning: List[bool]
    batch: PriorityBatch
    num_bands: int
    engine: object
    ridx: np.ndarray  # [E] segment per edge
    cids: np.ndarray  # [E] client handles
    pos: np.ndarray  # [E] slot within the resource row
    gets: "np.ndarray | None" = None  # [R, K], filled by solve()


def _shared_native_engine(stores) -> "object | None":
    """The one StoreEngine behind every store, or None if the stores are
    not all native views on a single engine."""
    engines = set()
    for store in stores:
        if not isinstance(store, NativeLeaseStore):
            return None
        engines.add(id(store._engine))
    if len(engines) != 1:
        return None
    return stores[0]._engine


class BatchSolver:
    """Synchronous batched ticks on `device` ("cuda" by default, where
    the dense lane part is kernel K1 and each banded allocation kernel
    K3; "cpu" only when asked, with the plain versions)."""

    def __init__(
        self,
        *,
        dtype=np.float64,
        device="cuda",
        clock: Callable[[], float] = time.time,
    ):
        self._dtype = np.dtype(dtype)
        self._tdtype = torch.float64 if self._dtype == np.float64 else torch.float32
        self.device = resolve_device(device)
        self._clock = clock
        self._group_caps: Dict[str, float] = {}
        self.ticks = 0
        self.last_tick_seconds = 0.0
        self._tick_start = 0.0
        # The last snapshot written back (its tables stay on the device,
        # the priority part's grants on the host), for status pages and
        # checks.
        self.last_snapshot: "Snapshot | None" = None
        # Cumulative per-phase wall time (seconds); keys pre-created so
        # concurrent readers can iterate while a tick updates values.
        # "bands" is the host's per-resource wire-priority ranking.
        self.phase_s: Dict[str, float] = {
            name: 0.0 for name in ("pack", "bands", "solve", "apply")
        }

    def set_groups(self, group_caps: Dict[str, float]) -> None:
        """Install the config's capacity groups (name -> shared cap);
        referenced by PRIORITY_BANDS resources via
        ResourceTemplate.capacity_group."""
        self._group_caps = dict(group_caps)

    def snapshot(
        self, resources: Iterable[Resource], ph: "PhaseLaps | None" = None
    ) -> Snapshot:
        """Pack one tick: the lane resources into the lane part (dense
        up to DENSE_MAX_K clients a resource, else an edge list), the
        PRIORITY_BANDS resources into `priority_part`."""
        ph = ph if ph is not None else PhaseLaps({})
        res_list, prio_res = [], []
        for r in resources:
            is_prio = r._decide_kind == AlgoKind.PRIORITY_BANDS
            (prio_res if is_prio else res_list).append(r)
        part = self._snapshot_priority(prio_res, ph) if prio_res else None
        if res_list:
            snap = self._snapshot_lanes(res_list)
        else:
            snap = Snapshot(edges=None, resources=None, resource_ids=[],
                            num_edges=0)
        snap.priority_part = part
        ph.lap("pack")
        return snap

    def _snapshot_lanes(self, res_list: List[Resource]) -> Snapshot:
        """One dm_pack call dumps every lease of every lane resource as
        flat, resource-major edge arrays; they go to the dense layout
        while the widest resource fits a dense row, else to the edge
        list."""
        specs = [
            ResourceSpec(
                resource_id=r.id,
                capacity=r.capacity,
                algo_kind=algo_kind_for(r.template),
                learning=r.in_learning_mode,
                static_capacity=static_param(r.template),
            )
            for r in res_list
        ]
        stores = [r.store for r in res_list]
        engine = _shared_native_engine(stores)
        if engine is None:
            raise NotImplementedError(
                "not yet ported: the Python-store lane pack (the port's "
                "BatchSolver packs one native StoreEngine)"
            )
        ridx, cid, wants, has, sub, _prio = engine.pack(stores)
        counts = np.bincount(ridx, minlength=len(specs))
        kmax = int(counts.max()) if len(counts) else 0
        if len(ridx) and kmax <= DENSE_MAX_K:
            return self._pack_dense(
                specs, ridx, cid, wants, has, sub, counts, engine
            )
        dev = self.device
        return pack_edge_arrays(
            specs,
            ridx,
            wants.astype(self._dtype, copy=False),
            has.astype(self._dtype, copy=False),
            sub.astype(self._dtype, copy=False),
            dtype=self._dtype,
            to_device=lambda a: place(a, dev),
            engine=engine,
            cids=cid,
        )

    def _pack_dense(
        self,
        specs: List[ResourceSpec],
        ridx: np.ndarray,
        cid: np.ndarray,
        wants: np.ndarray,
        has: np.ndarray,
        sub: np.ndarray,
        counts: np.ndarray,
        engine: object,
    ) -> Snapshot:
        """Scatter the engine's flat edge arrays into the [R, K] dense
        layout (rows filled contiguously from lane 0, resource-major
        order preserved)."""
        dtype = self._dtype
        n_spec = len(specs)
        R = _round_rows(n_spec)
        K = _bucket(int(counts.max()), 8)
        starts = np.zeros(n_spec + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        pos = np.arange(len(ridx), dtype=np.int64) - starts[ridx]
        w = np.zeros((R, K), dtype)
        h = np.zeros((R, K), dtype)
        s = np.zeros((R, K), dtype)
        act = np.zeros((R, K), bool)
        w[ridx, pos] = wants
        h[ridx, pos] = has
        s[ridx, pos] = sub
        act[ridx, pos] = True
        cap = np.zeros(R, dtype)
        kind = np.zeros(R, np.int32)
        learn = np.zeros(R, bool)
        statc = np.zeros(R, dtype)
        for i, spec in enumerate(specs):
            cap[i] = spec.capacity
            kind[i] = int(spec.algo_kind)
            learn[i] = spec.learning
            statc[i] = spec.static_capacity
        dev = self.device
        dense = DenseBatch(
            wants=place(w, dev), has=place(h, dev), subclients=place(s, dev),
            active=place(act, dev), capacity=place(cap, dev),
            algo_kind=place(kind, dev), learning=place(learn, dev),
            static_capacity=place(statc, dev),
        )
        # The download slices to the filled extent, rounded up to
        # multiples of 8.
        n_rows = min(R, -(-n_spec // 8) * 8)
        kfill = min(K, -(-int(counts.max()) // 8) * 8)
        snap = Snapshot(
            edges=None,
            resources=None,
            resource_ids=[spec.resource_id for spec in specs],
            num_edges=len(ridx),
            learning=[bool(spec.learning) for spec in specs],
            engine=engine,
            ridx=ridx,
            cids=cid,
            dense=dense,
            pos=pos,
            dense_fill=(n_rows, kfill),
        )
        # Host lane knowledge for the plain solve (solver.lanes fast
        # paths, byte-identical): the kinds present, and each iterative
        # lane's rows padded to a bucketed length (repeats are
        # harmless). K1 on the card computes its row's lane alone and
        # takes neither.
        snap.dense_lanes = frozenset(int(k) for k in np.unique(kind[:n_spec]))
        if dev.type == "cpu":
            iter_rows = {}
            for k in sorted(ITERATIVE_KINDS & snap.dense_lanes):
                rows = np.nonzero(kind[:n_spec] == int(k))[0].astype(np.int32)
                if len(rows):
                    iter_rows[k] = torch.from_numpy(
                        np.resize(rows, _bucket(len(rows), 8))
                    )
            snap.dense_iter = iter_rows or None
        return snap

    def _snapshot_priority(
        self, prio_res: List[Resource], ph: "PhaseLaps | None" = None
    ) -> PrioritySnapshot:
        """Dense pack of the PRIORITY_BANDS resources: higher wire
        priority = lower band rank; capacity groups resolved against the
        config's group caps. One dm_pack call, no per-lease Python
        objects."""
        ph = ph if ph is not None else PhaseLaps({})
        R = len(prio_res)
        dtype = self._dtype
        capacity = np.zeros(R, dtype)
        group = np.full(R, -1, np.int32)
        learning: List[bool] = []
        group_ids: Dict[str, int] = {}
        group_caps: List[float] = []
        for i, res in enumerate(prio_res):
            capacity[i] = res.capacity
            learning.append(res.in_learning_mode)
            tpl = res.template
            if tpl.HasField("capacity_group"):
                name = tpl.capacity_group
                if name in self._group_caps:
                    if name not in group_ids:
                        group_ids[name] = len(group_caps)
                        group_caps.append(float(self._group_caps[name]))
                    group[i] = group_ids[name]

        stores = [r.store for r in prio_res]
        engine = _shared_native_engine(stores)
        if engine is None:
            raise NotImplementedError(
                "not yet ported: the Python-store priority pack (the "
                "port's BatchSolver packs one native StoreEngine)"
            )
        ridx, cids, wants_f, _has_f, sub_f, prio_f = engine.pack(stores)
        counts = np.bincount(ridx, minlength=R)
        K = _bucket(int(counts.max()) if len(ridx) else 1, 8)
        starts = np.zeros(R + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        pos = np.arange(len(ridx), dtype=np.int64) - starts[ridx]
        wants = np.zeros((R, K), dtype)
        weights = np.zeros((R, K), dtype)
        band = np.zeros((R, K), np.int32)
        active = np.zeros((R, K), bool)
        wants[ridx, pos] = wants_f
        weights[ridx, pos] = sub_f
        active[ridx, pos] = True
        ph.lap("pack")
        num_bands = 1
        band_f = np.zeros(len(ridx), np.int32)
        for i in range(R):
            s, e = starts[i], starts[i + 1]
            if s == e:
                continue
            levels = np.unique(prio_f[s:e])[::-1]  # descending
            num_bands = max(num_bands, len(levels))
            band_f[s:e] = np.searchsorted(-levels, -prio_f[s:e])
        band[ridx, pos] = band_f
        ph.lap("bands")

        dev = self.device
        batch = PriorityBatch(
            wants=place(wants, dev),
            weights=place(weights, dev),
            band=place(band, dev),
            active=place(active, dev),
            capacity=place(capacity, dev),
            group=place(group, dev),
            group_cap=place(np.asarray(group_caps, dtype), dev),
        )
        ph.lap("pack")
        return PrioritySnapshot(
            resource_ids=[r.id for r in prio_res],
            learning=learning,
            batch=batch,
            num_bands=_bucket(num_bands, 1),
            engine=engine,
            ridx=ridx,
            cids=cids,
            pos=pos,
        )

    def prepare(self, resources: Iterable[Resource]) -> Snapshot:
        """Phase 1 (host, in the thread that owns the stores): sweep
        expired leases and pack the snapshot."""
        self._tick_start = self._clock()
        ph = PhaseLaps(self.phase_s)
        res_list = list(resources)
        for r in res_list:
            r.store.clean()
        ph.lap("pack")
        return self.snapshot(res_list, ph)

    def solve(self, snap: Snapshot) -> np.ndarray:
        """Phase 2 (device; blocking — safe to run in an executor
        thread, touches no host store state): the lane part's grants as
        a flat host array in edge order; the priority part's grants
        [R, K] land on the part. On CUDA the dense lane part is one K1
        launch and every banded allocation a K3 launch; the downloads
        end the phase."""
        ph = PhaseLaps(self.phase_s)
        part = snap.priority_part
        if part is not None:
            prio_gets = solve_priority(
                part.batch, num_bands=part.num_bands, use_kernel=True
            )
        if snap.dense is not None:
            n_rows, kfill = snap.dense_fill
            got = solve_dense_k1(
                snap.dense, lanes=snap.dense_lanes, lane_rows=snap.dense_iter
            )[:n_rows, :kfill].cpu().numpy()
            gets = got[snap.ridx, snap.pos]
        elif snap.edges is not None:
            gets = solve_tick(snap.edges, snap.resources).cpu().numpy()
        else:
            gets = np.zeros(0)
        if part is not None:
            part.gets = prio_gets.cpu().numpy()
        ph.lap("solve")
        return gets

    def apply(
        self,
        resources: Iterable[Resource],
        snap: Snapshot,
        gets: np.ndarray,
        *,
        return_grants: bool = True,
    ) -> Dict[str, Dict[str, float]]:
        """Phase 3 (host, store-owning thread): one dm_apply call per
        part writes the grants back (grants only; demand that changed
        while the solve was in flight is preserved, and clients released
        mid-solve stay released); learning-mode segments keep the
        reported has. `return_grants=False` skips the per-client grant
        map."""
        ph = PhaseLaps(self.phase_s)
        by_id = {r.id: r for r in resources}
        out: Dict[str, Dict[str, float]] = {}
        if snap.engine is not None:
            self._apply_native(
                snap.engine, by_id, snap.resource_ids, snap.learning,
                snap.ridx, snap.cids, np.asarray(gets[: snap.num_edges]),
                out, return_grants,
            )
        part = snap.priority_part
        if part is not None:
            self._apply_native(
                part.engine, by_id, part.resource_ids, part.learning,
                part.ridx, part.cids, part.gets[part.ridx, part.pos],
                out, return_grants,
            )
        ph.lap("apply")
        self.last_snapshot = snap
        self.ticks += 1
        self.last_tick_seconds = self._clock() - self._tick_start
        return out

    def _apply_native(
        self,
        engine,
        by_id: Dict[str, Resource],
        resource_ids: List[str],
        learning: List[bool],
        ridx: np.ndarray,
        cids: np.ndarray,
        flat: np.ndarray,
        out: Dict[str, Dict[str, float]],
        return_grants: bool,
    ) -> None:
        n_seg = len(resource_ids)
        order = np.full(n_seg, -1, np.int32)
        keep_has = np.zeros(n_seg, np.uint8)
        for i, resource_id in enumerate(resource_ids):
            res = by_id.get(resource_id)
            if res is None:
                continue  # resource vanished mid-solve: skip its edges
            if getattr(res.store, "_engine", None) is not engine:
                continue  # store replaced mid-solve (mastership reset)
            order[i] = res.store._rid
            keep_has[i] = 1 if learning[i] else 0
        flat = np.asarray(flat, np.float64)
        applied = engine.apply(order, ridx, cids, flat, keep_has)
        if not return_grants:
            return
        _rebuild_grant_map(
            engine, by_id, resource_ids, ridx, cids, applied, flat,
            keep_has, out,
        )

    def tick(self, resources: Iterable[Resource]) -> Dict[str, Dict[str, float]]:
        """One synchronous batched tick (prepare + solve + apply); a
        concurrent server runs the three phases separately so only
        `solve` leaves the store-owning thread."""
        res_list = list(resources)
        snap = self.prepare(res_list)
        gets = self.solve(snap)
        return self.apply(res_list, snap, gets)
