"""BatchSolver: the per-tick snapshot/solve/write-back cycle around
solve_priority (port of doorman_tpu/solver/batch.py, its priority part).

    pack:       native store -> [R, K] PriorityBatch   (host, one dm_pack)
    solve:      solve_priority on the device            (K3 on CUDA)
    write-back: grants -> the store, one dm_apply call  (host)

The port's server ticks lane resources through the device-resident
solver (solver.resident); the BatchSolver carries the PRIORITY_BANDS
resources and their capacity groups. Its dense and edge-list lane parts
(the reference's fallback for lane resources) are not ported: a lane
resource handed to it raises NotImplementedError.

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
from doorman_tpu_torch.core.resource import Resource
from doorman_tpu_torch.core.snapshot import _bucket
from doorman_tpu_torch.native import NativeLeaseStore
from doorman_tpu_torch.solver.engine import PhaseLaps, place
from doorman_tpu_torch.solver.priority import PriorityBatch, solve_priority
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
    """Synchronous batched ticks of PRIORITY_BANDS resources on `device`
    ("cuda" by default, where each banded allocation is kernel K3;
    "cpu" only when asked, with the plain version)."""

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
        # its grants on the host), for status pages and checks.
        self.last_snapshot: "PrioritySnapshot | None" = None
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
    ) -> PrioritySnapshot:
        res_list = list(resources)
        for r in res_list:
            if r._decide_kind != AlgoKind.PRIORITY_BANDS:
                raise NotImplementedError(
                    f"not yet ported: the BatchSolver's lane part (dense "
                    f"and edge-list) for {r.id!r}; lane resources tick "
                    "through the resident solver"
                )
        return self._snapshot_priority(res_list, ph)

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

    def prepare(self, resources: Iterable[Resource]) -> PrioritySnapshot:
        """Phase 1 (host, in the thread that owns the stores): sweep
        expired leases and pack the snapshot."""
        self._tick_start = self._clock()
        ph = PhaseLaps(self.phase_s)
        res_list = list(resources)
        for r in res_list:
            r.store.clean()
        ph.lap("pack")
        return self.snapshot(res_list, ph)

    def solve(self, snap: PrioritySnapshot) -> np.ndarray:
        """Phase 2 (device; blocking — safe to run in an executor
        thread, touches no host store state): the grants [R, K] as a
        host array, also kept on the snapshot. On CUDA every banded
        allocation is a K3 launch; the download ends the phase."""
        ph = PhaseLaps(self.phase_s)
        gets = solve_priority(
            snap.batch, num_bands=snap.num_bands, use_kernel=True
        )
        snap.gets = gets.cpu().numpy()
        ph.lap("solve")
        return snap.gets

    def apply(
        self,
        resources: Iterable[Resource],
        snap: PrioritySnapshot,
        gets: np.ndarray,
        *,
        return_grants: bool = True,
    ) -> Dict[str, Dict[str, float]]:
        """Phase 3 (host, store-owning thread): one dm_apply call writes
        the grants back (grants only; demand that changed while the
        solve was in flight is preserved, and clients released mid-solve
        stay released); learning-mode segments keep the reported has.
        `return_grants=False` skips the per-client grant map."""
        ph = PhaseLaps(self.phase_s)
        by_id = {r.id: r for r in resources}
        out: Dict[str, Dict[str, float]] = {}
        self._apply_priority_native(by_id, snap, gets, out, return_grants)
        ph.lap("apply")
        self.last_snapshot = snap
        self.ticks += 1
        self.last_tick_seconds = self._clock() - self._tick_start
        return out

    def _apply_priority_native(
        self,
        by_id: Dict[str, Resource],
        part: PrioritySnapshot,
        gets: np.ndarray,
        out: Dict[str, Dict[str, float]],
        return_grants: bool,
    ) -> None:
        engine = part.engine
        n_seg = len(part.resource_ids)
        order = np.full(n_seg, -1, np.int32)
        keep_has = np.zeros(n_seg, np.uint8)
        for i, resource_id in enumerate(part.resource_ids):
            res = by_id.get(resource_id)
            if res is None:
                continue  # resource vanished mid-solve: skip its edges
            if getattr(res.store, "_engine", None) is not engine:
                continue  # store replaced mid-solve (mastership reset)
            order[i] = res.store._rid
            keep_has[i] = 1 if part.learning[i] else 0
        flat = np.asarray(gets[part.ridx, part.pos], np.float64)
        applied = engine.apply(order, part.ridx, part.cids, flat, keep_has)
        if not return_grants:
            return
        _rebuild_grant_map(
            engine, by_id, part.resource_ids, part.ridx, part.cids,
            applied, flat, keep_has, out,
        )

    def tick(self, resources: Iterable[Resource]) -> Dict[str, Dict[str, float]]:
        """One synchronous batched tick (prepare + solve + apply); a
        concurrent server runs the three phases separately so only
        `solve` leaves the store-owning thread."""
        res_list = list(resources)
        snap = self.prepare(res_list)
        gets = self.solve(snap)
        return self.apply(res_list, snap, gets)
