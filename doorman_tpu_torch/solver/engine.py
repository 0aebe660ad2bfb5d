"""The tick engine: the shared half of the device-resident solver (port of
doorman_tpu/solver/engine.py).

  staging   — what reaches the device this tick: the drained dirty set,
              the (optional) admission-fused pack cache (`FusedStaging`),
              and the compact transfer encoding (`bf16_exact`);
  solve     — the table solve, shaped by host knowledge from the config
              mirror (`ConfigTable`);
  delivery  — the rotation-and-dirty download back into the store of
              record (`_rotation_rows`, `TickEngineBase.collect`), with
              pipelining owned by `PipelinedTicker`.

The host classes are copies of the reference's; the device seams are
PyTorch: `place` (one counted host->device copy), `count_launch`, and
the landing of a tick's delivery slabs (utils.transfer).

There is one tick tail. The table rows always shard over a mesh
(solver.resident_mesh.MeshRows): the caller's parallel.mesh Mesh, or
without one a one-shard mesh over the solver's device — the single-
device tick is that mesh's one-shard case, not a second tail. Per-row
tables and config land one allocation per device group, viewed apart
per shard (`_put_rows`); per-segment config lands replicated on every
device group (`_put_rep`); the rotation walks per-shard cursors; a tick
stages one buffer and one host->device copy per device group (a
round-trip tick: one copy per block; `_upload`) and lands one delivery
slab per device group (`_land`), its changed and solve-moved masks in
the slab beside the grants. Only a caller's mesh publishes per-shard
accounting (`_account_shards`, `shard_launches`).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from doorman_tpu_torch.core.resource import Resource, algo_kind_for, static_param
from doorman_tpu_torch.obs.phases import PhaseRecorder
from doorman_tpu_torch.utils import dispatch as dispatch_mod
from doorman_tpu_torch.utils import transfer

log = logging.getLogger(__name__)

# Every tick engine exposes this phase vocabulary (cumulative seconds in
# phase_s). "fused" is the fused-tick device window: the single staged
# buffer placement, the staging->solve->delta launches and the download
# kickoff. A round-trip tick (fused=False) laps "upload" (one placement
# per staged block) and "solve" (the scatters, the full-table solve, the
# delta compare and the download kickoff) instead, never "fused".
# "aggregate" is the federated intermediate's band-masked subtree sum
# (federation/aggregate.py): its own name because it is not a lease
# solve at all. "match" is the stream fanout's changed-row -> subscriber
# intersection (server/match.py). Names and order are the reference's,
# so phase_s carries the same keys in both packages.
PHASES = (
    "sweep", "drain", "config", "pack", "staging", "upload", "solve",
    "fused", "aggregate", "match", "download", "apply", "delta", "rebuild",
)


def pow2_bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two (>= minimum): the scoped-solve
    compact table's row count, so its size classes stay O(log R)."""
    size = max(int(minimum), 1)
    while size < n:
        size *= 2
    return size


def ceil_to(n: int, m: int) -> int:
    """Round up to a multiple of m (>= m): per-tick scatter/delivery
    shapes track the true size to within m."""
    return max(m, ((n + m - 1) // m) * m)


def cat_rows(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row blocks joined in order on the first one's device; a single
    block is returned as it is (no copy)."""
    if len(parts) == 1:
        return parts[0]
    dev = parts[0].device
    return torch.cat([p if p.device == dev else p.to(dev) for p in parts])


def _joined(parts: Sequence[np.ndarray]) -> np.ndarray:
    """Host blocks joined in order; a single block as it is."""
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def place(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """The tick engine's single placement chokepoint: every device table,
    config column and staged per-tick buffer lands through here (one
    counted host->device copy)."""
    return transfer.place(arr, device)


def count_launch(n: int = 1) -> None:
    """Record a tick launch in the dispatch accounting."""
    dispatch_mod.count_dispatch(n)


def bf16_exact(arr: np.ndarray) -> bool:
    """True when `arr` round-trips bfloat16 exactly — then shipping the
    block as bf16 and casting back on device is byte-identical at half
    (f32) or a quarter (f64) of the upload bytes."""
    if arr.size == 0:
        return False
    # bfloat16 is float32's upper half: a value round-trips iff it is a
    # float32 (NaN never compares equal; a float64 past float32's range
    # casts to inf) whose low 16 bits are zero.
    with np.errstate(over="ignore", invalid="ignore"):
        f32 = arr.astype(np.float32, copy=False)
    return not (f32.view(np.uint32) & 0xFFFF).any() and bool(
        (f32 == arr).all())


def compact_index_dtype(limit: int):
    """int32 when every index below `limit` fits (half the index-upload
    bytes of int64), else int64."""
    return np.int32 if limit < 2**31 else np.int64


def bf16_bytes(arr: np.ndarray) -> np.ndarray:
    """The bfloat16 encoding of `arr` as raw bytes (round to nearest
    even, as torch casts)."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint8).ravel()


@dataclass
class TickHandle:
    """One in-flight tick: the delivery downloads plus everything
    collect() needs to write them back. parts=None marks an idle tick."""

    # One delivery slab download per device group: its shards' delivered
    # rows back to back, then — with `tracked` — their changed masks,
    # then their solve-moved masks (narrow: per shard, `scope_counts`
    # slots each; wide: the scope's per-segment mask, `moved_rows` rows
    # of group 0's slab); masks are {0,1} in the download dtype,
    # flattened slot-major. Shard-major order IS the sorted order of
    # sel_rows and scope_ids.
    parts: "list | None"
    sel_rows: np.ndarray  # [n_sel] row indices (unique)
    rids: np.ndarray  # [n_sel] engine resource handles
    versions: np.ndarray  # [n_sel] membership epochs at upload
    keep_has: np.ndarray  # [n_sel] uint8 (learning rows)
    n_sel: int = 0
    dispatched_at: float = 0.0
    collected: bool = False
    fused_windows: int = 0
    fused_rows: int = 0
    scope_ids: "np.ndarray | None" = None
    moved_rows: int = 0
    seq: int = 0
    # Wide (chunked) ticks only: the chunk number of each delivered row
    # (solver.resident_wide writes back with apply_chunks).
    chunks: "np.ndarray | None" = None
    # Per shard: delivered rows and (narrow scoped ticks) scope rows.
    shard_counts: "list | None" = None
    scope_counts: "list | None" = None
    tracked: bool = False


def idle_handle(now: float) -> TickHandle:
    return TickHandle(
        parts=None,
        sel_rows=np.zeros(0, np.int64),
        rids=np.zeros(0, np.int32),
        versions=np.zeros(0, np.uint64),
        keep_has=np.zeros(0, np.uint8),
        n_sel=0,
        dispatched_at=now,
    )


class ConfigTable:
    """Per-row config mirror: one pass over the templates only when the
    caller's config epoch moves; time-driven drift (learning-mode end,
    parent-lease expiry) recomputed vectorized every tick. `put` places
    the per-row vectors; `pad` is the padded row count."""

    def __init__(self, dtype, put: Callable):
        self._dtype = np.dtype(dtype)
        self._put = put
        self.pad = 0
        self.n_real = 0
        self.cap_h = self.learn_h = self.kind_h = self.statc_h = None
        self.cap_d = self.kind_d = self.statc_d = self.learn_d = None
        self._lanes = frozenset()
        self.refresh = None
        self._cap_raw = self._learn_end = self._parent_exp = None
        self._epoch = -1

    def reset(self, pad: int) -> None:
        """New layout (rebuild): drop every mirror so the next refresh
        re-reads and re-places everything."""
        self.pad = pad
        self.cap_h = self.learn_h = self.kind_h = self.statc_h = None
        self._lanes = frozenset()
        self._cap_raw = None

    def lanes(self) -> frozenset:
        """The AlgoKind values present among the real rows (read once a
        config epoch, where the kind vector is read)."""
        return self._lanes

    def derived_rotate(self, tick_interval: "float | None") -> "int | None":
        """Delivery covers the whole table at least once per refresh
        interval, capped at 64 ticks."""
        if not tick_interval or self.refresh is None or self.n_real == 0:
            return None
        return max(
            1,
            min(int(self.refresh[: self.n_real].min() / tick_interval), 64),
        )

    def _read(self, rows: Sequence[Resource]) -> None:
        pad = self.pad
        dtype = self._dtype
        cap = np.zeros(pad, dtype)
        kind = np.zeros(pad, np.int32)
        statc = np.zeros(pad, dtype)
        refresh = np.full(pad, 1.0, np.float64)
        learn_end = np.zeros(pad, np.float64)
        parent_exp = np.full(pad, np.inf, np.float64)
        for i, r in enumerate(rows):
            tpl = r.template
            cap[i] = tpl.capacity
            kind[i] = algo_kind_for(tpl)
            statc[i] = static_param(tpl)
            refresh[i] = float(tpl.algorithm.refresh_interval)
            learn_end[i] = r.learning_mode_end
            if r.parent_expiry is not None:
                parent_exp[i] = r.parent_expiry
        self.n_real = len(rows)
        self._cap_raw = cap
        self._learn_end = learn_end
        self._parent_exp = parent_exp
        self.refresh = refresh
        if self.kind_h is None or not np.array_equal(kind, self.kind_h):
            self.kind_h, self.kind_d = kind, self._put(kind)
        self._lanes = frozenset(
            int(k) for k in np.unique(kind[: self.n_real]))
        if self.statc_h is None or not np.array_equal(statc, self.statc_h):
            self.statc_h, self.statc_d = statc, self._put(statc)

    def refresh_view(
        self, rows: Sequence[Resource], config_epoch: int, now: float
    ) -> "np.ndarray | None":
        """Per-tick config view; returns the rows whose effective config
        changed this tick (they must be delivered this tick). None means
        "everything may have changed" (epoch moved / first tick)."""
        epoch_moved = config_epoch != self._epoch or self._cap_raw is None
        if epoch_moved:
            self._epoch = config_epoch
            self._read(rows)
        # Expired parent lease => capacity 0 (core/resource.py:capacity).
        cap = np.where(
            self._parent_exp < now, 0.0, self._cap_raw
        ).astype(self._dtype)
        learn = self._learn_end > now
        if epoch_moved or self.cap_h is None or self.learn_h is None:
            changed: "np.ndarray | None" = None
        else:
            mask = (cap != self.cap_h) | (learn != self.learn_h)
            changed = np.nonzero(mask)[0]
        if self.cap_h is None or not np.array_equal(cap, self.cap_h):
            self.cap_h, self.cap_d = cap, self._put(cap)
        if self.learn_h is None or not np.array_equal(learn, self.learn_h):
            self.learn_h, self.learn_d = learn, self._put(learn)
        return changed


class FusedStaging:
    """Admission-fused dirty-row staging: the window-time pack cache.

    A writer hands the rows it just wrote to `stage`, which packs them
    from the (authoritative) store at once; dispatch consumes the cache
    (`take`) after its drain. The drained dirty set stays the single
    source of truth for WHICH rows upload; the cache only short-circuits
    packing their VALUES. An entry is valid only while no store write
    touched its row after it was staged: untracked writers `invalidate`.
    The tick's own delivery write-back (`collect`), which in a pipeline
    lands between a window and the next dispatch, rewrites `has` only:
    so dispatch serves only wants-only rows from the cache (their upload
    is `wants`) and packs full-upload rows afresh. (The reference serves
    full rows from the cache too, and so can upload a delivered row's
    pre-delivery `has`; ROADMAP §C.) Thread-safe."""

    def __init__(self, engine):
        self._engine = engine
        self._lock = threading.Lock()
        self._cache: Dict[int, tuple] = {}  # guarded-by: self._lock
        self.windows = 0  # guarded-by: self._lock
        self.staged_rows = 0  # guarded-by: self._lock
        self.total_windows = 0  # guarded-by: self._lock
        self.total_staged_rows = 0  # guarded-by: self._lock

    def stage(self, rids, kfill: int) -> int:
        rids = np.unique(np.asarray(rids, np.int32))
        if kfill <= 0 or not len(rids):
            return 0
        w, h, s, act, counts, versions = self._engine.pack_rows(rids, kfill)
        with self._lock:
            self.windows += 1
            self.total_windows += 1
            self.staged_rows += len(rids)
            self.total_staged_rows += len(rids)
            for i, rid in enumerate(rids):
                self._cache[int(rid)] = (
                    kfill, w[i], h[i], s[i], act[i],
                    int(counts[i]), versions[i],
                )
        return len(rids)

    def invalidate(self, rid: "int | None" = None) -> None:
        with self._lock:
            if rid is None:
                self._cache.clear()
            else:
                self._cache.pop(int(rid), None)

    def take(self) -> Tuple[Dict[int, tuple], int, int]:
        with self._lock:
            cache, self._cache = self._cache, {}
            windows, self.windows = self.windows, 0
            rows, self.staged_rows = self.staged_rows, 0
            return cache, windows, rows

    def status(self) -> dict:
        with self._lock:
            return {
                "pending_rows": len(self._cache),
                "windows_total": self.total_windows,
                "staged_rows_total": self.total_staged_rows,
            }


class ScopeTracker:
    """Host mirror of the not-yet-at-fixpoint row set (the scoped solve's
    "frontier"). Invariant: any row whose next solve would differ from
    its resident grants is in the frontier.

      entry — at dispatch, when the host knows a row may move (dirty,
              config drift, or seed_all on rebuild / config epoch),
              stamped with the dispatch sequence;
      exit  — only when a collected tick reports the row unmoved (its
              fresh solve equals its input `has`);
      guard — exits apply only when the entry seq <= the reporting
              tick's seq, so a stale mask never evicts a re-entered row.
    """

    def __init__(self):
        self._entry: Dict[int, int] = {}  # unit id -> entry seq

    def __len__(self) -> int:
        return len(self._entry)

    def add(self, ids, seq: int) -> None:
        ids = np.asarray(ids).ravel()
        if len(ids):
            self._entry.update(zip(ids.tolist(), (seq,) * len(ids)))

    def seed_all(self, n_units: int, seq: int) -> None:
        self._entry = {i: seq for i in range(int(n_units))}

    def apply_moved(self, ids: np.ndarray, moved: np.ndarray,
                    seq: int) -> None:
        entry = self._entry
        ids = np.asarray(ids).ravel()
        moved = np.asarray(moved).ravel()
        for i in ids[~moved[: len(ids)]].tolist():
            if entry.get(i, seq + 1) <= seq:
                del entry[i]

    def ids(self) -> np.ndarray:
        if not self._entry:
            return np.zeros(0, np.int64)
        return np.sort(np.fromiter(self._entry, np.int64, len(self._entry)))

    def clear(self) -> None:
        self._entry = {}


class TickEngineBase:
    """The shared half of a device-resident tick engine: the stage
    skeleton (sweep -> drain -> config -> idle gate -> launch), placement,
    config mirroring, rotation, scope decisions and the collect/apply
    tail. Subclasses implement _needs_rebuild / rebuild / _drain /
    _drained_empty / _launch / _apply_grants."""

    component = "resident"
    supports_delta = False
    # Per-row config (narrow) lands like the table rows on a mesh;
    # per-segment config (wide) is replicated on every device group.
    replicated_config = False

    def __init__(
        self,
        engine,
        *,
        dtype=np.float32,
        device: torch.device,
        mesh=None,
        clock: Callable[[], float] = time.time,
        rotate_ticks: "int | None" = 8,
        tick_interval: "float | None" = None,
        download_dtype=None,
        fused: bool = True,
        scoped: bool = True,
    ):
        self._engine = engine
        self._dtype = np.dtype(dtype)
        self._tdtype = torch.float64 if self._dtype == np.float64 else torch.float32
        self._device = device
        # A parallel.mesh Mesh shards the table rows (and the per-tick
        # staging and delivery) over its shards; `device` is then the
        # first shard's. Without one the tables are a one-shard mesh
        # over `device`: the same tail, one group of one shard.
        from doorman_tpu_torch.parallel.combine import Combine
        from doorman_tpu_torch.parallel.mesh import Mesh
        from doorman_tpu_torch.solver.resident_mesh import MeshRows

        self._mesh = mesh
        layout = mesh if mesh is not None else Mesh(
            [device], [1], ("clients",))
        self._meshrows = MeshRows(layout)
        self._combine = Combine(layout)
        self._cursors = np.zeros(self._meshrows.n_dev, np.int64)
        # Kernel wrapper calls on CUDA shards, per shard (the wrappers'
        # own counters, dense_cuda.LAUNCHES, sum them): a caller's mesh
        # only, as every per-shard series.
        self.shard_launches = None if mesh is None else {
            k: [0] * mesh.size for k in ("k1", "k2")
        }
        self._clock = clock
        self._tick_interval = tick_interval
        self._rotate_override: "int | None" = None
        if rotate_ticks is None:
            self._rotate = 8
        else:
            self.rotate_ticks = rotate_ticks
        # Grants download in the solve dtype by default (bfloat16 on
        # request: half the bytes, ~0.4% rounding in the store).
        if download_dtype not in (None, torch.bfloat16):
            raise ValueError("download_dtype: None or torch.bfloat16")
        self._out_tdtype = download_dtype or self._tdtype
        self.ticks = 0
        self.idle_ticks = 0
        self.last_tick_seconds = 0.0
        self._quiet_ticks = 0
        self._just_rebuilt = False
        self._config = ConfigTable(
            self._dtype,
            self._put_rep if self.replicated_config else self._put_rows,
        )
        self._track_deltas = False
        self._changed_lock = threading.Lock()
        self._changed_rids: set = set()  # guarded-by: self._changed_lock
        # Fused (the default): one staged buffer, one placement, the
        # scoped or full solve and the delta compare in one window.
        # fused=False keeps the round-trip tick: a placement per staged
        # block and a full-table solve every tick, byte-identical.
        self._fused = bool(fused)
        self._scoped = bool(scoped)
        self._scope = ScopeTracker()
        self._seq = 0
        self._swept_removed = 0
        self._scope_reset = False
        self.last_solve_mode = "full"
        self.last_full_reason: "str | None" = "startup"
        self.last_scope: Dict[str, int] = {"rows": 0, "resources": 0}
        self.solve_modes: Dict[str, int] = {"scoped": 0, "full": 0}
        self._staging: "FusedStaging | None" = None
        self.last_fused: Dict[str, int] = {"windows": 0, "rows": 0}
        self.on_anomaly: "Callable[[str, dict], None] | None" = None
        self.phase_s: Dict[str, float] = {name: 0.0 for name in PHASES}

    # -- configuration ------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def rotate_ticks(self) -> int:
        return self._rotate

    @rotate_ticks.setter
    def rotate_ticks(self, value: int) -> None:
        self._rotate_override = max(int(value), 1)
        self._rotate = self._rotate_override

    @property
    def fused_tick(self) -> bool:
        return self._fused

    @fused_tick.setter
    def fused_tick(self, value: bool) -> None:
        """Runtime toggle (triage: flip a live server to the round-trip
        tick without a restart). Each launch picks its tail from this
        flag, so the next tick runs in the new mode; the frontier stays
        a superset of the unsettled rows (round-trip ticks only add to
        it), so turning fusion back on needs no re-seed."""
        self._fused = bool(value)

    @property
    def scoped_solve(self) -> bool:
        return self._scoped

    @scoped_solve.setter
    def scoped_solve(self, value: bool) -> None:
        """Turning scoped mode ON re-seeds the whole frontier on the next
        tick (while off, no moved masks flowed)."""
        value = bool(value)
        if value != self._scoped:
            self._scoped = value
            if value:
                self._scope_reset = True

    def scope_status(self) -> dict:
        return {
            "enabled": self._scoped,
            "last_mode": self.last_solve_mode,
            "last_full_reason": self.last_full_reason,
            "last_scope_rows": int(self.last_scope.get("rows", 0)),
            "frontier": len(self._scope),
            "scoped_ticks": int(self.solve_modes.get("scoped", 0)),
            "full_ticks": int(self.solve_modes.get("full", 0)),
        }

    def _scope_for_tick(
        self,
        dirty_units: np.ndarray,
        config_changed: "np.ndarray | None",
        n_units: int,
    ) -> "Tuple[np.ndarray | None, str | None]":
        """Per-tick solve-mode decision: (scope_ids, None) for a scoped
        tick, or (None, reason) when this tick must solve the full table.
        Reasons: rebuild, config-epoch, config-drift, expiry-sweep,
        scope-reset, round-trip (fused=False has no scoped variant),
        disabled.

        A unit is what the subclass solves as one: a row of the narrow
        solver, a whole resource SEGMENT of the wide one (its
        per-segment lanes couple every chunk row of the resource, so
        one dirty slot puts the segment's whole chunk span in scope)."""
        self._seq += 1
        seq = self._seq
        reason: "str | None" = None
        if not self._scoped:
            reason = "disabled"
        elif not self._fused:
            reason = "round-trip"
        elif self._swept_removed:
            reason = "expiry-sweep"
        if self._just_rebuilt or config_changed is None:
            self._scope.seed_all(n_units, seq)
            if reason is None:
                reason = "rebuild" if self._just_rebuilt else "config-epoch"
        elif self._scope_reset:
            self._scope.seed_all(n_units, seq)
            if reason is None:
                reason = "scope-reset"
        else:
            if len(dirty_units):
                self._scope.add(dirty_units, seq)
            if len(config_changed):
                cc = np.asarray(config_changed)
                self._scope.add(cc[cc < n_units], seq)
                if reason is None:
                    reason = "config-drift"
        self._scope_reset = False
        if reason is not None:
            self.last_solve_mode = "full"
            self.last_full_reason = reason
            self.solve_modes["full"] += 1
            return None, reason
        scope = self._scope.ids()
        if len(scope) and scope[-1] >= n_units:
            scope = scope[scope < n_units]
        self.last_solve_mode = "scoped"
        self.last_full_reason = None
        self.solve_modes["scoped"] += 1
        return scope, None

    def attach_staging(self) -> FusedStaging:
        if self._staging is None:
            self._staging = FusedStaging(self._engine)
        return self._staging

    def enable_delta_tracking(self) -> bool:
        """Turn on delivered-grant delta extraction; the next dispatch
        rebuilds so the previous-grants table exists. Idempotent."""
        if not self.supports_delta:
            return False
        if not self._track_deltas:
            self._track_deltas = True
            self._invalidate_layout()
        return True

    def _invalidate_layout(self) -> None:
        """Subclass hook: drop the device tables (forces a rebuild)."""

    @property
    def delta_tracking(self) -> bool:
        return self._track_deltas

    def take_changed_rids(self) -> list:
        """Drain the engine rids whose delivered grants changed since
        they were last delivered."""
        with self._changed_lock:
            out = list(self._changed_rids)
            self._changed_rids.clear()
        return out

    @property
    def staging(self) -> "FusedStaging | None":
        return self._staging

    @property
    def mesh(self):
        return self._mesh

    def _put_groups(self, arr) -> list:
        """Row placement: an array of the padded table's rows lands one
        copy per device group, holding that group's shards' rows only
        (shard-major), in group order."""
        arr = np.asarray(arr)
        Rl = arr.shape[0] // self._meshrows.n_dev
        return [place(arr[first * Rl:(first + n) * Rl], dev)
                for dev, first, n in self._meshrows.groups]

    def _put_rows(self, arr) -> list:
        """`_put_groups`, viewed apart per shard, in mesh order."""
        Rl = np.shape(arr)[0] // self._meshrows.n_dev
        return [t[i * Rl:(i + 1) * Rl]
                for t, (_d, _f, n) in zip(self._put_groups(arr),
                                          self._meshrows.groups)
                for i in range(n)]

    def _put_rep(self, arr) -> list:
        """Replicated placement (per-segment config): one copy per device
        group, in group order."""
        return [place(arr, dev) for dev, _f, _n in self._meshrows.groups]

    def _count_shard(self, kernel: str, shard: int, device) -> None:
        if self.shard_launches is not None and device.type == "cuda":
            self.shard_launches[kernel][shard] += 1

    def _account_shards(self, ph: PhaseRecorder, per_shard: Callable) -> None:
        """Per-shard payload bytes of a tick (obs.phases.shard_bytes;
        `per_shard()` gives the upload and download arrays), for a
        caller's mesh only: an unmeshed solver has no shard series."""
        if self._mesh is not None:
            upload, download = per_shard()
            ph.shard_bytes("upload", upload)
            ph.shard_bytes("download", download)

    def _reset_layout(self, rows: int) -> int:
        """A rebuild's padded row count: equal row blocks per shard, and
        fresh per-shard rotation cursors (the old ones indexed the old
        layout)."""
        self._cursors = np.zeros(self._meshrows.n_dev, np.int64)
        return self._meshrows.round_rows(rows)

    def _upload(self, ph: PhaseRecorder, blocks: Sequence[np.ndarray],
                extra: "Sequence[np.ndarray] | None" = None) -> list:
        """Stage and place one tick's host blocks: `blocks` are shard-
        major [n_dev, ...] arrays, of which each device group takes its
        own shards' rows, then its `extra` block, if any. A fused tick
        packs a group's blocks into one buffer and one host->device
        copy (every block's byte size is a multiple of 8, so each view
        stays aligned); a round-trip tick places each block on its own.
        Laps "staging" once the host side is packed and, round trip,
        "upload" after the placements. Returns per group its blocks'
        device views as flat bytes."""
        fused = self._fused
        host = []
        for g, (_dev, first, n) in enumerate(self._meshrows.groups):
            grp = [b[first:first + n].reshape(-1).view(np.uint8)
                   for b in blocks]
            if extra is not None:
                grp.append(extra[g].view(np.uint8))
            host.append((grp, np.concatenate(grp) if fused else None))
        ph.lap("staging")
        views = []
        for (dev, _f, _n), (grp, buf) in zip(self._meshrows.groups, host):
            if buf is None:
                views.append([place(b, dev) for b in grp])
                continue
            buf_d, o, cut = place(buf, dev), 0, []
            for b in grp:
                cut.append(buf_d[o: o + b.size])
                o += b.size
            views.append(cut)
        if not fused:
            ph.lap("upload")
        return views

    def _anomaly(self, kind: str, detail: dict) -> None:
        log.warning("%s: %s: %s", type(self).__name__, kind, detail)
        if self.on_anomaly is not None:
            try:
                self.on_anomaly(kind, detail)
            except Exception:
                log.exception("anomaly hook failed")

    def _refresh_config(
        self, rows: Sequence[Resource], config_epoch: int, now: float
    ) -> "np.ndarray | None":
        changed = self._config.refresh_view(rows, config_epoch, now)
        if self._rotate_override is None:
            derived = self._config.derived_rotate(self._tick_interval)
            if derived is not None:
                self._rotate = derived
        return changed

    def _rotation_rows(self, n_real: int) -> np.ndarray:
        """This tick's rotation slice: each shard advances its own cursor
        through its real rows of the padded table's `_Rp`
        (MeshRows.rotation_rows)."""
        mr = self._meshrows
        return mr.rotation_rows(
            self._cursors, n_real, self._Rp // mr.n_dev, self.rotate_ticks
        )

    # -- the stage skeleton -------------------------------------------

    def dispatch(
        self, resources: Sequence[Resource], config_epoch: int = 0
    ) -> TickHandle:
        """Sweep expiries, stage the dirty deltas, launch the solve, and
        start the grant download for this tick's delivered rows. Safe to
        run in an executor thread (the native engine is mutex-guarded).
        `config_epoch`: bump whenever templates / learning windows /
        parent leases changed outside the store."""
        ph = PhaseRecorder(self.component, self.phase_s)
        now = self._clock()
        removed = self._engine.clean_all(now)
        # The sweep dirties rows it does not name: a removal escalates
        # this tick to a full solve and drops the window pack cache.
        self._swept_removed = int(removed)
        if removed and self._staging is not None:
            self._staging.invalidate()
        ph.lap("sweep")
        res_list = list(resources)
        if self._needs_rebuild(res_list):
            self.rebuild(res_list)
            ph.lap("rebuild")

        drained = self._drain(ph)
        config_changed = self._refresh_config(res_list, config_epoch, now)
        ph.lap("config")

        # Idle fast path: no store change and no config movement for two
        # full rotations => the store holds the device fixpoint.
        quiet = (
            self._drained_empty(drained)
            and not self._just_rebuilt
            and config_changed is not None
            and len(config_changed) == 0
        )
        if quiet:
            self._quiet_ticks += 1
            if self._quiet_ticks > max(2 * self.rotate_ticks,
                                       self.rotate_ticks + 3):
                return idle_handle(now)
        else:
            self._quiet_ticks = 0
        return self._launch(res_list, drained, config_changed, now, ph)

    def collect(self, handle: TickHandle) -> int:
        """Write one tick's downloaded grants back into the engine; rows
        whose membership moved mid-flight are skipped. Returns the rows
        applied."""
        if handle.collected:
            return 0
        handle.collected = True
        if handle.parts is None:
            self.ticks += 1
            self.idle_ticks += 1
            self.last_tick_seconds = self._clock() - handle.dispatched_at
            return 0
        ph = PhaseRecorder(self.component, self.phase_s)
        gets, changed, moved = self._land(handle)
        ph.lap("download")
        applied = self._apply_grants(handle, gets)
        ph.lap("apply")
        if changed is not None:
            if changed.any():
                rids = handle.rids[changed]
                rids = rids[rids >= 0]
                if len(rids):
                    with self._changed_lock:
                        self._changed_rids.update(int(r) for r in rids)
            ph.lap("delta")
        if moved is not None:
            self._scope.apply_moved(handle.scope_ids, moved, handle.seq)
        self.ticks += 1
        self.last_tick_seconds = self._clock() - handle.dispatched_at
        return applied

    def _land(self, handle: TickHandle):
        """Land a tick's per-group slabs: (gets [n_sel, W], changed
        [n_sel] or None, moved aligned with scope_ids or None)."""
        gets, changed, moved = [], [], []
        for (_dev, first, n), part in zip(self._meshrows.groups, handle.parts):
            slab = transfer.land(part)
            W = slab.shape[1]
            n_sel = sum(handle.shard_counts[first:first + n])
            gets.append(slab[:n_sel])
            o = n_sel
            if handle.tracked:
                rows = -(-n_sel // W)
                changed.append(slab[o:o + rows].reshape(-1)[:n_sel] != 0.0)
                o += rows
            if handle.scope_counts is not None:
                n_sc = sum(handle.scope_counts[first:first + n])
                rows = -(-n_sc // W)
                moved.append(slab[o:o + rows].reshape(-1)[:n_sc] != 0.0)
            elif handle.moved_rows and first == 0:
                moved.append(
                    slab[o:o + handle.moved_rows].reshape(-1)[
                        : len(handle.scope_ids)] != 0.0
                )
        return (
            _joined(gets),
            _joined(changed) if handle.tracked else None,
            _joined(moved) if moved and handle.scope_ids is not None
            else None,
        )

    def step(
        self, resources: Sequence[Resource], config_epoch: int = 0
    ) -> int:
        """Dispatch a tick and collect it immediately."""
        return self.collect(self.dispatch(resources, config_epoch))

    # -- subclass hooks ------------------------------------------------

    def _needs_rebuild(self, resources: List[Resource]) -> bool:
        raise NotImplementedError

    def rebuild(self, resources: Sequence[Resource]) -> None:
        raise NotImplementedError

    def _drain(self, ph: PhaseRecorder):
        raise NotImplementedError

    def _drained_empty(self, drained) -> bool:
        raise NotImplementedError

    def _launch(self, resources, drained, config_changed, now, ph):
        raise NotImplementedError

    def _apply_grants(self, handle: TickHandle, gets: np.ndarray) -> int:
        raise NotImplementedError


class PipelinedTicker:
    """Depth-N dispatch/collect pipeline: up to `depth` ticks stay in
    flight, so tick N's delivery download lands concurrent with the
    staging and solve of ticks N+1..N+depth-1. Handles are stored WITH
    their engine; a handle whose engine was replaced is dropped, not
    collected."""

    def __init__(self, depth: int = 3):
        self.depth = max(int(depth), 1)
        self._queue: deque = deque()

    def __len__(self) -> int:
        return len(self._queue)

    def step(self, solver, resources, config_epoch: int = 0) -> TickHandle:
        while len(self._queue) >= self.depth:
            s, h = self._queue.popleft()
            if s is solver:
                s.collect(h)
        handle = solver.dispatch(resources, config_epoch)
        self._queue.append((solver, handle))
        return handle

    def flush(self, solver=None) -> int:
        n = 0
        remaining: deque = deque()
        while self._queue:
            s, h = self._queue.popleft()
            if solver is None or s is solver:
                s.collect(h)
                n += 1
            else:
                remaining.append((s, h))
        self._queue = remaining
        return n

    def drop(self) -> None:
        self._queue.clear()
