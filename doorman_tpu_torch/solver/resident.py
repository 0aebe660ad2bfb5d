"""Device-resident steady-state tick solver, narrow rows (port of
doorman_tpu/solver/resident.py: the fused tick and the round-trip tick,
on one device or row-sharded over a mesh).

The dense [R, K] demand tables stay RESIDENT on the device between
ticks and only what changed moves:

  staging:  rows whose solver-visible inputs changed since the last tick
            (the native engine tracks dirtiness per resource), packed on
            the host into ONE uint8 buffer — int32 indices, the
            wants-only block (bf16 when that round-trips exactly), the
            full-row has/subclients block, the scope indices, the active
            flags — and sent with one host->device copy; the tick views
            the blocks apart at static byte offsets and scatters them
            into the tables in place.
  solve:    scoped by default to the dirty rows plus the not-yet-
            converged frontier (engine.ScopeTracker): K1 solves those
            rows straight out of the resident tables and the fresh
            grants are written back into the resident grant table; any
            escalation (rebuild, config epoch/drift, expiry sweep) solves
            the full table — K1, or K2 when delta tracking is on. `has`
            chains on device from the previous tick's grants.
  delivery: only the rows delivered this tick — every dirty row, every
            config-changed row, and a rotating slice covering the table
            every `rotate_ticks` ticks — as one slab (grants, then the
            changed mask, then the scope's moved mask) copied to the
            host on a copy stream; collect() applies it to the store.

The round-trip tick (fused=False, `--no-fused-tick`) keeps the
reference's multi-dispatch baseline: one placement per staged block,
K1 over the full table every tick (scope reason "round-trip") and, with
delta tracking, the changed mask compared in plain torch ops rather
than K2 — byte-identical stores and changed rows.

On a CUDA device the solve runs the hand-written kernels of
solver.dense_cuda for f32 and f64 alike; on the CPU (device="cpu") the
same wrappers take their plain PyTorch versions.

With `mesh=` (a parallel.mesh Mesh) the tables shard their rows over
the mesh's shards (solver.resident_mesh). Rows are independent, so a
mesh tick needs no combine: each device group of the mesh gets one
packed staging buffer and one host->device copy a tick (its shards'
blocks, shard-local indices, viewed apart at static offsets), K1 — or
K2 on a tracked full tick — runs once per shard over that shard's rows
(the scoped tick: its own scope rows), and each group's delivery lands
as one slab (`_stage_mesh`). Per-row arithmetic is the single-device
tick's, so the stores are byte-identical to it.

Write-back safety: each row records the resource's membership epoch at
upload; `apply_dense` skips rows whose epoch moved while the solve was in
flight (the change dirtied the row, so the next tick re-delivers it).
"""

from __future__ import annotations

import time
from typing import Callable, List, Sequence

import numpy as np
import torch

from doorman_tpu_torch.core.resource import Resource
from doorman_tpu_torch.core.snapshot import _bucket
from doorman_tpu_torch.obs.phases import PhaseRecorder
from doorman_tpu_torch.solver.dense import DenseBatch
from doorman_tpu_torch.solver.dense_cuda import fused_tick_k2, solve_dense_k1
from doorman_tpu_torch.solver.engine import (
    TickEngineBase,
    TickHandle,
    bf16_bytes,
    bf16_exact,
    ceil_to,
    count_launch,
    place,
    pow2_bucket,
)
from doorman_tpu_torch.solver.lanes import ITERATIVE_KINDS
from doorman_tpu_torch.solver.resident_mesh import (
    group_by_shard,
    mesh_device,
    pad_shard_blocks,
    pad_shard_indices,
)
from doorman_tpu_torch.utils import transfer
from doorman_tpu_torch.utils.backend import resolve_device

# The widest resource a dense row holds (doorman_tpu/solver/batch.py).
DENSE_MAX_K = 4096


def _round_rows(n: int) -> int:
    """Dense row padding: powers of two while small, multiples of 1024
    beyond (padding waste bounded at ~10%)."""
    if n <= 1024:
        return _bucket(max(n, 1), 16)
    return -(-n // 1024) * 1024


def _iter_positions(kind: np.ndarray, lanes: frozenset):
    """(layout, concatenated position segments or None): the positions
    of each iterative lane's rows within `kind`, one segment per
    ITERATIVE_KINDS lane in `lanes` (an empty lane repeats position 0;
    no lane reads a level at a row of another kind)."""
    present = sorted(ITERATIVE_KINDS & set(lanes))
    if not present:
        return (), None
    segments, layout, off = [], [], 0
    for k in present:
        p = np.nonzero(kind == int(k))[0].astype(np.int32)
        if not len(p):
            p = np.zeros(1, np.int32)
        segments.append(p)
        layout.append((int(k), off, len(p)))
        off += len(p)
    return tuple(layout), np.concatenate(segments)


def _lane_rows(layout: tuple, buf: "torch.Tensor | None"):
    """solve_lanes' per-kind `lane_rows` dict, sliced from a positions
    buffer by its (kind, offset, length) layout."""
    if buf is None or not layout:
        return None
    return {k: buf[off: off + ln] for (k, off, ln) in layout}


class ResidentOverflow(RuntimeError):
    """A resource outgrew the dense bucket cap (DENSE_MAX_K)."""


class ResidentDenseSolver(TickEngineBase):
    """Steady-state batched ticks with the device as the table of record,
    for lane-algorithm resources backed by one native StoreEngine.

    `device` defaults to "cuda" and raises without a GPU; pass
    device="cpu" to run the plain PyTorch solve on the host."""

    component = "resident"
    supports_delta = True

    def __init__(
        self,
        engine,
        *,
        dtype=np.float32,
        device="cuda",
        mesh=None,
        clock: Callable[[], float] = time.time,
        rotate_ticks: "int | None" = 8,
        tick_interval: "float | None" = None,
        download_dtype=None,
        fused: bool = True,
        scoped: bool = True,
    ):
        super().__init__(
            engine,
            dtype=dtype,
            device=mesh_device(mesh) if mesh is not None
            else resolve_device(device),
            mesh=mesh,
            clock=clock,
            rotate_ticks=rotate_ticks,
            tick_interval=tick_interval,
            download_dtype=download_dtype,
            fused=fused,
            scoped=scoped,
        )
        self._rows: List[Resource] = []
        self._row_lut = np.full(1, -1, np.int64)
        self._R = 0  # real rows
        self._Rp = 0  # padded rows
        self._K = 8
        self._kfill = 8
        self._uploaded_versions = np.zeros(0, np.uint64)
        self._rids = np.zeros(0, np.int32)
        # Device tables, updated in place by each tick.
        self._wants = self._has = self._sub = self._act = None
        # Resident previous-DELIVERED-grants table (delta tracking), in
        # the download dtype; None until enable_delta_tracking() and the
        # next rebuild.
        self._prev = None
        # Plain-path iterative-lane rows of the full table (mesh: one
        # per shard), rebuilt when the config's kind vector moves.
        self._iter_src = None
        self._iter_rows_d = None
        self._iter_layout = ()

    # -- build / rebuild ----------------------------------------------

    def rebuild(self, resources: Sequence[Resource]) -> None:
        """Full pack: (re)upload every table. Called on first use and
        whenever the resource set or bucket width moves."""
        rows = list(resources)
        self._rows = rows
        self._R = len(rows)
        max_rid = max((r.store._rid for r in rows), default=-1)
        self._row_lut = np.full(max_rid + 2, -1, np.int64)
        for i, r in enumerate(rows):
            self._row_lut[r.store._rid] = i
        # +1 reserves a padding row: ticks with no dirty rows scatter a
        # zero row there instead of disturbing a live row's has chain.
        self._Rp = _round_rows(self._R + 1)
        if self._meshrows is not None:
            # Equal row blocks per shard; fresh per-shard rotation
            # cursors (the old ones indexed the old partition).
            self._Rp = self._meshrows.round_rows(self._Rp)
            self._rotation.reset(self._meshrows.n_dev)
        else:
            self._rotation.reset()
        self._rids = np.full(self._Rp, -1, np.int32)
        for i, r in enumerate(rows):
            self._rids[i] = r.store._rid
        # Drain BEFORE packing (a write between pack and drain would
        # lose its flag); the rebuild also invalidates the pack cache.
        self._engine.drain_dirty2()
        if self._staging is not None:
            self._staging.invalidate()
        K = self._K
        while True:
            w, h, s, act, counts, versions = self._engine.pack_rows(
                self._rids, K
            )
            kmax = int(counts.max()) if len(counts) else 1
            # A row past the cap overflows below: no repack at a width
            # no table will take.
            if kmax <= K or kmax > DENSE_MAX_K:
                break
            K = _bucket(kmax, 8)
        if kmax > DENSE_MAX_K:
            self._wants = None
            raise ResidentOverflow(
                f"resource with {kmax} clients exceeds the dense bucket "
                f"cap {DENSE_MAX_K}"
            )
        self._K = K
        self._kfill = min(K, ceil_to(kmax, 8))
        dtype = self._dtype
        put = self._put if self._meshrows is None else self._put_rows
        self._wants = put(w.astype(dtype))
        self._has = put(h.astype(dtype))
        self._sub = put(s.astype(dtype))
        self._act = put(act.astype(bool))
        # The previous-grants table starts at the store's current has, in
        # the download dtype (the compare sees the bytes the host would).
        if not self._track_deltas:
            self._prev = None
        elif self._meshrows is None:
            self._prev = self._put(h.astype(dtype)).to(self._out_tdtype)
        else:
            self._prev = [t.to(self._out_tdtype)
                          for t in self._put_rows(h.astype(dtype))]
        self._uploaded_versions = versions
        self._config.reset(self._Rp)
        self._iter_src = None
        self._refresh_config(rows, self._config._epoch, self._clock())
        self._just_rebuilt = True

    def _invalidate_layout(self) -> None:
        self._wants = None
        self._prev = None

    def _needs_rebuild(self, resources: List[Resource]) -> bool:
        return (
            self._wants is None
            or len(resources) != self._R
            or any(a is not b for a, b in zip(resources, self._rows))
        )

    def _full_lane_rows(self, lanes: frozenset):
        """Plain path only: each iterative lane's rows of the full table
        (the solve restricts each fill to them — byte-identical)."""
        kind_h = self._config.kind_h
        if kind_h is not self._iter_src:
            self._iter_src = kind_h
            layout, pos = _iter_positions(kind_h[: self._R], lanes)
            self._iter_layout = layout
            self._iter_rows_d = (
                torch.from_numpy(pos) if pos is not None else None
            )
        return _lane_rows(self._iter_layout, self._iter_rows_d)

    # -- drain / pack ---------------------------------------------------

    def _drain(self, ph: PhaseRecorder):
        """Drain the engine's dirty-row flags and resolve them to table
        rows; also consumes the fused pack cache."""
        dirty_rids, full_flags = self._engine.drain_dirty2()
        if len(dirty_rids):
            lut = self._row_lut
            clamped = np.minimum(dirty_rids, len(lut) - 1)
            rows_all = lut[clamped]
            oob = dirty_rids != clamped
            if oob.any() and (rows_all[oob] >= 0).any():
                detail = {
                    "oob_rids": np.asarray(dirty_rids[oob][:8]).tolist(),
                    "lut_size": int(len(lut)),
                }
                self._anomaly("dirty_rid_alias", detail)
                raise AssertionError(
                    "resident row LUT reserved slot is not -1: "
                    f"out-of-range rids would alias live rows {detail}"
                )
            valid = rows_all >= 0
            dirty_rows = rows_all[valid]
            dirty_full = full_flags[valid].astype(bool)
        else:
            dirty_rows = np.zeros(0, np.int64)
            dirty_full = np.zeros(0, bool)
        if self._staging is not None:
            fused, fwin, frows = self._staging.take()
        else:
            fused, fwin, frows = None, 0, 0
        ph.lap("drain")
        return dirty_rows, dirty_full, fused, fwin, frows

    def _drained_empty(self, drained) -> bool:
        return len(drained[0]) == 0

    def _pack_rows_fused(self, pack_rids: np.ndarray, kfill: int, fused,
                         n_full: int = 0):
        """Pack the given rids at lane width kfill, serving rows from the
        window-time pack cache where a valid entry exists and one C pack
        call for the rest. The first `n_full` rids are full uploads
        (has, subclients, active too): packed afresh, since a delivery
        write-back may have moved their `has` after the window staged
        them (engine.FusedStaging)."""
        n = len(pack_rids)
        hit = np.zeros(n, bool)
        entries = []
        if fused:
            for i in range(n_full, n):
                rid = pack_rids[i]
                e = fused.get(int(rid))
                if e is not None and e[0] == kfill:
                    hit[i] = True
                    entries.append(e)
        if not hit.any():
            w, h, s, act, counts, versions = self._engine.pack_rows(
                pack_rids, kfill
            )
            return w, h, s, act, counts, versions, 0
        w = np.zeros((n, kfill), np.float64)
        h = np.zeros((n, kfill), np.float64)
        s = np.zeros((n, kfill), np.float64)
        act = np.zeros((n, kfill), np.uint8)
        counts = np.zeros(n, np.int32)
        versions = np.zeros(n, np.uint64)
        miss = ~hit
        if miss.any():
            mw, mh, ms, mact, mcounts, mversions = self._engine.pack_rows(
                pack_rids[miss], kfill
            )
            w[miss], h[miss], s[miss], act[miss] = mw, mh, ms, mact
            counts[miss], versions[miss] = mcounts, mversions
        pos = np.nonzero(hit)[0]
        w[pos] = np.stack([e[1] for e in entries])
        h[pos] = np.stack([e[2] for e in entries])
        s[pos] = np.stack([e[3] for e in entries])
        act[pos] = np.stack([e[4] for e in entries])
        counts[pos] = [e[5] for e in entries]
        versions[pos] = [e[6] for e in entries]
        return w, h, s, act, counts, versions, int(hit.sum())

    def stage_rids(self, rids) -> int:
        """Admission-window entry point: pack the given engine rids into
        the fused staging cache at the current lane width."""
        if self._staging is None:
            return 0
        return self._staging.stage(rids, self._kfill)

    # -- the tick ---------------------------------------------------------

    def _launch(self, res_list, drained, config_changed, now, ph):
        dirty_rows, dirty_full, fused, fwin, frows = drained
        dirty_real = dirty_rows  # pre-sentinel: the frontier entries
        if len(dirty_rows) == 0:
            # No demand changes: scatter the reserved zero padding row.
            dirty_rows = np.asarray([self._R], np.int64)
            dirty_full = np.asarray([False])
        # Full-upload rows first, wants-only rows after.
        order = np.concatenate(
            [dirty_rows[dirty_full], dirty_rows[~dirty_full]]
        )
        n_full = int(dirty_full.sum())
        pack_rids = self._rids[order]
        while True:
            w, h, s, act, counts, versions, rows_hit = (
                self._pack_rows_fused(pack_rids, self._kfill, fused, n_full)
            )
            kmax = int(counts.max()) if len(counts) else 0
            if kmax <= self._kfill:
                break
            if ceil_to(kmax, 8) > self._K:
                # Bucket overflow: a resource outgrew the lane width.
                self.rebuild(res_list)
                order = np.asarray([self._R], np.int64)
                n_full = 0
                pack_rids = self._rids[order]
                fused = None
            else:
                self._kfill = min(self._K, ceil_to(kmax, 8))
        # Rows whose membership epoch moved between drain and pack are
        # promoted to full uploads.
        is_full = np.zeros(len(order), bool)
        is_full[:n_full] = True
        is_full |= versions != self._uploaded_versions[order]
        self._uploaded_versions[order] = versions
        scope, _forced = self._scope_for_tick(
            dirty_real, config_changed, self._R
        )
        n_scope = len(scope) if scope is not None else self._R
        self.last_scope = {"rows": int(n_scope), "resources": int(n_scope)}
        ph.lap("pack")

        # Delivery set: dirty + config-changed + rotation slice, or every
        # row on a rebuild / epoch-moved tick.
        if self._just_rebuilt or config_changed is None:
            self._just_rebuilt = False
            sel = np.arange(max(self._R, 1), dtype=np.int64)
        else:
            rot = self._rotation_rows(
                self._R,
                self._Rp // self._meshrows.n_dev if self._meshrows else 0,
            )
            parts = [order, rot]
            if len(config_changed):
                parts.append(config_changed[config_changed < self._R])
            sel = np.unique(np.concatenate(parts))
        n_sel = len(sel)
        if self._meshrows is not None:
            return self._stage_mesh(order, is_full, w, h, s, act, sel, now,
                                    ph, fwin, rows_hit, scope)

        kfill = self._kfill
        dtype = self._dtype
        Da = ceil_to(len(order), 64)
        Df = ceil_to(int(is_full.sum()), 8)
        Sb = ceil_to(n_sel, 256)
        a_pad = np.resize(np.arange(len(order)), Da)
        a_idx = order[a_pad]
        a_w = np.ascontiguousarray(w[a_pad, :kfill]).astype(dtype)
        use_bf16 = bf16_exact(a_w)
        f_pos = np.nonzero(is_full)[0]
        if len(f_pos):
            f_pad = np.resize(f_pos, Df)
            f_idx = order[f_pad]
            f_block = np.stack([h[f_pad, :kfill], s[f_pad, :kfill]]).astype(dtype)
            f_act = np.ascontiguousarray(act[f_pad, :kfill]).astype(bool)
        else:
            f_idx = np.full(Df, self._R, np.int64)
            f_block = np.zeros((2, Df, kfill), dtype)
            f_act = np.zeros((Df, kfill), bool)
        sel_pad = np.resize(sel, Sb)
        idx_host = np.concatenate([a_idx, f_idx, sel_pad]).astype(np.int32)
        lanes = self._config.lanes()
        plain = self._device.type == "cpu"
        if not self._fused:
            return self._launch_round_trip(
                ph, now, sel, idx_host, a_w, use_bf16, f_block, f_act,
                lanes, fwin, rows_hit,
            )

        # Scope block: the pow2-bucketed compact row set (padding slots
        # repeat the reserved padding row: duplicates solve identical
        # inputs and write identical grants), then — plain path only —
        # each iterative lane's positions within it.
        clayout = ()
        scope_host = np.zeros(0, np.int32)
        Cb = 0
        if scope is not None:
            Cb = min(pow2_bucket(len(scope), 8), self._Rp)
            pos = None
            if plain:
                clayout, pos = _iter_positions(
                    self._config.kind_h[scope], lanes
                )
            scope_host = np.full(
                Cb + (len(pos) if pos is not None else 0), self._R, np.int32
            )
            scope_host[: len(scope)] = scope
            if pos is not None:
                scope_host[Cb:] = pos
        # One buffer, one host->device copy. Every block's byte offset is
        # a multiple of its element size (Da, Df, Sb are multiples of 8).
        buf = np.concatenate([
            idx_host.view(np.uint8),
            bf16_bytes(a_w) if use_bf16 else a_w.view(np.uint8).ravel(),
            np.ascontiguousarray(f_block).view(np.uint8).ravel(),
            scope_host.view(np.uint8),
            f_act.view(np.uint8).ravel(),
        ])
        ph.lap("staging")

        buf_d = self._put(buf)
        tdt = self._tdtype
        o = 0

        def take(nbytes):
            nonlocal o
            part = buf_d[o: o + nbytes]
            o += nbytes
            return part

        idx = take(idx_host.nbytes).view(torch.int32).long()
        a_w_d = take(a_w.size * (2 if use_bf16 else a_w.itemsize)).view(
            torch.bfloat16 if use_bf16 else tdt
        ).reshape(Da, kfill).to(tdt)
        f_block_d = take(f_block.nbytes).view(tdt).reshape(2, Df, kfill)
        scope_d = take(scope_host.nbytes).view(torch.int32)
        f_act_d = (take(f_act.size) != 0).reshape(Df, kfill)
        a_i, f_i, sel_i = idx[:Da], idx[Da:Da + Df], idx[Da + Df:]
        batch = self._scatter(a_i, a_w_d, f_i, f_block_d, f_act_d)
        cfg = self._config
        out_dt = self._out_tdtype
        changed = None
        moved = None
        if scope is not None:
            rows_c = scope_d[:Cb]
            h_c = self._has[rows_c.long()]
            gets_c = solve_dense_k1(
                batch, rows=rows_c, lanes=lanes,
                lane_rows=_lane_rows(clayout, scope_d[Cb:]),
            )
            # The fixpoint test, in the solve dtype: a scope row whose
            # fresh solve equals its input has is back at rest.
            moved = (gets_c != h_c).any(dim=1)
            self._has.index_copy_(0, rows_c.long(), gets_c)
            out = self._has[sel_i, :kfill].to(out_dt)
            if self._track_deltas:
                changed = (out != self._prev[sel_i, :kfill]).any(dim=1)
                self._prev[sel_i, :kfill] = out
        else:
            lane_rows = self._full_lane_rows(lanes) if plain else None
            if self._track_deltas:
                delivered = torch.zeros(
                    self._Rp, dtype=torch.bool, device=self._device
                )
                delivered[sel_i] = True
                gets, self._prev, changed_rows = fused_tick_k2(
                    batch, self._prev, delivered, lanes=lanes,
                    lane_rows=lane_rows,
                )
                changed = changed_rows[sel_i]
            else:
                gets = solve_dense_k1(batch, lanes=lanes, lane_rows=lane_rows)
            # `gets` IS the next tick's has: grants chain on device.
            self._has = gets
            out = gets[sel_i, :kfill].to(out_dt)
        slab = [out]
        mask_rows = moved_rows = 0
        if changed is not None:
            mask_rows = -(-Sb // kfill)
            slab.append(self._mask_rows(changed, mask_rows, kfill))
        if moved is not None:
            moved_rows = -(-Cb // kfill)
            slab.append(self._mask_rows(moved, moved_rows, kfill))
        slab = torch.cat(slab, dim=0) if len(slab) > 1 else out
        count_launch()
        download = transfer.start_download(slab)
        ph.lap("fused")
        self.last_fused = {"windows": fwin, "rows": rows_hit}
        return TickHandle(
            out=download,
            sel_rows=sel,
            rids=self._rids[sel],
            versions=self._uploaded_versions[sel],
            keep_has=cfg.learn_h[sel].astype(np.uint8),
            n_sel=n_sel,
            dispatched_at=now,
            fused_windows=fwin,
            fused_rows=rows_hit,
            mask_rows=mask_rows,
            scope_ids=scope,
            moved_rows=moved_rows,
            seq=self._seq,
        )

    def _scatter(self, a_i, a_w, f_i, f_block, f_act) -> DenseBatch:
        """This tick's row scatters over the first `kfill` lanes (the
        wants-only rows, then the full rows' has, subclients and active
        flags); the resident tables as a DenseBatch."""
        kfill = self._kfill
        self._wants[a_i, :kfill] = a_w
        self._has[f_i, :kfill] = f_block[0]
        self._sub[f_i, :kfill] = f_block[1]
        self._act[f_i, :kfill] = f_act
        cfg = self._config
        return DenseBatch(
            wants=self._wants, has=self._has, subclients=self._sub,
            active=self._act, capacity=cfg.cap_d, algo_kind=cfg.kind_d,
            learning=cfg.learn_d, static_capacity=cfg.statc_d,
        )

    def _launch_round_trip(self, ph, now, sel, idx_host, a_w, use_bf16,
                           f_block, f_act, lanes, fwin, rows_hit):
        """The round-trip tail (reference solver/resident.py `_launch`
        :1566-1625, `_tick_fn` :523): four placements (indices, the
        wants-only block, bf16 when exact, the full rows' has and
        subclients, their active flags), the scatters over the first
        `kfill` lanes, K1 over the full table, the delivered rows in the
        download dtype and, with delta tracking, the changed mask
        against the previous-grants table; then one download, the mask
        rows packed after the grants. The same scatters, solve and
        compare as the fused tick, so the stores are byte-identical."""
        ph.lap("staging")
        kfill = self._kfill
        tdt = self._tdtype
        Da, Df = a_w.shape[0], f_act.shape[0]
        Sb = len(idx_host) - Da - Df
        put = self._put
        idx = put(idx_host).long()
        if use_bf16:
            a_w_d = put(bf16_bytes(a_w).view(np.int16).reshape(a_w.shape))
            a_w_d = a_w_d.view(torch.bfloat16)
        else:
            a_w_d = put(a_w)
        f_block_d = put(f_block)
        f_act_d = put(f_act)
        ph.lap("upload")
        a_i, f_i, sel_i = idx[:Da], idx[Da:Da + Df], idx[Da + Df:]
        batch = self._scatter(a_i, a_w_d.to(tdt), f_i, f_block_d, f_act_d)
        cfg = self._config
        lane_rows = (
            self._full_lane_rows(lanes) if self._device.type == "cpu" else None
        )
        gets = solve_dense_k1(batch, lanes=lanes, lane_rows=lane_rows)
        # `gets` IS the next tick's has: grants chain on device.
        self._has = gets
        out = gets[sel_i, :kfill].to(self._out_tdtype)
        slab, mask_rows = out, 0
        if self._track_deltas:
            changed = (out != self._prev[sel_i, :kfill]).any(dim=1)
            self._prev[sel_i, :kfill] = out
            mask_rows = -(-Sb // kfill)
            slab = torch.cat(
                [out, self._mask_rows(changed, mask_rows, kfill)], dim=0
            )
        count_launch()
        download = transfer.start_download(slab)
        ph.lap("solve")
        self.last_fused = {"windows": fwin, "rows": rows_hit}
        return TickHandle(
            out=download,
            sel_rows=sel,
            rids=self._rids[sel],
            versions=self._uploaded_versions[sel],
            keep_has=cfg.learn_h[sel].astype(np.uint8),
            n_sel=len(sel),
            dispatched_at=now,
            fused_windows=fwin,
            fused_rows=rows_hit,
            mask_rows=mask_rows,
            seq=self._seq,
        )

    def _mask_rows(self, mask: torch.Tensor, n_rows: int, kfill: int):
        """A bool mask as {0,1} rows of the slab (download dtype)."""
        flat = torch.zeros(
            n_rows * kfill, dtype=self._out_tdtype, device=mask.device
        )
        flat[: mask.shape[0]] = mask.to(self._out_tdtype)
        return flat.reshape(n_rows, kfill)

    # -- the mesh tick -------------------------------------------------

    def _shard_lane_rows(self, d: int, lanes: frozenset):
        """Plain path only: each iterative lane's rows of shard d's real
        rows, shard-local (the mesh analog of _full_lane_rows)."""
        kind_h = self._config.kind_h
        if kind_h is not self._iter_src:
            self._iter_src = kind_h
            Rl = self._Rp // self._meshrows.n_dev
            self._iter_layout = []
            for e in range(self._meshrows.n_dev):
                kinds = kind_h[e * Rl: min((e + 1) * Rl, self._R)]
                layout, pos = _iter_positions(kinds, lanes)
                self._iter_layout.append(
                    (layout, torch.from_numpy(pos) if pos is not None
                     else None))
        return _lane_rows(*self._iter_layout[d])

    def _stage_mesh(self, order, is_full, w, h, s, act, sel, now, ph,
                    fwin, rows_hit, scope):
        """The mesh tail of the launch: this tick's row scatters, scope
        and delivery set grouped by owning shard (shard-local indices,
        padded per shard to one width; padded slots are never read), one
        staged buffer and one host->device copy per device group (its
        shards' blocks only), then per shard the scatters, K1 over its
        scope rows or its whole table (K2 on a tracked full tick), and
        its delivered rows; each group's delivery lands as one slab."""
        mr = self._meshrows
        n_dev = mr.n_dev
        Rl = self._Rp // n_dev
        kfill = self._kfill
        dtype = self._dtype
        owner_a = order // Rl
        counts_a, (a_idx_l, a_w_l) = group_by_shard(
            owner_a, n_dev, [order - owner_a * Rl, w[:, :kfill]]
        )
        f_pos = np.nonzero(is_full)[0]
        rows_f = order[f_pos]
        owner_f = rows_f // Rl
        counts_f, (f_idx_l, f_h_l, f_s_l, f_a_l) = group_by_shard(
            owner_f, n_dev,
            [rows_f - owner_f * Rl, h[f_pos, :kfill], s[f_pos, :kfill],
             act[f_pos, :kfill]],
        )
        # sel is sorted, so the stable grouping keeps its order exactly:
        # the handle's global bookkeeping needs no permutation.
        owner_sel = sel // Rl
        counts_sel, (sel_l,) = group_by_shard(
            owner_sel, n_dev, [sel - owner_sel * Rl]
        )
        Da = ceil_to(int(counts_a.max()), 8)
        Df = ceil_to(int(counts_f.max()), 8)
        Sb = ceil_to(int(counts_sel.max()), 8)
        a_idx_b, a_w_b, f_idx_b, f_h_b, f_s_b, f_a_b = (
            pad_shard_blocks(counts_a, Da, [(a_idx_l, 0),
                                            (a_w_l.astype(dtype), 0)])
            + pad_shard_blocks(counts_f, Df, [
                (f_idx_l, 0), (f_h_l.astype(dtype), 0),
                (f_s_l.astype(dtype), 0), (f_a_l.astype(bool), False)])
        )
        use_bf16 = bf16_exact(a_w_b)
        f_block = np.stack([f_h_b, f_s_b], axis=1)  # [n_dev, 2, Df, k]
        idx_host = np.concatenate(
            [a_idx_b, f_idx_b, pad_shard_indices(counts_sel, Sb, sel_l)],
            axis=1,
        ).astype(np.int32)
        counts_c = None
        Cb = 0
        if scope is not None:
            # Per-shard scoped extents: the sorted global scope groups
            # into contiguous shard-local blocks.
            owner_c = scope // Rl
            counts_c, (scope_l,) = group_by_shard(
                owner_c, n_dev, [scope - owner_c * Rl]
            )
            Cb = ceil_to(int(counts_c.max()), 8)
            (scope_b,) = pad_shard_blocks(counts_c, Cb, [(scope_l, 0)])
            scope_b = scope_b.astype(np.int32)
        itemsize = dtype.itemsize
        ph.shard_bytes(
            "upload",
            counts_a * (kfill * itemsize + 4)
            + counts_f * (kfill * (2 * itemsize + 1) + 4)
            + counts_sel * 4
            + (counts_c * 4 if counts_c is not None else 0),
        )
        ph.shard_bytes(
            "download",
            counts_sel * kfill * self._out_tdtype.itemsize,
        )
        lanes = self._config.lanes()
        plain = self._device.type == "cpu"
        tdt = self._tdtype
        track = self._track_deltas
        fused = self._fused
        parts = []
        for dev, first, n in mr.groups:
            grp = slice(first, first + n)
            blocks = [
                idx_host[grp],
                bf16_bytes(a_w_b[grp]).view(np.int16) if use_bf16
                else a_w_b[grp],
                f_block[grp],
                f_a_b[grp],
            ]
            if scope is not None:
                blocks.append(scope_b[grp])
            if fused:
                # One buffer, one host->device copy for the group; every
                # block's byte offset is a multiple of its element size
                # (each block's width is a multiple of 8).
                buf_d = place(
                    np.concatenate([np.ascontiguousarray(b).view(np.uint8)
                                    .ravel() for b in blocks]), dev)
                o = 0
                views = []
                for b in blocks:
                    nbytes = b.size * b.itemsize
                    views.append(buf_d[o: o + nbytes])
                    o += nbytes
                idx, a_w_d, f_block_d, f_act_d = (
                    views[0].view(torch.int32), views[1], views[2],
                    views[3])
                scope_d = (views[4].view(torch.int32)
                           if scope is not None else None)
            else:
                idx, a_w_d, f_block_d, f_act_d = (
                    place(b, dev) for b in blocks[:4])
                scope_d = None
            idx = idx.reshape(n, -1).long()
            a_w_d = a_w_d.view(torch.bfloat16 if use_bf16 else tdt).reshape(
                n, Da, kfill).to(tdt)
            f_block_d = f_block_d.view(tdt).reshape(n, 2, Df, kfill)
            f_act_d = (f_act_d.view(torch.uint8) != 0).reshape(n, Df, kfill)
            if scope_d is not None:
                scope_d = scope_d.reshape(n, Cb)
            outs, changed, moved = [], [], []
            for i in range(n):
                d = first + i
                ca, cf, cs = (int(counts_a[d]), int(counts_f[d]),
                              int(counts_sel[d]))
                a_i = idx[i, :ca]
                f_i = idx[i, Da:Da + cf]
                sel_i = idx[i, Da + Df:Da + Df + cs]
                self._wants[d][a_i, :kfill] = a_w_d[i, :ca]
                self._has[d][f_i, :kfill] = f_block_d[i, 0, :cf]
                self._sub[d][f_i, :kfill] = f_block_d[i, 1, :cf]
                self._act[d][f_i, :kfill] = f_act_d[i, :cf]
                batch = self._shard_batch(d)
                out, ch, mv = self._solve_shard(
                    d, batch, sel_i, lanes, plain,
                    scope_d[i, :int(counts_c[d])] if scope is not None
                    else None,
                    scope[int(counts_c[:d].sum()):][:int(counts_c[d])]
                    if scope is not None else None,
                )
                outs.append(out)
                if ch is not None:
                    changed.append(ch)
                if mv is not None:
                    moved.append(mv)
            slab = [torch.cat(outs)]
            if track:
                ch = torch.cat(changed)
                slab.append(self._mask_rows(ch, -(-ch.shape[0] // kfill),
                                            kfill))
            if scope is not None:
                mv = torch.cat(moved)
                slab.append(self._mask_rows(mv, -(-mv.shape[0] // kfill),
                                            kfill))
            count_launch()
            parts.append(transfer.start_download(torch.cat(slab)))
        ph.lap("fused" if fused else "solve")
        self.last_fused = {"windows": fwin, "rows": rows_hit}
        cfg = self._config
        return TickHandle(
            out=None,
            sel_rows=sel,
            rids=self._rids[sel],
            versions=self._uploaded_versions[sel],
            keep_has=cfg.learn_h[sel].astype(np.uint8),
            n_sel=len(sel),
            dispatched_at=now,
            fused_windows=fwin,
            fused_rows=rows_hit,
            scope_ids=scope,
            seq=self._seq,
            parts=parts,
            shard_counts=counts_sel,
            scope_counts=counts_c,
            tracked=track,
        )

    def _shard_batch(self, d: int) -> DenseBatch:
        cfg = self._config
        return DenseBatch(
            wants=self._wants[d], has=self._has[d], subclients=self._sub[d],
            active=self._act[d], capacity=cfg.cap_d[d],
            algo_kind=cfg.kind_d[d], learning=cfg.learn_d[d],
            static_capacity=cfg.statc_d[d],
        )

    def _solve_shard(self, d, batch, sel_i, lanes, plain, rows_c, scope_g):
        """Shard d's solve and delivery: (delivered rows in the download
        dtype, changed mask or None, solve-moved mask or None). The
        single-device tick's arithmetic on the shard's rows."""
        kfill = self._kfill
        out_dt = self._out_tdtype
        dev = batch.wants.device
        if rows_c is not None:
            moved = torch.zeros(0, dtype=torch.bool, device=dev)
            if rows_c.shape[0]:
                lane_rows = None
                if plain:
                    layout, pos = _iter_positions(
                        self._config.kind_h[scope_g], lanes)
                    lane_rows = _lane_rows(
                        layout, torch.from_numpy(pos) if pos is not None
                        else None)
                h_c = self._has[d][rows_c.long()]
                gets_c = solve_dense_k1(batch, rows=rows_c, lanes=lanes,
                                        lane_rows=lane_rows)
                self._count_shard("k1", d, dev)
                moved = (gets_c != h_c).any(dim=1)
                self._has[d].index_copy_(0, rows_c.long(), gets_c)
            out = self._has[d][sel_i, :kfill].to(out_dt)
            changed = None
            if self._track_deltas:
                changed = (out != self._prev[d][sel_i, :kfill]).any(dim=1)
                self._prev[d][sel_i, :kfill] = out
            return out, changed, moved
        lane_rows = self._shard_lane_rows(d, lanes) if plain else None
        if self._track_deltas and self._fused:
            delivered = torch.zeros(batch.wants.shape[0], dtype=torch.bool,
                                    device=dev)
            delivered[sel_i] = True
            gets, self._prev[d], changed_rows = fused_tick_k2(
                batch, self._prev[d], delivered, lanes=lanes,
                lane_rows=lane_rows,
            )
            self._count_shard("k2", d, dev)
            self._has[d] = gets
            return gets[sel_i, :kfill].to(out_dt), changed_rows[sel_i], None
        gets = solve_dense_k1(batch, lanes=lanes, lane_rows=lane_rows)
        self._count_shard("k1", d, dev)
        # `gets` IS the next tick's has: grants chain on device.
        self._has[d] = gets
        out = gets[sel_i, :kfill].to(out_dt)
        changed = None
        if self._track_deltas:
            # The round-trip tick compares in plain ops, as on one device.
            changed = (out != self._prev[d][sel_i, :kfill]).any(dim=1)
            self._prev[d][sel_i, :kfill] = out
        return out, changed, None

    def _apply_grants(self, handle: TickHandle, gets: np.ndarray) -> int:
        return self._engine.apply_dense(
            handle.rids, gets, handle.keep_has, handle.versions,
        )
