"""Device-resident steady-state tick solver, narrow rows (port of
doorman_tpu/solver/resident.py: the fused tick and the round-trip tick).

The dense [R, K] demand tables stay RESIDENT on the device between
ticks and only what changed moves:

  staging:  rows whose solver-visible inputs changed since the last tick
            (the native engine tracks dirtiness per resource), packed on
            the host into ONE uint8 buffer — int32 indices, the
            wants-only block (bf16 when that round-trips exactly), the
            full-row has/subclients block, the active flags, the scope
            indices — and sent with one host->device copy; the tick
            views the blocks apart at static byte offsets and scatters
            them into the tables in place.
  solve:    scoped by default to the dirty rows plus the not-yet-
            converged frontier (engine.ScopeTracker): K1 solves exactly
            those rows straight out of the resident tables and the fresh
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

There is one tail (`_stage`). The tables shard their rows over a mesh
(solver.resident_mesh): the caller's parallel.mesh Mesh (`mesh=`), or
without one a one-shard mesh over `device`, whose tick is the
single-device tick above. Rows are independent, so a tick needs no
combine: each device group of the mesh gets one packed staging buffer
and one host->device copy a tick (its shards' blocks, shard-local
indices), K1 — or K2 on a tracked full tick — runs once per shard over
that shard's rows (the scoped tick: its own scope rows), and each
group's delivery lands as one slab. The per-row arithmetic does not
depend on the partition, so every mesh's stores are byte-identical.

On a CUDA device the solve runs the hand-written kernels of
solver.dense_cuda for f32 and f64 alike; on the CPU (device="cpu") the
same wrappers take their plain PyTorch versions.

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
    cat_rows,
    ceil_to,
    count_launch,
)
from doorman_tpu_torch.solver.lanes import ITERATIVE_KINDS
from doorman_tpu_torch.solver.resident_mesh import (
    mesh_device,
    pad_shard_block,
    split_rows,
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
        # Plain-path iterative-lane rows of each shard's table, rebuilt
        # when the config's kind vector moves.
        self._iter_src = None
        self._iter_layout = []

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
        self._Rp = self._reset_layout(_round_rows(self._R + 1))
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
        # Per shard, views of one allocation per device group.
        self._wants = self._put_rows(w.astype(dtype))
        self._has = self._put_rows(h.astype(dtype))
        self._sub = self._put_rows(s.astype(dtype))
        self._act = self._put_rows(act.astype(bool))
        # The previous-grants table starts at the store's current has, in
        # the download dtype (the compare sees the bytes the host would).
        self._prev = [
            t.to(self._out_tdtype) for t in self._put_rows(h.astype(dtype))
        ] if self._track_deltas else None
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

    def table(self) -> DenseBatch:
        """The whole resident table as one DenseBatch, rows in table
        order: a mesh's shards joined, one shard's own tensors (no
        copy)."""
        cfg = self._config
        return DenseBatch(
            wants=cat_rows(self._wants), has=cat_rows(self._has),
            subclients=cat_rows(self._sub), active=cat_rows(self._act),
            capacity=cat_rows(cfg.cap_d), algo_kind=cat_rows(cfg.kind_d),
            learning=cat_rows(cfg.learn_d),
            static_capacity=cat_rows(cfg.statc_d),
        )

    def prev_table(self) -> "torch.Tensor | None":
        """The whole previous-delivered-grants table (delta tracking; K2's
        `prev`), as `table()` joins it; None while tracking is off."""
        return cat_rows(self._prev) if self._prev is not None else None

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
            rot = self._rotation_rows(self._R)
            parts = [order, rot]
            if len(config_changed):
                parts.append(config_changed[config_changed < self._R])
            sel = np.unique(np.concatenate(parts))
        return self._stage(order, is_full, w, h, s, act, sel, now, ph,
                           fwin, rows_hit, scope)

    def _mask_rows(self, mask: torch.Tensor, kfill: int):
        """A bool mask as {0,1} rows of the slab (download dtype)."""
        n_rows = -(-mask.shape[0] // kfill)
        flat = torch.zeros(
            n_rows * kfill, dtype=self._out_tdtype, device=mask.device
        )
        flat[: mask.shape[0]] = mask.to(self._out_tdtype)
        return flat.reshape(n_rows, kfill)

    def _shard_lane_rows(self, d: int, lanes: frozenset):
        """Plain path only: each iterative lane's rows of shard d's real
        rows, shard-local (the solve restricts each fill to them —
        byte-identical)."""
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

    def _stage(self, order, is_full, w, h, s, act, sel, now, ph,
               fwin, rows_hit, scope):
        """The tail of the launch: this tick's row scatters, scope and
        delivery set grouped by owning shard (shard-local indices,
        padded per shard to one width; padded slots are never read),
        staged per device group (engine `_upload`: one buffer and one
        host->device copy on a fused tick), then per shard the
        scatters, K1 over its scope rows or its whole table (K2 on a
        tracked fused full tick), and its delivered rows; each group's
        delivery lands as one slab."""
        mr = self._meshrows
        n_dev = mr.n_dev
        Rl = self._Rp // n_dev
        kfill = self._kfill
        dtype = self._dtype
        counts_a, a_idx_l, (a_w_l,) = split_rows(
            order, Rl, n_dev, [w[:, :kfill]])
        f_pos = np.nonzero(is_full)[0]
        counts_f, f_idx_l, (f_h_l, f_s_l, f_a_l) = split_rows(
            order[f_pos], Rl, n_dev,
            [h[f_pos, :kfill], s[f_pos, :kfill], act[f_pos, :kfill]])
        # sel is sorted, so its shard-major order is its own: the
        # handle's global bookkeeping needs no permutation.
        counts_sel, sel_l, _ = split_rows(sel, Rl, n_dev)
        Da = ceil_to(max(counts_a), 8)
        Df = ceil_to(max(counts_f), 8)
        Sb = ceil_to(max(counts_sel), 8)
        # Each block is packed once, cast to its wire dtype on the copy.
        idx_host = np.empty((n_dev, Da + Df + Sb), np.int32)
        pad_shard_block(counts_a, a_idx_l, out=idx_host[:, :Da])
        pad_shard_block(counts_f, f_idx_l, out=idx_host[:, Da:Da + Df])
        pad_shard_block(counts_sel, sel_l, out=idx_host[:, Da + Df:])
        a_w_b = pad_shard_block(counts_a, a_w_l, Da, dtype=dtype)
        use_bf16 = bf16_exact(a_w_b)
        f_block = np.empty((n_dev, 2, Df, kfill), dtype)
        pad_shard_block(counts_f, f_h_l, out=f_block[:, 0])
        pad_shard_block(counts_f, f_s_l, out=f_block[:, 1])
        f_a_b = pad_shard_block(counts_f, f_a_l, Df, False, dtype=bool)
        blocks = [
            idx_host,
            bf16_bytes(a_w_b).view(np.int16).reshape(a_w_b.shape)
            if use_bf16 else a_w_b,
            f_block, f_a_b,
        ]
        counts_c = None
        Cb = 0
        if scope is not None:
            # Per-shard scoped extents: the sorted global scope splits
            # into contiguous shard-local blocks.
            counts_c, scope_l, _ = split_rows(scope, Rl, n_dev)
            Cb = ceil_to(max(counts_c), 8)
            blocks.append(pad_shard_block(counts_c, scope_l, Cb,
                                          dtype=np.int32))
        itemsize = dtype.itemsize

        def per_shard():
            a, f, sl = map(np.asarray, (counts_a, counts_f, counts_sel))
            c = np.asarray(counts_c) if counts_c is not None else 0
            return (a * (kfill * itemsize + 4)
                    + f * (kfill * (2 * itemsize + 1) + 4) + (sl + c) * 4,
                    sl * kfill * self._out_tdtype.itemsize)

        self._account_shards(ph, per_shard)
        lanes = self._config.lanes()
        plain = self._device.type == "cpu"
        tdt = self._tdtype
        track = self._track_deltas
        staged = self._upload(ph, blocks)
        c_at = 0  # the shard's first row in the global scope
        parts = []
        Wi = Da + Df + Sb  # a shard's index block
        for (_dev, first, n), views in zip(mr.groups, staged):
            # The group's blocks as flat index vectors and row tables:
            # shard i's are the i-th Wi indices, Da wants rows, 2 * Df
            # has-then-subclients rows, Df active rows and Cb scope rows.
            idx = views[0].view(torch.int32).long()
            a_w_d = views[1].view(torch.bfloat16 if use_bf16 else tdt)
            a_w_d = a_w_d.view(-1, kfill).to(tdt)
            f_block_d = views[2].view(tdt).view(-1, kfill)
            f_act_d = views[3].view(torch.bool).view(-1, kfill)
            scope_d = views[4].view(torch.int32) if scope is not None else None
            outs, changed, moved = [], [], []
            for i in range(n):
                d = first + i
                ca, cf, cs = counts_a[d], counts_f[d], counts_sel[d]
                o, a, f = i * Wi, i * Da, 2 * i * Df
                a_i = idx[o:o + ca]
                f_i = idx[o + Da:o + Da + cf]
                sel_i = idx[o + Da + Df:o + Da + Df + cs]
                self._wants[d][a_i, :kfill] = a_w_d[a:a + ca]
                self._has[d][f_i, :kfill] = f_block_d[f:f + cf]
                self._sub[d][f_i, :kfill] = f_block_d[f + Df:f + Df + cf]
                self._act[d][f_i, :kfill] = f_act_d[i * Df:i * Df + cf]
                batch = self._shard_batch(d)
                rows_c = scope_g = None
                if scope is not None:
                    rows_c = scope_d[i * Cb:i * Cb + counts_c[d]]
                    scope_g = scope[c_at:c_at + counts_c[d]]
                    c_at += counts_c[d]
                out, ch, mv = self._solve_shard(d, batch, sel_i, lanes,
                                                plain, rows_c, scope_g)
                outs.append(out)
                if ch is not None:
                    changed.append(ch)
                if mv is not None:
                    moved.append(mv)
            slab = [cat_rows(outs)]
            if track:
                slab.append(self._mask_rows(cat_rows(changed), kfill))
            if scope is not None:
                slab.append(self._mask_rows(cat_rows(moved), kfill))
            count_launch()
            parts.append(transfer.start_download(cat_rows(slab)))
        ph.lap("fused" if self._fused else "solve")
        self.last_fused = {"windows": fwin, "rows": rows_hit}
        cfg = self._config
        return TickHandle(
            parts=parts,
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
        dtype, changed mask or None, solve-moved mask or None)."""
        kfill = self._kfill
        out_dt = self._out_tdtype
        dev = batch.wants.device
        if rows_c is not None:
            if rows_c.shape[0]:
                lane_rows = None
                if plain:
                    layout, pos = _iter_positions(
                        self._config.kind_h[scope_g], lanes)
                    lane_rows = _lane_rows(
                        layout, torch.from_numpy(pos) if pos is not None
                        else None)
                rows_l = rows_c.long()
                h_c = self._has[d][rows_l]
                gets_c = solve_dense_k1(batch, rows=rows_c, lanes=lanes,
                                        lane_rows=lane_rows)
                self._count_shard("k1", d, dev)
                # The fixpoint test, in the solve dtype: a scope row
                # whose fresh solve equals its input has is back at rest.
                moved = (gets_c != h_c).any(dim=1)
                self._has[d].index_copy_(0, rows_l, gets_c)
            else:
                moved = torch.zeros(0, dtype=torch.bool, device=dev)
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
            # The round-trip tick compares in plain torch ops, not K2.
            changed = (out != self._prev[d][sel_i, :kfill]).any(dim=1)
            self._prev[d][sel_i, :kfill] = out
        return out, changed, None

    def _apply_grants(self, handle: TickHandle, gets: np.ndarray) -> int:
        return self._engine.apply_dense(
            handle.rids, gets, handle.keep_has, handle.versions,
        )
