"""Device-resident tick solver for WIDE resources, the chunked layout
(port of doorman_tpu/solver/resident_wide.py: the fused tick and the
round-trip tick).

Doorman's headline shape is ONE shared resource with a huge client
population. The narrow resident solver (solver.resident) maps one
resource to one table row, which caps a resource at DENSE_MAX_K
clients; this solver lets a resource span CONSECUTIVE rows ("chunks")
of an [R, W] table — slot s of a resource based at row b lives at flat
index b*W + s — and solves with a two-level reduction: a row reduction,
then a segment reduction over the row totals (solver.dense's chunked
layout; plain PyTorch on either device, with fixed reduction orders).

What crosses the host<->device link per tick:

  staging:  individual dirty SLOTS as one flat 1D scatter (the store
            engine tracks dirtiness per slot for chunk-tracked
            resources). Wants-only churn ships just the wants value;
            slots whose shape changed (membership, has, subclients)
            ship all four lanes. Every block of a tick is packed into
            ONE uint8 buffer (the scoped tick's compact layout in it)
            and sent with one host->device copy; flat
            slot indices ship as int32 when the table fits
            (engine.compact_index_dtype), the wants block as bf16 when
            that round-trips exactly (engine.bf16_exact).
  solve:    scoped by default to the SEGMENT closure of the dirty slots
            plus the not-yet-converged frontier: every chunk row of
            every touched resource is gathered into a compact table
            (per-segment lanes couple all of a resource's chunks, so the
            closure is the correctness invariant), solved with the same
            two-level reduction in the same order — bit-identical to the
            full solve — and written back into the resident grant table.
            Any escalation (engine.ScopeTracker) solves the full table.
            `has` chains on device either way.
  delivery: chunk rows DELIVERED this tick — rows holding full-dirty
            slots (membership / client-reported has), every row of a
            resource whose effective config changed, wants-dirty rows
            while they stay within a small budget, and a rotating slice
            covering the whole table every `rotate_ticks` ticks. With a
            shared water level any demand change moves EVERY client's
            grant, so same-tick delivery of every changed grant would
            re-download the whole table each tick; the rotation bounds
            each stored grant's staleness by `rotate_ticks` ticks, the
            information staleness the reference already has.

The round-trip tick (fused=False) places each staged block on its own
and solves the full table every tick (scope reason "round-trip"): the
same scatters and the same chunked solve, so byte-identical stores.

There is one tail (`_stage`). The chunk rows shard over a mesh
(solver.resident_mesh): the caller's parallel.mesh Mesh (`mesh=`), or
without one a one-shard mesh over `device`, whose tick is the
single-device tick. Chunks may straddle shard boundaries. Each device
group (the shards one device holds, one row block) stages one buffer and
one host->device copy a tick, scatters its slots with shard-local
indices and runs the chunked solve over its rows; per-segment totals
come from parallel.sharded.resident_chunk_reduces (scoped ticks:
scoped_chunk_reduces): each group writes its per-row totals into the
GLOBAL row vector at its own offset, the mesh combine adds disjoint
supports (a lone group's totals are the whole vector), and every group
runs the same sorted segment op — so the stores are byte-identical
whatever the partition.

Write-back safety: chunk membership versions are read after the slot
drain and before the pack (StoreEngine.chunk_versions), so an apply's
expected version can lag the device state but never lead it — a
mid-flight membership change makes the apply skip that chunk, and the
re-marked slots re-deliver it next tick.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from doorman_tpu_torch.core.resource import Resource
from doorman_tpu_torch.core.snapshot import _bucket
from doorman_tpu_torch.obs.phases import PhaseRecorder
from doorman_tpu_torch.solver.dense import ChunkedDenseBatch
from doorman_tpu_torch.solver.engine import (
    TickEngineBase,
    TickHandle,
    bf16_bytes,
    bf16_exact,
    cat_rows,
    ceil_to,
    compact_index_dtype,
    count_launch,
    pow2_bucket,
)
from doorman_tpu_torch.solver.lanes import solve_lanes
from doorman_tpu_torch.solver.resident import DENSE_MAX_K, _round_rows
from doorman_tpu_torch.solver.resident_mesh import (
    mesh_device,
    pad_shard_block,
    split_rows,
)
from doorman_tpu_torch.utils import transfer
from doorman_tpu_torch.utils.backend import resolve_device


class WideResidentSolver(TickEngineBase):
    """Steady-state batched ticks for lane resources wider than the dense
    row cap, with the device as the table of record, backed by one
    native StoreEngine. The caller partitions: narrow lane resources ->
    ResidentDenseSolver, PRIORITY_BANDS -> the BatchSolver's priority
    part, wide lane resources -> here.

    `device` defaults to "cuda" and raises without a GPU; pass
    device="cpu" to run the solve on the host."""

    component = "resident_wide"
    replicated_config = True  # per-segment config

    def __init__(
        self,
        engine,
        *,
        dtype=np.float32,
        device="cuda",
        mesh=None,
        clock: Callable[[], float] = time.time,
        rotate_ticks: "int | None" = None,
        tick_interval: "float | None" = None,
        download_dtype=None,
        chunk_width: "int | None" = None,
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
        self._W = int(chunk_width or DENSE_MAX_K)
        self._res: List[Resource] = []
        self._S = 0  # segments (resources)
        self._Sp = 8
        self._R = 0  # real chunk rows
        self._Rp = 0  # padded rows
        self._idx_dtype = np.int64  # flat slot indices (compacted at rebuild)
        self._base_row = np.zeros(0, np.int64)  # per segment
        self._n_chunks = np.zeros(0, np.int64)  # per segment
        self._row_rids = np.zeros(0, np.int32)  # per row (-1 padding)
        self._row_chunk = np.zeros(0, np.int32)  # per row (-1 padding)
        self._row_seg_h = np.zeros(0, np.int32)  # per row (Sp-1 padding)
        self._rid_to_seg: Dict[int, int] = {}
        # Device tables, updated in place by each tick.
        self._wants = self._has = self._sub = self._act = None
        self._row_seg_d = self._seg_len_d = None

    # -- build / rebuild ----------------------------------------------

    def rebuild(self, resources: Sequence[Resource]) -> None:
        """Full pack: size the chunk map from live counts, install the
        engine's chunk tracking, and upload every table."""
        res = list(resources)
        self._res = res
        self._S = len(res)
        self._Sp = _bucket(self._S + 1, 8)
        W = self._W
        counts = np.array([len(r.store) for r in res], np.int64)
        self._n_chunks = np.maximum(1, -(-counts // W))
        self._base_row = np.zeros(self._S + 1, np.int64)
        np.cumsum(self._n_chunks, out=self._base_row[1:])
        self._R = int(self._base_row[-1])
        # +1 reserves a padding row for no-op scatters.
        self._Rp = self._reset_layout(_round_rows(self._R + 1))
        # Flat device indices (slot s of the segment at row b lives at
        # b*W + s): int32 halves the index-upload bytes when it fits.
        self._idx_dtype = compact_index_dtype((self._Rp + 1) * W)
        self._row_rids = np.full(self._Rp, -1, np.int32)
        self._row_chunk = np.full(self._Rp, -1, np.int32)
        # Padding rows resolve to the reserved padding segment Sp-1
        # (capacity 0, all lanes inactive).
        self._row_seg_h = np.full(self._Rp, self._Sp - 1, np.int32)
        self._rid_to_seg = {}
        for i, r in enumerate(res):
            b, n = self._base_row[i], self._n_chunks[i]
            self._row_rids[b: b + n] = r.store._rid
            self._row_chunk[b: b + n] = np.arange(n, dtype=np.int32)
            self._row_seg_h[b: b + n] = i
            self._rid_to_seg[r.store._rid] = i
        # Resource-major rows: each segment's rows are consecutive, the
        # layout the segment reductions' lengths describe.
        assert (np.diff(self._row_seg_h) >= 0).all()
        seg_len = np.bincount(self._row_seg_h, minlength=self._Sp)

        # Install tracking, then pack. Writes landing between the two
        # calls mark slot dirt that survives to the next drain AND are
        # already in the pack (it reads live state) — a benign double
        # upload, never a miss.
        self._engine.chunk_config(
            np.asarray([r.store._rid for r in res], np.int32), W
        )
        w, h, s, act, _filled, _versions = self._engine.pack_chunks(
            self._row_rids[: self._R], self._row_chunk[: self._R], W
        )
        dtype = self._dtype
        pad = ((0, self._Rp - self._R), (0, 0))
        # One row block per device group (its shards' rows).
        self._wants = self._put_groups(np.pad(w, pad).astype(dtype))
        self._has = self._put_groups(np.pad(h, pad).astype(dtype))
        self._sub = self._put_groups(np.pad(s, pad).astype(dtype))
        self._act = self._put_groups(np.pad(act, pad).astype(bool))
        # Every group runs the segment op over the whole row vector: the
        # global row->segment map and lengths on each device (a group's
        # own rows' segments are its slice of the map).
        self._row_seg_d = self._put_rep(self._row_seg_h.astype(np.int64))
        self._seg_len_d = self._put_rep(seg_len.astype(np.int64))
        self._config.reset(self._Sp)
        self._refresh_config(res, self._config._epoch, self._clock())
        self._just_rebuilt = True

    def _needs_rebuild(self, resources: List[Resource]) -> bool:
        if self._wants is None or len(resources) != self._S or any(
            a is not b for a, b in zip(resources, self._res)
        ):
            return True
        # Growth past the allocated chunks (one C sums call per wide
        # resource — there are few by nature).
        for i, r in enumerate(self._res):
            if len(r.store) > self._n_chunks[i] * self._W:
                return True
        return False

    def table(self) -> ChunkedDenseBatch:
        """The whole resident table as one ChunkedDenseBatch, rows in
        table order: a mesh's device groups joined, one group's own
        tensors (no copy); the per-segment config and the row->segment
        map are replicated, so any group's copy is the whole."""
        cfg = self._config
        return ChunkedDenseBatch(
            wants=cat_rows(self._wants), has=cat_rows(self._has),
            subclients=cat_rows(self._sub), active=cat_rows(self._act),
            row_seg=self._row_seg_d[0], capacity=cfg.cap_d[0],
            algo_kind=cfg.kind_d[0], learning=cfg.learn_d[0],
            static_capacity=cfg.statc_d[0], lengths=self._seg_len_d[0],
        )

    # -- phases -------------------------------------------------------

    def _drain(self, ph: PhaseRecorder):
        """Drain dirty slots of our tracked rids (drain FIRST, then read
        versions, then pack — see StoreEngine.chunk_versions)."""
        W = self._W
        slot_parts: List[np.ndarray] = []  # flat device indices
        lvl_parts: List[np.ndarray] = []
        rid_parts: List[np.ndarray] = []  # rid per drained slot
        raw_slot_parts: List[np.ndarray] = []  # engine slot per drained
        for rid in self._engine.dirty_slot_rids():
            seg = self._rid_to_seg.get(int(rid))
            if seg is None:
                continue
            slots, levels = self._engine.drain_slots(int(rid))
            if not len(slots):
                continue
            # Slots past the allocated chunk span (growth raced the
            # rebuild check) force a rebuild next tick via
            # _needs_rebuild; clamp here so this tick stays in bounds.
            keep = slots < int(self._n_chunks[seg]) * W
            slots = slots[keep]
            levels = levels[keep]
            slot_parts.append(self._base_row[seg] * W + slots)
            lvl_parts.append(levels)
            rid_parts.append(np.full(len(slots), rid, np.int32))
            raw_slot_parts.append(slots)
        if slot_parts:
            drained = (
                np.concatenate(slot_parts), np.concatenate(lvl_parts),
                np.concatenate(rid_parts), np.concatenate(raw_slot_parts),
            )
        else:
            drained = (
                np.zeros(0, np.int64), np.zeros(0, np.uint8),
                np.zeros(0, np.int32), np.zeros(0, np.int64),
            )
        ph.lap("drain")
        return drained

    def _drained_empty(self, drained) -> bool:
        return len(drained[0]) == 0

    def _scope_rows(self, scope: np.ndarray) -> np.ndarray:
        """Every chunk row of the given segments, in row order."""
        if not len(scope):
            return np.zeros(0, np.int64)
        return np.concatenate([
            np.arange(self._base_row[s], self._base_row[s] + self._n_chunks[s],
                      dtype=np.int64)
            for s in scope
        ])

    def _launch(self, res_list, drained, config_changed, now, ph):
        flat_idx, levels, slot_rids, raw_slots = drained
        W = self._W
        full_mask = levels >= 2
        dirty_rows = flat_idx // W
        # The scope unit is the SEGMENT: one dirty slot scopes the
        # segment's whole chunk span.
        if len(dirty_rows):
            dirty_segs = self._row_seg_h[np.unique(dirty_rows)]
            dirty_segs = np.unique(dirty_segs[dirty_segs < self._S])
        else:
            dirty_segs = np.zeros(0, np.int64)
        scope, _forced = self._scope_for_tick(
            dirty_segs, config_changed, self._S
        )
        if scope is not None:
            self.last_scope = {
                "rows": int(self._n_chunks[scope].sum()) if len(scope) else 0,
                "resources": int(len(scope)),
            }
        else:
            self.last_scope = {"rows": self._R, "resources": self._S}
        rot = self._rotation_rows(self._R)
        # Delivery set (chunk rows): full-dirty rows and config-changed
        # segments always deliver same-tick; wants-dirty rows only while
        # the set stays small (beyond the budget the rotation covers
        # them within a refresh interval).
        if self._just_rebuilt or config_changed is None:
            self._just_rebuilt = False
            sel = np.arange(max(self._R, 1), dtype=np.int64)
        else:
            parts = [dirty_rows[full_mask], rot]
            budget = max(64, 2 * max(len(rot), 1))
            wants_rows = np.unique(dirty_rows[~full_mask])
            if len(wants_rows) <= budget:
                parts.append(wants_rows)
            for s in config_changed:
                if s < self._S:
                    b, n = self._base_row[s], self._n_chunks[s]
                    parts.append(np.arange(b, b + n, dtype=np.int64))
            sel = np.unique(np.concatenate(parts))
        n_sel = len(sel)
        sel_rids = self._row_rids[sel]
        sel_chunks = self._row_chunk[sel]
        # Versions BEFORE the pack (safe direction; see chunk_versions).
        versions = self._engine.chunk_versions(sel_rids, sel_chunks)

        # Pack the dirty slots' values, one gather call per rid. A
        # swap-remove landing between the drain and this pack makes a
        # wants-only slot ship the new occupant's wants beside the old
        # occupant's lanes for this one solve; the membership change
        # bumped the chunk version, so the version guard (read above)
        # blocks that chunk's write-back and the re-marked slots
        # re-deliver a consistent solve next tick.
        n_w = int((~full_mask).sum())
        n_f = int(full_mask.sum())
        dtype = self._dtype
        w_idx = np.zeros(n_w, np.int64)
        w_val = np.zeros(n_w, dtype)
        f_idx = np.zeros(n_f, np.int64)
        f_w = np.zeros(n_f, dtype)
        f_h = np.zeros(n_f, dtype)
        f_s = np.zeros(n_f, dtype)
        f_a = np.zeros(n_f, bool)
        wpos = fpos = 0
        for rid in np.unique(slot_rids) if len(slot_rids) else ():
            m = slot_rids == rid
            pw, phas, psub, pact = self._engine.pack_slots(
                int(rid), raw_slots[m]
            )
            fm = full_mask[m]
            fi = flat_idx[m]
            nw_i = int((~fm).sum())
            nf_i = int(fm.sum())
            w_idx[wpos: wpos + nw_i] = fi[~fm]
            w_val[wpos: wpos + nw_i] = pw[~fm]
            wpos += nw_i
            f_idx[fpos: fpos + nf_i] = fi[fm]
            f_w[fpos: fpos + nf_i] = pw[fm]
            f_h[fpos: fpos + nf_i] = phas[fm]
            f_s[fpos: fpos + nf_i] = psub[fm]
            f_a[fpos: fpos + nf_i] = pact[fm].astype(bool)
            fpos += nf_i
        keep = np.zeros(n_sel, np.uint8)
        if n_sel:
            keep = self._config.learn_h[self._row_seg_h[sel]].astype(np.uint8)
        ph.lap("pack")
        return self._stage(
            (w_idx, w_val, f_idx, f_w, f_h, f_s, f_a), sel, sel_rids,
            sel_chunks, versions, keep, now, ph, scope,
        )

    def _stage(self, packed, sel, sel_rids, sel_chunks, versions, keep,
               now, ph, scope):
        """The tail of the launch: slot scatters and the delivery set
        grouped by owning shard (shard-local indices, padded per shard
        to one width; padded slots are never read), staged per device
        group (engine `_upload`: one buffer and one host->device copy on
        a fused tick, the scope plan in it), the chunked solve per group
        in lockstep with the bit-exact combine, and one delivery slab per
        group."""
        w_idx, w_val, f_idx, f_w, f_h, f_s, f_a = packed
        mr = self._meshrows
        n_dev = mr.n_dev
        W = self._W
        Rl = self._Rp // n_dev
        span = Rl * W
        idt = self._idx_dtype
        counts_w, w_idx_l, (w_val_l,) = split_rows(
            w_idx, span, n_dev, [w_val])
        counts_f, f_idx_l, f_cols = split_rows(
            f_idx, span, n_dev, [f_w, f_h, f_s, f_a])
        # sel is sorted, so its shard-major order is its own.
        counts_sel, sel_l, _ = split_rows(sel, Rl, n_dev)
        Dw = ceil_to(max(counts_w), 8)
        Df = ceil_to(max(counts_f), 8)
        Sb = ceil_to(max(counts_sel), 8)
        w_val_b = pad_shard_block(counts_w, w_val_l, Dw)
        use_bf16 = bf16_exact(w_val_b)
        blocks = [
            pad_shard_block(counts_w, w_idx_l, Dw, dtype=idt),
            bf16_bytes(w_val_b).view(np.int16).reshape(w_val_b.shape)
            if use_bf16 else w_val_b,
            pad_shard_block(counts_f, f_idx_l, Df, dtype=idt),
            pad_shard_block(counts_f, f_cols[0], Df),
            pad_shard_block(counts_f, f_cols[1], Df),
            pad_shard_block(counts_f, f_cols[2], Df),
            pad_shard_block(counts_sel, sel_l, Sb, dtype=np.int32),
            pad_shard_block(counts_f, f_cols[3], Df, False),
        ]
        itemsize = self._dtype.itemsize
        idx_bytes = np.dtype(idt).itemsize

        def per_shard():
            w, f, sl = map(np.asarray, (counts_w, counts_f, counts_sel))
            return (w * (idx_bytes + itemsize)
                    + f * (idx_bytes + 3 * itemsize + 1) + sl * 4,
                    sl * W * self._out_tdtype.itemsize)

        self._account_shards(ph, per_shard)
        plan, scope_blocks = (self._mesh_scope(scope, Rl)
                              if scope is not None else (None, None))
        staged = self._upload(ph, blocks, scope_blocks)
        tdt = self._tdtype
        it_t = torch.int32 if idt == np.int32 else torch.int64
        sels = []
        for gi, ((_dev, first, n), views) in enumerate(zip(mr.groups,
                                                           staged)):
            w_i = views[0].view(it_t).reshape(n, Dw).long()
            w_v = views[1].view(torch.bfloat16 if use_bf16 else tdt).reshape(
                n, Dw).to(tdt)
            f_i = views[2].view(it_t).reshape(n, Df).long()
            f_wv, f_hv, f_sv = (v.view(tdt).reshape(n, Df)
                                for v in views[3:6])
            sels.append(views[6].view(torch.int32).reshape(n, Sb).long())
            f_av = views[7].view(torch.bool).reshape(n, Df)
            if plan is not None:
                plan["groups"][gi]["block"] = views[8].view(
                    torch.int32).long()
            wants, has = self._wants[gi].view(-1), self._has[gi].view(-1)
            sub, act = self._sub[gi].view(-1), self._act[gi].view(-1)
            for i in range(n):
                d = first + i
                cw, cf = counts_w[d], counts_f[d]
                base = i * span  # the shard's slots in the group's block
                wants[base + w_i[i, :cw]] = w_v[i, :cw]
                fi = base + f_i[i, :cf]
                wants[fi] = f_wv[i, :cf]
                has[fi] = f_hv[i, :cf]
                sub[fi] = f_sv[i, :cf]
                act[fi] = f_av[i, :cf]

        cfg = self._config
        lanes = cfg.lanes()
        if plan is None:
            def body(g):
                return self._solve_group_full(g, lanes)
        else:
            def body(g):
                return self._solve_group_scoped(g, lanes, plan)
        results = self._combine.run(body)
        out_dt = self._out_tdtype
        parts = []
        moved_rows = 0
        for gi, (dev, first, n) in enumerate(mr.groups):
            moved_seg = results[gi]
            has = self._has[gi]
            rows = [has[i * Rl:(i + 1) * Rl][
                        sels[gi][i, :counts_sel[first + i]]]
                    for i in range(n)]
            slab = [cat_rows(rows).to(out_dt)]
            if moved_seg is not None and gi == 0:
                Scb = moved_seg.shape[0]
                moved_rows = -(-Scb // W)
                mvd = torch.zeros(moved_rows * W, dtype=out_dt, device=dev)
                mvd[:Scb] = moved_seg.to(out_dt)
                slab.append(mvd.reshape(moved_rows, W))
            count_launch()
            parts.append(transfer.start_download(cat_rows(slab)))
        ph.lap("fused" if self._fused else "solve")
        return TickHandle(
            parts=parts,
            sel_rows=sel,
            rids=sel_rids,
            versions=versions,
            keep_has=keep,
            n_sel=len(sel),
            dispatched_at=now,
            chunks=sel_chunks,
            scope_ids=scope,
            moved_rows=moved_rows,
            seq=self._seq,
            shard_counts=counts_sel,
        )

    def _solve_group_full(self, g: int, lanes):
        """Device group g's full chunked solve over its rows, with the
        bit-exact cross-shard reduction; grants chain into has."""
        from doorman_tpu_torch.parallel.sharded import resident_chunk_reduces

        _dev, first, n = self._meshrows.groups[g]
        Rl = self._Rp // self._meshrows.n_dev
        cfg = self._config
        row_seg = self._row_seg_d[g]
        segsum, segmax = resident_chunk_reduces(
            self._combine, g, row_seg, self._seg_len_d[g], first * Rl,
            self._Rp,
        )
        seg = row_seg[first * Rl:(first + n) * Rl]
        self._has[g] = solve_lanes(
            self._wants[g], self._has[g], self._sub[g], self._act[g],
            cfg.cap_d[g], cfg.kind_d[g], cfg.learn_d[g], cfg.statc_d[g],
            segsum=segsum, segmax=segmax,
            expand=lambda totals: totals[seg][:, None], lanes=lanes,
        )
        return None

    def _mesh_scope(self, scope: np.ndarray, Rl: int):
        """The scoped tick's compact layout: the closure's chunk rows
        (global order), its compact segment map, the scoped segment ids
        and lengths, and per device group where its scoped rows sit
        among them (`start`, `count`: consecutive, since the rows are
        sorted) and its local gather of them, padded to the pow2 bucket
        of its row count (padding rows repeat a real one and are never
        written back). Returns (plan, one int32 host block per group:
        the compact map, ids, lengths, then the group's gather)."""
        scope_rows = self._scope_rows(scope)
        Cbg = min(pow2_bucket(max(len(scope_rows), 1), 8), self._Rp)
        Scb = pow2_bucket(len(scope) + 1, 8)
        row_seg_cg = np.full(Cbg, Scb - 1, np.int32)
        row_seg_cg[: len(scope_rows)] = np.repeat(
            np.arange(len(scope), dtype=np.int32), self._n_chunks[scope])
        seg_ids = np.full(Scb, self._Sp - 1, np.int32)
        seg_ids[: len(scope)] = scope
        seg_len = np.bincount(row_seg_cg, minlength=Scb).astype(np.int32)
        groups, blocks = [], []
        for _dev, first, n in self._meshrows.groups:
            lo, hi = first * Rl, (first + n) * Rl
            start, stop = (int(i) for i in np.searchsorted(scope_rows,
                                                           [lo, hi]))
            count = stop - start
            Cbl = min(pow2_bucket(max(count, 1), 8), n * Rl)
            rows_l = scope_rows[start:stop] - lo
            gather = (np.resize(rows_l, Cbl) if count
                      else np.zeros(Cbl, np.int64))
            blocks.append(np.concatenate(
                [row_seg_cg, seg_ids, seg_len, gather.astype(np.int32)]))
            groups.append(dict(start=start, count=count))
        return dict(Cbg=Cbg, Scb=Scb, groups=groups), blocks

    def _solve_group_scoped(self, g: int, lanes, plan: dict):
        """Device group g's scoped solve: its scoped rows gathered,
        solved with the scoped cross-shard reduction, written back into
        has; returns the per-segment moved mask [Scb]."""
        from doorman_tpu_torch.parallel.sharded import scoped_chunk_reduces

        sp = plan["groups"][g]
        Cbg, Scb = plan["Cbg"], plan["Scb"]
        block = sp["block"]
        row_seg, sid = block[:Cbg], block[Cbg:Cbg + Scb]
        rows = block[Cbg + 2 * Scb:]
        start, count = sp["start"], sp["count"]
        cfg = self._config
        segsum, segmax = scoped_chunk_reduces(
            self._combine, g, start, row_seg, block[Cbg + Scb:Cbg + 2 * Scb],
            Cbg, count,
        )
        seg_l = row_seg[start:start + count]
        if rows.shape[0] > count:
            seg_l = torch.cat([seg_l, seg_l.new_full(
                (rows.shape[0] - count,), Scb - 1)])
        h_c = self._has[g][rows]
        gets_c = solve_lanes(
            self._wants[g][rows], h_c, self._sub[g][rows], self._act[g][rows],
            cfg.cap_d[g][sid], cfg.kind_d[g][sid], cfg.learn_d[g][sid],
            cfg.statc_d[g][sid],
            segsum=segsum, segmax=segmax,
            expand=lambda totals: totals[seg_l][:, None], lanes=lanes,
        )
        moved = segsum(
            (gets_c != h_c).any(dim=1).to(self._tdtype)[:, None]) > 0
        self._has[g].index_copy_(0, rows[:count], gets_c[:count])
        return moved

    def _apply_grants(self, handle: TickHandle, gets: np.ndarray) -> int:
        return self._engine.apply_chunks(
            handle.rids, handle.chunks, gets, handle.keep_has,
            handle.versions,
        )
