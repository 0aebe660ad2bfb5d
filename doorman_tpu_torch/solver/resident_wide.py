"""Device-resident tick solver for WIDE resources, the chunked layout
(port of doorman_tpu/solver/resident_wide.py, fused ticks on one
device).

Doorman's headline shape is ONE shared resource with a huge client
population. The narrow resident solver (solver.resident) maps one
resource to one table row, which caps a resource at DENSE_MAX_K
clients; this solver lets a resource span CONSECUTIVE rows ("chunks")
of an [R, W] table — slot s of a resource based at row b lives at flat
index b*W + s — and solves with the two-level reduction of
solver.dense.solve_chunked (plain PyTorch on either device, with fixed
reduction orders).

What crosses the host<->device link per tick:

  staging:  individual dirty SLOTS as one flat 1D scatter (the store
            engine tracks dirtiness per slot for chunk-tracked
            resources). Wants-only churn ships just the wants value;
            slots whose shape changed (membership, has, subclients)
            ship all four lanes. Every block of a tick is packed into
            ONE uint8 buffer and sent with one host->device copy; flat
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
from doorman_tpu_torch.solver.dense import (
    ChunkedDenseBatch,
    chunked_reduces,
    solve_chunked,
)
from doorman_tpu_torch.solver.engine import (
    PhaseLaps,
    TickEngineBase,
    TickHandle,
    bf16_bytes,
    bf16_exact,
    ceil_to,
    compact_index_dtype,
    count_launch,
    pow2_bucket,
)
from doorman_tpu_torch.solver.resident import DENSE_MAX_K, _round_rows
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

    def __init__(
        self,
        engine,
        *,
        dtype=np.float32,
        device="cuda",
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
            device=resolve_device(device),
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
        self._Rp = _round_rows(self._R + 1)
        self._rotation.reset()
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
        self._wants = self._put(np.pad(w, pad).astype(dtype))
        self._has = self._put(np.pad(h, pad).astype(dtype))
        self._sub = self._put(np.pad(s, pad).astype(dtype))
        self._act = self._put(np.pad(act, pad).astype(bool))
        self._row_seg_d = self._put(self._row_seg_h.astype(np.int64))
        self._seg_len_d = self._put(seg_len.astype(np.int64))
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

    def _fused_layout(self, Dw: int, Df: int, Sb: int, use_bf16: bool):
        """Byte sizes of the staged blocks in the one upload buffer, in
        order: flat wants-only slot indices and values (bf16 when
        exact), full slots' indices and wants / has / subclients, the
        delivery rows (int32), then the full slots' active flags as raw
        uint8 last. Every offset is a multiple of the next block's
        element size (Dw, Df and Sb are multiples of 32)."""
        idt_size = int(np.dtype(self._idx_dtype).itemsize)
        itemsize = int(self._dtype.itemsize)
        wval_item = 2 if use_bf16 else itemsize
        return (
            Dw * idt_size,   # w_idx
            Dw * wval_item,  # w_val
            Df * idt_size,   # f_idx
            Df * itemsize,   # f_w
            Df * itemsize,   # f_h
            Df * itemsize,   # f_s
            Sb * 4,          # sel (int32)
            Df,              # f_a (uint8)
        )

    # -- phases -------------------------------------------------------

    def _drain(self, ph: PhaseLaps):
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

        Dw = ceil_to(n_w, 1024)
        Df = ceil_to(n_f, 256)
        Sb = ceil_to(n_sel, 32)
        pad_slot = self._R * W  # the reserved padding row's slot 0
        idt = self._idx_dtype

        def padded(arr, width, fill):
            out = np.full(width, fill, arr.dtype)
            out[: len(arr)] = arr
            return out

        w_val_block = padded(w_val, Dw, 0)
        use_bf16 = bf16_exact(w_val_block)
        sel_pad = np.resize(sel, Sb) if n_sel else np.zeros(Sb, np.int64)
        buf = np.concatenate([
            padded(w_idx, Dw, pad_slot).astype(idt).view(np.uint8),
            bf16_bytes(w_val_block) if use_bf16
            else w_val_block.view(np.uint8),
            padded(f_idx, Df, pad_slot).astype(idt).view(np.uint8),
            padded(f_w, Df, 0).view(np.uint8),
            padded(f_h, Df, 0).view(np.uint8),
            padded(f_s, Df, 0).view(np.uint8),
            sel_pad.astype(np.int32).view(np.uint8),
            padded(f_a, Df, False).view(np.uint8),
        ])
        scope_host = None
        if scope is not None:
            # The closure's whole chunk-row span, its compact segment
            # map, the scoped segment ids and the compact segments'
            # lengths, in one int32 buffer. Scb reserves a compact
            # padding segment (seg id Sp-1: capacity 0, inactive) above
            # every real one; padding slots point at the reserved
            # padding row.
            scope_rows = self._scope_rows(scope)
            Cb = min(pow2_bucket(max(len(scope_rows), 1), 8), self._Rp)
            Scb = pow2_bucket(len(scope) + 1, 8)
            rows_c = np.full(Cb, self._R, np.int32)
            rows_c[: len(scope_rows)] = scope_rows
            row_seg_c = np.full(Cb, Scb - 1, np.int32)
            row_seg_c[: len(scope_rows)] = np.repeat(
                np.arange(len(scope), dtype=np.int32), self._n_chunks[scope]
            )
            seg_ids = np.full(Scb, self._Sp - 1, np.int32)
            seg_ids[: len(scope)] = scope
            seg_len = np.bincount(row_seg_c, minlength=Scb).astype(np.int32)
            scope_host = np.concatenate([rows_c, row_seg_c, seg_ids, seg_len])
            buf = np.concatenate([buf, scope_host.view(np.uint8)])
        ph.lap("staging")

        # One host->device copy, viewed apart at static offsets.
        buf_d = self._put(buf)
        tdt = self._tdtype
        o = 0

        def take(nbytes):
            nonlocal o
            part = buf_d[o: o + nbytes]
            o += nbytes
            return part

        sizes = self._fused_layout(Dw, Df, Sb, use_bf16)
        it_t = torch.int32 if idt == np.int32 else torch.int64
        w_i = take(sizes[0]).view(it_t).long()
        w_v = take(sizes[1]).view(torch.bfloat16 if use_bf16 else tdt).to(tdt)
        f_i = take(sizes[2]).view(it_t).long()
        f_wv, f_hv, f_sv = (take(n).view(tdt) for n in sizes[3:6])
        sel_i = take(sizes[6]).view(torch.int32).long()
        f_av = take(sizes[7]) != 0
        wants = self._wants.view(-1)
        wants[w_i] = w_v
        wants[f_i] = f_wv
        self._has.view(-1)[f_i] = f_hv
        self._sub.view(-1)[f_i] = f_sv
        self._act.view(-1)[f_i] = f_av
        cfg = self._config
        out_dt = self._out_tdtype
        lanes = cfg.lanes()
        moved_rows = 0
        if scope is not None:
            sc = take(scope_host.nbytes).view(torch.int32).long()
            rows, row_seg_c = sc[:Cb], sc[Cb: 2 * Cb]
            seg_c, len_c = sc[2 * Cb: 2 * Cb + Scb], sc[2 * Cb + Scb:]
            h_c = self._has[rows]
            gets_c = solve_chunked(
                ChunkedDenseBatch(
                    wants=self._wants[rows], has=h_c,
                    subclients=self._sub[rows], active=self._act[rows],
                    row_seg=row_seg_c, capacity=cfg.cap_d[seg_c],
                    algo_kind=cfg.kind_d[seg_c], learning=cfg.learn_d[seg_c],
                    static_capacity=cfg.statc_d[seg_c], lengths=len_c,
                ),
                lanes=lanes,
            )
            # Per-segment fixpoint test: a segment moved when any of
            # its chunk rows' fresh solve differs from its input has.
            segsum, _ = chunked_reduces(row_seg_c, Scb, len_c)
            moved_seg = segsum(
                (gets_c != h_c).any(dim=1).to(tdt)[:, None]
            ) > 0
            # Padding slots repeat the padding row, whose grants are 0.
            self._has.index_copy_(0, rows, gets_c)
            out = self._has[sel_i].to(out_dt)
            moved_rows = -(-Scb // W)
            mvd = torch.zeros(moved_rows * W, dtype=out_dt, device=self._device)
            mvd[:Scb] = moved_seg.to(out_dt)
            slab = torch.cat([out, mvd.reshape(moved_rows, W)], dim=0)
        else:
            gets = solve_chunked(
                ChunkedDenseBatch(
                    wants=self._wants, has=self._has, subclients=self._sub,
                    active=self._act, row_seg=self._row_seg_d,
                    capacity=cfg.cap_d, algo_kind=cfg.kind_d,
                    learning=cfg.learn_d, static_capacity=cfg.statc_d,
                    lengths=self._seg_len_d,
                ),
                lanes=lanes,
            )
            # `gets` IS the next tick's has: grants chain on device.
            self._has = gets
            slab = gets[sel_i].to(out_dt)
        count_launch()
        download = transfer.start_download(slab)
        ph.lap("fused")
        return TickHandle(
            out=download,
            sel_rows=sel,
            rids=sel_rids,
            versions=versions,
            keep_has=keep,
            n_sel=n_sel,
            dispatched_at=now,
            chunks=sel_chunks,
            scope_ids=scope,
            moved_rows=moved_rows,
            seq=self._seq,
        )

    def _apply_grants(self, handle: TickHandle, gets: np.ndarray) -> int:
        return self._engine.apply_chunks(
            handle.rids, handle.chunks, gets, handle.keep_has,
            handle.versions,
        )
