"""Device-side changed-row -> subscriber matching for the stream fanout
(port of doorman_tpu/server/match.py).

A tick edge must cost O(changed rows x affected subscribers), not
O(subscribers). This module keeps the row -> subscriber incidence
resident on the server's device: the engine's changed-rid set (solver/
engine.py delta tracking, K2's `changed` flags on a full tick) is
intersected with the incidence table there, and only the matched
(subscriber-slot, row) pairs come back to the host.

Layout: a CSR-like padded-extent table. Every subscribed engine rid owns
a contiguous extent of `indices` holding the subscriber slots watching
it (-1 padding up to the extent's capacity); `row_of` carries the owning
rid per position, so one boolean mask — "position holds a live slot AND
its row changed" — selects the matched pairs in one vectorized pass.
Extents carry headroom, so steady subscribe/unsubscribe churn lands as
point scatters into the resident table in place; only an extent
overflowing its capacity (or a new rid) repacks it.

Match cost: the matched-pair count M is known on the host before any
device work (the extent lengths are mirrored), so the compaction writes
into a host-sized bucket and the download carries the matched pairs
plus sentinel padding: no device->host sync decides a shape. The one
sync is landing the pairs, lapped as "download".

Host mirror: every structure is mirrored in numpy and the device side is
a cache of it. A matcher built with `use_device=False` matches from the
mirror. A device matcher does not fall back to the mirror: a fault in
its match raises.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from doorman_tpu_torch.obs.phases import PhaseRecorder
from doorman_tpu_torch.solver.engine import PHASES, ceil_to, place
from doorman_tpu_torch.utils import dispatch as dispatch_mod
from doorman_tpu_torch.utils.backend import resolve_device

__all__ = ["SubscriptionMatcher"]

# Extent headroom: a rid's extent is sized for its current watcher count
# plus slack, so steady subscribe/unsubscribe churn updates in place
# (point scatters) instead of repacking the table.
_EXTENT_PAD = 8


def _pow2(n: int, floor: int = 64) -> int:
    """Geometric shape bucket: the match's pads and the packed table grow
    in powers of two, so a ramping subscriber population passes through
    log2(max) sizes."""
    out = floor
    while out < n:
        out <<= 1
    return out


class SubscriptionMatcher:
    """Row -> subscriber-slot incidence with device-side intersection.

    Slots are dense ints allocated here (free-listed); the caller owns
    the slot -> subscription map. All mutators run on the server's event
    loop (the serialization the stream registry relies on); `match` runs
    wherever the fanout runs. The host mirror is the source of truth.
    """

    component = "stream"

    def __init__(self, *, device="cuda", use_device: bool = True):
        # "cuda" by default, as every device class of the port: without
        # a GPU the caller must ask for "cpu".
        self._device = resolve_device(device)
        self._use_device = use_device
        # slot allocation
        self._free: List[int] = []
        self._n_slots = 0
        self._slot_rids: Dict[int, Tuple[int, ...]] = {}
        # incidence: rid -> ordered subscriber slots (source of truth)
        self._members: Dict[int, List[int]] = {}
        # packed mirror: rid -> [start, capacity] extents over _indices_h
        self._ext: Dict[int, List[int]] = {}
        self._indices_h = np.full(1, -1, np.int32)  # last = sentinel
        self._row_of_h = np.full(1, -1, np.int32)
        self._rpad = 1
        self._rebuild = True
        self._dirty: List[int] = []  # positions to re-scatter
        # device cache of the mirror
        self._indices_d: "torch.Tensor | None" = None
        self._row_of_d: "torch.Tensor | None" = None
        # counters (status)
        self.matched_total = 0
        self.rebuilds = 0
        self.scatters = 0
        self.phase_s: Dict[str, float] = {name: 0.0 for name in PHASES}

    # -- membership (event-loop only) ----------------------------------

    def add(self, rids: Sequence[int]) -> int:
        """Register one subscriber over `rids`; returns its slot."""
        slot = self._free.pop() if self._free else self._n_slots
        if slot == self._n_slots:
            self._n_slots += 1
        rids = tuple(int(r) for r in rids)
        self._slot_rids[slot] = rids
        for rid in rids:
            members = self._members.setdefault(rid, [])
            members.append(slot)
            ext = self._ext.get(rid)
            if ext is None or len(members) > ext[1]:
                self._rebuild = True
            elif not self._rebuild:
                pos = ext[0] + len(members) - 1
                self._indices_h[pos] = slot
                self._dirty.append(pos)
        return slot

    def remove(self, slot: int) -> None:
        """Drop one subscriber's incidence rows (idempotent)."""
        rids = self._slot_rids.pop(slot, None)
        if rids is None:
            return
        self._free.append(slot)
        for rid in rids:
            members = self._members.get(rid)
            if not members or slot not in members:
                continue
            i = members.index(slot)
            members[i] = members[-1]
            members.pop()
            if not members:
                del self._members[rid]
            if self._rebuild:
                continue
            ext = self._ext.get(rid)
            if ext is None:
                continue
            # Mirror the swap-delete in the packed extent: the removed
            # position takes the tail slot and the tail clears.
            tail = ext[0] + len(members)
            self._indices_h[ext[0] + i] = (
                members[i] if i < len(members) else -1
            )
            self._indices_h[tail] = -1
            self._dirty.append(ext[0] + i)
            self._dirty.append(tail)

    def watchers(self, rid: int) -> int:
        return len(self._members.get(int(rid), ()))

    def __len__(self) -> int:
        return len(self._slot_rids)

    # -- matching ------------------------------------------------------

    def match(self, changed_rids: Sequence[int]) -> np.ndarray:
        """Intersect the changed-rid set with the incidence structure;
        returns [M, 2] int32 (subscriber_slot, rid) pairs. M is exact:
        padding never reaches the caller."""
        work = [
            int(r) for r in changed_rids if self._members.get(int(r))
        ]
        total = sum(len(self._members[r]) for r in work)
        if total == 0:
            return np.zeros((0, 2), np.int32)
        ph = PhaseRecorder(self.component, self.phase_s)
        if self._use_device:
            pairs = self._match_device(work, total, ph)
        else:
            pairs = self._match_host(work)
            ph.lap("match")
        self.matched_total += len(pairs)
        return pairs

    def _match_host(self, work: List[int]) -> np.ndarray:
        parts = [
            np.stack(
                [
                    np.asarray(self._members[r], np.int32),
                    np.full(len(self._members[r]), r, np.int32),
                ],
                axis=1,
            )
            for r in work
        ]
        return np.concatenate(parts) if parts else np.zeros((0, 2), np.int32)

    def _match_device(self, work: List[int], total: int,
                      ph: PhaseRecorder) -> np.ndarray:
        self._sync_device()
        ph.lap("staging")  # incidence scatters / (re)placement
        cpad = _pow2(len(work))
        changed = np.full(cpad, -1, np.int32)
        changed[: len(work)] = work
        out = self._match_on_device(
            place(changed, self._device), _pow2(total)
        )
        dispatch_mod.count_dispatch()  # the masked-gather launches
        ph.lap("match")
        # Landing the matched pairs is the match's one device->host sync
        # (the pair count was known on the host before the launch).
        dispatch_mod.count_host_sync()
        pairs = out.cpu().numpy()
        ph.lap("download")
        return pairs[pairs[:, 0] >= 0]

    def _match_on_device(self, changed: torch.Tensor,
                         cap: int) -> torch.Tensor:
        """[cap, 2] int32 (slot, rid) pairs of the positions that hold a
        live slot of a changed row, in position order, then the
        sentinel's (-1, -1) pair as padding."""
        indices, row_of = self._indices_d, self._row_of_d
        rpad = self._rpad
        sentinel = indices.numel() - 1
        # Changed-rid set -> row mask. The -1 padding of `changed` is
        # sent to a dump row past rpad and dropped, never wrapped to
        # row rpad - 1.
        tgt = torch.where(changed >= 0, changed, rpad).long()
        rmask = torch.zeros(rpad + 1, dtype=torch.bool, device=indices.device)
        rmask.index_fill_(0, tgt, True)
        mask = (indices >= 0) & rmask[row_of.clamp(0, rpad - 1).long()]
        # Compaction by cumsum and scatter, not torch.nonzero (whose
        # output shape is read back from the device, a sync) and not
        # torch.nonzero_static (not in every torch build for CUDA): each
        # matched position writes its own index at its rank, the others
        # write to a dump slot at `cap`, and the unwritten tail keeps
        # the sentinel position. Two launches, no sync, deterministic.
        rank = torch.cumsum(mask, dim=0) - 1
        dest = torch.where(mask, rank, cap)
        idx = torch.full(
            (cap + 1,), sentinel, dtype=torch.long, device=indices.device
        )
        idx.scatter_(0, dest, torch.arange(
            indices.numel(), dtype=torch.long, device=indices.device
        ))
        idx = idx[:cap]
        return torch.stack([indices[idx], row_of[idx]], dim=1)

    # -- device plumbing -----------------------------------------------

    def _repack(self) -> None:
        """Rebuild the packed mirror: deterministic rid-major layout,
        per-rid extents with headroom, one sentinel tail position the
        gather's padding points at."""
        self._ext = {}
        offset = 0
        order = sorted(self._members)
        for rid in order:
            cap = ceil_to(len(self._members[rid]) + _EXTENT_PAD, 8)
            self._ext[rid] = [offset, cap]
            offset += cap
        size = _pow2(max(offset, 1), 256) + 1  # +1: sentinel
        indices = np.full(size, -1, np.int32)
        row_of = np.full(size, -1, np.int32)
        for rid in order:
            start, cap = self._ext[rid]
            members = self._members[rid]
            indices[start : start + len(members)] = members
            row_of[start : start + cap] = rid
        self._indices_h, self._row_of_h = indices, row_of
        self._rpad = _pow2(max(order, default=0) + 1, 256)
        self._rebuild = False
        self._dirty = []
        self._indices_d = self._row_of_d = None
        self.rebuilds += 1

    def _sync_device(self) -> None:
        """Bring the device cache up to the mirror: a repacked (or first)
        table is placed whole; steady churn scatters only the dirty
        positions, in place into the resident table."""
        if self._rebuild:
            self._repack()
        if self._indices_d is None:
            self._indices_d = place(self._indices_h, self._device)
            self._row_of_d = place(self._row_of_h, self._device)
            self._dirty = []
            return
        if not self._dirty:
            return
        dirty = np.unique(np.asarray(self._dirty, np.int64))
        self._dirty = []
        self._indices_d.index_copy_(
            0, place(dirty, self._device),
            place(self._indices_h[dirty], self._device),
        )
        dispatch_mod.count_dispatch()  # the point-scatter launch
        self.scatters += 1

    # -- introspection -------------------------------------------------

    def status(self) -> dict:
        return {
            "slots": len(self._slot_rids),
            "rows": len(self._members),
            "packed_size": int(len(self._indices_h)),
            "matched_total": int(self.matched_total),
            "rebuilds": int(self.rebuilds),
            "scatters": int(self.scatters),
            "device": bool(self._indices_d is not None),
        }
