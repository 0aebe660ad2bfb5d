"""Incremental journal of assign/release/decide deltas between snapshots.

Each mutation the master applies to lease state between snapshots lands
as one framed record with a monotonically increasing sequence number;
replaying records with `seq > snapshot.seq` over the snapshot rebuilds
the exact lease table the master held at its last flush. Records are
buffered in memory and flushed to the backend once per tick (the tick
pipeline drives `PersistManager.step`), so durability lags live state by
at most one flush interval — the staleness bound the warm-takeover
learning-mode decision leans on (restore.py).

Record framing: one JSON array per line, `[seq, t, kind, ...]`:

  ["a", resource, client, expiry, refresh, has, wants, sub, prio]
      — a lease upsert (an immediate-mode decide, a batch-mode demand
        refresh, or a learning-mode grant); carries the full lease so
        replay needs no prior state.
  ["r", resource, client]      — an explicit release.
  ["d"]                        — clean mastership step-down: the writer
        stopped granting at `t` and every grant it issued is in the
        records before this one. Restore treats a journal ending in "d"
        as COMPLETE (no unknown-grant gap), which is what justifies
        skipping learning mode outright.

A torn final line (crash mid-flush) fails JSON parsing and is dropped,
as is everything after the first gap or parse failure — suffix-only
damage loses at most the final flush batch, never silently reorders.

Compaction is lease-expiry-aware: between snapshots a long-lived journal
is rewritten keeping, per (resource, client), only the LAST assign —
and only if its lease is still alive at compaction time and not
superseded by a later release. Releases of clients with no surviving
assign compact away entirely; the terminal "d" marker (if any) is
preserved. Sequence numbers survive compaction untouched, so a snapshot
taken later still fences replay correctly.

Host-only (standard library and core/lease.py): a copy of the JAX
package's module, import paths aside; the record framing is the
reference's, so either package replays the other's journal.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

from doorman_tpu_torch.core.lease import Lease

KIND_ASSIGN = "a"
KIND_RELEASE = "r"
KIND_DOWN = "d"


class Record:
    """One parsed journal record."""

    __slots__ = ("seq", "t", "kind", "resource", "client", "lease")

    def __init__(self, seq: int, t: float, kind: str,
                 resource: str = "", client: str = "",
                 lease: Optional[Lease] = None):
        self.seq = seq
        self.t = t
        self.kind = kind
        self.resource = resource
        self.client = client
        self.lease = lease

    def encode(self) -> bytes:
        if self.kind == KIND_ASSIGN:
            l = self.lease
            row = [self.seq, self.t, self.kind, self.resource, self.client,
                   l.expiry, l.refresh_interval, l.has, l.wants,
                   l.subclients, l.priority]
        elif self.kind == KIND_RELEASE:
            row = [self.seq, self.t, self.kind, self.resource, self.client]
        else:
            row = [self.seq, self.t, self.kind]
        return json.dumps(row, separators=(",", ":")).encode()

    @classmethod
    def decode(cls, line: bytes) -> "Record":
        row = json.loads(line.decode())
        seq, t, kind = int(row[0]), float(row[1]), str(row[2])
        if kind == KIND_ASSIGN:
            return cls(
                seq, t, kind, str(row[3]), str(row[4]),
                Lease(
                    expiry=float(row[5]), refresh_interval=float(row[6]),
                    has=float(row[7]), wants=float(row[8]),
                    subclients=int(row[9]), priority=int(row[10]),
                ),
            )
        if kind == KIND_RELEASE:
            return cls(seq, t, kind, str(row[3]), str(row[4]))
        if kind == KIND_DOWN:
            return cls(seq, t, kind)
        raise ValueError(f"unknown journal record kind {kind!r}")


def read_records(lines: Sequence[bytes]) -> List[Record]:
    """Parse backend journal lines, tolerating a damaged suffix: stop at
    the first unparseable line or sequence regression (a torn flush or a
    stale writer) and return the clean prefix."""
    out: List[Record] = []
    last_seq = 0
    for line in lines:
        if not line:
            continue
        try:
            rec = Record.decode(line)
        except (ValueError, IndexError, KeyError, UnicodeDecodeError):
            break
        if rec.seq <= last_seq:
            break
        last_seq = rec.seq
        out.append(rec)
    return out


class Journal:
    """The writer half: sequence numbering, buffering, flush, compaction."""

    def __init__(self, backend, *, start_seq: int = 0):
        self.backend = backend
        self._seq = int(start_seq)
        self._buf: List[bytes] = []
        # Records flushed since the last reset — the compaction trigger.
        self.flushed_records = 0

    @property
    def seq(self) -> int:
        """Last sequence number handed out."""
        return self._seq

    @property
    def pending(self) -> int:
        return len(self._buf)

    def _append(self, rec: Record) -> int:
        self._buf.append(rec.encode())
        return rec.seq

    def _next(self) -> int:
        self._seq += 1
        return self._seq

    def record_assign(self, t: float, resource: str, client: str,
                      lease: Lease) -> int:
        return self._append(
            Record(self._next(), t, KIND_ASSIGN, resource, client, lease)
        )

    def record_release(self, t: float, resource: str, client: str) -> int:
        return self._append(
            Record(self._next(), t, KIND_RELEASE, resource, client)
        )

    def record_down(self, t: float) -> int:
        return self._append(Record(self._next(), t, KIND_DOWN))

    def flush(self) -> int:
        """Push buffered records to the backend; returns how many."""
        if not self._buf:
            return 0
        buf, self._buf = self._buf, []
        self.backend.append_journal(buf)
        self.flushed_records += len(buf)
        return len(buf)

    def reset(self) -> None:
        """Drop the persisted journal (a fresh snapshot supersedes it).
        Buffered-but-unflushed records are dropped too: they describe
        state the snapshot already contains."""
        self._buf = []
        self.backend.reset_journal()
        self.flushed_records = 0

    def compact(self, now: float) -> Tuple[int, int]:
        """Expiry-aware rewrite of the persisted journal; returns
        (records_before, records_after). Call between snapshots when the
        journal outgrows its usefulness — replay cost is proportional to
        journal length, and expired leases are pure dead weight (restore
        drops them against the clock anyway)."""
        self.flush()
        records = read_records(self.backend.read_journal())
        last_assign: dict = {}
        released: dict = {}
        down: Optional[Record] = None
        for rec in records:
            key = (rec.resource, rec.client)
            if rec.kind == KIND_ASSIGN:
                last_assign[key] = rec
                released.pop(key, None)
            elif rec.kind == KIND_RELEASE:
                last_assign.pop(key, None)
                released[key] = rec
            elif rec.kind == KIND_DOWN:
                down = rec
        kept = [
            rec for rec in last_assign.values()
            if rec.lease.expiry > now
        ]
        # A release only matters if the snapshot below the journal might
        # still carry the lease; keeping them is cheap and correct,
        # dropping them would resurrect snapshot leases on replay.
        kept.extend(released.values())
        if down is not None:
            kept.append(down)
        kept.sort(key=lambda r: r.seq)
        self.backend.reset_journal([r.encode() for r in kept])
        self.flushed_records = len(kept)
        return len(records), len(kept)
