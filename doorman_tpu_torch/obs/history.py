"""Durable multi-resolution history for per-tick flight records.

The flight recorder (flightrec.py) is a bounded in-process ring: it
explains the last N ticks and then forgets. This module is its memory.
A :class:`HistoryStore` keeps

  * a **raw ring** of the most recent records (tier 0, one dict per
    tick, same schema the flight recorder stamps), and
  * **decimated tiers** — for each decimation factor F, one bucket per
    F consecutive records carrying min/max/mean/last of every numeric
    field, so hours and days of history stay queryable at bounded
    memory long after the raw ring has wrapped.

When constructed with a directory it is also **durable**: records
append to checksummed segment files using the persist backend's
journal discipline — append-only lines, each prefixed with the first 8
hex chars of its payload's sha256, flushed on every append and fsynced
on rotation.  A torn tail (half-written final line after a crash) is
tolerated on open: replay stops at the first corrupt line and new
appends start a fresh segment, so a torn tail can never be appended
to.  Each process generation stamps its records with a monotone
``run`` number; ``run_delta`` compares a field's quantile across the
current and previous runs, which is what lets ``TrajectoryComparator``
-style deltas and SLO windows span process lifetimes.

Queries: ``records(start, end, tier, fields)`` by history-sequence
range, ``series(field, tier, run)`` as a flat float list (SLO sample
streams), ``view()``/``chrome()`` for /debug/history, ``status()`` for
status pages. All methods are thread-safe: the server appends from its
tick loop while the debug HTTP thread and the cmd.obs CLI read.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

log = logging.getLogger(__name__)

__all__ = ["HistoryStore", "SEGMENT_PREFIX"]

SEGMENT_PREFIX = "history-seg-"

# Fields that are bookkeeping, not signal: excluded from tier
# aggregation (they are reconstructible or meaningless to average).
_SKIP_TIER_FIELDS = frozenset({"seq", "hseq", "run", "tier"})


def _checksum(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()[:8]


def _encode(rec: dict) -> bytes:
    payload = json.dumps(
        rec, separators=(",", ":"), sort_keys=True, default=str
    ).encode()
    return _checksum(payload).encode() + b" " + payload + b"\n"


def _decode(line: bytes) -> Optional[dict]:
    """One journal line back to a record; None on any corruption
    (truncation, bit rot, bad JSON) — the torn-tail contract."""
    if not line.endswith(b"\n"):
        return None
    body = line[:-1]
    if len(body) < 10 or body[8:9] != b" ":
        return None
    digest, payload = body[:8], body[9:]
    if _checksum(payload).encode() != digest:
        return None
    try:
        rec = json.loads(payload)
    except ValueError:
        return None
    return rec if isinstance(rec, dict) else None


class _TierBucket:
    """Aggregation state for one in-progress decimation bucket."""

    __slots__ = ("start", "run", "n", "fields")

    def __init__(self, start: int, run: int):
        self.start = start
        self.run = run
        self.n = 0
        # field -> [min, max, sum, last]
        self.fields: Dict[str, List[float]] = {}

    def add(self, rec: dict) -> None:
        self.n += 1
        for k, v in rec.items():
            if k in _SKIP_TIER_FIELDS:
                continue
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            f = float(v)
            st = self.fields.get(k)
            if st is None:
                self.fields[k] = [f, f, f, f]
            else:
                if f < st[0]:
                    st[0] = f
                if f > st[1]:
                    st[1] = f
                st[2] += f
                st[3] = f

    def finalize(self) -> dict:
        return {
            "hseq": self.start,
            "run": self.run,
            "n": self.n,
            "fields": {
                k: {
                    "min": st[0],
                    "max": st[1],
                    "mean": st[2] / self.n,
                    "last": st[3],
                }
                for k, st in sorted(self.fields.items())
            },
        }


class HistoryStore:
    """Raw ring + decimated tiers, optionally durable (see module doc).

    ``tiers`` are decimation factors; bucket boundaries are exact:
    bucket ``b`` of factor ``F`` aggregates records with
    ``hseq in [b*F, (b+1)*F)`` and is emitted the moment the first
    record of the next bucket arrives (or at close/flush replay time
    for the partial tail, which stays pending and is NOT emitted —
    boundary exactness is part of the contract tests pin).
    """

    def __init__(
        self,
        dir: Optional[str] = None,
        *,
        ring: int = 4096,
        tiers: Sequence[int] = (10, 100),
        tier_buckets: int = 4096,
        segment_records: int = 1024,
        max_segments: int = 64,
        component: str = "server",
        clock=time.time,
    ):
        if ring <= 0:
            raise ValueError("ring must be positive")
        for f in tiers:
            if f <= 1:
                raise ValueError("tier factors must be > 1")
        self.dir = dir
        self.component = component
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(ring))  # guarded-by: self._lock
        self._tiers: Dict[int, deque] = {  # factor -> finalized buckets
            int(f): deque(maxlen=int(tier_buckets)) for f in tiers
        }
        self._pending: Dict[int, Optional[_TierBucket]] = {
            int(f): None for f in tiers
        }
        self._seq = 0  # last stamped hseq, guarded-by: self._lock
        self.run = 1
        self._segment_records = max(1, int(segment_records))
        self._max_segments = max(1, int(max_segments))
        self._fh = None  # current segment file handle
        self._fh_records = 0
        self._seg_index = 0
        if dir is not None:
            self._open_durable(dir)

    # -- durability -----------------------------------------------------

    def _segment_paths(self) -> List[str]:
        try:
            names = sorted(
                n
                for n in os.listdir(self.dir)
                if n.startswith(SEGMENT_PREFIX) and n.endswith(".log")
            )
        except FileNotFoundError:
            return []
        return [os.path.join(self.dir, n) for n in names]

    def _open_durable(self, dir: str) -> None:
        os.makedirs(dir, exist_ok=True)
        max_run = 0
        for path in self._segment_paths():
            name = os.path.basename(path)
            try:
                idx = int(name[len(SEGMENT_PREFIX):-4])
            except ValueError:
                continue
            self._seg_index = max(self._seg_index, idx)
            try:
                with open(path, "rb") as f:
                    lines = f.readlines()
            except OSError:
                log.exception("history segment %s unreadable", path)
                continue
            for line in lines:
                rec = _decode(line)
                if rec is None:
                    # Torn tail: everything after the first corrupt
                    # line in a segment is untrusted — stop replaying
                    # this segment (appends go to a fresh one).
                    break
                self._ingest(rec)
                self._seq = max(self._seq, int(rec.get("hseq", 0)))
                max_run = max(max_run, int(rec.get("run", 0)))
        self.run = max_run + 1
        # Appends always start a new segment: a torn tail is never
        # appended to, and each process generation's records are
        # physically contiguous.
        self._seg_index += 1

    def _rotate_locked(self) -> None:
        if self._fh is not None:
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()
            except OSError:
                log.exception("history segment close failed")
            self._fh = None
        self._seg_index += 1
        self._fh_records = 0
        # Retention: drop oldest segments beyond the cap.
        paths = self._segment_paths()
        for stale in paths[: max(0, len(paths) - self._max_segments)]:
            try:
                os.remove(stale)
            except OSError:
                log.exception("history segment retention failed")

    def _append_durable_locked(self, rec: dict) -> None:
        if self._fh is None:
            path = os.path.join(
                self.dir, f"{SEGMENT_PREFIX}{self._seg_index:08d}.log"
            )
            self._fh = open(path, "ab")
        self._fh.write(_encode(rec))
        self._fh.flush()
        self._fh_records += 1
        if self._fh_records >= self._segment_records:
            self._rotate_locked()

    # -- ingest ---------------------------------------------------------

    def _ingest(self, rec: dict) -> None:  # holds-lock: self._lock
        """Ring + tier bookkeeping for one stamped record (no I/O)."""
        self._ring.append(rec)
        hseq = int(rec.get("hseq", 0))
        for factor, finalized in self._tiers.items():
            bucket_start = (hseq // factor) * factor
            pending = self._pending[factor]
            if pending is not None and pending.start != bucket_start:
                finalized.append(pending.finalize())
                pending = None
            if pending is None:
                pending = _TierBucket(
                    bucket_start, int(rec.get("run", self.run))
                )
                self._pending[factor] = pending
            pending.add(rec)

    def append(self, rec: dict) -> int:
        """Stamp ``hseq``/``run`` onto a copy of ``rec`` and store it;
        returns the history sequence number. Never raises on disk
        trouble — history must not take down the tick loop."""
        with self._lock:
            self._seq += 1
            stamped = dict(rec)
            stamped["hseq"] = self._seq
            stamped["run"] = self.run
            self._ingest(stamped)
            if self.dir is not None:
                try:
                    self._append_durable_locked(stamped)
                except OSError:
                    log.exception("history append to %s failed", self.dir)
            return self._seq

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                except OSError:
                    log.exception("history flush failed")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                    self._fh.close()
                except OSError:
                    log.exception("history close failed")
                self._fh = None

    # -- queries --------------------------------------------------------

    @property
    def head_hseq(self) -> int:
        # Benign racy read (monotone int) for status pages.
        return self._seq  # doorman: allow[lock-discipline]

    def records(
        self,
        start: Optional[int] = None,
        end: Optional[int] = None,
        tier: int = 0,
        fields: Optional[Sequence[str]] = None,
    ) -> List[dict]:
        """Records (tier 0: raw ring) or finalized buckets (tier = a
        decimation factor) with ``start <= hseq <= end``, optionally
        projected to ``fields`` (+ hseq/run always)."""
        with self._lock:
            if tier == 0:
                rows = [dict(r) for r in self._ring]
            else:
                if tier not in self._tiers:
                    raise KeyError(f"no history tier with factor {tier}")
                rows = [dict(b) for b in self._tiers[tier]]
        if start is not None:
            rows = [r for r in rows if r["hseq"] >= start]
        if end is not None:
            rows = [r for r in rows if r["hseq"] <= end]
        if fields is not None:
            keep = set(fields) | {"hseq", "run", "n"}
            if tier == 0:
                rows = [
                    {k: v for k, v in r.items() if k in keep} for r in rows
                ]
            else:
                rows = [
                    {
                        **{k: v for k, v in r.items() if k != "fields"},
                        "fields": {
                            k: v
                            for k, v in r["fields"].items()
                            if k in keep
                        },
                    }
                    for r in rows
                ]
        return rows

    def series(
        self,
        field: str,
        tier: int = 0,
        run: Optional[int] = None,
        agg: str = "mean",
    ) -> List[float]:
        """One field as a flat float list (skipping records where it is
        absent or non-numeric). Tier 0 reads the raw value; decimated
        tiers read the ``agg`` aggregate (min|max|mean|last)."""
        out: List[float] = []
        for r in self.records(tier=tier):
            if run is not None and r.get("run") != run:
                continue
            if tier == 0:
                v = r.get(field)
            else:
                v = (r.get("fields") or {}).get(field, {}).get(agg)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            out.append(float(v))
        return out

    def runs(self) -> List[int]:
        with self._lock:
            seen = {int(r.get("run", 0)) for r in self._ring}
        return sorted(seen)

    def run_delta(
        self, field: str, q: float = 0.5, tier: int = 0
    ) -> Optional[dict]:
        """Restart-spanning trajectory delta: the ``q`` quantile of
        ``field`` in the newest run vs the newest prior run that also
        carries it. None until two runs have data (i.e. until history
        has actually survived a restart)."""
        from doorman_tpu_torch.obs.slo import sample_quantile

        runs = self.runs()
        cur = None
        for r in reversed(runs):
            vals = self.series(field, tier=tier, run=r)
            v = sample_quantile(vals, q)
            if v is None:
                continue
            if cur is None:
                cur = (r, v, len(vals))
            else:
                delta = cur[1] - v
                return {
                    "field": field,
                    "q": q,
                    "run": cur[0],
                    "previous_run": r,
                    "current": cur[1],
                    "previous": v,
                    "delta": delta,
                    "ratio": (cur[1] / v) if v else None,
                    "samples": cur[2],
                    "previous_samples": len(vals),
                }
        return None

    # -- export ---------------------------------------------------------

    def view(
        self,
        start: Optional[int] = None,
        end: Optional[int] = None,
        tier: int = 0,
        fields: Optional[Sequence[str]] = None,
    ) -> dict:
        """The /debug/history JSON body (no side effects)."""
        return {
            "component": self.component,
            "at": self._clock(),
            "run": self.run,
            "head_hseq": self.head_hseq,
            "tier": tier,
            "tiers": sorted(self._tiers),
            "records": self.records(start, end, tier, fields),
        }

    def chrome(self) -> str:
        """Raw-ring records as a Chrome-trace overlay — same renderer
        the flight recorder uses, so history drops into Perfetto next
        to a live trace."""
        from doorman_tpu_torch.obs.flightrec import FlightRecorder

        fr = FlightRecorder(
            capacity=1,
            component=f"history:{self.component}",
            clock=self._clock,
        )
        return fr.chrome_overlay(self.records())

    def status(self) -> dict:
        with self._lock:
            tier_occupancy = {
                str(f): len(buckets) for f, buckets in self._tiers.items()
            }
            ring_len = len(self._ring)
            ring_cap = self._ring.maxlen
        return {
            "component": self.component,
            "dir": self.dir,
            "run": self.run,
            "head_hseq": self.head_hseq,
            "ring": ring_len,
            "ring_capacity": ring_cap,
            "tiers": tier_occupancy,
            "segments": len(self._segment_paths()) if self.dir else 0,
        }
