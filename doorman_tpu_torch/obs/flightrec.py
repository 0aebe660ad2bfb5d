"""Per-tick flight recorder: the black box that explains a failure.

A bounded ring of structured per-tick records — phase laps, admission
level and per-band shed tallies, per-shard transfer bytes, persist
journal sequence, mastership epoch, a store digest — cheap enough to
run always-on next to the serving path. When something goes wrong (a
chaos invariant violation, an unhandled server-tick exception) the ring
is dumped: JSON that replays the last N ticks record by record, plus a
Chrome-trace overlay so the same window drops straight into Perfetto
next to the span tracer's timeline. `/debug/flightrec` serves the same
view on demand.

Two producers share this ring type:

  * CapacityServer records one entry per tick_once (wall-clock phase
    laps included) and auto-dumps on a tick exception;
  * ChaosRunner records one entry per VIRTUAL tick — deterministic
    fields only (virtual time, masters, admission tallies, digests), so
    a violation dump is byte-stable across two runs of the same seeded
    plan and lands in the verdict as the replay artifact.

Dumps write to ``dump_dir`` when set, else to ``$DOORMAN_FLIGHTREC_DIR``
when that is set (CI points it at a scratch dir and uploads whatever
landed there as artifacts on test failure), else nowhere — the dump
dict is returned either way.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

log = logging.getLogger(__name__)

__all__ = [
    "ENV_DUMP_DIR", "FlightRecorder", "digest_stores", "store_digest",
]

ENV_DUMP_DIR = "DOORMAN_FLIGHTREC_DIR"

_REASON_SAFE = re.compile(r"[^A-Za-z0-9._-]+")


def store_digest(resources: Dict[str, object]) -> str:
    """A 16-hex-char digest of the lease-store aggregates (capacity,
    sum_has, sum_wants, lease count per resource). O(#resources): the
    stores maintain running sums, so this never walks leases. Two
    states that diverge in aggregate grant mass diverge here — the
    cheap "did the stores move?" pin a dump reader diffs first."""
    return digest_stores(resources)[0]


def digest_stores(resources: Dict[str, object]) -> Tuple[str, bool]:
    """`store_digest` and whether it read every store in one native
    call: when all stores are native views of one engine their rows come
    from one locked `StoreEngine.sums`, else each store is read on its
    own. Both give the same bytes."""
    # Deferred: the native module imports the obs package.
    from doorman_tpu_torch.native import bulk_sums

    ordered = sorted(resources.items())
    sums = bulk_sums([res.store for _, res in ordered])
    if sums is None:
        items = [
            (
                rid,
                round(float(res.capacity), 6),
                round(float(res.store.sum_has), 6),
                round(float(res.store.sum_wants), 6),
                len(res.store),
            )
            for rid, res in ordered
        ]
    else:
        items = [
            (rid, round(float(res.capacity), 6), round(has, 6),
             round(wants, 6), int(n))
            for (rid, res), (has, wants, _, n) in zip(ordered, sums.tolist())
        ]
    payload = json.dumps(items, separators=(",", ":")).encode()
    return hashlib.sha256(payload).hexdigest()[:16], sums is not None


class FlightRecorder:
    """Bounded ring of per-tick dicts with monotone sequence numbers.

    Thread-safe: the server records from its event loop / executor
    while the debug HTTP thread reads. Records are plain dicts; the
    producer decides the schema (see module docstring), the recorder
    only stamps ``seq``.
    """

    def __init__(
        self,
        capacity: int = 512,
        *,
        component: str = "server",
        clock=time.time,
        dump_dir: Optional[str] = None,
    ):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self.component = component
        self._clock = clock
        self._ring: deque = deque(maxlen=self.capacity)  # guarded-by: self._lock
        self._seq = 0  # guarded-by: self._lock
        self._lock = threading.Lock()
        self.dump_dir = (
            dump_dir
            if dump_dir is not None
            else (os.environ.get(ENV_DUMP_DIR) or None)
        )
        # Summary of the most recent dump (status pages); never the
        # records themselves.
        self.last_dump: Optional[dict] = None

    # -- recording ------------------------------------------------------

    def record(self, **fields) -> int:
        """Append one record; returns its sequence number."""
        with self._lock:
            self._seq += 1
            fields["seq"] = self._seq
            self._ring.append(fields)
            return self._seq

    @property
    def head_seq(self) -> int:
        # Lock-free racy read, deliberately: a monotone int for status
        # pages; CPython int loads are atomic and staleness is harmless.
        return self._seq  # doorman: allow[lock-discipline]

    @property
    def occupancy(self) -> int:
        # Same benign racy read as head_seq (deque len is atomic).
        return len(self._ring)  # doorman: allow[lock-discipline]

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def status(self) -> dict:
        return {
            "head_seq": self.head_seq,
            "occupancy": self.occupancy,
            "capacity": self.capacity,
            "last_dump": self.last_dump,
        }

    # -- dumping --------------------------------------------------------

    def view(self, reason: str = "on_demand", extra: Optional[dict] = None
             ) -> dict:
        """The dump structure without side effects (no files, no
        last_dump update) — what /debug/flightrec serves."""
        records = self.snapshot()
        out = {
            "component": self.component,
            "reason": reason,
            "at": self._clock(),
            "head_seq": self.head_seq,
            "capacity": self.capacity,
            "records": records,
        }
        if extra:
            out["extra"] = extra
        return out

    def dump(self, reason: str, extra: Optional[dict] = None) -> dict:
        """Dump the ring: returns the JSON-able dict, notes it as the
        last dump, and — when a dump directory is configured — writes
        the JSON plus its Chrome-trace overlay there. File trouble
        never raises: the black box must not take down the plane."""
        out = self.view(reason, extra)
        self.last_dump = {
            "reason": reason,
            "at": out["at"],
            "head_seq": out["head_seq"],
            "records": len(out["records"]),
        }
        if self.dump_dir:
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                safe = _REASON_SAFE.sub(
                    "_", f"{self.component}-{reason}-{out['head_seq']}"
                )
                base = os.path.join(self.dump_dir, f"flightrec-{safe}")
                with open(base + ".json", "w") as f:
                    json.dump(out, f, indent=1, sort_keys=True)
                    f.write("\n")
                with open(base + ".trace.json", "w") as f:
                    f.write(self.chrome_overlay(out["records"]))
                self.last_dump["path"] = base + ".json"
            except Exception:
                log.exception(
                    "flight-recorder dump to %s failed", self.dump_dir
                )
        return out

    # -- Chrome-trace overlay ------------------------------------------

    def chrome_overlay(
        self, records: Optional[Iterable[dict]] = None, pid: int = 1
    ) -> str:
        """Render records as Chrome trace-event JSON: one complete
        event per recorded tick (phase laps laid out sequentially
        inside it), counter tracks for admission level / persist seq /
        shed totals, and instants for errors and violations. Time axis
        is the records' own ``t`` (wall for the server, virtual for
        chaos), relative to the first record."""
        recs = list(records) if records is not None else self.snapshot()
        events: List[dict] = [
            {
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": f"flightrec:{self.component}"},
            }
        ]
        if not recs:
            return json.dumps(
                {"traceEvents": events, "displayTimeUnit": "ms"}
            )
        t0 = float(recs[0].get("t", 0.0))
        for rec in recs:
            ts = (float(rec.get("t", t0)) - t0) * 1e6
            args = {
                k: rec[k]
                for k in ("seq", "tick", "digest", "epoch", "is_master",
                          "masters", "resources", "persist_seq")
                if k in rec
            }
            wall_ms = rec.get("wall_ms")
            if isinstance(wall_ms, (int, float)) and wall_ms > 0:
                events.append({
                    "name": "tick", "cat": "flightrec", "ph": "X",
                    "pid": pid, "tid": 0,
                    "ts": ts, "dur": wall_ms * 1000.0, "args": args,
                })
                offset = ts
                for phase, ms in (rec.get("phases") or {}).items():
                    if not isinstance(ms, (int, float)) or ms <= 0:
                        continue
                    events.append({
                        "name": phase, "cat": "flightrec.phase",
                        "ph": "X", "pid": pid, "tid": 0,
                        "ts": offset, "dur": ms * 1000.0, "args": {},
                    })
                    offset += ms * 1000.0
            else:
                events.append({
                    "name": "tick", "cat": "flightrec", "ph": "i",
                    "pid": pid, "tid": 0, "ts": ts, "s": "t",
                    "args": args,
                })
            # straddle_capacity / straddle_updates / upstream_rpcs are
            # the federation beat (server records stamp them per tick
            # when the server is a shard — doc/federation.md);
            # dispatches / host_syncs are the per-tick dispatch
            # accounting deltas (utils.dispatch via the server's tick
            # records) — the fused-tick triage counters;
            # scoped_rows / scoped_resources are the churn-
            # proportional solve's per-tick scope (the compact table
            # the tick actually solved — a counter stuck at the table
            # size means solve_mode is stuck at full, doc/
            # operations.md).
            # population / offered / forecast_rps are the workload
            # harness's per-tick beat (doorman_tpu/workload): live
            # client count, offered refreshes this tick, and the
            # forecaster's next-tick demand prediction — overlaying
            # forecast_rps on offered shows the predictive-admission
            # lead time directly.
            # audit_divergence / anomalies are the continuous-telemetry
            # beat (obs/audit.py, obs/detect.py): cumulative confirmed
            # shadow-oracle divergences and online anomaly detections —
            # both flatline at zero on a healthy server, so any step in
            # these tracks is the moment to scrub to.
            for counter in ("admission_level", "persist_seq",
                            "straddle_capacity", "straddle_updates",
                            "upstream_rpcs", "dispatches",
                            "host_syncs", "scoped_rows",
                            "scoped_resources", "population",
                            "offered", "forecast_rps",
                            "audit_divergence", "anomalies"):
                v = rec.get(counter)
                if isinstance(v, (int, float)):
                    events.append({
                        "name": counter, "ph": "C", "pid": pid,
                        "ts": ts, "args": {counter: v},
                    })
            shed = rec.get("shed_by_band")
            if isinstance(shed, dict) and shed:
                events.append({
                    "name": "shed_by_band", "ph": "C", "pid": pid,
                    "ts": ts,
                    "args": {str(k): v for k, v in sorted(shed.items())},
                })
            for key in ("error", "violations"):
                v = rec.get(key)
                if v:
                    events.append({
                        "name": key, "cat": "flightrec", "ph": "i",
                        "pid": pid, "tid": 0, "ts": ts, "s": "g",
                        "args": {key: v},
                    })
        return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"})
