"""Warm master takeover: snapshot + journal -> live lease state.

The reference wipes all lease state on every mastership change and makes
the fresh master serve conservative learning-mode grants for a full
window (server.go:438-455; server.py `_on_is_master`) — every election
flap costs up to a lease length of degraded allocation per resource.
Restore replaces that with: load the latest snapshot, replay the journal
records after it, drop leases already expired against the clock, rebuild
the store engine (one bulk C call on native engines), clamp any restored
over-commit, and decide learning mode PER RESOURCE from how fresh the
restored state actually is.

Learning-mode decision (the documented warm-takeover semantics; see
doc/persistence.md for the failure matrix):

  * journal ends with a clean step-down marker ("d"): the previous
    master flushed everything it ever granted before it stopped — there
    is no unknown-grant gap, so learning mode is SKIPPED outright.
    The masterless gap between step-down and takeover adds nothing:
    no master, no grants.
  * no step-down marker (crash / torn flush) and the state is `age`
    seconds stale (age = now - last flush): grants issued in that gap
    are unknown, so learning mode is SHORTENED to cover exactly `age`
    seconds instead of the full window.
  * `age` at or beyond the learning window, or no usable state at all,
    or any checksum/format mismatch: the cold path, byte-for-byte the
    behavior persistence was bolted onto.

Restored grants never exceed capacity: any resource whose restored
`sum_has` exceeds its current configured capacity (a capacity cut while
we were down) has every lease's `has` scaled down proportionally before
serving — each clamped value is one the solver would converge to anyway,
and the chaos `restore_capacity` invariant pins it.

Host-only (numpy for the bulk restore): a copy of the JAX package's
module, import paths aside; `_BAND_SEP` comes from the port's server,
and `RestoredState.resource_ids` keeps its order in a dict instead of
scanning a list (the same ids in the same order, in linear time).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from doorman_tpu_torch.core.lease import Lease
from doorman_tpu_torch.persist import journal as journal_mod
from doorman_tpu_torch.persist.snapshot import (
    MasterSnapshot,
    SnapshotError,
    decode,
)

log = logging.getLogger(__name__)


@dataclass
class RestoredState:
    """The merged snapshot+journal view, before it touches a server."""

    snapshot: Optional[MasterSnapshot]
    # (resource, client) -> lease, post-replay.
    leases: Dict[Tuple[str, str], Lease]
    journal_seq: int         # last applied journal seq (0 = none)
    freshness: float         # timestamp of the newest persisted fact
    clean_down: bool         # journal ends with a step-down marker
    records_applied: int

    @property
    def resource_ids(self) -> List[str]:
        # First-seen order, as the reference's list scan gives it; a
        # dict keeps the membership test O(1) (the scan is O(leases x
        # resources): 85-105 s on a 1M-lease takeover).
        out = dict.fromkeys(rid for rid, _ in self.leases)
        if self.snapshot is not None:
            out.update(dict.fromkeys(r.id for r in self.snapshot.resources))
        return list(out)


@dataclass
class RestoreSummary:
    """What actually happened to one server's takeover (exposed as
    `server.last_restore` for status pages and the chaos invariants)."""

    at: float
    mode: str                # "warm" | "cold_empty" | "cold_error"
    detail: str = ""
    age: float = 0.0
    clean_down: bool = False
    journal_seq: int = 0
    records_applied: int = 0
    leases_restored: int = 0
    leases_dropped_expired: int = 0
    # rid -> per-resource outcome for the invariant checker:
    #   {"sum_has", "capacity", "leases", "learning": skip|shorten|cold,
    #    "clamped": bool}
    resources: Dict[str, dict] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "at": self.at,
            "mode": self.mode,
            "detail": self.detail,
            "age": self.age,
            "clean_down": self.clean_down,
            "journal_seq": self.journal_seq,
            "records_applied": self.records_applied,
            "leases_restored": self.leases_restored,
            "leases_dropped_expired": self.leases_dropped_expired,
            "resources": self.resources,
        }


def load_state(backend) -> Optional[RestoredState]:
    """Read + merge snapshot and journal. Returns None when the backend
    holds nothing; raises SnapshotError on corruption (caller goes
    cold)."""
    raw = backend.read_snapshot()
    snap = decode(raw) if raw is not None else None
    records = journal_mod.read_records(backend.read_journal())

    leases: Dict[Tuple[str, str], Lease] = {}
    freshness = 0.0
    if snap is not None:
        freshness = snap.taken_at
        for r in snap.resources:
            for c, e, ri, h, w, s, p in r.rows:
                leases[(r.id, c)] = Lease(
                    expiry=e, refresh_interval=ri, has=h, wants=w,
                    subclients=s, priority=p,
                )

    base_seq = snap.seq if snap is not None else 0
    applied = 0
    last_seq = base_seq
    clean_down = False
    for rec in records:
        if rec.seq <= base_seq:
            continue  # superseded by the snapshot
        last_seq = rec.seq
        freshness = max(freshness, rec.t)
        clean_down = rec.kind == journal_mod.KIND_DOWN
        if rec.kind == journal_mod.KIND_ASSIGN:
            leases[(rec.resource, rec.client)] = rec.lease
            applied += 1
        elif rec.kind == journal_mod.KIND_RELEASE:
            leases.pop((rec.resource, rec.client), None)
            applied += 1

    if snap is None and not records:
        return None
    return RestoredState(
        snapshot=snap,
        leases=leases,
        journal_seq=last_seq,
        freshness=freshness,
        clean_down=clean_down,
        records_applied=applied,
    )


def learning_end_for(
    *,
    age: float,
    clean_down: bool,
    duration: float,
    became_master_at: float,
) -> Tuple[float, str]:
    """Per-resource learning-mode end after a warm restore; returns
    (learning_mode_end, "skip"|"shorten"|"cold")."""
    if duration <= 0:
        return 0.0, "skip"
    if clean_down:
        return 0.0, "skip"
    if age >= duration:
        return became_master_at + duration, "cold"
    if age <= 0:
        return 0.0, "skip"
    return became_master_at + age, "shorten"


def restore_server(server, backend) -> RestoreSummary:
    """Rebuild `server`'s just-wiped master state from the backend.

    Runs synchronously inside `_on_is_master(True)` (on the event loop:
    nothing serves in parallel with the rebuild, which is exactly the
    atomicity restore needs). Any failure degrades to the cold path and
    says so in the summary — a broken backend must never be worse than
    no backend."""
    now = server._clock()
    try:
        state = load_state(backend)
    except SnapshotError as e:
        log.warning("%s: snapshot rejected (%s); cold takeover",
                    server.id, e)
        return RestoreSummary(at=now, mode="cold_error", detail=str(e))
    except Exception as e:
        log.exception("%s: persistence backend unreadable; cold takeover",
                      server.id)
        return RestoreSummary(at=now, mode="cold_error", detail=repr(e))
    if state is None:
        return RestoreSummary(
            at=now, mode="cold_empty", detail="no snapshot or journal"
        )

    age = max(0.0, now - state.freshness)
    summary = RestoreSummary(
        at=now, mode="warm", age=age, clean_down=state.clean_down,
        journal_seq=state.journal_seq,
        records_applied=state.records_applied,
    )

    # Group live rows per resource, dropping leases already expired
    # against the takeover clock.
    per_resource: Dict[str, List[Tuple[str, Lease]]] = {}
    for (rid, client), lease in state.leases.items():
        if lease.expiry <= now:
            summary.leases_dropped_expired += 1
            continue
        per_resource.setdefault(rid, []).append((client, lease))

    snap_learning = {
        r.id: r.learning_mode_end
        for r in (state.snapshot.resources if state.snapshot else [])
    }

    for rid in state.resource_ids:
        rows = per_resource.get(rid, [])
        try:
            res = server.get_or_create_resource(rid)
        except Exception:
            # E.g. the resource no longer matches any config template
            # after a config change while we were down: skip it — its
            # clients re-register as new against the live config.
            log.exception(
                "%s: restored resource %r has no config template; dropped",
                server.id, rid,
            )
            continue

        capacity = res.capacity
        sum_has = sum(l.has for _, l in rows)
        clamped = False
        if capacity > 0 and sum_has > capacity:
            # A capacity cut while we were down: scale grants down so
            # the restored table NEVER serves above the live capacity.
            scale = capacity / sum_has
            rows = [
                (
                    c,
                    Lease(
                        expiry=l.expiry,
                        refresh_interval=l.refresh_interval,
                        has=l.has * scale,
                        wants=l.wants,
                        subclients=l.subclients,
                        priority=l.priority,
                    ),
                )
                for c, l in rows
            ]
            sum_has = capacity
            clamped = True

        _restore_rows(res.store, rows)

        duration = _learning_duration(res)
        # A resource still inside a learning window it entered BEFORE the
        # snapshot keeps the remainder of that window — restoring cannot
        # grant more confidence than the previous master had.
        prior_end = snap_learning.get(rid, 0.0)
        end, kind = learning_end_for(
            age=age, clean_down=state.clean_down, duration=duration,
            became_master_at=server.became_master_at,
        )
        res.learning_mode_end = max(end, min(prior_end, now + duration))
        if prior_end > end and res.learning_mode_end > now:
            kind = "inherited"
        summary.leases_restored += len(rows)
        summary.resources[rid] = {
            "leases": len(rows),
            "sum_has": sum_has,
            "capacity": capacity,
            "learning": kind,
            "clamped": clamped,
        }

    _rebuild_server_bands(server, state)
    return summary


def _restore_rows(store, rows: List[Tuple[str, Lease]]) -> None:
    """Insert restored leases; native stores above a small threshold go
    through the engine's bulk upsert (one C call for the whole resource
    — the million-lease path the snapshot exists to keep hot)."""
    engine = getattr(store, "_engine", None)
    if engine is None or len(rows) < 64:
        for client, lease in rows:
            store.restore(client, lease)
        return
    import numpy as np

    n = len(rows)
    engine.bulk_assign(
        np.full(n, store._rid, np.int32),
        np.asarray(
            [engine.client_handle(c) for c, _ in rows], np.int64
        ),
        np.asarray([l.expiry for _, l in rows], np.float64),
        np.asarray([l.refresh_interval for _, l in rows], np.float64),
        np.asarray([l.has for _, l in rows], np.float64),
        np.asarray([l.wants for _, l in rows], np.float64),
        np.asarray([l.subclients for _, l in rows], np.int32),
        np.asarray([l.priority for _, l in rows], np.int64),
    )


def _learning_duration(res) -> float:
    algo = res.template.algorithm
    if algo.HasField("learning_mode_duration"):
        return float(algo.learning_mode_duration)
    return float(algo.lease_length)


def _rebuild_server_bands(server, state: RestoredState) -> None:
    """Reconstruct `_server_bands` so stale-band sweeping keeps working
    across a takeover. The snapshot carries the map verbatim; band
    sub-leases that arrived through the journal afterwards are folded in
    by parsing their store keys (server._BAND_SEP framing)."""
    from doorman_tpu_torch.server.server import _BAND_SEP

    bands: Dict[tuple, set] = {}
    if state.snapshot is not None:
        for rid, sid, prios in state.snapshot.server_bands:
            bands[(rid, sid)] = set(int(p) for p in prios)
    for rid, res in server.resources.items():
        for client, _ in res.store.items():
            if _BAND_SEP not in client:
                continue
            sid, _, prio = client.partition(_BAND_SEP)
            try:
                bands.setdefault((rid, sid), set()).add(int(prio))
            except ValueError:
                continue
    server._server_bands = bands
