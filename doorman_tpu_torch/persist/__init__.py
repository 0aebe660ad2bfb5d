"""doorman_tpu_torch.persist — durable lease-state snapshots + journal with
warm master takeover.

The reference throws away the whole wants/has table on every mastership
change and relearns it over a full lease length (server.go:438-455).
This subsystem makes that table durable: the master periodically
snapshots its full state (snapshot.py) to a pluggable backend
(backend.py: `file:` or `etcd:` through the shared gateway), journals
every assign/release/decide delta in between (journal.py), and a fresh
master restores snapshot + journal and skips or shortens learning mode
per-resource when the restored state is fresh (restore.py) — converting
election flaps from minutes-scale degraded allocation into a sub-second
restore. Any corruption falls back to the cold path.

`PersistManager` is the server-facing facade: the request path calls
`record_assign`/`record_release`, the tick pipeline calls `step()`
(flush + cadenced snapshot + compaction), and `_on_is_master` calls
`restore()`/`note_step_down()`. Observability rides the default
registry and tracer: snapshot age/size gauges, a restore-duration
histogram, `persist.snapshot`/`persist.restore` spans.

Host-only: a copy of the JAX package's module, import paths aside; the
metrics and spans land in the port's obs registry and tracer.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

from doorman_tpu_torch.core.lease import Lease
from doorman_tpu_torch.obs import metrics as metrics_mod
from doorman_tpu_torch.obs import trace as trace_mod
from doorman_tpu_torch.persist.backend import (  # noqa: F401
    EtcdBackend,
    FileBackend,
    MemoryBackend,
    PersistBackend,
    parse_backend,
)
from doorman_tpu_torch.persist.journal import Journal
from doorman_tpu_torch.persist.restore import RestoreSummary, restore_server
from doorman_tpu_torch.persist.snapshot import (  # noqa: F401
    SnapshotError,
    decode,
    encode,
    take_snapshot,
)

log = logging.getLogger(__name__)

DEFAULT_SNAPSHOT_INTERVAL = 30.0
# Rewrite the journal once it carries this many flushed records between
# snapshots (replay and takeover cost scale with journal length).
DEFAULT_COMPACT_THRESHOLD = 100_000


def _metrics():
    reg = metrics_mod.default_registry()
    return {
        "age": reg.gauge(
            "doorman_persist_snapshot_age_seconds",
            "Seconds since the master's last durable snapshot.",
            labels=("server",),
        ),
        "size": reg.gauge(
            "doorman_persist_snapshot_bytes",
            "Size of the last written snapshot.",
            labels=("server",),
        ),
        "journal": reg.counter(
            "doorman_persist_journal_records_total",
            "Journal records flushed, by kind.",
            labels=("server", "kind"),
        ),
        "restore": reg.histogram(
            "doorman_persist_restore_seconds",
            "Wall-clock duration of master-takeover restores.",
        ),
        "restores": reg.counter(
            "doorman_persist_restores_total",
            "Master-takeover restore attempts, by outcome.",
            labels=("server", "mode"),
        ),
    }


class PersistManager:
    """One per server process; owns the backend, the journal writer, and
    the snapshot cadence. All entry points run on the server's event
    loop (or inside the chaos runner's stepped schedule) — no locking."""

    def __init__(
        self,
        backend: PersistBackend,
        *,
        snapshot_interval: float = DEFAULT_SNAPSHOT_INTERVAL,
        flush_interval: float = 1.0,
        compact_threshold: int = DEFAULT_COMPACT_THRESHOLD,
        clock: Callable[[], float] = time.time,
    ):
        self.backend = backend
        self.snapshot_interval = float(snapshot_interval)
        self.flush_interval = float(flush_interval)
        self.compact_threshold = int(compact_threshold)
        self._clock = clock
        self.journal = Journal(backend)
        self._last_snapshot_at: Optional[float] = None
        self._was_master = False
        self._m = _metrics()

    # -- request-path hooks (master only; callers gate) -----------------

    def record_assign(self, resource_id: str, client: str,
                      lease: Lease) -> None:
        self.journal.record_assign(
            self._clock(), resource_id, client, lease
        )

    def record_release(self, resource_id: str, client: str) -> None:
        self.journal.record_release(self._clock(), resource_id, client)

    # -- cadence ---------------------------------------------------------

    def step(self, server) -> None:
        """One durability beat: flush buffered journal records, compact
        an overgrown journal, take a cadenced snapshot. The server's
        tick pipeline calls this once per tick; immediate-mode servers
        run it from a timer loop; the chaos runner steps it in virtual
        time."""
        flushed = self.journal.flush()
        if flushed:
            self._m["journal"].inc(server.id, "flushed", by=flushed)
        now = self._clock()
        if (
            self._last_snapshot_at is None
            or now - self._last_snapshot_at >= self.snapshot_interval
        ):
            self.snapshot_now(server)
        elif self.journal.flushed_records >= self.compact_threshold:
            before, after = self.journal.compact(now)
            log.info(
                "%s: journal compacted %d -> %d records",
                server.id, before, after,
            )
        if self._last_snapshot_at is not None:
            self._m["age"].set(now - self._last_snapshot_at, server.id)

    def snapshot_now(self, server) -> int:
        """Serialize the server's full master state and atomically
        replace the backend snapshot; the journal resets to empty (the
        snapshot supersedes it). Returns the snapshot size in bytes."""
        with trace_mod.default_tracer().span(
            "persist.snapshot", cat="persist",
            args={"server": server.id,
                  "resources": len(server.resources)},
        ):
            snap = take_snapshot(server, self.journal.seq)
            data = encode(snap)
            self.backend.write_snapshot(data)
            self.journal.reset()
        self._last_snapshot_at = self._clock()
        self._m["size"].set(len(data), server.id)
        self._m["age"].set(0.0, server.id)
        return len(data)

    # -- mastership edges -----------------------------------------------

    def restore(self, server) -> RestoreSummary:
        """Warm takeover: rebuild `server`'s state from the backend
        (falls back to cold inside restore_server on any corruption),
        then immediately re-baseline with a fresh snapshot so the next
        takeover starts from OUR state, not our predecessor's."""
        start = time.perf_counter()
        with trace_mod.default_tracer().span(
            "persist.restore", cat="persist", args={"server": server.id},
        ):
            summary = restore_server(server, self.backend)
            self.journal = Journal(
                self.backend, start_seq=summary.journal_seq
            )
            try:
                if summary.mode == "warm":
                    self.snapshot_now(server)
                else:
                    # Cold path: clear any stale/garbage journal so new
                    # records (seq restarts) never land behind old ones.
                    self.journal.reset()
            except Exception:
                # A broken backend must not break the takeover itself;
                # the next step() beat retries the snapshot.
                log.exception(
                    "%s: post-restore snapshot failed", server.id
                )
        self._was_master = True
        duration = time.perf_counter() - start
        self._m["restore"].observe(duration)
        self._m["restores"].inc(server.id, summary.mode)
        log.info(
            "%s: takeover restore mode=%s leases=%d age=%.3fs "
            "(%.1fms)%s",
            server.id, summary.mode, summary.leases_restored,
            summary.age, duration * 1e3,
            f" [{summary.detail}]" if summary.detail else "",
        )
        return summary

    def note_step_down(self) -> None:
        """A clean mastership loss: flush a terminal step-down marker so
        the next master knows this journal is COMPLETE (the warm-skip
        justification in restore.py). Only meaningful if we were master;
        a crash simply never writes it."""
        if not self._was_master:
            return
        self._was_master = False
        try:
            self.journal.record_down(self._clock())
            self.journal.flush()
        except Exception:
            # Losing mastership with a dead backend is exactly the
            # correlated-failure case the shorten path covers.
            log.exception("step-down marker write failed")

    def status(self) -> dict:
        now = self._clock()
        return {
            "snapshot_interval": self.snapshot_interval,
            "last_snapshot_age": (
                None if self._last_snapshot_at is None
                else round(now - self._last_snapshot_at, 3)
            ),
            "journal_seq": self.journal.seq,
            "journal_pending": self.journal.pending,
            "journal_flushed_records": self.journal.flushed_records,
        }
