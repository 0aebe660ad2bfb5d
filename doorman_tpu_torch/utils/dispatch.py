"""Per-process device-dispatch and host-sync accounting.

The fused-tick work (doc/design.md "Fused device-resident tick") turns
"one tick is one dispatch" from a claim into a number: every host->
device transfer and executable launch goes through a counted chokepoint
(`solver.engine.place`, `solver.engine.count_launch`, the download
split in `utils.transfer`), and every device->host landing through
another (`utils.transfer.land_parts`, the delta-mask / match landings).
The counters are process-global on purpose — the tick path may fan
work across executor threads, and the consumers (flight recorder,
/debug/status, bench.py) all want "what did this process ask of the
device between two points in time", which a `snapshot()` delta answers.

What counts as what:

  dispatches  — device work the host ENQUEUES: one per `place()`
                (host->device transfer op), one per tick-executable
                launch (`count_launch`), and one per extra slice op a
                split download creates (`utils.transfer
                .split_for_download` documents that each part beyond a
                single-part download is its own device op). The scoped
                tick's scope-index buffer counts only when it is
                actually re-placed: an unchanged scope reuses the
                cached device copy (TickEngineBase._place_scope), so a
                steady scoped tick reads 3 dispatches while churn
                moves the scope and 2 at the quiet-tick fixpoint —
                tests/test_scoped_solve.py pins both.
  host_syncs  — device->host landings the host WAITS on: one per part
                `land_parts` consumes, one per direct device->host
                `np.asarray`/`device_get` landing on the tick path
                (the delta mask, the mesh ticks' solve-moved mask,
                the stream matcher's pairs).

Increments are a few per tick, so one lock covers both counters.
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = [
    "count_dispatch",
    "count_host_sync",
    "snapshot",
    "delta",
]

_lock = threading.Lock()
_counts: Dict[str, int] = {  # guarded-by: _lock
    "dispatches": 0,
    "host_syncs": 0,
}


def count_dispatch(n: int = 1) -> None:
    """Record `n` device dispatches (transfer ops / launches)."""
    if n <= 0:
        return
    with _lock:
        _counts["dispatches"] += n


def count_host_sync(n: int = 1) -> None:
    """Record `n` device->host landings the host blocked on."""
    if n <= 0:
        return
    with _lock:
        _counts["host_syncs"] += n


def snapshot() -> Dict[str, int]:
    """Current cumulative counters (monotone since process start)."""
    with _lock:
        return dict(_counts)


def delta(since: Dict[str, int]) -> Dict[str, int]:
    """Counter movement since a previous `snapshot()`."""
    now = snapshot()
    return {k: now[k] - since.get(k, 0) for k in now}
