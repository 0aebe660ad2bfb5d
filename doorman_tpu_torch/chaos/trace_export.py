"""Chrome trace-event export of a chaos run's virtual-time event log.

A chaos verdict's `event_log` is a list of `[tick, kind, ...]` entries
on the run's VIRTUAL clock. This module renders it in the same Chrome
trace-event JSON the span tracer exports (obs.trace), so a fault plan —
fault windows, mastership changes, invariant violations, degradation
and reconvergence markers — loads in Perfetto on one timeline, with one
virtual tick mapped to its tick_interval in trace time.

Fault events know their duration (duration_ticks), so they render as
complete spans; everything else is an instant marker. Tracks (tid) are
assigned per event kind so faults, mastership and violations stack as
separate swimlanes instead of overlapping.

Port of doorman_tpu/chaos/trace_export.py: a copy apart from import paths.
"""

from __future__ import annotations

import json
from typing import Dict, List

__all__ = ["chrome_trace", "write_chrome_trace"]

# Swimlane per event kind; unknown kinds land on the last lane.
_LANES = ("fault", "master", "violation", "tick_error")
_OTHER_LANE = len(_LANES)

_PID = 1  # one logical "chaos" process


def _ts(tick: float, tick_interval: float) -> float:
    return tick * tick_interval * 1e6  # virtual µs


def chrome_trace(verdict: dict) -> dict:
    """Build the Chrome trace object from a runner verdict (as returned
    by ChaosRunner.run / written by `cmd.chaos --out`)."""
    interval = float(verdict.get("tick_interval", 1.0))
    events: List[dict] = [
        {
            "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
            "args": {"name": f"chaos:{verdict.get('plan', 'plan')}"},
        }
    ]
    lanes: Dict[str, int] = {k: i for i, k in enumerate(_LANES)}
    for name, tid in list(lanes.items()) + [("events", _OTHER_LANE)]:
        events.append({
            "name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
            "args": {"name": name},
        })
    for entry in verdict.get("event_log", []):
        tick, kind, rest = entry[0], str(entry[1]), entry[2:]
        tid = lanes.get(kind, _OTHER_LANE)
        ev = {
            "pid": _PID,
            "tid": tid,
            "ts": round(_ts(tick, interval), 3),
            "cat": "chaos",
            "args": {"tick": tick, "detail": rest},
        }
        if kind == "fault":
            # [tick, "fault", kind, target, duration_ticks]
            fault_kind = rest[0] if rest else "fault"
            target = rest[1] if len(rest) > 1 else ""
            dur_ticks = rest[2] if len(rest) > 2 else 1
            ev.update(
                name=f"{fault_kind}({target})",
                ph="X",
                dur=round(_ts(max(float(dur_ticks), 1.0), interval), 3),
            )
        elif kind == "violation":
            # [tick, "violation", invariant, subject, detail]
            ev.update(
                name=f"violation:{rest[0] if rest else '?'}", ph="i", s="p"
            )
        elif kind == "master":
            holders = ",".join(rest[0]) if rest and rest[0] else "(none)"
            ev.update(name=f"master={holders}", ph="i", s="p")
        else:
            ev.update(name=kind, ph="i", s="p")
        events.append(ev)
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(verdict: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(verdict), f)
        f.write("\n")
