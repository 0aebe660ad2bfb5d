"""Reduction of a torch.profiler Chrome trace of the measured window:
the device's busy time, each kernel's launches and device time, the
device operations that took most time, and the longest idle gaps named
by what the host was doing.

`kernel_label` and the busy-interval union are frozen copies of
chip_smoke.py's `_kernel_label` and `_trace_summary` (commit 37ca06e);
the window is the harness's own `portbench.window` annotation where the
trace has it, and the gaps and top lists are the benchmark's.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME = 160  # characters of a device operation's name kept

_KERNEL_NAME = re.compile(
    r"(dense_solve(?:_warp)?_kernel|banded_fill\w*_kernel)<([^>]*)>")


def kernel_label(name: str) -> Optional[str]:
    """K1 / K2 / K3 for a demangled kernel name from a profiler trace
    (K2 is K1's template with kFused = true), else None."""
    m = _KERNEL_NAME.search(name)
    if m is None:
        return None
    if m.group(1).startswith("banded"):
        return "K3"
    args = [a.strip() for a in m.group(2).split(",")]
    return "K2" if len(args) > 2 and args[2] == "true" else "K1"


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: List[dict], idle_label: str = "host between calls",
              top: int = 10, spans=(), window_start_s: Optional[float] = None
              ) -> Dict:
    """Times in seconds. `events`: a Chrome trace's traceEvents. `spans`:
    the program's own spans of the window, (start, end) in
    time.perf_counter seconds and a name, placed on the trace's axis by
    the window's start (`window_start_s`, perf_counter) so that they name
    idle gaps too."""
    evs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    win = [e for e in evs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if win:
        lo = float(win[0]["ts"])
        hi = lo + float(win[0].get("dur", 0.0))
    elif evs:
        lo = min(float(e["ts"]) for e in evs)
        hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in evs)
    else:
        lo = hi = 0.0
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    intervals = []
    for e in dev:
        a = max(float(e["ts"]), lo)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), hi)
        if b > a:
            intervals.append((a, b))
    busy = _union(intervals)
    busy_us = sum(b - a for a, b in busy)
    kernels: Dict[str, Dict] = {}
    by_name: Dict[str, float] = {}
    for e in dev:
        t0 = float(e["ts"])
        if t0 < lo or t0 > hi:
            continue
        dur = float(e.get("dur", 0.0))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + dur
        label = kernel_label(e["name"]) if e.get("cat") == "kernel" else None
        if label is not None:
            k = kernels.setdefault(label, {"launches": 0, "sum_s": 0.0})
            k["launches"] += 1
            k["sum_s"] += dur / 1e6
    # Idle gaps, each named by the innermost harness annotation or
    # program span that covers its middle.
    notes = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              e["name"]) for e in evs
             if e.get("cat") == "user_annotation" and e["name"] != WINDOW
             and e["name"].startswith("portbench.")]
    if win and window_start_s is not None:
        offset = lo - window_start_s * 1e6
        notes += [(a * 1e6 + offset, b * 1e6 + offset, name)
                  for a, b, name in spans]
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    longest = sorted(((b - a) / 1e6, a, b) for a, b in gaps)[::-1][:top]
    idle_gaps = []
    for dur, a, b in longest:
        mid = (a + b) / 2
        cover = [n for n in notes if n[0] <= mid <= n[1]]
        idle_gaps.append([min(cover, key=lambda n: n[1] - n[0])[2]
                          if cover else idle_label, dur])
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernels": kernels,
        "device_ops": [[n[:NAME], s / 1e6] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": idle_gaps,
    }


def read_trace(path: Path, idle_label: str = "host between calls",
               spans=(), window_start_s: Optional[float] = None) -> Dict:
    doc = json.loads(Path(path).read_text())
    return summarize(doc.get("traceEvents", []), idle_label, spans=spans,
                     window_start_s=window_start_s)
