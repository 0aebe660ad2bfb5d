"""Sums over the program's spans of a window, as the `tree_refresh`
cell keeps them (`run["program_spans"]`: each span's name, its start
in seconds from the window's, its seconds and the args the readers
take). A run without them, or without any span of
the name asked, reads None."""

from __future__ import annotations

from typing import Callable, Optional


def durations(run, name: str,
              keep: Optional[Callable[[dict], bool]] = None) -> list:
    spans = run.get("program_spans") or ()
    return [s["dur_s"] for s in spans if s["name"] == name
            and (keep is None or keep(s["args"]))]


def ms_per_iteration(run, name: str):
    """Σ of the window's spans of `name` over its iterations, in ms."""
    xs = durations(run, name)
    if not xs or not run.get("ticks"):
        return None
    return sum(xs) / run["ticks"] * 1e3


def ms_per_iteration_less(run, name: str, inner: str):
    """`ms_per_iteration` of `name` less the spans of `inner` that lie
    within one of its spans."""
    spans = run.get("program_spans") or ()
    outer = [s for s in spans if s["name"] == name]
    if not outer or not run.get("ticks"):
        return None
    nested = sum(s["dur_s"] for s in spans if s["name"] == inner and any(
        o["t_s"] <= s["t_s"] and s["t_s"] + s["dur_s"] <= o["t_s"] + o["dur_s"]
        for o in outer))
    return (sum(s["dur_s"] for s in outer) - nested) / run["ticks"] * 1e3
