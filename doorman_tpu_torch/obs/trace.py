"""Zero-dependency span tracer with Chrome trace-event export.

One process-global tracer records SPANS (named, timed, nested) from every
layer of a tick — the client refresh loop, the server RPC handlers, the
tick pipeline, and the solver phases — into a fixed-size ring buffer, and
exports them in the Chrome trace-event JSON format that Perfetto
(https://ui.perfetto.dev) and chrome://tracing load directly.

Design constraints, in order:

  * disabled means FREE: the tracer ships enabled on nobody. `span()` on
    a disabled tracer returns one shared no-op context manager — no
    allocation, no clock read — so instrumentation can stay inline in
    hot paths (RPC handlers, per-tick solver phases).
  * enabled means CHEAP: one perf_counter read on enter, one on exit,
    one deque append (the ring drops oldest on overflow). Budget is
    single-digit microseconds per span; tests/test_trace.py pins it
    loosely.
  * context propagates where the work goes: a contextvars.ContextVar
    carries the current (trace_id, span_id) through asyncio awaits, and
    `grpc_metadata()` / `parent_from_grpc_context()` carry it across the
    GetCapacity / GetServerCapacity gRPC hop (metadata key
    `doorman-trace`), so a client's refresh span is the parent of the
    server's handler span even across processes. Executor-thread work
    inherits it via contextvars.copy_context (the server's tick loop
    does this), so solver phase spans nest under the tick span.
  * one time axis: all timestamps are microseconds of time.perf_counter
    relative to one process epoch — monotonic and comparable across
    threads, which wall clocks are not. (Cross-process traces align by
    span parentage, not by ts.) A torch.profiler capture
    (start_torch_capture) carries the spans it overlaps into its own
    trace file, moved onto the profiler's axis by an anchor annotation.

Unclosed spans are tracked: `open_spans()` returns whatever entered but
never exited, and the tier-1 tests assert every instrumented path leaves
it empty — a leaked span means a code path skipped its __exit__.
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

__all__ = [
    "KNOWN_INSTANT_NAMES",
    "KNOWN_SPAN_NAMES",
    "PORT_SPAN_NAMES",
    "TRACE_METADATA_KEY",
    "Span",
    "SpanContext",
    "TorchCapture",
    "Tracer",
    "default_tracer",
    "grpc_metadata",
    "now_us",
    "parent_from_grpc_context",
    "parent_from_metadata",
    "perf_to_us",
    "start_torch_capture",
    "stop_torch_capture",
    "torch_capture",
]

# gRPC metadata key carrying "trace_id.span_id" (lowercase hex) on the
# client -> server and intermediate -> parent hops. Keys must be
# lowercase ASCII for gRPC.
TRACE_METADATA_KEY = "doorman-trace"

# The span/instant vocabularies. Trace consumers join on these names —
# Perfetto overlays, /debug/traces summaries, test assertions, and the
# route tables in doc/observability.md — so an unregistered name records
# into a stream nobody reads. doormanlint (trace-phase-hygiene) checks
# every `.span(...)`/`.instant(...)` literal against these sets; a
# `prefix.*` entry admits computed suffixes (f"server.{method}").
# Phase-lap names live next to the stage skeleton instead
# (solver/engine.py PHASES).
KNOWN_SPAN_NAMES = frozenset({
    "server.tick",
    "server.parent_refresh",
    "server.*",  # per-RPC handler spans: server.GetCapacity, ...
    "client.refresh",
    "client.GetCapacity",
    "client.WatchCapacity",  # stream establishment + read loop
    "admission.window",
    "persist.snapshot",
    "persist.restore",
    "stream.fanout",  # tick-edge lease push (server/streams.py)
    "stream.shard",  # one shard's slice of the fanout (StreamShard)
    # Federated capacity tree (doorman_tpu/federation): the straddle
    # reconciliation beat and the intermediate's device aggregation
    # tick; federation.* admits computed suffixes.
    "federation.reconcile",
    "federation.aggregate",
    "federation.*",
    # Workload harness (doorman_tpu/workload): one span per scenario
    # run, wrapping the whole stepped drive.
    "workload.scenario",
    # Serving-plane listener workers (doorman_tpu/frontend/worker.py):
    # one pump lap (ring drain + deadline wheel) and one held
    # WatchCapacity stream's serve loop.
    "frontend.pump",
    "frontend.stream",
    # Fleet runtime (doorman_tpu/fleet): one reconcile beat — the
    # controller's pull sweep, or one shard report folding into the
    # head's BeatCore on the wire deployment.
    "fleet.beat",
})
KNOWN_INSTANT_NAMES = frozenset({
    "election.transition",
    "shard.*",  # per-direction mesh transfer instants: shard.upload, ...
    "federation.*",  # e.g. federation.partition from the chaos seam
    # Workload event-log entries mirrored onto the trace timeline:
    # workload.crowd_start, workload.deploy, workload.elastic_preempt,
    # ... (harness.note stamps workload.<kind>).
    "workload.*",
    # Continuous telemetry (obs/audit.py, obs/detect.py): a confirmed
    # shadow-oracle divergence and an online anomaly detection, both
    # stamped by the server's tick loop off the hot path.
    "audit.divergence",
    "detect.anomaly",
    # A frontend worker declaring a held stream stalled (its ring
    # frame overdue past the stall margin) before resetting it.
    "frontend.stall",
    # Fleet runtime: a published routing epoch (live reshard) and one
    # shard-side beat report installing its returned shares.
    "fleet.epoch",
    "fleet.report",
})
# Spans only this port records. Kept apart from KNOWN_SPAN_NAMES, which
# stays equal to the reference package's (tests/test_torch_obs_parity.py
# holds the two vocabularies equal), and named in full rather than
# admitted by `server.*`, which stands for the RPC handler spans.
PORT_SPAN_NAMES = frozenset({
    # Children of server.tick after the solve: the shadow audit's
    # sampling, the per-tick flight record and, inside it, the digest
    # of every store's aggregates; the digest's args resources (rows
    # digested) and bulk (read in one native call).
    "server.audit",
    "server.flight_record",
    "server.store_digest",
    # An intermediate's parent exchange (_perform_parent_requests; arg
    # outcome) and, besides the RPC's server.parent_refresh, its parts:
    # the upstream request's aggregation (args resources, bands) and the
    # install of the grants as templates (arg templates).
    "server.parent_exchange",
    "server.band_aggregate",
    "server.parent_install",
    # The native store taking one batch of client refreshes
    # (StoreEngine.bulk_refresh); args n (asked) and done (refreshed).
    "store.bulk_refresh",
    # One full (generation 2) collection of Python's garbage collector;
    # the process tracer records it while enabled (Tracer.gc_spans).
    "python.gc",
})

# The process time axis: perf_counter at import. Chrome trace `ts` must
# be monotonic; wall clocks step and skew.
_EPOCH = time.perf_counter()


def now_us() -> float:
    """Microseconds on the tracer's monotonic axis."""
    return (time.perf_counter() - _EPOCH) * 1e6


def perf_to_us(perf_counter_value: float) -> float:
    """Map a raw time.perf_counter() reading onto the tracer's axis."""
    return (perf_counter_value - _EPOCH) * 1e6


class SpanContext(NamedTuple):
    trace_id: int
    span_id: int


# The current span, propagated through awaits within a task and into
# copied contexts (contextvars.copy_context for executor threads).
_current: contextvars.ContextVar = contextvars.ContextVar(
    "doorman_trace_span", default=None
)


def current_context() -> Optional[SpanContext]:
    return _current.get()


class Span:
    """One recorded event. ph 'X' = complete span (ts+dur), 'i' = instant."""

    __slots__ = (
        "name", "cat", "ph", "trace_id", "span_id", "parent_id",
        "ts", "dur", "tid", "args",
    )

    def __init__(self, name, cat, ph, trace_id, span_id, parent_id,
                 ts, dur, tid, args):
        self.name = name
        self.cat = cat
        self.ph = ph
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.args = args

    def as_chrome(self, pid: int) -> dict:
        args = dict(self.args) if self.args else {}
        args["trace_id"] = f"{self.trace_id:x}"
        args["span_id"] = f"{self.span_id:x}"
        if self.parent_id:
            args["parent_span_id"] = f"{self.parent_id:x}"
        ev = {
            "name": self.name,
            "cat": self.cat or "default",
            "ph": self.ph,
            "ts": round(self.ts, 3),
            "pid": pid,
            "tid": self.tid,
            "args": args,
        }
        if self.ph == "X":
            ev["dur"] = round(self.dur or 0.0, 3)
        else:
            ev["s"] = "p"  # instant scope: process
        return ev


class _NoopSpan:
    """Shared no-op context manager for the disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()
# Public alias: instrumentation that builds span args lazily can return
# this directly on the disabled path instead of paying for the args.
NOOP_SPAN = _NOOP


class _ActiveSpan:
    """Context manager for one live span (enabled tracer only)."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_parent",
                 "_rec", "_token")

    def __init__(self, tracer, name, cat, args, parent):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._parent = parent
        self._rec = None
        self._token = None

    def __enter__(self):
        tr = self._tracer
        parent = self._parent if self._parent is not None else _current.get()
        span_id = next(tr._ids)
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = span_id, 0
        rec = Span(
            self._name, self._cat, "X", trace_id, span_id, parent_id,
            now_us(), None, tr._tid(), self._args,
        )
        self._rec = rec
        with tr._open_lock:
            tr._open[span_id] = rec
        self._token = _current.set(SpanContext(trace_id, span_id))
        return rec

    def __exit__(self, exc_type, exc, tb):
        rec = self._rec
        rec.dur = now_us() - rec.ts
        if exc_type is not None:
            args = dict(rec.args) if rec.args else {}
            args["error"] = exc_type.__name__
            rec.args = args
        tr = self._tracer
        with tr._open_lock:
            tr._open.pop(rec.span_id, None)
        tr._events.append(rec)
        _current.reset(self._token)
        return False


class Tracer:
    """A ring buffer of spans plus the enable switch.

    Thread-safe: the ring is a deque (atomic appends), open-span
    tracking takes a small lock, ids come from itertools.count (atomic
    in CPython). Append paths never block each other for long.

    `gc_spans` (the process tracer's setting): while enabled, a hook in
    `gc.callbacks` records each full collection of Python's garbage
    collector as a `python.gc` span parented to the current span, and
    counts each young one (generations 0 and 1, hundreds a second) with
    its time on the enclosing open span (args `gc_young`,
    `gc_young_us`) rather than as spans of their own. Collections are
    process-wide, so one tracer records them.
    """

    def __init__(self, capacity: int = 65536, gc_spans: bool = False):
        self.enabled = False
        self.capacity = capacity
        self.gc_spans = gc_spans
        self._events: deque = deque(maxlen=capacity)
        self._open: Dict[int, Span] = {}
        # Re-entrant: a collection can start while a thread holds it,
        # and the GC hook runs in that thread.
        self._open_lock = threading.RLock()
        self._ids = itertools.count(1)
        self._tids: Dict[int, int] = {}
        self._tnames: Dict[int, str] = {}
        self._gc_start: Optional[float] = None
        # Bound once, so that disable() removes the object enable() added.
        self._gc_hook = self._on_gc

    # -- lifecycle -----------------------------------------------------

    def enable(self, capacity: Optional[int] = None) -> "Tracer":
        if capacity is not None and capacity != self.capacity:
            self.capacity = capacity
            self._events = deque(self._events, maxlen=capacity)
        if self.gc_spans and self._gc_hook not in gc.callbacks:
            gc.callbacks.append(self._gc_hook)
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False
        if self._gc_hook in gc.callbacks:
            gc.callbacks.remove(self._gc_hook)
        self._gc_start = None

    def clear(self) -> None:
        self._events.clear()
        with self._open_lock:
            self._open.clear()

    # -- recording -----------------------------------------------------

    def span(self, name: str, cat: str = "", args: Optional[dict] = None,
             parent: Optional[SpanContext] = None):
        """Context manager timing a block. No-op (and no allocation)
        while disabled. `parent` overrides the ambient context — pass
        the remote parent extracted from gRPC metadata on the server
        side of a hop."""
        if not self.enabled:
            return _NOOP
        return _ActiveSpan(self, name, cat, args, parent)

    def instant(self, name: str, cat: str = "",
                args: Optional[dict] = None) -> None:
        """A zero-duration marker (election flips, fault injections)."""
        if not self.enabled:
            return
        parent = _current.get()
        span_id = next(self._ids)
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = span_id, 0
        self._events.append(Span(
            name, cat, "i", trace_id, span_id, parent_id,
            now_us(), None, self._tid(), args,
        ))

    def add_complete(self, name: str, ts_us: float, dur_us: float,
                     cat: str = "", args: Optional[dict] = None,
                     parent: Optional[SpanContext] = None) -> None:
        """Record an already-measured interval (solver phase laps time
        themselves with perf_counter and report here afterwards)."""
        if not self.enabled:
            return
        ctx = parent if parent is not None else _current.get()
        span_id = next(self._ids)
        if ctx is not None:
            trace_id, parent_id = ctx.trace_id, ctx.span_id
        else:
            trace_id, parent_id = span_id, 0
        self._events.append(Span(
            name, cat, "X", trace_id, span_id, parent_id,
            ts_us, dur_us, self._tid(), args,
        ))

    def _on_gc(self, phase: str, info: dict) -> None:
        """The gc.callbacks hook (see the class docstring). Collections
        never overlap, so one start stamp serves every thread."""
        if phase == "start":
            self._gc_start = now_us()
            return
        t0, self._gc_start = self._gc_start, None
        if t0 is None or not self.enabled:
            return
        dur = now_us() - t0
        generation = info["generation"]
        if generation >= 2:
            self.add_complete(
                "python.gc", t0, dur, cat="gc",
                args={"generation": generation,
                      "collected": info["collected"]},
            )
            return
        ctx = _current.get()
        rec = self._open.get(ctx.span_id) if ctx is not None else None
        if rec is not None:
            args = dict(rec.args) if rec.args else {}
            args["gc_young"] = args.get("gc_young", 0) + 1
            args["gc_young_us"] = args.get("gc_young_us", 0.0) + dur
            rec.args = args

    # -- inspection / export -------------------------------------------

    def snapshot(self) -> List[Span]:
        return list(self._events)

    def open_spans(self) -> List[Span]:
        """Spans entered but never exited — an instrumented path that
        leaks one has a bug (tier-1 asserts this list stays empty)."""
        with self._open_lock:
            return list(self._open.values())

    def chrome_trace(self, extra_events: Iterable[dict] = ()) -> dict:
        """The whole ring as a Chrome trace-event JSON object (load in
        Perfetto or chrome://tracing). `extra_events` are pre-built
        trace-event dicts merged onto the same timeline."""
        pid = os.getpid()
        meta: List[dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"doorman:{pid}"},
        }]
        for ident, tid in list(self._tids.items()):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": self._tnames.get(tid, f"thread-{tid}")},
            })
        # A copy: a collection during the export appends to the ring.
        events = [rec.as_chrome(pid) for rec in self.snapshot()]
        events.extend(extra_events)
        events.sort(key=lambda e: e.get("ts", 0.0))
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def chrome_json(self, extra_events: Iterable[dict] = ()) -> str:
        return json.dumps(self.chrome_trace(extra_events))

    # -- internals -----------------------------------------------------

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._open_lock:
                tid = self._tids.setdefault(ident, len(self._tids))
                self._tnames.setdefault(
                    tid, threading.current_thread().name
                )
        return tid


_default = Tracer(gc_spans=True)


def default_tracer() -> Tracer:
    return _default


# ----------------------------------------------------------------------
# gRPC hop propagation
# ----------------------------------------------------------------------


def grpc_metadata() -> Tuple:
    """Metadata tuple carrying the current span context (empty when the
    tracer is disabled or no span is active) — pass as `metadata=` on
    the stub call."""
    if not _default.enabled:
        return ()
    ctx = _current.get()
    if ctx is None:
        return ()
    return ((TRACE_METADATA_KEY, f"{ctx.trace_id:x}.{ctx.span_id:x}"),)


def parent_from_metadata(md) -> Optional[SpanContext]:
    """Parse a SpanContext out of invocation metadata (a sequence of
    (key, value) pairs or objects with .key/.value)."""
    if not md:
        return None
    for item in md:
        key = getattr(item, "key", None)
        if key is None:
            key, value = item[0], item[1]
        else:
            value = item.value
        if key != TRACE_METADATA_KEY:
            continue
        try:
            t, s = str(value).split(".", 1)
            return SpanContext(int(t, 16), int(s, 16))
        except (ValueError, TypeError):
            return None
    return None


def parent_from_grpc_context(context) -> Optional[SpanContext]:
    """Extract the remote parent from a servicer context; tolerates
    context=None (tests drive handlers directly) and non-gRPC contexts."""
    if context is None:
        return None
    getter = getattr(context, "invocation_metadata", None)
    if getter is None:
        return None
    try:
        return parent_from_metadata(getter())
    except Exception:
        return None


# ----------------------------------------------------------------------
# Device-side timeline (opt-in)
# ----------------------------------------------------------------------

_capture_seq = itertools.count()

# The annotation whose `ts` in the exported trace places the tracer's
# spans on the profiler's time axis (time.perf_counter is read inside
# it), whatever clock the installed torch's profiler keeps.
CAPTURE_ANCHOR = "doorman.capture_anchor"


class TorchCapture:
    """A torch.profiler session from start_torch_capture: the profiler
    and the perf_counter reading taken inside its anchor annotation."""

    __slots__ = ("prof", "anchor")

    def __init__(self, prof, anchor: float):
        self.prof = prof
        self.anchor = anchor


def start_torch_capture(out_dir: Optional[str]) -> Optional[TorchCapture]:
    """Start a torch.profiler session (CPU ops, plus the CUDA kernels and
    copies when the card is present) whose trace goes to `out_dir`;
    returns the session, or None for a falsy out_dir. CUDA activity is
    recorded through CUPTI for the whole process, so kernels launched
    from executor threads (the tick's) land in the trace too. Raises
    what the profiler raises; callers that must not fail catch it."""
    if not out_dir:
        return None
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    # A session's first annotation takes about a millisecond to open;
    # behind a throwaway one the anchor's ts lies within microseconds
    # of the clock read inside it.
    with torch.profiler.record_function("doorman.capture_warmup"):
        pass
    with torch.profiler.record_function(CAPTURE_ANCHOR):
        anchor = time.perf_counter()
    return TorchCapture(prof, anchor)


def stop_torch_capture(capture: TorchCapture, out_dir: str) -> str:
    """Stop a session from start_torch_capture and write its Chrome trace
    (trace-<pid>-<n>.json, loadable in Perfetto) under `out_dir`;
    returns the file's path. The card is synchronized first, so every
    kernel launched before the call is in the trace. The process
    tracer's spans and instants that overlap the session are written
    into the same file, on the profiler's time axis, so each idle gap
    of the card lies under the program span that held the host."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    capture.prof.stop()
    stop_us = now_us()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"trace-{os.getpid()}-{next(_capture_seq)}.json"
    )
    capture.prof.export_chrome_trace(path)
    _merge_spans(path, perf_to_us(capture.anchor), stop_us)
    return path


def _merge_spans(path: str, anchor_us: float, stop_us: float) -> None:
    """Add the process tracer's events between the anchor and `stop_us`
    (with its process and thread names) to the Chrome trace at `path`,
    shifted by the anchor annotation's offset; a trace without the
    anchor is left as written."""
    ours = [
        ev for ev in _default.chrome_trace()["traceEvents"]
        if ev["ph"] == "M"
        or ev["ts"] <= stop_us and ev["ts"] + ev.get("dur", 0.0) >= anchor_us
    ]
    if all(ev["ph"] == "M" for ev in ours):
        return
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", [])
    mark = next(
        (e for e in events
         if e.get("name") == CAPTURE_ANCHOR and e.get("ph") == "X"),
        None,
    )
    if mark is None:
        return
    offset = float(mark["ts"]) - anchor_us
    for ev in ours:
        if ev["ph"] != "M":
            ev["ts"] = round(ev["ts"] + offset, 3)
    doc["traceEvents"] = events + ours
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def torch_capture(out_dir: Optional[str]):
    """Opt-in torch.profiler capture around a measured solve: wraps the
    block in a profiler session whose Chrome trace is written to
    `out_dir` (viewable with Perfetto or chrome://tracing). A falsy
    out_dir is a no-op; capture trouble (another session active, no
    profiler) degrades to a no-op rather than failing the measured
    work."""
    prof = None
    try:
        prof = start_torch_capture(out_dir)
    except Exception:
        pass
    try:
        yield
    finally:
        if prof is not None:
            try:
                stop_torch_capture(prof, out_dir)
            except Exception:
                pass
