"""A small metrics registry with Prometheus text exposition.

Zero-dependency equivalent of the prometheus instrumentation the reference
wires through its server and client:

- request-duration histograms and error counters per RPC method
  (reference go/server/doorman/server.go:92-121 and
  go/client/doorman/client.go:87-99);
- a custom collector exporting per-resource has/wants/count gauges,
  gathered at scrape time from live server state
  (reference go/server/doorman/server.go:501-517,558-573).

Metric values are collected under a mutex so the asyncio event loop and the
debug HTTP thread can both touch the registry.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "default_registry",
    "instrument_server",
    "instrument_client",
]

LabelValues = Tuple[str, ...]


def call_on_loop(loop, fn, timeout: float = 5.0):
    """Run fn on an asyncio loop from another thread (atomic w.r.t. the
    loop's coroutines) when the loop is running; else call directly."""
    if loop is not None and loop.is_running():
        import asyncio

        async def grab():
            return fn()

        return asyncio.run_coroutine_threadsafe(grab(), loop).result(timeout)
    return fn()

DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _format_labels(names: Sequence[str], values: LabelValues) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


def _escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _format_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Metric:
    """Base class: a named family of (labels -> value) series."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str = "",
                 labels: Sequence[str] = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(labels)
        self._lock = threading.Lock()

    def expose(self) -> Iterable[str]:  # pragma: no cover - abstract
        raise NotImplementedError


class Counter(Metric):
    kind = "counter"

    def __init__(self, name: str, help_text: str = "",
                 labels: Sequence[str] = ()):
        super().__init__(name, help_text, labels)
        self._values: Dict[LabelValues, float] = {}

    def inc(self, *label_values: str, by: float = 1.0) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def value(self, *label_values: str) -> float:
        return self._values.get(tuple(str(v) for v in label_values), 0.0)

    def expose(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._values.items())
        for labels, v in items:
            yield (
                f"{self.name}"
                f"{_format_labels(self.label_names, labels)}"
                f" {_format_value(v)}"
            )


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name: str, help_text: str = "",
                 labels: Sequence[str] = ()):
        super().__init__(name, help_text, labels)
        self._values: Dict[LabelValues, float] = {}

    def set(self, value: float, *label_values: str) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = float(value)

    def value(self, *label_values: str) -> float:
        return self._values.get(tuple(str(v) for v in label_values), 0.0)

    def expose(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._values.items())
        for labels, v in items:
            yield (
                f"{self.name}"
                f"{_format_labels(self.label_names, labels)}"
                f" {_format_value(v)}"
            )


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str = "",
                 labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_text, labels)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[LabelValues, List[int]] = {}
        self._sums: Dict[LabelValues, float] = {}
        self._totals: Dict[LabelValues, int] = {}

    def observe(self, value: float, *label_values: str) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, *label_values: str) -> int:
        return self._totals.get(tuple(str(v) for v in label_values), 0)

    def sum(self, *label_values: str) -> float:
        return self._sums.get(tuple(str(v) for v in label_values), 0.0)

    def expose(self) -> Iterable[str]:
        with self._lock:
            keys = sorted(self._totals)
            counts = {k: list(self._counts[k]) for k in keys}
            sums = dict(self._sums)
            totals = dict(self._totals)
        bucket_names = self.label_names + ("le",)
        for key in keys:
            for i, bound in enumerate(self.buckets):
                labels = key + (_format_value(bound),)
                yield (
                    f"{self.name}_bucket"
                    f"{_format_labels(bucket_names, labels)}"
                    f" {counts[key][i]}"
                )
            yield (
                f"{self.name}_bucket"
                f"{_format_labels(bucket_names, key + ('+Inf',))}"
                f" {totals[key]}"
            )
            yield (
                f"{self.name}_sum{_format_labels(self.label_names, key)}"
                f" {_format_value(sums[key])}"
            )
            yield (
                f"{self.name}_count{_format_labels(self.label_names, key)}"
                f" {totals[key]}"
            )


class Registry:
    """Holds metric families plus scrape-time collector callbacks."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}
        self._collectors: List[Callable[[], Iterable[Metric]]] = []

    def register(self, metric: Metric) -> Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help_text: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self.register(Counter(name, help_text, labels))  # type: ignore

    def gauge(self, name: str, help_text: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self.register(Gauge(name, help_text, labels))  # type: ignore

    def histogram(self, name: str, help_text: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self.register(  # type: ignore
            Histogram(name, help_text, labels, buckets)
        )

    def metrics(self) -> List[Metric]:
        """The registered metric families (live objects). Lets one
        registry re-export another's families at scrape time:
        `reg.add_collector(other.metrics)` — cmd/server chains the
        process-global default registry (tick-phase histograms, chaos
        counters) into its per-serve registry this way."""
        with self._lock:
            return list(self._metrics.values())

    def add_collector(
        self, collector: Callable[[], Iterable[Metric]]
    ) -> Callable[[], None]:
        """Register a callback producing metrics at scrape time (the
        equivalent of a custom prometheus.Collector,
        reference server.go:501-517). Returns an unregister callable."""
        with self._lock:
            self._collectors.append(collector)

        def unregister() -> None:
            with self._lock:
                try:
                    self._collectors.remove(collector)
                except ValueError:
                    pass

        return unregister

    def expose(self) -> str:
        """Render the whole registry in Prometheus text format."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        for collector in collectors:
            try:
                metrics.extend(collector())
            except Exception:  # a broken collector must not kill /metrics
                continue
        lines: List[str] = []
        for m in sorted(metrics, key=lambda m: m.name):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


_default_registry = Registry()


def default_registry() -> Registry:
    return _default_registry


def instrument_server(server, registry: Optional[Registry] = None) -> Registry:
    """Wire a CapacityServer's request hook and a per-resource collector
    into a registry (reference server.go:92-121,501-517,737-745)."""
    registry = registry or default_registry()
    durations = registry.histogram(
        "doorman_server_requests_durations",
        "Duration of different requests in seconds.",
        labels=("method",),
    )
    errors = registry.counter(
        "doorman_server_requests_error_count",
        "Number of requests that returned an error.",
        labels=("method",),
    )
    requests = registry.counter(
        "doorman_server_requests_count",
        "Number of requests received.",
        labels=("method",),
    )

    def on_request(method: str, duration: float, error: bool) -> None:
        requests.inc(method)
        durations.observe(duration, method)
        if error:
            errors.inc(method)

    server.on_request = on_request

    def collect() -> Iterable[Metric]:
        # Snapshot live server state on its asyncio loop when one is
        # running (atomic w.r.t. RPC handlers), mirroring the debug pages.
        try:
            return call_on_loop(
                getattr(server, "_loop", None),
                lambda: _collect_now(server),
            )
        except Exception:
            return []

    registry.add_collector(collect)
    return registry


def _collect_now(server) -> List[Metric]:
    is_master = Gauge(
        "doorman_server_is_master",
        "1 if this server is currently the master.",
    )
    is_master.set(1.0 if server.is_master else 0.0)
    has = Gauge(
        "doorman_server_resource_has",
        "Capacity currently leased out per resource.",
        labels=("resource",),
    )
    wants = Gauge(
        "doorman_server_resource_wants",
        "Capacity currently wanted per resource.",
        labels=("resource",),
    )
    count = Gauge(
        "doorman_server_resource_clients",
        "Number of clients holding a lease per resource.",
        labels=("resource",),
    )
    subclients = Gauge(
        "doorman_server_resource_subclients",
        "Number of subclients per resource.",
        labels=("resource",),
    )
    for rid, res in list(server.resources.items()):
        store = res.store
        has.set(store.sum_has, rid)
        wants.set(store.sum_wants, rid)
        count.set(len(store), rid)
        subclients.set(store.count, rid)
    return [is_master, has, wants, count, subclients]


def instrument_client(client, registry: Optional[Registry] = None) -> Registry:
    """Wire a doorman client's request hook into a registry
    (reference client.go:87-99,493-500)."""
    registry = registry or default_registry()
    durations = registry.histogram(
        "doorman_client_requests_durations",
        "Duration of client capacity requests in seconds.",
        labels=("method",),
    )
    errors = registry.counter(
        "doorman_client_requests_error_count",
        "Number of client requests that returned an error.",
        labels=("method",),
    )

    def on_request(method: str, duration: float, error: bool) -> None:
        durations.observe(duration, method)
        if error:
            errors.inc(method)

    client.on_request = on_request
    return registry
