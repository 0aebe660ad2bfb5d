"""Observability: metrics registry (Prometheus text exposition), the
debug HTTP server with /debug/status, /debug/resources, /debug/traces,
/debug/slo, /debug/flightrec, /debug/history and /metrics, the
zero-dependency span tracer (obs.trace) with Chrome trace-event export,
the declarative SLO engine (obs.slo), the per-tick flight recorder
(obs.flightrec), its durable multi-resolution history (obs.history),
the shadow-oracle auditor (obs.audit) and the online anomaly detector
(obs.detect).

Capability parity with the reference's go/status/status.go (composable
status parts), go/cmd/doorman/resourcez.go (per-lease table), and the
Prometheus instrumentation in go/server/doorman/server.go:92-121,501-517.
"""

from doorman_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
    instrument_server,
)
from doorman_tpu_torch.obs.audit import ShadowAuditor
from doorman_tpu_torch.obs.debug import DebugServer, add_status_part
from doorman_tpu_torch.obs.detect import AnomalyDetector
from doorman_tpu_torch.obs.flightrec import FlightRecorder, store_digest
from doorman_tpu_torch.obs.history import HistoryStore
from doorman_tpu_torch.obs.slo import (
    SloEngine,
    SloInputs,
    SloSpec,
    TrajectoryComparator,
    audit_divergence_spec,
    detector_anomaly_spec,
    server_slos,
)
from doorman_tpu_torch.obs.trace import Tracer, default_tracer

__all__ = [
    "AnomalyDetector",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "HistoryStore",
    "Registry",
    "ShadowAuditor",
    "SloEngine",
    "SloInputs",
    "SloSpec",
    "Tracer",
    "TrajectoryComparator",
    "audit_divergence_spec",
    "default_registry",
    "default_tracer",
    "detector_anomaly_spec",
    "instrument_server",
    "server_slos",
    "store_digest",
    "DebugServer",
    "add_status_part",
]
