"""The port's tick tracing (doorman_tpu_torch.obs.trace), the cases of
tests/test_trace.py against the port: span nesting, trace-context
propagation over loopback gRPC (the client's refresh span must be an
ancestor of the server's handler span), Chrome trace-event export
schema, per-phase histogram exposition, unclosed-span detection, the
/debug/traces + /debug index routes, and the tracer's overhead budget
(disabled = no-op; enabled = microseconds). The torch.profiler capture
(`torch_capture`, the server's `profile_dir`) writes a Chrome trace of
the CPU ops here; its CUDA half is checked on the card by chip_smoke.py.
Parity: the same span sequence gives the same Chrome-trace events in
both packages, apart from timestamps and ids. The port's own spans
(PORT_SPAN_NAMES): the tick span over the whole tick with the flight
record and the store digest beneath it, the native store's bulk
refresh, Python's collections on the process tracer, and the capture
that writes the tracer's spans into its Chrome trace on the profiler's
time axis.
"""

import asyncio
import json
import time
import urllib.request

import pytest

import tests.conftest  # noqa: F401

from doorman_tpu_torch.client import Client
from doorman_tpu_torch.obs import DebugServer, default_registry
from doorman_tpu_torch.obs import trace as trace_mod
from doorman_tpu_torch.server.config import parse_yaml_config
from doorman_tpu_torch.server.election import TrivialElection
from doorman_tpu_torch.server.server import CapacityServer

CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 100
  safe_capacity: 5
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
"""


@pytest.fixture
def tracer():
    """The process-global tracer, enabled for the test and restored
    after (other tests must see it disabled and empty)."""
    tr = trace_mod.default_tracer()
    tr.clear()
    tr.enable()
    yield tr
    tr.disable()
    tr.clear()


def fetch(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=5
    ) as resp:
        return resp.status, resp.read().decode()


# ----------------------------------------------------------------------
# Tracer core
# ----------------------------------------------------------------------


def test_span_nesting_and_instants(tracer):
    with tracer.span("outer", cat="t") as outer:
        tracer.instant("marker", cat="t")
        with tracer.span("inner", cat="t") as inner:
            pass
    events = {e.name: e for e in tracer.snapshot()}
    assert events["inner"].parent_id == outer.span_id
    assert events["inner"].trace_id == outer.trace_id
    assert events["marker"].parent_id == outer.span_id
    assert events["outer"].parent_id == 0
    assert events["outer"].dur >= events["inner"].dur >= 0.0


def test_disabled_tracer_records_nothing():
    tr = trace_mod.Tracer()
    assert not tr.enabled
    # One shared no-op context manager: no allocation per call.
    assert tr.span("a") is tr.span("b")
    with tr.span("a"):
        tr.instant("i")
        tr.add_complete("c", 0.0, 1.0)
    assert tr.snapshot() == []
    assert tr.open_spans() == []
    # Disabled tracer + no ambient span -> no metadata on the wire.
    assert trace_mod.grpc_metadata() == ()


def test_error_marks_span(tracer):
    with pytest.raises(ValueError):
        with tracer.span("boom"):
            raise ValueError("x")
    (ev,) = tracer.snapshot()
    assert ev.args["error"] == "ValueError"
    assert tracer.open_spans() == []


def test_unclosed_span_detection(tracer):
    cm = tracer.span("leaky")
    cm.__enter__()
    assert [s.name for s in tracer.open_spans()] == ["leaky"]
    cm.__exit__(None, None, None)
    assert tracer.open_spans() == []


def test_metadata_round_trip(tracer):
    with tracer.span("root"):
        md = trace_mod.grpc_metadata()
        assert md and md[0][0] == trace_mod.TRACE_METADATA_KEY
        ctx = trace_mod.parent_from_metadata(md)
        cur = trace_mod.current_context()
        assert ctx == cur
    # Garbage values parse to None, never raise.
    assert trace_mod.parent_from_metadata(
        ((trace_mod.TRACE_METADATA_KEY, "not-hex"),)
    ) is None
    assert trace_mod.parent_from_metadata(()) is None
    assert trace_mod.parent_from_grpc_context(None) is None


def test_ring_buffer_drops_oldest():
    tr = trace_mod.Tracer(capacity=4).enable()
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    names = [e.name for e in tr.snapshot()]
    assert names == ["s6", "s7", "s8", "s9"]


def test_torch_capture_noop_without_dir():
    with trace_mod.torch_capture(None):
        pass
    with trace_mod.torch_capture(""):
        pass


# ----------------------------------------------------------------------
# Chrome export schema
# ----------------------------------------------------------------------


def test_chrome_export_schema(tracer):
    with tracer.span("a", cat="x"):
        with tracer.span("b", cat="x"):
            pass
    tracer.instant("mark", cat="x")
    doc = tracer.chrome_trace()
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    events = doc["traceEvents"]
    body = [e for e in events if e["ph"] not in ("M",)]
    assert body, "no span events exported"
    for ev in events:
        assert {"name", "ph", "pid", "tid"} <= set(ev)
    for ev in body:
        assert ev["ts"] >= 0.0
        if ev["ph"] == "X":
            assert ev["dur"] >= 0.0
            assert "span_id" in ev["args"]
    # ts is monotonic non-decreasing in export order.
    ts = [e.get("ts", 0.0) for e in events]
    assert ts == sorted(ts)
    # The whole document is valid JSON (what Perfetto loads).
    json.loads(tracer.chrome_json())


# ----------------------------------------------------------------------
# Overhead budget (tier-1 keeps instrumentation honest)
# ----------------------------------------------------------------------


@pytest.mark.perf
def test_trace_overhead_budget():
    tr = trace_mod.Tracer()

    def cost(n=1000):
        t0 = time.perf_counter()
        for _ in range(n):
            with tr.span("hot"):
                pass
        return (time.perf_counter() - t0) / n

    # Disabled: the shared no-op; generous 2 µs bound (it is one method
    # call and one `with`).
    disabled = min(cost() for _ in range(3))
    assert disabled < 2e-6, f"disabled span costs {disabled * 1e6:.2f} µs"

    tr.enable()
    # Enabled: ring-buffer append budget is ~10 µs; asserted loosely
    # (5x) so a noisy CI box cannot flake it while a 100 µs regression
    # still fails.
    enabled = min(cost() for _ in range(3))
    assert enabled < 50e-6, f"enabled span costs {enabled * 1e6:.2f} µs"


# ----------------------------------------------------------------------
# Loopback gRPC propagation + phase histograms + debug routes
# ----------------------------------------------------------------------


def test_loopback_trace_propagation_and_debug_pages(tracer):
    """The acceptance-criterion run: a real client refreshing against a
    real batch server over loopback gRPC, tracing enabled. The export
    must contain client refresh -> server GetCapacity parented across
    the hop, solver ticks with upload/solve/download/apply children
    (native store -> device-resident tick path; the python-store batch
    path's pack/solve/apply is covered by the same assertions when the
    native engine is unavailable), /metrics must expose per-phase
    histograms with non-zero counts, and no instrumented path may leak
    an open span."""
    from doorman_tpu_torch import native

    native_store = native.native_available()
    component = "resident" if native_store else "batch"
    # The resident path runs the fused one-launch tick by default: the
    # device window is one "fused" phase span (round-trip mode would
    # emit upload/solve — see tests/test_fused_tick.py).
    phases = (
        ("fused", "download", "apply")
        if native_store
        else ("pack", "solve", "apply")
    )

    async def body():
        server = CapacityServer(
            "trace-server", TrivialElection(),
            minimum_refresh_interval=0.0, mode="batch",
            native_store=native_store, device="cpu",
        )
        port = await server.start(0, host="127.0.0.1")
        await server.load_config(parse_yaml_config(CONFIG))
        await asyncio.sleep(0)
        server.current_master = f"127.0.0.1:{port}"

        debug = DebugServer(host="127.0.0.1")
        debug.add_server(server, asyncio.get_running_loop())
        dport = debug.start()

        client = await Client.connect(
            f"127.0.0.1:{port}", "trace-client",
            minimum_refresh_interval=0.0,
        )
        res = await client.resource("r0", wants=40)
        cap = await asyncio.wait_for(res.capacity().get(), timeout=5)
        assert cap == 40.0
        # Two ticks: the resident path pipelines, so download/apply of
        # tick 1's grants land during tick 2's collect.
        await server.tick_once()
        await server.tick_once()

        loop = asyncio.get_running_loop()
        status, text = await loop.run_in_executor(
            None, fetch, dport, "/metrics"
        )
        status_traces, traces_page = await loop.run_in_executor(
            None, fetch, dport, "/debug/traces"
        )
        status_chrome, chrome = await loop.run_in_executor(
            None, fetch, dport, "/debug/traces?format=chrome"
        )
        status_index, index = await loop.run_in_executor(
            None, fetch, dport, "/debug"
        )

        await client.close()
        debug.stop()
        await server.stop()
        return (status, text, status_traces, traces_page,
                status_chrome, chrome, status_index, index)

    (status, text, status_traces, traces_page,
     status_chrome, chrome, status_index, index) = asyncio.run(body())

    # -- span parentage across the gRPC hop ---------------------------
    by_name = {}
    for ev in tracer.snapshot():
        by_name.setdefault(ev.name, []).append(ev)
    refresh = by_name["client.refresh"][0]
    rpc = by_name["client.GetCapacity"][0]
    handler = by_name["server.GetCapacity"][0]
    assert rpc.parent_id == refresh.span_id
    assert handler.parent_id == rpc.span_id
    assert handler.trace_id == refresh.trace_id

    # -- the solver tick spans have phase children --------------------
    tick_ids = {t.span_id for t in by_name["server.tick"]}
    for phase in phases:
        assert phase in by_name, phase
        ev = by_name[phase][0]
        assert ev.parent_id in tick_ids, phase
        assert ev.cat == f"phase:{component}"

    # -- no instrumented path leaks an open span ----------------------
    assert tracer.open_spans() == []

    # -- /metrics: per-phase histograms with non-zero counts ----------
    assert status == 200
    for phase in phases:
        line = next(
            ln for ln in text.splitlines()
            if ln.startswith(
                "doorman_tick_phase_seconds_count"
                f'{{component="{component}",phase="{phase}"}}'
            )
        )
        assert int(line.rsplit(" ", 1)[1]) > 0, line
    assert (
        f'doorman_tick_phase_last_seconds{{component="{component}"'
        in text
    )

    # -- /debug/traces + index + chrome download ----------------------
    assert status_traces == 200
    assert "tracer enabled" in traces_page
    assert "server.GetCapacity" in traces_page
    assert status_index == 200
    assert "/debug/traces" in index and "/metrics" in index
    assert status_chrome == 200
    doc = json.loads(chrome)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"client.refresh", "server.GetCapacity", "server.tick",
            "fused" if native_store else "solve"} <= names


def test_direct_handler_call_tolerates_no_context(tracer):
    """Tests and tooling drive handlers with context=None; the tracing
    wrapper must not assume gRPC invocation metadata exists."""
    from doorman_tpu_torch.proto import doorman_pb2 as pb

    async def body():
        server = CapacityServer(
            "nc-server", TrivialElection(), minimum_refresh_interval=0.0,
            device="cpu",
        )
        await server.load_config(parse_yaml_config(CONFIG))
        await asyncio.sleep(0)
        req = pb.GetCapacityRequest(client_id="c1")
        r = req.resource.add()
        r.resource_id = "r0"
        r.wants = 10.0
        out = await server.GetCapacity(req, None)
        assert out.response[0].gets.capacity == 10.0
        await server.stop()

    asyncio.run(body())
    assert [e.name for e in tracer.snapshot()
            if e.name == "server.GetCapacity"]
    assert tracer.open_spans() == []


def test_resident_phase_spans_and_histograms(tracer):
    """The device-resident tick path emits its phase laps (the fused
    device window by default, upload/solve in round-trip mode) as
    spans nested under the ambient tick span, and as per-phase
    histograms in the default registry. Both modes step so both
    vocabularies land."""
    from doorman_tpu_torch import native

    if not native.native_available():
        pytest.skip("native engine unavailable")
    import numpy as np

    from doorman_tpu_torch.core.resource import Resource
    from doorman_tpu_torch.proto import doorman_pb2 as pb
    from doorman_tpu_torch.solver.resident import ResidentDenseSolver

    engine = native.StoreEngine()
    tpl = pb.ResourceTemplate(
        identifier_glob="r0", capacity=100.0,
        algorithm=pb.Algorithm(
            kind=pb.Algorithm.PROPORTIONAL_SHARE,
            lease_length=60, refresh_interval=5,
        ),
    )
    res = Resource("r0", tpl, store_factory=engine.store)
    for c in range(4):
        res.store.assign(f"c{c}", 60.0, 5.0, 0.0, 10.0 * (c + 1), 1)
    solver = ResidentDenseSolver(
        engine, dtype=np.float64, rotate_ticks=1, device="cpu"
    )
    with tracer.span("server.tick", cat="tick") as tick:
        solver.step([res])  # fused (default): one "fused" device lap
    solver.fused_tick = False
    res.store.assign("c0", 60.0, 5.0, 0.0, 15.0, 1)
    with tracer.span("server.tick", cat="tick") as tick2:
        solver.step([res])  # round-trip: upload + solve laps
    by_name = {}
    for ev in tracer.snapshot():
        by_name.setdefault(ev.name, []).append(ev)
    for phase, parent in (
        ("sweep", tick), ("drain", tick), ("pack", tick),
        ("fused", tick), ("download", tick), ("apply", tick),
        ("rebuild", tick), ("upload", tick2), ("solve", tick2),
    ):
        assert phase in by_name, phase
        ev = by_name[phase][0]
        assert ev.parent_id == parent.span_id, phase
        assert ev.cat == "phase:resident"
    assert tracer.open_spans() == []
    text = default_registry().expose()
    for phase in ("fused", "upload"):
        assert (
            'doorman_tick_phase_seconds_count{component="resident",'
            f'phase="{phase}"}}' in text
        )


# ----------------------------------------------------------------------
# The tick's span tree: flight record, store digest, the store's ingest,
# Python's collector (the port's own spans, PORT_SPAN_NAMES)
# ----------------------------------------------------------------------


def _native_engine():
    from doorman_tpu_torch import native

    if not native.native_available():
        pytest.skip("native engine unavailable")
    return native


async def _native_server():
    """A batch server on the native store (CPU) with the flight recorder
    on (the default ring) and one lease, before its first tick."""
    from doorman_tpu_torch.algorithms import Request

    _native_engine()
    server = CapacityServer(
        "tree-server", TrivialElection(), mode="batch", native_store=True,
        tick_interval=3600.0, minimum_refresh_interval=0.0, device="cpu",
    )
    await server.load_config(parse_yaml_config(CONFIG))
    await asyncio.sleep(0)
    server._decide("r0", Request("c1", 0.0, 30.0, 1))
    assert server.flightrec is not None
    return server


def _one_tick():
    async def body():
        server = await _native_server()
        await server.tick_once()
        await server.stop()

    asyncio.run(body())


def _inside(child, parent):
    return (parent.ts <= child.ts
            and child.ts + child.dur <= parent.ts + parent.dur)


def test_tick_span_covers_flight_record_and_digest(tracer):
    _one_tick()
    spans = [e for e in tracer.snapshot() if e.ph == "X"]
    (tick,) = [e for e in spans if e.name == "server.tick"]
    (record,) = [e for e in spans if e.name == "server.flight_record"]
    (digest,) = [e for e in spans if e.name == "server.store_digest"]
    assert record.parent_id == tick.span_id and _inside(record, tick)
    assert digest.parent_id == record.span_id and _inside(digest, record)
    laps = [e for e in spans if e.cat.startswith("phase:")]
    assert {"sweep", "drain", "pack", "fused"} <= {e.name for e in laps}
    for lap in laps:
        assert lap.parent_id == tick.span_id, lap.name
    # No auditor on this server: no audit span.
    assert not [e for e in spans if e.name == "server.audit"]
    assert tracer.open_spans() == []


@pytest.mark.parametrize("native_store", [True, False])
def test_store_digest_span_names_its_rows_and_path(tracer, native_store):
    """The digest's args: every store of a native-store server is read
    in one call (bulk), a Python-store server's one store at a time."""
    from doorman_tpu_torch.algorithms import Request

    if native_store:
        _native_engine()

    async def body():
        server = CapacityServer(
            "digest-server", TrivialElection(), mode="batch",
            native_store=native_store, tick_interval=3600.0,
            minimum_refresh_interval=0.0, device="cpu",
        )
        await server.load_config(parse_yaml_config(CONFIG))
        await asyncio.sleep(0)
        for i in range(3):
            server._decide(f"r{i}", Request(f"c{i}", 0.0, 30.0, 1))
        await server.tick_once()
        await server.tick_once()
        n = len(server.resources)
        await server.stop()
        return n

    n = asyncio.run(body())
    digests = [e for e in tracer.snapshot()
               if e.ph == "X" and e.name == "server.store_digest"]
    assert n == 3 and len(digests) == 2
    for span in digests:
        assert span.args["resources"] == n
        assert span.args["bulk"] is native_store


def test_anomaly_instant_lands_in_the_flight_record(tracer):
    from doorman_tpu_torch.obs.detect import AnomalyDetector

    async def body():
        server = await _native_server()
        # A floor below any wall time fires on the first record.
        server.detector = AnomalyDetector(("wall_ms",),
                                          floors={"wall_ms": -1.0})
        await server.tick_once()
        await server.stop()

    asyncio.run(body())
    events = tracer.snapshot()
    (record,) = [e for e in events if e.name == "server.flight_record"]
    (mark,) = [e for e in events if e.name == "detect.anomaly"]
    assert mark.ph == "i" and mark.parent_id == record.span_id
    assert mark.args["field"] == "wall_ms"
    assert tracer.open_spans() == []


def test_fleet_beat_report_stamps_an_instant(tracer):
    from doorman_tpu_torch.fleet.rpc import ShardReporter
    from doorman_tpu_torch.proto import doorman_pb2 as pb

    class Head:
        """The head's GetServerCapacity: a share for every resource."""

        async def GetServerCapacity(self, request, timeout):
            resp = pb.GetServerCapacityResponse()
            for r in request.resource:
                out = resp.response.add(resource_id=r.resource_id)
                out.gets.capacity = 25.0
                out.gets.expiry_time = 2_000_000_000
            return resp

    async def body():
        server = await _native_server()
        reporter = ShardReporter(server, 1, "head:0", ("r0",))
        reporter._stub = Head()
        assert await reporter.step()
        await server.stop()

    asyncio.run(body())
    (mark,) = [e for e in tracer.snapshot() if e.name == "fleet.report"]
    assert mark.ph == "i" and mark.args == {"shard": 1, "resources": 1}


def test_bulk_refresh_span_counts_the_call(tracer):
    import numpy as np

    native = _native_engine()
    engine = native.StoreEngine()
    store = engine.store("r0")
    for c in range(3):
        store.assign(f"c{c}", 60.0, 5.0, 0.0, 10.0, 1)
    # Three leases and a client that holds none: four asked, three done.
    cids = np.array([engine.client_handle(f"c{c}") for c in range(4)])
    rids = np.full(4, store._rid, np.int32)
    done = engine.bulk_refresh(rids, cids, np.full(4, 90.0),
                               np.full(4, 5.0), np.arange(1.0, 5.0))
    (span,) = [e for e in tracer.snapshot() if e.name == "store.bulk_refresh"]
    assert span.args["n"] == 4
    assert span.args["done"] == done
    assert span.cat == "store" and span.dur >= 0.0
    assert tracer.open_spans() == []


def test_full_collection_is_a_span_under_the_current_one(tracer):
    import gc

    with tracer.span("outer", cat="t") as outer:
        gc.collect()
    (col,) = [e for e in tracer.snapshot() if e.name == "python.gc"]
    assert col.parent_id == outer.span_id
    assert col.args["generation"] == 2 and col.args["collected"] >= 0
    assert col.cat == "gc" and _inside(col, outer)
    assert tracer.open_spans() == []


def test_young_collections_count_on_the_enclosing_span(tracer):
    import gc

    with tracer.span("outer", cat="t") as outer:
        gc.collect(0)
        gc.collect(1)
    assert outer.args["gc_young"] >= 2
    assert outer.args["gc_young_us"] > 0.0
    assert not [e for e in tracer.snapshot() if e.name == "python.gc"]
    assert tracer.open_spans() == []


def test_enable_installs_one_gc_hook_and_disable_removes_it():
    import gc

    tr = trace_mod.default_tracer()
    assert tr.gc_spans and not tr.enabled
    before = list(gc.callbacks)
    tr.enable()
    tr.enable()
    try:
        added = [cb for cb in gc.callbacks if cb not in before]
        assert len(gc.callbacks) == len(before) + 1 and len(added) == 1
    finally:
        tr.disable()
        tr.clear()
    assert gc.callbacks == before
    # A tracer built without gc_spans never touches the hooks.
    other = trace_mod.Tracer().enable()
    assert gc.callbacks == before
    other.disable()


def test_disabled_tracer_records_no_tick_refresh_or_collection():
    import gc

    import numpy as np

    tr = trace_mod.default_tracer()
    assert not tr.enabled
    before = list(gc.callbacks)
    _one_tick()
    native = _native_engine()
    engine = native.StoreEngine()
    store = engine.store("r0")
    store.assign("c0", 60.0, 5.0, 0.0, 10.0, 1)
    engine.bulk_refresh(np.array([store._rid], np.int32),
                        np.array([engine.client_handle("c0")]),
                        np.array([90.0]), np.array([5.0]), np.array([2.0]))
    gc.collect()
    assert tr.snapshot() == [] and tr.open_spans() == []
    assert gc.callbacks == before


def _span_literals():
    """Names passed as a literal to .span(...) / .add_complete(...)
    anywhere in the port."""
    import ast
    from pathlib import Path

    import doorman_tpu_torch

    names = set()
    for path in Path(doorman_tpu_torch.__file__).parent.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("span", "add_complete")
                    and node.args and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return names


def test_port_span_names_are_apart_and_used():
    assert not trace_mod.PORT_SPAN_NAMES & trace_mod.KNOWN_SPAN_NAMES
    assert trace_mod.PORT_SPAN_NAMES <= _span_literals()


def test_capture_writes_program_spans_on_the_profiler_axis(tracer, tmp_path):
    import torch

    a = torch.randn(256, 256)
    capture = trace_mod.start_torch_capture(str(tmp_path))
    with tracer.span("capture.mm", cat="t"):
        torch.mm(a, a)
    path = trace_mod.stop_torch_capture(capture, str(tmp_path))
    events = json.loads(open(path).read())["traceEvents"]
    (span,) = [e for e in events if e.get("name") == "capture.mm"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert span["ph"] == "X" and "span_id" in span["args"]
    # aten::mm lies inside the span's interval, each edge placed to
    # within 100 us.
    assert mm["ts"] >= span["ts"] - 100.0
    assert mm["ts"] + mm["dur"] <= span["ts"] + span["dur"] + 100.0
    assert tracer.open_spans() == []
