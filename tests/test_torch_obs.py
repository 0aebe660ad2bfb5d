"""The port's observability (doorman_tpu_torch.obs), the cases of
tests/test_obs.py against the port: metrics registry exposition,
server/client instrumentation, the debug HTTP pages (pages served over
real HTTP), the admission and frontend pages of a server without those
parts, and the torch.profiler capture of the first batch ticks."""

import asyncio
import urllib.request

import tests.conftest  # noqa: F401

from doorman_tpu_torch.client import Client
from doorman_tpu_torch.obs import (
    DebugServer,
    Registry,
    add_status_part,
    instrument_server,
)
from doorman_tpu_torch.obs.metrics import instrument_client
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


def fetch(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=5
    ) as resp:
        return resp.status, resp.read().decode()


def test_counter_gauge_exposition():
    reg = Registry()
    c = reg.counter("requests_total", "Total requests.", labels=("method",))
    c.inc("GetCapacity")
    c.inc("GetCapacity")
    c.inc("Release", by=3)
    g = reg.gauge("temperature", "Now.")
    g.set(36.5)
    text = reg.expose()
    assert "# TYPE requests_total counter" in text
    assert 'requests_total{method="GetCapacity"} 2' in text
    assert 'requests_total{method="Release"} 3' in text
    assert "# HELP temperature Now." in text
    assert "temperature 36.5" in text


def test_request_log_stamps_via_injected_clock():
    # The clock is an injectable seam (doormanlint seeded-determinism):
    # a chaos-driven server's samples must carry VIRTUAL time, and the
    # explicit `when` override must win over the clock.
    from doorman_tpu_torch.obs.requests import RequestLog

    t = [1000.0]
    log = RequestLog(clock=lambda: t[0])
    log.record("GetCapacity", "c1", ["r0"], 5.0, 0.01, False)
    t[0] = 2000.0
    log.record("Release", "c1", ["r0"], 0.0, 0.01, False, when=42.0)
    newest, oldest = log.snapshot()
    assert oldest.when == 1000.0
    assert newest.when == 42.0


def test_histogram_exposition():
    reg = Registry()
    h = reg.histogram("latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    text = reg.expose()
    assert 'latency_bucket{le="0.1"} 1' in text
    assert 'latency_bucket{le="1"} 2' in text
    assert 'latency_bucket{le="+Inf"} 3' in text
    assert "latency_count 3" in text
    assert abs(h.sum() - 5.55) < 1e-9


def test_registry_dedupes_by_name():
    reg = Registry()
    a = reg.counter("x")
    b = reg.counter("x")
    assert a is b


def test_label_escaping():
    reg = Registry()
    c = reg.counter("c", labels=("v",))
    c.inc('say "hi"\n')
    assert 'c{v="say \\"hi\\"\\n"} 1' in reg.expose()


def test_instrumented_server_and_debug_pages():
    async def body():
        server = CapacityServer(
            "obs-server", TrivialElection(), minimum_refresh_interval=0.0,
            device="cpu",
        )
        reg = Registry()
        instrument_server(server, reg)
        port = await server.start(0, host="127.0.0.1")
        await server.load_config(parse_yaml_config(CONFIG))
        await asyncio.sleep(0)
        server.current_master = f"127.0.0.1:{port}"

        debug = DebugServer(host="127.0.0.1", registry=reg)
        debug.add_server(server, asyncio.get_running_loop())
        dport = debug.start()
        add_status_part("test-part", lambda: "<p>part-content-xyz</p>")

        client = await Client.connect(
            f"127.0.0.1:{port}", "client-1", minimum_refresh_interval=0.0
        )
        instrument_client(client, reg)
        res = await client.resource("r0", wants=40)
        cap = await asyncio.wait_for(res.capacity().get(), timeout=5)
        assert cap == 40.0

        loop = asyncio.get_running_loop()
        status, text = await loop.run_in_executor(
            None, fetch, dport, "/metrics"
        )
        assert status == 200
        assert (
            'doorman_server_requests_count{method="GetCapacity"} 1' in text
        )
        assert "doorman_server_requests_durations_bucket" in text
        assert 'doorman_server_resource_wants{resource="r0"} 40' in text
        assert "doorman_server_is_master 1" in text
        assert "doorman_client_requests_durations_count" in text

        status, page = await loop.run_in_executor(
            None, fetch, dport, "/debug/status"
        )
        assert status == 200
        assert "obs-server" in page
        assert "r0" in page
        assert "part-content-xyz" in page

        status, page = await loop.run_in_executor(
            None, fetch, dport, "/debug/resources?resource=r0"
        )
        assert status == 200
        assert "client-1" in page

        # The request sample ring renders the RPC we just made.
        status, page = await loop.run_in_executor(
            None, fetch, dport, "/debug/requests"
        )
        assert status == 200
        assert "GetCapacity" in page
        assert "client-1" in page
        assert "r0" in page
        sample = server.request_log.snapshot(1)[0]
        assert sample.method == "GetCapacity"
        assert sample.wants == 40.0
        assert not sample.error

        status, _ = await loop.run_in_executor(None, fetch, dport, "/healthz")
        assert status == 200

        await client.close()
        debug.stop()
        await server.stop()

    asyncio.run(body())


def test_debug_frontend_and_admission_pages_without_those_parts():
    """/debug/frontend and /debug/admission render a server that has no
    frontend pool and no admission front-end the way the reference
    renders one with them off; ?format=json says None, never a 500."""
    import json

    async def body():
        server = CapacityServer(
            "fe-none", TrivialElection(), minimum_refresh_interval=0.0,
            mode="immediate", stream_push=True, stream_shards=4,
            device="cpu",
        )
        port = await server.start(0, host="127.0.0.1")
        await server.load_config(parse_yaml_config(CONFIG))
        await asyncio.sleep(0)
        server.current_master = f"127.0.0.1:{port}"
        debug = DebugServer(host="127.0.0.1", registry=Registry())
        loop = asyncio.get_running_loop()
        debug.add_server(server, loop)
        dport = debug.start()
        try:
            status, page = await loop.run_in_executor(
                None, fetch, dport, "/debug/frontend"
            )
            assert status == 200
            assert "no frontend pool attached" in page
            status, text = await loop.run_in_executor(
                None, fetch, dport, "/debug/frontend?format=json"
            )
            assert status == 200
            assert json.loads(text) == {"fe-none": None}
            status, page = await loop.run_in_executor(
                None, fetch, dport, "/debug/admission"
            )
            assert status == 200
            assert "admission control disabled" in page
            st = server.status()
            assert st["frontend"] is None and st["admission"] is None
        finally:
            debug.stop()
            await server.stop()

    asyncio.run(body())


def test_batch_tick_profiler_trace(tmp_path):
    """profile_dir writes a torch.profiler Chrome trace of the first
    ticks (the CPU ops here; the card's kernels on the card)."""
    import json

    async def body():
        server = CapacityServer(
            "prof-server", TrivialElection(), minimum_refresh_interval=0.0,
            mode="batch", profile_dir=str(tmp_path), profile_ticks=1,
            device="cpu",
        )
        await server.load_config(parse_yaml_config(CONFIG))
        await asyncio.sleep(0)
        from doorman_tpu_torch.proto import doorman_pb2 as pb

        req = pb.GetCapacityRequest()
        req.client_id = "c1"
        r = req.resource.add()
        r.resource_id = "r0"
        r.wants = 10.0
        await server.GetCapacity(req, None)
        await server.tick_once()
        await server.tick_once()
        assert server._profiler is None and server._profile_done
        return server.profile_trace

    path = asyncio.run(body())
    traces = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert [str(p) for p in traces] == [path], "no profiler trace written"
    doc = json.loads(traces[0].read_text())
    assert doc["traceEvents"], "empty profiler trace"
