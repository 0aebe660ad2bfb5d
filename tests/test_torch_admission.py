"""RPC admission in the port (doorman_tpu_torch/admission/), against the
reference on the CPU (the port's servers on device="cpu"; the
reference's with JAX on the CPU).

Mirrors tests/test_admission.py on the port — the AIMD controller, the
shed matrix, deadline fast-fail, the coalescing parity pin, the
retry-after contract over gRPC, the client's jittered retry, the debug
page and the metrics — and pins the port to the reference on the same
seeded inputs:

  * AIMD level sequences equal, step for step, on a fake clock (the
    seeded `random.Random` is drawn in the reference's order);
  * the coalesced GetCapacity responses byte-equal to the reference's
    (tests/test_admission.py:269's stream, both stores);
  * a batch native server with `fuse_admission` in each package: the
    responses byte-equal and the stores equal after every tick (f64,
    exact), and the port's fused server equal to its unfused twin with
    staged rows consumed by the resident tick;
  * every store writer in the port's server/server.py and
    admission/coalesce.py calls `_fused_invalidate` / `_fused_stage` or
    is named in the port's FUSED_TRACKED_WRITERS.
"""

import ast
import asyncio
import json
import math
import random
import urllib.request
from pathlib import Path

import grpc
import numpy as np
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu.admission import Admission as JAdmission
from doorman_tpu.admission.controller import AimdController as JAimd
from doorman_tpu.proto import doorman_pb2 as jpb
from doorman_tpu.server.config import parse_yaml_config as j_parse
from doorman_tpu.server.election import TrivialElection as JElection
from doorman_tpu.server.server import CapacityServer as JServer
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.admission import RETRY_AFTER_KEY, Admission
from doorman_tpu_torch.admission.controller import AimdController
from doorman_tpu_torch.admission.deadline import (
    DecisionLatency,
    fast_fail_reason,
)
from doorman_tpu_torch.admission.policy import SHED_MATRIX, sheddable
from doorman_tpu_torch.client import Client
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto import doorman_stream_pb2 as spb
from doorman_tpu_torch.proto.grpc_api import CapacityStub
from doorman_tpu_torch.server import server as server_mod
from doorman_tpu_torch.server.config import parse_yaml_config
from doorman_tpu_torch.server.election import TrivialElection
from doorman_tpu_torch.server.server import CapacityServer
from doorman_tpu_torch.utils.backoff import backoff

ROOT = Path(__file__).resolve().parent.parent

CONFIG = """
resources:
- identifier_glob: prop
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
- identifier_glob: "*"
  capacity: 120
  safe_capacity: 3
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
"""

NATIVE = pytest.param(
    True, id="native-store",
    marks=pytest.mark.skipif(
        not tnative.native_available(), reason="native engine unavailable"
    ),
)
STORES = [pytest.param(False, id="python-store"), NATIVE]


def run(coro):
    return asyncio.run(coro)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


async def make_server(admission=None, clock=None, **kwargs):
    server = CapacityServer(
        "adm-test", TrivialElection(), mode="immediate",
        minimum_refresh_interval=0.0, admission=admission,
        device="cpu",
        **({"clock": clock} if clock is not None else {}), **kwargs,
    )
    port = await server.start(0, host="127.0.0.1")
    await server.load_config(parse_yaml_config(CONFIG))
    await asyncio.sleep(0)
    server.current_master = f"127.0.0.1:{port}"
    return server, f"127.0.0.1:{port}"


async def make_ref_server(admission=None, clock=None, **kwargs):
    server = JServer(
        "adm-test", JElection(), mode="immediate",
        minimum_refresh_interval=0.0, admission=admission,
        **({"clock": clock} if clock is not None else {}), **kwargs,
    )
    port = await server.start(0, host="127.0.0.1")
    await server.load_config(j_parse(CONFIG))
    await asyncio.sleep(0)
    server.current_master = f"127.0.0.1:{port}"
    return server, f"127.0.0.1:{port}"


# ----------------------------------------------------------------------
# Controller (reference tests/test_admission.py:75-188)
# ----------------------------------------------------------------------


def test_aimd_level_collapses_under_overload_and_recovers():
    clock = FakeClock()
    ctl = AimdController(
        window=1.0, clock=clock, rng=random.Random(0), max_rps=10.0
    )
    for tick in range(3):
        clock.t = float(tick)
        for _ in range(3):
            admitted, _ = ctl.admit(0)
            assert admitted
    assert ctl.level == 1.0
    levels = []
    for tick in range(3, 7):
        clock.t = float(tick)
        for _ in range(30):
            ctl.admit(0)
        levels.append(ctl.level)
    assert levels[-1] < levels[0] <= 1.0
    assert ctl.overloaded_windows >= 3
    for tick in range(7, 25):
        clock.t = float(tick)
        ctl.admit(0)
    assert ctl.level == 1.0


def test_hard_cap_sheds_inside_the_spiking_window():
    ctl = AimdController(
        window=1.0, clock=FakeClock(), rng=random.Random(0), max_rps=5.0
    )
    outcomes = [ctl.admit(0)[0] for _ in range(12)]
    assert outcomes[:5] == [True] * 5
    assert not any(outcomes[5:])


def test_bands_shed_bottom_up_and_top_band_never():
    ctl = AimdController(
        window=1.0, clock=FakeClock(), rng=random.Random(1), max_rps=1000.0
    )
    for band in (0, 1, 2):
        ctl.admit(band)
    for level, expect_full, expect_zero in (
        (1.0, {0, 1, 2}, set()),
        (0.8, {1, 2}, set()),
        (2 / 3, {1, 2}, {0}),
        (0.5, {2}, {0}),
        (1 / 3, {2}, {0, 1}),
        (0.2, set(), {0, 1}),
    ):
        ctl.level = level
        for band in (0, 1, 2):
            p = ctl.band_probability(band)
            if band in expect_zero:
                assert p == 0.0, (level, band, p)
            if band in expect_full:
                assert p == pytest.approx(1.0), (level, band, p)
        assert (
            ctl.band_probability(0)
            <= ctl.band_probability(1)
            <= ctl.band_probability(2)
        )
    ctl.level = ctl.min_level
    admitted, _ = ctl.admit(2)
    assert admitted


def test_retry_after_bounded_and_longer_for_deeper_bands():
    ctl = AimdController(window=1.0, clock=FakeClock(), rng=random.Random(2))
    for band in (0, 1, 2):
        ctl.admit(band)
    ctl.level = 0.1
    low, mid, top = (ctl.retry_after(b) for b in (0, 1, 2))
    assert low > mid > top >= ctl.window
    assert low <= ctl.max_retry_after


def test_backoff_full_jitter_opt_in():
    assert backoff(1.0, 60.0, 3) == pytest.approx(1.3**3)
    rng = random.Random(42)
    draws = [backoff(1.0, 60.0, 8, jitter=rng) for _ in range(64)]
    ladder = backoff(1.0, 60.0, 8)
    assert all(0.0 <= d <= ladder for d in draws)
    assert len(set(round(d, 9) for d in draws)) > 32


def test_shed_matrix():
    assert sheddable("GetCapacity")
    assert sheddable("WatchCapacity")
    for method in ("ReleaseCapacity", "GetServerCapacity", "Discovery"):
        assert not sheddable(method)
    assert set(SHED_MATRIX) == {
        "GetCapacity", "WatchCapacity", "GetServerCapacity",
        "ReleaseCapacity", "Discovery",
    }


def test_deadline_fast_fail_math():
    lat = DecisionLatency()
    lat.observe(0.02)

    class Ctx:
        def __init__(self, remaining):
            self._r = remaining

        def time_remaining(self):
            return self._r

    assert fast_fail_reason(None, 0.1, lat) is None
    assert fast_fail_reason(Ctx(None), 0.1, lat) is None
    assert fast_fail_reason(Ctx(10.0), 0.1, lat) is None
    reason = fast_fail_reason(Ctx(0.05), 0.1, lat)
    assert reason is not None and "fast-fail" in reason


def test_level_recovers_within_documented_window():
    """From the floor, full admission returns within
    ceil((1 - min_level) / ai_step) healthy control windows (reference
    :534, on a fake clock in place of the chaos clock)."""
    clock = FakeClock()
    ctl = AimdController(
        window=1.0, clock=clock, rng=random.Random(0), max_rps=10.0
    )
    for _ in range(8):
        for _ in range(40):
            ctl.admit(0)
        clock.advance(1.0)
    assert ctl.level == ctl.min_level
    budget = math.ceil((1.0 - ctl.min_level) / ctl.ai_step)
    for k in range(budget + 1):
        ctl.admit(0)
        clock.advance(1.0)
        if ctl.level == 1.0:
            break
    assert ctl.level == 1.0, (k, ctl.level)
    assert k <= budget, (k, budget)


def test_forecast_seam_folds_into_pressure():
    clock = FakeClock()
    ctl = AimdController(
        window=1.0, clock=clock, rng=random.Random(0), max_rps=10.0
    )
    for _ in range(3):
        ctl.admit(0)
        clock.advance(1.0)
    assert ctl.level == 1.0
    ctl.set_forecast(30.0)
    ctl.admit(0)
    clock.advance(1.0)
    ctl.admit(0)
    assert ctl.level < 1.0
    ctl.set_forecast(None)
    for _ in range(15):
        ctl.admit(0)
        clock.advance(1.0)
    assert ctl.level == 1.0
    ctl.set_forecast(12.5)
    assert ctl.status()["forecast_rps"] == 12.5


def _aimd_trace(cls, seed, scenario):
    """Drive one controller through a seeded storm on a fake clock and
    record every admit decision, retry-after and level."""
    clock = FakeClock()
    ctl = cls(window=1.0, clock=clock, rng=random.Random(seed),
              max_rps=20.0)
    rng = random.Random(1000 + seed)
    out = []
    for tick in range(30):
        clock.t = float(tick) * 0.5
        arrivals = 60 if 8 <= tick < 18 else 5
        if scenario == "forecast" and tick == 4:
            ctl.set_forecast(45.0)
        if scenario == "tick_lag":
            ctl.observe_tick_lag(3.0 if 10 <= tick < 14 else 0.5)
        if scenario == "latency":
            ctl.observe_rpc(0.4 if 6 <= tick < 12 else 0.001)
            ctl.observe_queue(float(arrivals))
        for _ in range(arrivals):
            band = rng.choice((0, 1, 2))
            admitted, retry = ctl.admit(band)
            out.append((admitted, retry))
        out.append(("level", ctl.level))
    return out, ctl.status()


@pytest.mark.parametrize("scenario", ["storm", "forecast", "tick_lag",
                                      "latency"])
def test_aimd_level_sequences_equal_the_reference(scenario):
    """The same seeded storm through both packages' controllers on a
    fake clock: every admit decision, retry-after and level is equal
    (exact: the same float operations in the same order)."""
    for seed in (0, 7):
        got, st_got = _aimd_trace(AimdController, seed, scenario)
        want, st_want = _aimd_trace(JAimd, seed, scenario)
        assert got == want
        assert st_got == st_want


# ----------------------------------------------------------------------
# Coalescing parity (reference tests/test_admission.py:206-345)
# ----------------------------------------------------------------------


def _round_requests(mod, round_index, prev=None):
    reqs = []
    for i in range(6):
        cid = f"cl{i}"
        req = mod.GetCapacityRequest(client_id=cid)
        rids = ["prop"] if i % 3 == 0 else ["fair"]
        if i % 2 == 0:
            rids = rids + (["fair"] if rids == ["prop"] else ["prop"])
        for rid in rids:
            rr = req.resource.add()
            rr.resource_id = rid
            rr.wants = 10.0 * (i + 1) + round_index
            rr.priority = i % 3
            if prev is not None:
                for resp in prev[cid].response:
                    if resp.resource_id == rid:
                        rr.has.CopyFrom(resp.gets)
        reqs.append(req)
    return reqs


async def _drive_per_request(server, reqs):
    out = {}
    for req in reqs:
        out[req.client_id] = await server.GetCapacity(req, None)
    return out


async def _drive_coalesced(server, reqs):
    tasks = [
        asyncio.create_task(server.GetCapacity(req, None)) for req in reqs
    ]
    outs = await asyncio.gather(*tasks)
    return {req.client_id: out for req, out in zip(reqs, outs)}


def _store_rows(server):
    return {
        rid: sorted(res.store.dump_rows())
        for rid, res in server.resources.items()
    }


def _wire(outs):
    return {cid: r.SerializeToString() for cid, r in outs.items()}


@pytest.mark.parametrize("native_store", STORES)
def test_coalescing_parity(native_store):
    async def body():
        clock = FakeClock(1_000.0)
        ref, _ = await make_server(clock=clock, native_store=native_store)
        adm = Admission(coalesce_window=0.05)
        coal, _ = await make_server(
            admission=adm, clock=clock, native_store=native_store
        )
        try:
            prev_ref = await _drive_per_request(ref, _round_requests(pb, 0))
            prev_coal = await _drive_coalesced(coal, _round_requests(pb, 0))
            clock.t += 5.0
            out_ref = await _drive_per_request(
                ref, _round_requests(pb, 1, prev_ref)
            )
            out_coal = await _drive_coalesced(
                coal, _round_requests(pb, 1, prev_coal)
            )
            assert _wire(prev_ref) == _wire(prev_coal)
            assert _wire(out_ref) == _wire(out_coal)
            assert _store_rows(ref) == _store_rows(coal)
            assert adm.coalescer.max_occupancy == 6
            assert adm.coalescer.coalesced_requests == 12
        finally:
            await ref.stop()
            await coal.stop()

    run(body())


@pytest.mark.parametrize("native_store", STORES)
def test_coalesced_responses_equal_the_reference(native_store):
    """The reference's coalescing stream (its :269) through both
    packages' coalescers: responses byte-equal, round for round, and
    the stores equal."""

    async def body():
        clock = FakeClock(1_000.0)
        t_adm = Admission(coalesce_window=0.05)
        j_adm = JAdmission(coalesce_window=0.05)
        port, _ = await make_server(
            admission=t_adm, clock=clock, native_store=native_store
        )
        ref, _ = await make_ref_server(
            admission=j_adm, clock=clock, native_store=native_store
        )
        try:
            prev_t = prev_j = None
            for rnd in range(3):
                prev_t = await _drive_coalesced(
                    port, _round_requests(pb, rnd, prev_t)
                )
                prev_j = await _drive_coalesced(
                    ref, _round_requests(jpb, rnd, prev_j)
                )
                assert _wire(prev_t) == _wire(prev_j), rnd
                assert _store_rows(port) == _store_rows(ref), rnd
                clock.t += 5.0
            assert (
                t_adm.coalescer.status() | {"window_s": 0}
                == j_adm.coalescer.status() | {"window_s": 0}
            )
            assert t_adm.status()["tallies"] == j_adm.status()["tallies"]
        finally:
            await port.stop()
            await ref.stop()

    run(body())


def test_coalesced_mastership_flip_redirects_parked_requests():
    async def body():
        adm = Admission(coalesce_window=0.05)
        server, _ = await make_server(admission=adm)
        try:
            req = _round_requests(pb, 0)[0]
            task = asyncio.create_task(server.GetCapacity(req, None))
            await asyncio.sleep(0)
            server.is_master = False
            out = await task
            assert out.HasField("mastership")
            assert not out.response
        finally:
            await server.stop()

    run(body())


# ----------------------------------------------------------------------
# Shedding over real gRPC + the retry-after contract
# ----------------------------------------------------------------------


def _request(client_id, rid="fair", wants=5.0, priority=0):
    req = pb.GetCapacityRequest(client_id=client_id)
    rr = req.resource.add()
    rr.resource_id = rid
    rr.wants = wants
    rr.priority = priority
    return req


def test_shed_carries_retry_after_and_never_sheds_releases():
    async def body():
        adm = Admission(
            coalesce_window=0.0, max_rps=0.02, window=100.0,
            rng=random.Random(0),
        )
        server, addr = await make_server(admission=adm)
        try:
            async with grpc.aio.insecure_channel(addr) as ch:
                stub = CapacityStub(ch)
                hints = []
                raw = []
                ok = 0
                for i in range(8):
                    try:
                        await stub.GetCapacity(_request(f"s{i}"))
                        ok += 1
                    except grpc.aio.AioRpcError as e:
                        assert (
                            e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
                        )
                        for k, v in e.trailing_metadata() or ():
                            if k == RETRY_AFTER_KEY:
                                raw.append(v)
                                hints.append(float(v))
                assert ok == 2 and len(hints) == 6
                assert all(h > 0 for h in hints)
                # The decimal text the client parses: three places.
                assert all(v == f"{float(v):.3f}" for v in raw)
                out = await stub.ReleaseCapacity(
                    pb.ReleaseCapacityRequest(
                        client_id="s0", resource_id=["fair"]
                    )
                )
                assert not out.HasField("mastership")
                gsc = pb.GetServerCapacityRequest(server_id="downstream")
                rr = gsc.resource.add()
                rr.resource_id = "fair"
                band = rr.wants.add()
                band.priority = 1
                band.num_clients = 2
                band.wants = 8.0
                out = await stub.GetServerCapacity(gsc)
                assert len(out.response) == 1
            tallies = server._admission.tallies
            assert tallies[("GetCapacity", 0)]["shed"] == 6
            assert tallies[("ReleaseCapacity", 0)] == {
                "admitted": 1, "shed": 0, "fast_fail": 0}
            assert tallies[("GetServerCapacity", 1)] == {
                "admitted": 1, "shed": 0, "fast_fail": 0}
        finally:
            await server.stop()

    run(body())


def test_client_honors_retry_after_with_jitter_and_keeps_lease():
    async def body():
        adm = Admission(
            coalesce_window=0.0, max_rps=0.01, window=100.0,
            rng=random.Random(0),
        )
        server, addr = await make_server(admission=adm)
        client = Client(
            addr, "jit", minimum_refresh_interval=0.0, max_retries=0
        )
        try:
            await client.resource("fair", 5.0)
            interval, retry = await client._perform_requests(0)
            assert retry == 0
            res = client.resources["fair"]
            granted = res.current_capacity()
            assert granted == 5.0
            hint = server._admission.controller.retry_after(0)
            for _ in range(3):
                interval, retry = await client._perform_requests(0)
                assert retry == 1
                assert 0.5 * hint <= interval <= hint
                assert res.lease is not None
                assert res.current_capacity() == granted
        finally:
            await client.close()
            await server.stop()

    run(body())


def test_deadline_fast_fail_over_grpc():
    async def body():
        adm = Admission(coalesce_window=0.5)
        server, addr = await make_server(admission=adm)
        try:
            async with grpc.aio.insecure_channel(addr) as ch:
                stub = CapacityStub(ch)
                with pytest.raises(grpc.aio.AioRpcError) as excinfo:
                    await stub.GetCapacity(
                        _request("dl", priority=2), timeout=0.1
                    )
                assert (
                    excinfo.value.code()
                    == grpc.StatusCode.RESOURCE_EXHAUSTED
                )
            tallies = server._admission.tallies
            assert tallies[("GetCapacity", 2)]["fast_fail"] == 1
            assert tallies[("GetCapacity", 2)]["shed"] == 0
        finally:
            await server.stop()

    run(body())


def test_watch_establishment_goes_through_the_gate():
    """WatchCapacity establishment draws from the same AIMD gate: past
    the budget the stream is refused RESOURCE_EXHAUSTED with the
    retry-after trailer, and the WatchCapacity tallies count it."""

    async def body():
        adm = Admission(
            coalesce_window=0.0, max_rps=0.01, window=100.0,
            rng=random.Random(0),
        )
        server, addr = await make_server(admission=adm, stream_push=True)
        try:
            async with grpc.aio.insecure_channel(addr) as ch:
                stub = CapacityStub(ch)
                req = spb.WatchCapacityRequest(client_id="w0")
                rr = req.resource.add()
                rr.resource_id = "fair"
                rr.wants = 5.0
                call = stub.WatchCapacity(req)
                first = await call.read()
                assert first.response[0].resource_id == "fair"
                req.client_id = "w1"
                call2 = stub.WatchCapacity(req)
                with pytest.raises(grpc.aio.AioRpcError) as excinfo:
                    await call2.read()
                err = excinfo.value
                assert err.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
                assert any(
                    k == RETRY_AFTER_KEY
                    for k, _ in err.trailing_metadata() or ()
                )
                call.cancel()
            tallies = server._admission.tallies
            assert tallies[("WatchCapacity", 0)] == {
                "admitted": 1, "shed": 1, "fast_fail": 0}
        finally:
            await server.stop()

    run(body())


# ----------------------------------------------------------------------
# Observability
# ----------------------------------------------------------------------


def test_debug_admission_page_and_status():
    from doorman_tpu_torch.obs import DebugServer

    async def body():
        adm = Admission(coalesce_window=0.0)
        server, addr = await make_server(admission=adm)
        async with grpc.aio.insecure_channel(addr) as ch:
            stub = CapacityStub(ch)
            await stub.GetCapacity(_request("dbg", priority=1))
        st = server.status()["admission"]
        assert st["controller"]["level"] == 1.0
        assert st["tallies"]["GetCapacity/1"]["admitted"] == 1
        await server.stop()
        return server

    server = run(body())
    debug = DebugServer(port=0)
    debug.add_server(server, None)
    debug.start()
    try:
        html_page = urllib.request.urlopen(
            f"http://127.0.0.1:{debug.port}/debug/admission", timeout=5
        ).read().decode()
        assert "level" in html_page and "GetCapacity/1" in html_page
        js = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{debug.port}/debug/admission?format=json",
            timeout=5,
        ).read().decode())
        assert js["adm-test"]["tallies"]["GetCapacity/1"]["admitted"] == 1
    finally:
        debug.stop()


def test_admission_metrics_in_default_registry():
    from doorman_tpu_torch.obs import default_registry

    async def body():
        adm = Admission(coalesce_window=0.0)
        server, addr = await make_server(admission=adm)
        try:
            async with grpc.aio.insecure_channel(addr) as ch:
                stub = CapacityStub(ch)
                await stub.GetCapacity(_request("met", priority=3))
        finally:
            await server.stop()

    run(body())
    text = default_registry().expose()
    assert (
        'doorman_admission_requests{method="GetCapacity",band="3",'
        'outcome="admitted"}' in text
    )
    assert "doorman_admission_window_occupancy" in text


# ----------------------------------------------------------------------
# Admission-fused staging on the batch native server
# ----------------------------------------------------------------------

SERVER_CONFIG = """
resources:
- identifier_glob: "fair*"
  capacity: 300
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
"""


async def _batch_server(ref, fuse, native_store, clock):
    common = dict(
        mode="batch", tick_interval=60.0, minimum_refresh_interval=0.0,
        native_store=native_store, clock=clock, flightrec_capacity=64,
        fuse_admission=fuse,
    )
    if ref:
        server = JServer(f"eng-{fuse}", JElection(),
                         admission=JAdmission(coalesce_window=0.05),
                         **common)
        parse = j_parse
    else:
        server = CapacityServer(f"eng-{fuse}", TrivialElection(),
                                admission=Admission(coalesce_window=0.05),
                                device="cpu", **common)
        parse = parse_yaml_config
    await server.start(0, host="127.0.0.1")
    await server.load_config(parse(SERVER_CONFIG))
    await asyncio.sleep(0)
    return server


def _server_requests(mod, round_index, prev=None, scale=10.0):
    reqs = []
    for i in range(6):
        cid = f"cl{i}"
        req = mod.GetCapacityRequest(client_id=cid)
        for rid in (["fair0"] if i % 2 else ["fair0", "prop"]):
            rr = req.resource.add()
            rr.resource_id = rid
            rr.wants = scale * (i + 1) + round_index
            rr.priority = i % 3
            if prev is not None:
                for resp in prev[cid].response:
                    if resp.resource_id == rid:
                        rr.has.CopyFrom(resp.gets)
        reqs.append(req)
    return reqs


@pytest.mark.parametrize("native_store", STORES)
def test_fused_server_parity(native_store):
    """The port's fused admission->staging path against its round-trip
    twin (reference tests/test_engine.py:502): responses and stores
    byte-identical over coalesced windows with manual ticks between;
    on the native store the staged rows are consumed by the resident
    tick, on the Python store the flag is a clean no-op."""

    async def body():
        clock = FakeClock(1_000.0)
        plain = await _batch_server(False, False, native_store, clock)
        fused = await _batch_server(False, True, native_store, clock)
        try:
            prev_p = await _drive_coalesced(plain, _server_requests(pb, 0))
            prev_f = await _drive_coalesced(fused, _server_requests(pb, 0))
            hits = 0
            for rnd in range(1, 5):
                await plain.tick_once()
                await fused.tick_once()
                if native_store:
                    hits += fused._resident.last_fused["rows"]
                clock.t += 1.0
                prev_p = await _drive_coalesced(
                    plain, _server_requests(pb, rnd, prev_p)
                )
                prev_f = await _drive_coalesced(
                    fused, _server_requests(pb, rnd, prev_f)
                )
                assert _wire(prev_p) == _wire(prev_f), rnd
                assert _store_rows(plain) == _store_rows(fused), rnd
            if native_store:
                st = fused._resident.staging.status()
                assert st["windows_total"] > 0
                assert st["staged_rows_total"] > 0
                assert hits > 0  # staged packs served the tick's upload
                assert plain._resident.staging is None
            else:
                assert fused._resident is None
        finally:
            await plain.stop()
            await fused.stop()

    run(body())


def test_fused_device_tables_equal_the_unfused_twin_in_a_deep_pipeline():
    """At pipeline depth 3 a tick's delivery write-back lands between a
    window and the next dispatch. Windows decided before the first tick
    applied (scalar decides: full-upload rows) must not ship the staged
    pre-delivery `has`: the fused twin's device tables equal the unfused
    twin's after every tick, and its stores too."""
    if not tnative.native_available():
        pytest.skip("native engine unavailable")
    import torch

    async def body():
        clock = FakeClock(1_000.0)
        side = {}
        for fuse in (True, False):
            server = CapacityServer(
                f"deep-{fuse}", TrivialElection(), mode="batch",
                tick_interval=60.0, minimum_refresh_interval=0.0,
                native_store=True, clock=clock, flightrec_capacity=0,
                tick_pipeline_depth=3, device="cpu",
                admission=Admission(coalesce_window=0.05),
                fuse_admission=fuse,
            )
            await server.start(0, host="127.0.0.1", tick_loop=False)
            await server.load_config(parse_yaml_config(SERVER_CONFIG))
            side[fuse] = server
        try:
            prev = {f: None for f in side}
            hits = 0
            for rnd in range(8):
                for fuse, server in side.items():
                    # Wants past both capacities: the tick's grants
                    # differ from the windows' first responses.
                    prev[fuse] = await _drive_coalesced(
                        server, _server_requests(pb, rnd, prev[fuse],
                                                 scale=100.0))
                    await server.tick_once()
                assert _wire(prev[True]) == _wire(prev[False]), rnd
                assert _store_rows(side[True]) == _store_rows(side[False])
                assert torch.equal(side[True]._resident.table().has,
                                   side[False]._resident.table().has), rnd
                hits += side[True]._resident.last_fused["rows"]
                clock.t += 1.0
            assert hits > 0
        finally:
            for server in side.values():
                await server.stop()

    run(body())


def test_fused_batch_native_server_equals_the_reference():
    """A batch native server with fuse_admission in each package (the
    reference's resident tick with JAX on the CPU): every window's
    responses byte-equal and the stores equal after every tick, at f64."""
    if not tnative.native_available():
        pytest.skip("native engine unavailable")

    async def body():
        clock = FakeClock(1_000.0)
        port = await _batch_server(False, True, True, clock)
        ref = await _batch_server(True, True, True, clock)
        try:
            prev_t = await _drive_coalesced(port, _server_requests(pb, 0))
            prev_j = await _drive_coalesced(ref, _server_requests(jpb, 0))
            assert _wire(prev_t) == _wire(prev_j)
            for rnd in range(1, 6):
                await port.tick_once()
                await ref.tick_once()
                assert _store_rows(port) == _store_rows(ref), rnd
                clock.t += 1.0
                prev_t = await _drive_coalesced(
                    port, _server_requests(pb, rnd, prev_t)
                )
                prev_j = await _drive_coalesced(
                    ref, _server_requests(jpb, rnd, prev_j)
                )
                assert _wire(prev_t) == _wire(prev_j), rnd
            assert (
                port._resident.staging.status()
                == ref._resident.staging.status()
            )
        finally:
            await port.stop()
            await ref.stop()

    run(body())


def test_failed_window_drops_the_whole_staging_cache():
    """A window whose grouped pass raises drops every staged pack (the
    freshness contract: a partially-applied window proves nothing)."""
    if not tnative.native_available():
        pytest.skip("native engine unavailable")

    async def body():
        clock = FakeClock(1_000.0)
        server = await _batch_server(False, True, True, clock)
        try:
            await _drive_coalesced(server, _server_requests(pb, 0))
            await server.tick_once()
            await _drive_coalesced(server, _server_requests(pb, 1))
            staging = server._resident.staging
            assert staging.status()["pending_rows"] > 0
            real = server._decide

            def boom(resource_id, request):
                raise RuntimeError("store write failed")

            server._decide = boom
            with pytest.raises(RuntimeError):
                await server.GetCapacity(_server_requests(pb, 2)[0], None)
            server._decide = real
            assert staging.status()["pending_rows"] == 0
        finally:
            await server.stop()

    run(body())


def test_tick_lag_feeds_the_controller_and_the_flight_record():
    if not tnative.native_available():
        pytest.skip("native engine unavailable")

    async def body():
        clock = FakeClock(1_000.0)
        server = await _batch_server(False, True, True, clock)
        try:
            await _drive_coalesced(server, _server_requests(pb, 0))
            body_once = server._tick_once_locked

            async def slow_tick():
                await body_once()
                clock.t += 30.0  # half the 60 s tick interval

            server._tick_once_locked = slow_tick
            ctl = server._admission.controller
            assert ctl.status()["tick_lag_ewma"] == 0.0
            await server.tick_once()
            assert ctl.status()["tick_lag_ewma"] > 0.0
            rec = server.flightrec.snapshot()[-1]
            assert rec["admission_level"] == 1.0
            assert rec["admitted_total"] == 6
            verdicts = server.evaluate_slos()
            assert verdicts
        finally:
            await server.stop()

    run(body())


def test_decide_bulk_equals_the_per_request_path():
    """decide_bulk (the vectorized grouped pass, with its sequential
    fallback) answers exactly as the per-request decides do, and leaves
    the same store."""
    if not tnative.native_available():
        pytest.skip("native engine unavailable")

    async def body():
        clock = FakeClock(1_000.0)
        a, _ = await make_server(clock=clock, native_store=True)
        b, _ = await make_server(clock=clock, native_store=True)
        try:
            rng = np.random.default_rng(5)
            n = 40
            cids = [f"c{i}" for i in range(n)]
            wants = rng.integers(1, 9, n).astype(np.float64)
            prio = rng.integers(0, 3, n)
            zeros = np.zeros(n)
            for rid in ("prop", "fair"):
                got = b.decide_bulk(
                    rid, cids, zeros, wants, prio, old_has=zeros,
                    old_wants=zeros, new_mask=np.ones(n, bool),
                    expected_count=0,
                )
                for i in range(n):
                    out = await a.GetCapacity(
                        _request(cids[i], rid, float(wants[i]),
                                 int(prio[i])), None)
                    resp = out.response[0]
                    assert got[0][i] == resp.gets.capacity
                    assert int(got[1][i]) == resp.gets.expiry_time
                    assert got[3][i] == resp.safe_capacity
            assert _store_rows(a) == _store_rows(b)
        finally:
            await a.stop()
            await b.stop()

    run(body())


# ----------------------------------------------------------------------
# The fused-writer discipline (reference tools/lint fused_writer.py)
# ----------------------------------------------------------------------

_WRITERS = {
    "assign", "regrant", "release", "restore", "bulk_assign",
    "bulk_refresh", "decide", "decide_fast", "refresh_grant",
    "clean", "clean_all", "_decide",
}
_HOOKS = {"_fused_invalidate", "_fused_stage"}


def _writer_findings(path: Path):
    tree = ast.parse(path.read_text())
    owners = {}

    def walk(node, stack):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk(child, stack + [child])
            elif isinstance(child, ast.ClassDef):
                walk(child, stack + [child])
            else:
                if isinstance(child, ast.Call) and isinstance(
                    child.func, ast.Attribute
                ):
                    funcs = [s for s in stack
                             if not isinstance(s, ast.ClassDef)]
                    if funcs:
                        # Obligations attach to the outermost def.
                        outer = funcs[0]
                        cls = [s for s in stack[:stack.index(outer)]
                               if isinstance(s, ast.ClassDef)]
                        name = ".".join([c.name for c in cls]
                                        + [outer.name])
                        slot = owners.setdefault(name, [False, False])
                        if child.func.attr in _HOOKS:
                            slot[1] = True
                        elif child.func.attr in _WRITERS:
                            slot[0] = True
                walk(child, stack)

    walk(tree, [])
    return {name for name, (writes, hooks) in owners.items()
            if writes and not hooks}


@pytest.mark.parametrize("rel", ["doorman_tpu_torch/server/server.py",
                                 "doorman_tpu_torch/admission/coalesce.py"])
def test_every_store_writer_invalidates_or_is_tracked(rel):
    untracked = _writer_findings(ROOT / rel)
    assert untracked <= server_mod.FUSED_TRACKED_WRITERS, (
        sorted(untracked - server_mod.FUSED_TRACKED_WRITERS)
    )
    # The registry names no ghost: each entry is a writer of one of the
    # two files.
    if rel.endswith("server.py"):
        both = untracked | _writer_findings(
            ROOT / "doorman_tpu_torch/admission/coalesce.py")
        assert server_mod.FUSED_TRACKED_WRITERS - both <= {
            "Coalescer._decide_batch"}


def test_fused_tracked_writers_equal_the_reference():
    from doorman_tpu.server import server as j_server

    assert server_mod.FUSED_TRACKED_WRITERS == j_server.FUSED_TRACKED_WRITERS
