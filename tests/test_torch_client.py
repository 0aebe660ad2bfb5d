"""The reference's server/client cases (tests/test_server_client.py) on
the port's Client, Connection, ratelimiter and server, over real gRPC on
loopback: mastership redirect, learning mode, release, config hot-swap,
GetServerCapacity and its validation, the client refresh loop, outage
expiry to the server-sent safe capacity, the bounded redirect loop, and
the batch serving mode on both stores (device="cpu", the kernels' plain
versions). Then Client(stream=True) against a port server with stream
push (the watcher's grant moves by push alone) and against one without
(UNIMPLEMENTED: the client polls and backs its stream probe off)."""

import asyncio
import time

import grpc
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu_torch.client import Client, Connection
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto.grpc_api import (
    CapacityServicer,
    CapacityStub,
    add_capacity_servicer,
)
from doorman_tpu_torch.server.config import parse_yaml_config
from doorman_tpu_torch.server.election import TrivialElection
from doorman_tpu_torch.server.server import CapacityServer

CONFIG = """
resources:
- identifier_glob: proportional
  capacity: 100
  safe_capacity: 2
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
- identifier_glob: "*"
  capacity: 120
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
"""

LEARNING_CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 100}
"""


async def make_server(mode="immediate", config=CONFIG, **kwargs):
    server = CapacityServer(
        "test-server", TrivialElection(), mode=mode,
        minimum_refresh_interval=0.0, device="cpu", **kwargs,
    )
    port = await server.start(0, host="127.0.0.1")
    await server.load_config(parse_yaml_config(config))
    await asyncio.sleep(0)  # let election callbacks land
    server.current_master = f"127.0.0.1:{port}"
    return server, f"127.0.0.1:{port}"


def run(coro):
    return asyncio.run(coro)


def capacity_request(client_id, resource_id, wants, has=None):
    req = pb.GetCapacityRequest(client_id=client_id)
    rr = req.resource.add()
    rr.resource_id = resource_id
    rr.wants = wants
    if has is not None:
        rr.has.CopyFrom(has)
    return req


def test_discovery():
    async def body():
        server, addr = await make_server()
        try:
            async with grpc.aio.insecure_channel(addr) as ch:
                stub = CapacityStub(ch)
                out = await stub.Discovery(pb.DiscoveryRequest())
                assert out.is_master
                assert out.mastership.master_address == addr
        finally:
            await server.stop()

    run(body())


def test_get_capacity_immediate():
    async def body():
        server, addr = await make_server()
        try:
            async with grpc.aio.insecure_channel(addr) as ch:
                stub = CapacityStub(ch)
                out = await stub.GetCapacity(
                    capacity_request("client-1", "proportional", 40.0)
                )
                assert len(out.response) == 1
                resp = out.response[0]
                assert resp.resource_id == "proportional"
                assert resp.gets.capacity == 40.0
                assert resp.safe_capacity == 2.0
                assert resp.gets.refresh_interval == 1
        finally:
            await server.stop()

    run(body())


def test_invalid_request_rejected():
    async def body():
        server, addr = await make_server()
        try:
            async with grpc.aio.insecure_channel(addr) as ch:
                stub = CapacityStub(ch)
                with pytest.raises(grpc.aio.AioRpcError) as excinfo:
                    await stub.GetCapacity(
                        capacity_request("", "proportional", 40.0)
                    )
                assert excinfo.value.code() == grpc.StatusCode.INVALID_ARGUMENT
                # A NUL in the id could forge a downstream server's band
                # sub-lease key; the wire rejects it.
                with pytest.raises(grpc.aio.AioRpcError) as excinfo:
                    await stub.GetCapacity(
                        capacity_request(
                            "mid\x00band\x002", "proportional", 40.0
                        )
                    )
                assert excinfo.value.code() == grpc.StatusCode.INVALID_ARGUMENT
                with pytest.raises(grpc.aio.AioRpcError) as excinfo:
                    await stub.ReleaseCapacity(
                        pb.ReleaseCapacityRequest(
                            client_id="mid\x00band\x002",
                            resource_id=["proportional"],
                        )
                    )
                assert excinfo.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        finally:
            await server.stop()

    run(body())


def test_mastership_redirect():
    async def body():
        server, addr = await make_server()

        # A fake non-master that always points at the real server
        # (mirrors reference client_test.go:117-172).
        class NonMaster(CapacityServicer):
            async def GetCapacity(self, request, context):
                out = pb.GetCapacityResponse()
                out.mastership.master_address = addr
                return out

            async def Discovery(self, request, context):
                out = pb.DiscoveryResponse(is_master=False)
                out.mastership.master_address = addr
                return out

        fake = grpc.aio.server()
        add_capacity_servicer(fake, NonMaster())
        fake_port = fake.add_insecure_port("127.0.0.1:0")
        await fake.start()
        try:
            conn = Connection(f"127.0.0.1:{fake_port}", max_retries=2)
            out = await conn.execute(
                lambda stub: stub.GetCapacity(
                    capacity_request("client-1", "proportional", 10.0)
                )
            )
            assert out.response[0].gets.capacity == 10.0
            assert conn.current_master == addr
            await conn.close()
        finally:
            await fake.stop(None)
            await server.stop()

    run(body())


def test_learning_mode_and_post_learning_clamp():
    async def body():
        server, addr = await make_server(config=LEARNING_CONFIG)
        try:
            async with grpc.aio.insecure_channel(addr) as ch:
                stub = CapacityStub(ch)
                # During learning mode the server grants whatever the client
                # reports it has (even over capacity).
                has = pb.Lease(expiry_time=2**31, refresh_interval=1,
                               capacity=300.0)
                out = await stub.GetCapacity(
                    capacity_request("c1", "proportional", 300.0, has)
                )
                assert out.response[0].gets.capacity == 300.0

                # Leave learning mode (rewind became_master_at, like the
                # reference test rewinds it, server_test.go:339-382).
                server.became_master_at -= 10_000
                for res in server.resources.values():
                    res.learning_mode_end = 0.0

                out = await stub.GetCapacity(
                    capacity_request("c1", "proportional", 300.0, has)
                )
                assert out.response[0].gets.capacity <= 100.0
        finally:
            await server.stop()

    run(body())


def test_release_capacity():
    async def body():
        server, addr = await make_server()
        try:
            async with grpc.aio.insecure_channel(addr) as ch:
                stub = CapacityStub(ch)
                await stub.GetCapacity(
                    capacity_request("c1", "proportional", 40.0)
                )
                assert server.resources["proportional"].store.has_client("c1")
                out = await stub.ReleaseCapacity(
                    pb.ReleaseCapacityRequest(
                        client_id="c1", resource_id=["proportional", "ghost"]
                    )
                )
                assert not out.HasField("mastership")
                assert not server.resources["proportional"].store.has_client(
                    "c1"
                )
        finally:
            await server.stop()

    run(body())


def test_config_hot_swap():
    async def body():
        server, addr = await make_server()
        try:
            async with grpc.aio.insecure_channel(addr) as ch:
                stub = CapacityStub(ch)
                await stub.GetCapacity(capacity_request("c1", "res", 10.0))
                new_config = parse_yaml_config(
                    """
resources:
- identifier_glob: "*"
  capacity: 7
  algorithm: {kind: STATIC, lease_length: 60, refresh_interval: 1}
"""
                )
                await server.load_config(new_config)
                out = await stub.GetCapacity(
                    capacity_request("c1", "res", 10.0)
                )
                # STATIC grants min(per-client capacity, wants) = 7.
                assert out.response[0].gets.capacity == 7.0
        finally:
            await server.stop()

    run(body())


def test_get_server_capacity_and_validation():
    async def body():
        server, addr = await make_server()
        try:
            async with grpc.aio.insecure_channel(addr) as ch:
                stub = CapacityStub(ch)
                req = pb.GetServerCapacityRequest(server_id="downstream")
                rr = req.resource.add()
                rr.resource_id = "proportional"
                band = rr.wants.add()
                band.priority = 1
                band.num_clients = 5
                band.wants = 250.0
                out = await stub.GetServerCapacity(req)
                resp = out.response[0]
                assert resp.resource_id == "proportional"
                assert resp.gets.capacity == 100.0  # whole capacity, one asker
                assert resp.algorithm.kind == pb.Algorithm.PROPORTIONAL_SHARE
                # subclients must be >= 1
                bad = pb.GetServerCapacityRequest(server_id="downstream")
                rr = bad.resource.add()
                rr.resource_id = "proportional"
                band = rr.wants.add()
                band.priority = 1
                band.num_clients = 0
                band.wants = 1.0
                with pytest.raises(grpc.aio.AioRpcError) as excinfo:
                    await stub.GetServerCapacity(bad)
                assert excinfo.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        finally:
            await server.stop()

    run(body())


def test_batch_mode_serves_solved_grants():
    async def body():
        server, addr = await make_server(mode="batch")
        try:
            async with grpc.aio.insecure_channel(addr) as ch:
                stub = CapacityStub(ch)
                # First round: unknown clients go through the immediate path.
                for c, w in [("a", 60.0), ("b", 60.0), ("c", 10.0)]:
                    await stub.GetCapacity(
                        capacity_request(c, "proportional", w)
                    )
                # Batched tick rebalances everyone at once.
                await server.tick_once()
                await server.tick_once()
                out = await stub.GetCapacity(
                    capacity_request("b", "proportional", 60.0)
                )
                # Solved grant: 60 * 100/130.
                assert out.response[0].gets.capacity == pytest.approx(
                    60.0 * 100.0 / 130.0
                )
        finally:
            await server.stop()

    run(body())


def test_batch_mode_native_resident_serves_solved_grants():
    """Native batch servers take the device-resident tick path: grants
    land one tick after their solve (the pipelined collect), then serve
    from the store like any batch grant."""

    async def body():
        from doorman_tpu_torch import native

        if not native.native_available():
            pytest.skip("native engine unavailable")
        server, addr = await make_server(mode="batch", native_store=True)
        try:
            async with grpc.aio.insecure_channel(addr) as ch:
                stub = CapacityStub(ch)
                for c, w in [("a", 60.0), ("b", 60.0), ("c", 10.0)]:
                    await stub.GetCapacity(
                        capacity_request(c, "proportional", w)
                    )
                # dispatch -> collect+dispatch -> collect lands grants.
                await server.tick_once()
                await server.tick_once()
                await server.tick_once()
                assert server._resident is not None
                assert server._resident.ticks >= 1
                out = await stub.GetCapacity(
                    capacity_request("b", "proportional", 60.0)
                )
                assert out.response[0].gets.capacity == pytest.approx(
                    60.0 * 100.0 / 130.0
                )
        finally:
            await server.stop()

    run(body())


def test_client_refresh_loop():
    async def body():
        server, addr = await make_server()
        try:
            client = await Client.connect(
                addr, "itest-client", minimum_refresh_interval=0.05
            )
            res = await client.resource("proportional", 30.0)
            capacity = await asyncio.wait_for(res.capacity().get(), timeout=5)
            assert capacity == 30.0
            # Raising wants refreshes to a bigger grant on the next cycle.
            await res.ask(80.0)
            capacity = await asyncio.wait_for(res.capacity().get(), timeout=5)
            assert capacity == 80.0
            await res.release()
            assert not server.resources["proportional"].store.has_client(
                "itest-client"
            )
            await client.close()
        finally:
            await server.stop()

    run(body())


def test_outage_expiry_falls_back_to_safe_capacity():
    """A lease expiring during a server outage falls back to the
    SERVER-SENT safe capacity (design.md semantics; reference
    simulation/client.py:197-200), not to 0 — and the QPS limiter
    throttles to that fallback rate. 0 remains the fallback only when
    the server never sent a safe capacity."""

    async def body():
        from doorman_tpu_torch.ratelimiter import new_qps

        server, addr = await make_server()
        client = await Client.connect(
            addr, "safecap-client", minimum_refresh_interval=0.05
        )
        try:
            res = await client.resource("proportional", 30.0)
            capacity = await asyncio.wait_for(res.capacity().get(), timeout=5)
            assert capacity == 30.0
            # The config's safe_capacity rode the response in.
            assert res.safe_capacity == 2.0
            limiter = new_qps(res)
            await asyncio.sleep(0.1)  # limiter consumes the 30.0 update

            # Outage: server down, lease forced past expiry.
            await server.stop()
            res.lease.expiry_time = 1
            deadline = time.monotonic() + 5.0
            while res.lease is not None and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
            assert res.lease is None, "lease not expired during outage"
            assert res.current_capacity() == 2.0
            # The limiter now meters at the safe rate: 2 QPS -> one
            # release per 500ms; three waits take >= ~1s, not instant.
            t0 = time.monotonic()
            for _ in range(3):
                await asyncio.wait_for(limiter.wait(), timeout=5)
            assert time.monotonic() - t0 > 0.8, "limiter not throttled"
            await limiter.close()
        finally:
            await client.close()
            await server.stop()

    run(body())


def test_outage_expiry_without_safe_capacity_pushes_zero():
    """The '*' template has no safe_capacity: the server sends a
    dynamic fallback (capacity / clients) — the client must use what
    the server sent; clearing the field server-side would mean 0."""

    async def body():
        server, addr = await make_server()
        client = await Client.connect(
            addr, "nocap-client", minimum_refresh_interval=0.05
        )
        try:
            res = await client.resource("other", 10.0)
            await asyncio.wait_for(res.capacity().get(), timeout=5)
            # Dynamic safe capacity: capacity 120 / 1 client.
            assert res.safe_capacity == 120.0
            # Simulate "server never sent one" (old servers / cleared
            # field): the conservative 0 fallback applies.
            res.safe_capacity = None
            await server.stop()
            res.lease.expiry_time = 1
            deadline = time.monotonic() + 5.0
            while res.lease is not None and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
            assert res.lease is None
            assert res.current_capacity() == 0.0
        finally:
            await client.close()
            await server.stop()

    run(body())


def test_not_master_redirects_client():
    async def body():
        server, addr = await make_server()
        try:
            server.is_master = False
            server.current_master = ""
            async with grpc.aio.insecure_channel(addr) as ch:
                stub = CapacityStub(ch)
                out = await stub.GetCapacity(
                    capacity_request("c1", "proportional", 10.0)
                )
                assert out.HasField("mastership")
                assert not out.mastership.HasField("master_address")
        finally:
            await server.stop()

    run(body())


def test_redirect_loop_between_two_non_masters_is_bounded():
    """Two servers each pointing at the other as master must not spin
    the connection in an unbounded sleepless redirect chase: after the
    bounded number of immediate redirects the attempt fails, and with
    max_retries exhausted execute() raises MasterUnknown (reference
    runMasterAware's redirect loop, connection.go:143-227)."""

    async def body():
        from doorman_tpu_torch.client.connection import MasterUnknown

        a, addr_a = await make_server()
        b, addr_b = await make_server()
        conn = None
        try:
            a.is_master = False
            a.current_master = addr_b
            b.is_master = False
            b.current_master = addr_a
            conn = Connection(addr_a, max_retries=1)
            # wait_for makes a broken redirect bound FAIL crisply
            # instead of hanging the suite on an endless chase.
            with pytest.raises(MasterUnknown):
                await asyncio.wait_for(
                    conn.execute(
                        lambda stub: stub.GetCapacity(
                            capacity_request("c1", "proportional", 5.0)
                        )
                    ),
                    timeout=30.0,
                )
        finally:
            if conn is not None:
                await conn.close()
            await a.stop()
            await b.stop()

    run(body())


def test_stream_client_takes_pushes_from_a_port_server():
    """Client(stream=True) against a port batch server with stream push:
    the opening snapshot carries the first grant, and a second
    (polling) client's demand moves the watcher's grant by a tick-edge
    push, with no ask() on the watcher."""

    async def body():
        server, addr = await make_server(
            mode="batch", stream_push=True, tick_interval=0.1
        )
        watcher = await Client.connect(
            addr, "watcher", stream=True, minimum_refresh_interval=0.0
        )
        poller = await Client.connect(
            addr, "poller", minimum_refresh_interval=0.05
        )
        try:
            res = await watcher.resource("proportional", 30.0)
            assert await asyncio.wait_for(res.capacity().get(), 5) == 30.0
            assert len(server._streams) == 1
            other = await poller.resource("proportional", 90.0)
            await asyncio.wait_for(other.capacity().get(), 5)
            value = 30.0
            deadline = time.monotonic() + 10.0
            while value != pytest.approx(25.0) and time.monotonic() < deadline:
                value = await asyncio.wait_for(res.capacity().get(), 10)
            # Proportional share of 100 between wants 30 and 90.
            assert value == pytest.approx(25.0)
            assert server.status()["streams"]["messages_total"] >= 2
        finally:
            await poller.close()
            await watcher.close()
            await server.stop()

    run(body())


def test_stream_client_polls_a_port_server_without_stream_push():
    async def body():
        server, addr = await make_server()
        client = await Client.connect(
            addr, "w", stream=True, minimum_refresh_interval=0.0
        )
        try:
            res = await client.resource("proportional", 25.0)
            assert await asyncio.wait_for(res.capacity().get(), 10) == 25.0
            # UNIMPLEMENTED: the stream probe backed off instead of
            # spinning, and the poll served the grant.
            assert client._stream_retry_at > client._clock()
        finally:
            await client.close()
            await server.stop()

    run(body())
