"""The reference server and the port's server side by side on loopback
gRPC: same YAML config, same clock, same request sequence; after every
tick each server must answer with IDENTICAL GetCapacity responses.

Both run batch mode on the native store at f64 (the reference's parity
dtype); the port's tick runs on the CPU (device="cpu"), i.e. the plain
version of its kernels. The reference's wire service
(doorman_tpu.Capacity) serves both, so one stub class talks to either.
"""

import asyncio

import grpc
import numpy as np
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu import native as jnative
from doorman_tpu.proto import doorman_pb2 as pb
from doorman_tpu.proto.grpc_api import CapacityStub
from doorman_tpu.server.config import parse_yaml_config as j_parse
from doorman_tpu.server.election import TrivialElection as JElection
from doorman_tpu.server.server import CapacityServer as JServer
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.server.config import parse_yaml_config as t_parse
from doorman_tpu_torch.server.election import TrivialElection as TElection
from doorman_tpu_torch.server.server import CapacityServer as TServer

pytestmark = pytest.mark.skipif(
    not (jnative.native_available() and tnative.native_available()),
    reason="native engine unavailable",
)

CONFIG = """
resources:
  - identifier_glob: fair*
    capacity: 120
    algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0}
  - identifier_glob: prop*
    capacity: 90
    algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
                refresh_interval: 5, learning_mode_duration: 0}
  - identifier_glob: topup*
    capacity: 75
    algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
                refresh_interval: 5, learning_mode_duration: 0,
                parameters: [{name: variant, value: topup}]}
  - identifier_glob: maxmin*
    capacity: 100
    algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0,
                parameters: [{name: variant, value: maxmin}]}
  - identifier_glob: static*
    capacity: 15
    algorithm: {kind: STATIC, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0}
  - identifier_glob: "*"
    capacity: 1000
    algorithm: {kind: NO_ALGORITHM, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0}
"""

RESOURCES = ("fair0", "prop0", "topup0", "maxmin0", "static0", "free0")
CLIENTS = tuple(f"client{i}" for i in range(6))


def _request(client, rng, has_by_key):
    req = pb.GetCapacityRequest(client_id=client)
    for rid in RESOURCES:
        r = req.resource.add()
        r.resource_id = rid
        r.priority = 1
        r.wants = float(rng.integers(1, 60))
        has = has_by_key.get((client, rid))
        if has is not None:
            r.has.capacity = has
    return req


async def _run(ticks: int):
    t = [5000.0]
    clock = lambda: t[0]  # noqa: E731
    ref = JServer("ref", JElection(), mode="batch", native_store=True,
                  solver_dtype="f64", clock=clock, tick_interval=1000.0,
                  flightrec_capacity=0)
    port = TServer("port", TElection(), mode="batch", native_store=True,
                   solver_dtype="f64", clock=clock, tick_interval=1000.0,
                   device="cpu")
    servers = [ref, port]
    ports = [await s.start(0, host="127.0.0.1") for s in servers]
    await ref.load_config(j_parse(CONFIG))
    await port.load_config(t_parse(CONFIG))
    channels = [grpc.aio.insecure_channel(f"127.0.0.1:{p}") for p in ports]
    stubs = [CapacityStub(c) for c in channels]
    rngs = [np.random.default_rng(11) for _ in servers]
    has = [{}, {}]
    compared = 0
    try:
        for d in await asyncio.gather(
            *(s.Discovery(pb.DiscoveryRequest()) for s in stubs)
        ):
            assert d.is_master
        for step in range(ticks):
            for client in CLIENTS:
                if step == 3 and client == "client2":
                    rel = pb.ReleaseCapacityRequest(
                        client_id=client, resource_id=["fair0", "prop0"],
                    )
                    for s in stubs:
                        await s.ReleaseCapacity(rel)
                    continue
                outs = []
                for i, s in enumerate(stubs):
                    out = await s.GetCapacity(_request(client, rngs[i], has[i]))
                    for r in out.response:
                        has[i][(client, r.resource_id)] = r.gets.capacity
                    outs.append(out)
                assert outs[0] == outs[1], (
                    f"step {step} {client}:\n{outs[0]}\n!=\n{outs[1]}"
                )
                compared += 1
            for s in servers:
                await s.tick_once()
            t[0] += 1.0
        # Depth-1 pipelines: each tick collects the one before it.
        assert ref._ticks_done == port._ticks_done == ticks - 1
        st = port.status()
        assert st["ticks"] == ticks - 1 and st["is_master"]
        assert st["resources"] == len(RESOURCES)
        assert st["device"]["platform"] == "cpu"
        assert st["scope"]["scoped_ticks"] + st["scope"]["full_ticks"] == ticks
    finally:
        for c in channels:
            await c.close()
        for s in servers:
            await s.stop()
    return compared


def test_port_server_answers_like_the_reference_over_loopback():
    compared = asyncio.run(_run(ticks=6))
    assert compared == 6 * len(CLIENTS) - 1


def test_port_server_serves_every_mode_and_store_and_refuses_unported_rpcs():
    """Immediate mode and the Python lease store are the defaults, as in
    the reference; a grouped config loads in batch mode and is refused
    in immediate mode; the BatchSolver ticks a lane resource on either
    store. GetServerCapacity is served (this unconfigured server is not
    the master, so it answers with a mastership redirect, as the
    reference's does), and WatchCapacity on a server without
    `stream_push` answers UNIMPLEMENTED, as the reference's does."""
    from doorman_tpu.proto import doorman_stream_pb2 as spb
    from doorman_tpu_torch.core.store import LeaseStore
    from doorman_tpu_torch.server.config import ConfigError
    from doorman_tpu_torch.solver.batch import BatchSolver

    default = TServer("x", TElection(), device="cpu")
    assert default.mode == "immediate"
    assert default._store_engine is None and default._fused_tick
    server = TServer("x", TElection(), mode="batch", native_store=True,
                     fused_tick=False, device="cpu")
    bands = t_parse(
        "groups:\n  - name: up\n    capacity: 15\n"
        "resources:\n  - identifier_glob: 'p*'\n    capacity: 10\n"
        "    capacity_group: up\n"
        "    algorithm: {kind: PRIORITY_BANDS, lease_length: 60,"
        " refresh_interval: 5}\n"
        "  - identifier_glob: '*'\n    capacity: 10\n"
        "    algorithm: {kind: FAIR_SHARE, lease_length: 60,"
        " refresh_interval: 5}\n"
    )

    async def load():
        with pytest.raises(ConfigError, match="capacity group"):
            await default.load_config(bands)
        assert default.config is None
        await server.load_config(bands)
        port = await default.start(0, host="127.0.0.1")
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                stub = CapacityStub(ch)
                out = await stub.GetServerCapacity(
                    pb.GetServerCapacityRequest(server_id="s")
                )
                assert out.HasField("mastership") and not out.response
                with pytest.raises(grpc.aio.AioRpcError) as err:
                    async for _ in stub.WatchCapacity(
                        spb.WatchCapacityRequest()
                    ):
                        pass
                assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
        finally:
            await default.stop()
        return server.get_or_create_resource("lane0")

    lane = asyncio.run(load())
    assert server.config is bands
    assert server._get_solver()._group_caps == {"up": 15.0}
    assert server.status()["fused_tick"] is False
    solver = BatchSolver(dtype=np.float64, device="cpu")
    solver.tick([lane])  # the lane part on the native store
    lane.store = LeaseStore("lane0")
    lane.store.assign("c", 60.0, 5.0, 0.0, 3.0, 1)
    lane.learning_mode_end = 0.0  # a solve, not the learning replay
    grants = solver.tick([lane])  # and on the Python store
    assert solver.ticks == 2
    assert grants == {"lane0": {"c": 3.0}}
    assert lane.store.get("c").has == 3.0
