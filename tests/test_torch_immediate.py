"""Immediate mode, the reference server's default, on the port.

  * the port's and the reference's immediate-mode servers side by side
    over loopback gRPC, on one fake clock and the same request sequence,
    on the Python and on the native lease store: every lane kind, a
    resource in learning mode that leaves it mid-run, an ungrouped
    PRIORITY_BANDS resource at mixed wire priorities, and
    ReleaseCapacity. Every response is equal field for field (capacity,
    expiry, refresh interval, safe capacity);
  * a config with capacity groups is refused outside batch mode, as the
    reference's tests/test_priority_e2e.py:116 pins;
  * an immediate server starts no tick loop and makes no solver;
  * the CLI's defaults for --mode, --native-store and --fused-tick are
    the reference's, and `serve` with the default flags (and --device
    cpu) runs an immediate server on the Python store that answers a
    GetCapacity.
"""

import asyncio

import grpc
import numpy as np
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu import native as jnative
from doorman_tpu.cmd import server as j_cmd
from doorman_tpu.proto import doorman_pb2 as pb
from doorman_tpu.proto.grpc_api import CapacityStub
from doorman_tpu.server.config import parse_yaml_config as j_parse
from doorman_tpu.server.election import TrivialElection as JElection
from doorman_tpu.server.server import CapacityServer as JServer
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.cmd import server as t_cmd
from doorman_tpu_torch.server.config import ConfigError
from doorman_tpu_torch.server.config import parse_yaml_config as t_parse
from doorman_tpu_torch.server.election import TrivialElection as TElection
from doorman_tpu_torch.server.server import CapacityServer as TServer

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
  - identifier_glob: bal*
    capacity: 110
    algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0,
                parameters: [{name: variant, value: balanced}]}
  - identifier_glob: pf*
    capacity: 95
    algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
                refresh_interval: 5, learning_mode_duration: 0,
                parameters: [{name: variant, value: logutil}]}
  - identifier_glob: static*
    capacity: 15
    algorithm: {kind: STATIC, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0}
  - identifier_glob: learn*
    capacity: 80
    algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 3}
  - identifier_glob: prio*
    capacity: 70
    algorithm: {kind: PRIORITY_BANDS, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0}
  - identifier_glob: "*"
    capacity: 1000
    algorithm: {kind: NO_ALGORITHM, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0}
"""

GROUPED = """
groups:
  - name: upstream
    capacity: 120
resources:
  - identifier_glob: "prio-*"
    capacity: 100
    capacity_group: upstream
    algorithm: {kind: PRIORITY_BANDS, lease_length: 60, refresh_interval: 5}
  - identifier_glob: "*"
    capacity: 100
    algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
                refresh_interval: 5}
"""

RESOURCES = ("fair0", "prop0", "topup0", "maxmin0", "bal0", "pf0",
             "static0", "learn0", "prio0", "free0")
CLIENTS = tuple(f"client{i}" for i in range(5))
PRIORITIES = (0, 1, 5, 10)


def _request(client, rng, has_by_key):
    req = pb.GetCapacityRequest(client_id=client)
    for rid in RESOURCES:
        r = req.resource.add()
        r.resource_id = rid
        r.priority = int(rng.choice(PRIORITIES))
        r.wants = float(rng.integers(1, 60))
        has = has_by_key.get((client, rid))
        if has is not None:
            r.has.capacity = has
    return req


async def _run(native: bool, steps: int):
    t = [5000.0]
    clock = lambda: t[0]  # noqa: E731
    ref = JServer("ref", JElection(), mode="immediate", native_store=native,
                  clock=clock, flightrec_capacity=0)
    port = TServer("port", TElection(), mode="immediate", native_store=native,
                   clock=clock, device="cpu")
    servers = [ref, port]
    ports = [await s.start(0, host="127.0.0.1") for s in servers]
    await ref.load_config(j_parse(CONFIG))
    await port.load_config(t_parse(CONFIG))
    channels = [grpc.aio.insecure_channel(f"127.0.0.1:{p}") for p in ports]
    stubs = [CapacityStub(c) for c in channels]
    rngs = [np.random.default_rng(41) for _ in servers]
    has = [{}, {}]
    compared = 0
    learning = set()
    try:
        for step in range(steps):
            for client in CLIENTS:
                if step == 2 and client == "client3":
                    rel = pb.ReleaseCapacityRequest(
                        client_id=client, resource_id=["fair0", "prio0"],
                    )
                    for s in stubs:
                        await s.ReleaseCapacity(rel)
                    for s in servers:
                        assert not s.resources["fair0"].store.has_client(
                            client)
                    for h in has:
                        h.pop((client, "fair0"), None)
                        h.pop((client, "prio0"), None)
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
            learning.add(port.resources["learn0"].in_learning_mode)
            t[0] += 1.0
        assert learning == {True, False}  # the window ended mid-run
        assert port._solver is None and port._ticks_done == 0
        for rid in RESOURCES:
            a, b = (
                {c: (l.expiry, l.refresh_interval, l.has, l.wants,
                     l.subclients, l.priority)
                 for c, l in s.resources[rid].store.items()}
                for s in servers
            )
            assert a == b, rid
        st = port.status()
        assert st["mode"] == "immediate" and st["native_store"] is native
        assert st["leases"] == sum(len(r.store) for r in
                                   port.resources.values())
    finally:
        for c in channels:
            await c.close()
        for s in servers:
            await s.stop()
    return compared


@pytest.mark.parametrize("store", ["python", "native"])
def test_immediate_server_answers_like_the_reference_over_loopback(store):
    native = store == "native"
    if native and not (jnative.native_available()
                       and tnative.native_available()):
        pytest.skip("native engine unavailable")
    compared = asyncio.run(_run(native, steps=6))
    assert compared == 6 * len(CLIENTS) - 1


def test_grouped_config_rejected_outside_batch_mode():
    async def scenario():
        server = TServer("s1", TElection(), device="cpu")
        with pytest.raises(ConfigError, match="capacity group"):
            await server.load_config(t_parse(GROUPED))
        assert server.config is None
        # The server keeps running and accepts a group-free config.
        await server.load_config(t_parse(CONFIG))
        assert server.is_master
        # A batch server accepts the same grouped config.
        batch = TServer("s2", TElection(), mode="batch", device="cpu")
        await batch.load_config(t_parse(GROUPED))
        assert batch.config.groups[0].capacity == 120.0

    asyncio.run(scenario())


def test_immediate_server_runs_no_tick_loop():
    async def scenario():
        server = TServer("s1", TElection(), tick_interval=0.01, device="cpu")
        batch = TServer("s2", TElection(), mode="batch", tick_interval=0.01,
                        device="cpu")
        await server.start(0, host="127.0.0.1")
        await batch.start(0, host="127.0.0.1")
        try:
            assert server._tasks == [] and len(batch._tasks) == 1
            await server.load_config(t_parse(CONFIG))
            req = pb.GetCapacityRequest(client_id="c")
            r = req.resource.add()
            r.resource_id, r.wants = "fair0", 30.0
            out = await server.GetCapacity(req, None)
            assert out.response[0].gets.capacity == 30.0
            await asyncio.sleep(0.05)
            assert server._solver is None and server._ticks_done == 0
        finally:
            await server.stop()
            await batch.stop()

    asyncio.run(scenario())


def test_cli_defaults_match_the_reference():
    ref, port = j_cmd.make_parser(), t_cmd.make_parser()
    for dest in ("mode", "native_store", "fused_tick"):
        assert port.get_default(dest) == ref.get_default(dest), dest
    args = port.parse_args(["--config", "file:x", "--no-fused-tick",
                            "--native-store", "--mode", "batch"])
    assert (args.mode, args.native_store, args.fused_tick) == (
        "batch", True, False)


def test_cli_default_flags_serve_an_immediate_python_store_server(tmp_path):
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(CONFIG)
    args = t_cmd.make_parser().parse_args(
        ["--config", f"file:{cfg}", "--port", "0", "--host", "127.0.0.1",
         "--device", "cpu", "--debug-port", "-1"]
    )

    async def scenario():
        started = asyncio.get_running_loop().create_future()
        task = asyncio.create_task(t_cmd.serve(
            args, lambda server, _debug: started.set_result(server)
        ))
        try:
            server = await asyncio.wait_for(started, 10)
            assert server.mode == "immediate"
            assert server._store_engine is None
            assert server.status()["fused_tick"] is True
            async with grpc.aio.insecure_channel(
                f"127.0.0.1:{server.port}"
            ) as ch:
                req = pb.GetCapacityRequest(client_id="c")
                r = req.resource.add()
                r.resource_id, r.wants = "prop0", 40.0
                out = await CapacityStub(ch).GetCapacity(req)
            assert out.response[0].gets.capacity == 40.0
            assert server._tasks == []
        finally:
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task

    asyncio.run(scenario())
