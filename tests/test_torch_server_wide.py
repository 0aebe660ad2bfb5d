"""The port's server with lane resources wider than DENSE_MAX_K
(device="cpu"), the cap patched to 16 so that test-sized populations
cross it, as tests/test_server_wide.py does.

  * tests/test_server_wide.py's cases on the port: a wide resource
    partitions onto the chunked solver from the first tick, beside a
    narrow one on the narrow solver, and serves capacity-safe grants
    over gRPC; exactly at the cap stays narrow, one past it goes wide;
  * an overflow: a narrow resource grows past the cap between ticks.
    That tick runs through the BatchSolver's edge-list lane part over
    every resource, and the next one runs the resource on the wide
    solver;
  * the reference's server and the port's side by side over loopback
    through the same sequence (wide, narrow and growing resources, the
    overflow included): IDENTICAL GetCapacity responses after every
    tick (f64; every layout on this path adds in the reference's order
    at these widths).
"""

import asyncio
import time

import grpc
import numpy as np
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu import native as jnative
from doorman_tpu.proto import doorman_pb2 as jpb
from doorman_tpu.proto.grpc_api import CapacityStub
from doorman_tpu.server.config import parse_yaml_config as j_parse
from doorman_tpu.server.election import TrivialElection as JElection
from doorman_tpu.server.server import CapacityServer as JServer
from doorman_tpu_torch import native
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.server.config import parse_yaml_config
from doorman_tpu_torch.server.election import TrivialElection
from doorman_tpu_torch.server.server import CapacityServer

pytestmark = pytest.mark.skipif(
    not (native.native_available() and jnative.native_available()),
    reason="native engine unavailable",
)

CONFIG = """
resources:
- identifier_glob: "wide"
  capacity: 1000
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
- identifier_glob: "grow"
  capacity: 300
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
- identifier_glob: "*"
  capacity: 500
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
"""


def patch_cap(monkeypatch, cap, reference=False):
    """The dense bucket cap is read at call time in the three modules
    that partition or overflow on it (and, in the port, as the chunked
    solver's default chunk width)."""
    if reference:
        import doorman_tpu.solver.batch as b
        import doorman_tpu.solver.resident as r
        import doorman_tpu.solver.resident_wide as w
    else:
        import doorman_tpu_torch.solver.batch as b
        import doorman_tpu_torch.solver.resident as r
        import doorman_tpu_torch.solver.resident_wide as w
    for mod in (b, r, w):
        monkeypatch.setattr(mod, "DENSE_MAX_K", cap)


def bulk_load(server, resource_id, n, wants=5.0, expiry=None, tag="bulk"):
    engine = server._store_factory.__self__
    res = server.resources[resource_id]
    rids = np.full(n, res.store._rid, np.int32)
    cids = np.array(
        [engine.client_handle(f"{tag}_{resource_id}_{i}") for i in range(n)],
        np.int64,
    )
    exp = time.time() + 60.0 if expiry is None else expiry
    engine.bulk_assign(
        rids, cids, np.full(n, exp), np.full(n, 1.0), np.zeros(n),
        np.full(n, wants) + np.arange(n) % 7, np.ones(n, np.int32),
    )
    return res


def request(i, resource, wants):
    req = pb.GetCapacityRequest(client_id=f"c{i}")
    rr = req.resource.add()
    rr.resource_id = resource
    rr.wants = wants
    return req


def test_wide_resource_partitions_to_chunked_solver(monkeypatch):
    patch_cap(monkeypatch, 16)

    async def body():
        server = CapacityServer(
            "widesrv", TrivialElection(), mode="batch", tick_interval=0.05,
            native_store=True, device="cpu",
        )
        port = await server.start(0, host="127.0.0.1")
        await server.load_config(parse_yaml_config(CONFIG))
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub = CapacityStub(ch)
            # Prime both resources over gRPC, then bulk-grow "wide" past
            # the (patched) cap BEFORE the first tick partitions.
            await stub.GetCapacity(request(0, "wide", 5.0))
            await stub.GetCapacity(request(0, "narrow", 5.0))
            res = bulk_load(server, "wide", 40, wants=40.0)
            assert len(res.store) > 16
            for _ in range(200):
                if (
                    server._resident_wide is not None
                    and server._resident_wide.ticks >= 3
                    and server._resident is not None
                    and server._resident.ticks >= 3
                ):
                    break
                await asyncio.sleep(0.05)
            # Partitioned directly — no overflow fallback needed.
            assert server._resident_wide is not None
            assert server._resident_wide.ticks >= 3
            assert "wide" in server._wide_ids
            assert server._resident_wide._W == 16
            assert server._resident_wide._R == 3  # 41 clients, 3 chunks
            # The narrow resource kept the narrow resident solver.
            assert server._resident is not None
            assert server._resident.ticks >= 3
            assert "narrow" not in server._wide_ids
            assert server._solver is None or server._solver.ticks == 0
            # Oversubscribed proportional share: grants scale to
            # capacity; the store conserves exactly.
            out = await stub.GetCapacity(request(0, "wide", 40.0))
            got = out.response[0].gets.capacity
            assert 0.0 <= got <= 40.0
            assert res.store.sum_has <= 1000.0 + 1e-6
            lease_sum = sum(l.has for _c, l in res.store.items())
            assert abs(lease_sum - res.store.sum_has) < 1e-6
            st = server.status()
            assert st["wide_resources"] == ["wide"]
            assert st["wide_scope"]["scoped_ticks"] >= 1
            assert st["phase_s"]["wide.fused"] > 0.0
            assert st["phase_s"]["fused"] > 0.0
        await server.stop()

    asyncio.run(body())


@pytest.mark.parametrize("width,expect_wide", [(16, False), (17, True)])
def test_partition_boundary(monkeypatch, width, expect_wide):
    """Exactly at the cap stays narrow; one past it goes wide."""
    patch_cap(monkeypatch, 16)

    async def body():
        server = CapacityServer(
            "boundary", TrivialElection(), mode="batch", tick_interval=0.05,
            native_store=True, device="cpu",
        )
        port = await server.start(0, host="127.0.0.1")
        await server.load_config(parse_yaml_config(CONFIG))
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub = CapacityStub(ch)
            await stub.GetCapacity(request(0, "wide", 5.0))
            res = bulk_load(server, "wide", width - 1, wants=10.0)
            assert len(res.store) == width
            deadline = time.time() + 10.0
            while time.time() < deadline:
                solver = (
                    server._resident_wide if expect_wide
                    else server._resident
                )
                if solver is not None and solver.ticks >= 2:
                    break
                await asyncio.sleep(0.05)
            assert ("wide" in server._wide_ids) == expect_wide
            solver = server._resident_wide if expect_wide else server._resident
            assert solver is not None and solver.ticks >= 2
            # Demand fits capacity: everyone gets wants, conserved.
            assert res.store.sum_has <= 1000.0 + 1e-6
        await server.stop()

    asyncio.run(body())


def test_narrow_resource_overflow_ticks_through_the_batch_solver(monkeypatch):
    patch_cap(monkeypatch, 16)

    async def body():
        t = [3000.0]
        server = CapacityServer(
            "overflow", TrivialElection(), mode="batch", device="cpu",
            tick_interval=1000.0, clock=lambda: t[0],
        )
        await server.start(0, host="127.0.0.1", tick_loop=False)
        await server.load_config(parse_yaml_config(CONFIG))
        server.get_or_create_resource("narrow")
        grow = server.get_or_create_resource("grow")
        bulk_load(server, "narrow", 10, expiry=t[0] + 60)
        bulk_load(server, "grow", 12, wants=30.0, expiry=t[0] + 60)
        for _ in range(2):
            await server.tick_once()
            t[0] += 1.0
        assert server._wide_ids == set() and server._solver.ticks == 0
        # Between two ticks "grow" passes the cap without a new
        # resource: the narrow solver finds it mid-tick.
        bulk_load(server, "grow", 30, wants=30.0, expiry=t[0] + 60,
                  tag="late")
        await server.tick_once()
        solver = server._solver
        assert solver.ticks == 1
        snap = solver.last_snapshot
        assert snap.edges is not None and snap.dense is None
        assert snap.resource_ids == ["narrow", "grow"]
        assert grow.store.sum_has <= 300.0 * (1 + 1e-9)
        fair = [l.has for _c, l in grow.store.items()]
        assert len(fair) == 42 and min(fair) > 0.0
        # The next tick runs "grow" on the wide solver.
        t[0] += 1.0
        await server.tick_once()
        await server.flush_ticks()
        assert server._wide_ids == {"grow"}
        assert server._resident_wide.ticks >= 1
        assert solver.ticks == 1
        assert grow.store.sum_has <= 300.0 * (1 + 1e-9)
        await server.stop()

    asyncio.run(body())


async def _loopback(ticks):
    t = [5000.0]
    clock = lambda: t[0]  # noqa: E731
    ref = JServer("ref", JElection(), mode="batch", native_store=True,
                  solver_dtype="f64", clock=clock, tick_interval=1000.0,
                  flightrec_capacity=0)
    port = CapacityServer("port", TrivialElection(), mode="batch",
                          native_store=True, solver_dtype="f64", clock=clock,
                          tick_interval=1000.0, device="cpu")
    servers = [ref, port]
    ports = [await s.start(0, host="127.0.0.1") for s in servers]
    await ref.load_config(j_parse(CONFIG))
    await port.load_config(parse_yaml_config(CONFIG))
    channels = [grpc.aio.insecure_channel(f"127.0.0.1:{p}") for p in ports]
    stubs = [CapacityStub(c) for c in channels]
    rngs = [np.random.default_rng(41) for _ in servers]
    has = [{}, {}]
    compared = 0
    resources = ("wide", "grow", "narrow")
    try:
        for step in range(ticks):
            if step == 1:  # both grow without a new resource: an overflow
                for s in servers:
                    bulk_load(s, "wide", 40, wants=40.0, expiry=t[0] + 60)
                    bulk_load(s, "narrow", 6, expiry=t[0] + 60)
            if step == 4:  # "grow" passes the cap between two ticks
                for s in servers:
                    bulk_load(s, "grow", 25, wants=12.0, expiry=t[0] + 60)
            for c in range(5):
                outs = []
                for i, s in enumerate(stubs):
                    req = jpb.GetCapacityRequest(client_id=f"client{c}")
                    for rid in resources:
                        r = req.resource.add()
                        r.resource_id = rid
                        r.wants = float(rngs[i].integers(1, 80))
                        if (c, rid) in has[i]:
                            r.has.capacity = has[i][(c, rid)]
                    out = await s.GetCapacity(req)
                    for r in out.response:
                        has[i][(c, r.resource_id)] = r.gets.capacity
                    outs.append(out)
                assert outs[0] == outs[1], (
                    f"step {step} client{c}:\n{outs[0]}\n!=\n{outs[1]}"
                )
                compared += 1
            for s in servers:
                await s.tick_once()
            t[0] += 1.0
        assert ref._wide_ids == port._wide_ids == {"wide", "grow"}
        # Two overflow ticks ran through the BatchSolver, in both.
        assert ref._solver.ticks == port._solver.ticks == 2
        assert ref._ticks_done == port._ticks_done
    finally:
        for c in channels:
            await c.close()
        for s in servers:
            await s.stop()
    return compared


def test_port_server_answers_wide_resources_like_the_reference(monkeypatch):
    patch_cap(monkeypatch, 16)
    patch_cap(monkeypatch, 16, reference=True)
    assert asyncio.run(_loopback(ticks=9)) == 9 * 5
