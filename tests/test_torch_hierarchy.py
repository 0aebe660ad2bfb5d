"""The capacity tree on the port: the root role (GetServerCapacity, one
sub-lease per downstream server and priority band) and the intermediate
role (the upstream request, the parent exchange, parent-lease expiry),
held against the JAX package's servers.

  * the reference's three hierarchy cases (tests/test_hierarchy.py) on
    port servers over loopback;
  * a port root and a reference root on one fake clock, fed the same
    seeded GetServerCapacity / ReleaseCapacity sequence (band churn, a
    downstream server that vanishes until its bands lapse and the band
    sweep drops it, a release, a direct client beside the bands, a
    resource in learning mode whose bands are granted the `has` they
    report, live, absent or lapsed), in
    immediate mode on both stores and in batch mode (resident on the
    native store, the BatchSolver on the Python store, tick_once after
    every round): every response byte-equal, the stores and the band
    bookkeeping equal after every round;
  * the intermediate's upstream request byte-equal to the reference's
    from the same local leases and band sub-leases, on both stores, the
    probe request included;
  * _perform_parent_requests against a stub parent: the same templates,
    parent expiries, interval and retry number as the reference's, on
    success, on an RPC failure and on a ConfigError;
  * an intermediate's capacity falls to 0 once its parent lease expires
    with no config change, on a fake clock, on both stores and in both
    modes, answering as the reference's intermediate does;
  * mixed trees (a port intermediate under a reference root and the
    other way round) answer exactly as a tree of two reference servers;
  * `--parent` through cmd/server.py.

The port runs with device="cpu" (the kernels' plain versions), f64.
"""

import asyncio

import grpc
import numpy as np
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu import native as jnative
from doorman_tpu.algorithms import Request as JRequest
from doorman_tpu.proto import doorman_pb2 as pb
from doorman_tpu.proto.grpc_api import (
    CapacityServicer,
    CapacityStub,
    add_capacity_servicer,
)
from doorman_tpu.server.config import parse_yaml_config as j_parse
from doorman_tpu.server.election import TrivialElection as JElection
from doorman_tpu.server.server import CapacityServer as JServer
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.algorithms import Request as TRequest
from doorman_tpu_torch.cmd import server as t_cmd
from doorman_tpu_torch.server.config import parse_yaml_config as t_parse
from doorman_tpu_torch.server.election import TrivialElection as TElection
from doorman_tpu_torch.server.server import BAND_SWEEP_INTERVAL
from doorman_tpu_torch.server.server import CapacityServer as TServer
from doorman_tpu_torch.server.server import (
    _band_key,
    default_resource_template,
)

NATIVE = pytest.param(
    True, id="native-store",
    marks=pytest.mark.skipif(
        not (jnative.native_available() and tnative.native_available()),
        reason="native engine unavailable",
    ),
)
STORES = [pytest.param(False, id="python-store"), NATIVE]
MODES = [
    pytest.param("immediate", False, id="immediate-python"),
    pytest.param("immediate", True, id="immediate-native",
                 marks=NATIVE.marks),
    pytest.param("batch", True, id="batch-resident", marks=NATIVE.marks),
    pytest.param("batch", False, id="batch-python"),
]

ROOT_CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
"""

BANDED_ROOT_CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: PRIORITY_BANDS, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
"""


def run(coro):
    return asyncio.run(coro)


def capacity_request(client_id, resource_id, wants, priority=0):
    req = pb.GetCapacityRequest(client_id=client_id)
    rr = req.resource.add()
    rr.resource_id = resource_id
    rr.wants = wants
    rr.priority = priority
    return req


# ---------------------------------------------------------------------------
# The reference's cases on port servers
# ---------------------------------------------------------------------------


async def make_root():
    root = TServer(
        "root", TElection(), minimum_refresh_interval=0.0, device="cpu"
    )
    port = await root.start(0, host="127.0.0.1")
    await root.load_config(t_parse(ROOT_CONFIG))
    await asyncio.sleep(0)
    root.current_master = f"127.0.0.1:{port}"
    return root, f"127.0.0.1:{port}"


async def make_intermediate(root_addr, server_id="intermediate"):
    mid = TServer(
        server_id,
        TElection(),
        parent_addr=root_addr,
        minimum_refresh_interval=0.1,
        device="cpu",
    )
    port = await mid.start(0, host="127.0.0.1")
    await asyncio.sleep(0)
    mid.current_master = f"127.0.0.1:{port}"
    return mid, f"127.0.0.1:{port}"


def test_intermediate_converges_to_root_capacity():
    async def body():
        root, root_addr = await make_root()
        mid, mid_addr = await make_intermediate(root_addr)
        try:
            # The intermediate starts with the default "*" template
            # (capacity 0) and a 20s learning mode; disable learning so
            # the convergence is driven by the parent refresh alone.
            mid.became_master_at -= 1000
            async with grpc.aio.insecure_channel(mid_addr) as ch:
                stub = CapacityStub(ch)
                out = await stub.GetCapacity(
                    capacity_request("client-a", "res0", 40.0)
                )
                granted = out.response[0].gets.capacity
                for _ in range(60):
                    await asyncio.sleep(0.1)
                    res = mid.resources.get("res0")
                    if res is not None:
                        res.learning_mode_end = 0.0
                    out = await stub.GetCapacity(
                        capacity_request("client-a", "res0", 40.0)
                    )
                    granted = out.response[0].gets.capacity
                    if granted == 40.0:
                        break
                assert granted == 40.0, f"never converged, last={granted}"
            # The root tracks the intermediate's aggregated demand, one
            # sub-lease per priority band (client-a sent priority 0).
            root_res = root.resources.get("res0")
            assert root_res is not None
            band = _band_key("intermediate", 0)
            assert root_res.store.has_client(band)
            assert root_res.store.get(band).wants == 40.0
        finally:
            await mid.stop()
            await root.stop()

    run(body())


def test_parent_grant_becomes_intermediate_capacity():
    async def body():
        root, root_addr = await make_root()
        mid, mid_addr = await make_intermediate(root_addr)
        try:
            mid.became_master_at -= 1000
            async with grpc.aio.insecure_channel(mid_addr) as ch:
                stub = CapacityStub(ch)
                # Total wants 150 exceed the root's capacity 100, so the
                # intermediate's lease (its local capacity) caps at 100.
                for _ in range(60):
                    await asyncio.sleep(0.1)
                    res = mid.resources.get("shared")
                    if res is not None:
                        res.learning_mode_end = 0.0
                    await stub.GetCapacity(
                        capacity_request("c1", "shared", 90.0)
                    )
                    await stub.GetCapacity(
                        capacity_request("c2", "shared", 60.0)
                    )
                    res = mid.resources.get("shared")
                    if res is not None and 0 < res.capacity <= 100.0:
                        break
                res = mid.resources.get("shared")
                assert res is not None
                assert 0 < res.capacity <= 100.0
                # Grants to local clients never exceed the parent lease.
                assert res.store.sum_has <= res.capacity + 1e-9
        finally:
            await mid.stop()
            await root.stop()

    run(body())


def test_priority_bands_flow_through_two_hops():
    """Two intermediates with different band mixes against a
    PRIORITY_BANDS root (capacity 100, total demand 180): the high band
    is served in full and the leftovers split evenly across the two
    priority-1 bands, through the client->intermediate->root hops."""

    async def body():
        root, root_addr = await make_root()
        await root.load_config(t_parse(BANDED_ROOT_CONFIG))
        mid1, mid1_addr = await make_intermediate(root_addr, "mid1")
        mid2, mid2_addr = await make_intermediate(root_addr, "mid2")
        try:
            mid1.became_master_at -= 1000
            mid2.became_master_at -= 1000
            async with grpc.aio.insecure_channel(mid1_addr) as ch1, \
                    grpc.aio.insecure_channel(mid2_addr) as ch2:
                stub1, stub2 = CapacityStub(ch1), CapacityStub(ch2)
                grants = {}
                for _ in range(100):
                    await asyncio.sleep(0.1)
                    for mid in (mid1, mid2):
                        res = mid.resources.get("shared")
                        if res is not None:
                            res.learning_mode_end = 0.0
                    o_hi = await stub1.GetCapacity(
                        capacity_request("hi", "shared", 60.0, priority=2)
                    )
                    o_lo = await stub1.GetCapacity(
                        capacity_request("lo", "shared", 60.0, priority=1)
                    )
                    o_lo2 = await stub2.GetCapacity(
                        capacity_request("lo2", "shared", 60.0, priority=1)
                    )
                    grants = {
                        "hi": o_hi.response[0].gets.capacity,
                        "lo": o_lo.response[0].gets.capacity,
                        "lo2": o_lo2.response[0].gets.capacity,
                    }
                    if (
                        abs(grants["hi"] - 60.0) < 1e-6
                        and abs(grants["lo"] - 20.0) < 1e-6
                        and abs(grants["lo2"] - 20.0) < 1e-6
                    ):
                        break
                assert abs(grants["hi"] - 60.0) < 1e-6, grants
                assert abs(grants["lo"] - 20.0) < 1e-6, grants
                assert abs(grants["lo2"] - 20.0) < 1e-6, grants
            # The root sees each intermediate's bands separately, at the
            # band-correct granted amounts.
            root_res = root.resources.get("shared")
            assert root_res is not None
            hi_band = root_res.store.get(_band_key("mid1", 2))
            lo_band1 = root_res.store.get(_band_key("mid1", 1))
            lo_band2 = root_res.store.get(_band_key("mid2", 1))
            assert hi_band.wants == lo_band1.wants == lo_band2.wants == 60.0
            assert abs(hi_band.has - 60.0) < 1e-6
            assert abs(lo_band1.has - 20.0) < 1e-6
            assert abs(lo_band2.has - 20.0) < 1e-6
        finally:
            await mid1.stop()
            await mid2.stop()
            await root.stop()

    run(body())


# ---------------------------------------------------------------------------
# The root: port vs reference on one seeded sequence
# ---------------------------------------------------------------------------

PARITY_CONFIG = """
resources:
  - identifier_glob: prop*
    capacity: 300
    safe_capacity: 7
    algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 20,
                refresh_interval: 5, learning_mode_duration: 0}
  - identifier_glob: fair*
    capacity: 250
    algorithm: {kind: FAIR_SHARE, lease_length: 20, refresh_interval: 5,
                learning_mode_duration: 0}
  - identifier_glob: maxmin*
    capacity: 180
    algorithm: {kind: FAIR_SHARE, lease_length: 20, refresh_interval: 4,
                learning_mode_duration: 0,
                parameters: [{name: variant, value: maxmin}]}
  - identifier_glob: prio*
    capacity: 200
    algorithm: {kind: PRIORITY_BANDS, lease_length: 20, refresh_interval: 5,
                learning_mode_duration: 0}
  - identifier_glob: static*
    capacity: 15
    algorithm: {kind: STATIC, lease_length: 20, refresh_interval: 5,
                learning_mode_duration: 0}
  - identifier_glob: learn*
    capacity: 120
    algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 20,
                refresh_interval: 5, learning_mode_duration: 60}
  - identifier_glob: "*"
    capacity: 500
    algorithm: {kind: NO_ALGORITHM, lease_length: 20, refresh_interval: 5,
                learning_mode_duration: 0}
"""

RESOURCES = ("prop0", "prop1", "fair0", "maxmin0", "prio0", "prio1",
             "static0", "free0")
DOWNSTREAM = tuple(f"down{i}" for i in range(6))
PRIORITIES = (0, 1, 5, 10)
ROUNDS = 12
STEP_S = 4.0  # fake-clock seconds a round; leases are 20 s
VANISHED = "down5"  # silent in rounds 2-9: its bands lapse, then swept
RELEASE_ROUND = 5  # down2 releases two resources
# learn0 is in learning mode all run, so each band is granted the `has`
# it reports; only down4 asks for it, in these rounds: rounds 1 and 8
# find the band's sub-lease live (its stored grant is the band's has),
# rounds 0 and 7 find none or a lapsed one still in the store (the
# wants-proportional split of the wire has).
LEARN_ROUNDS = (0, 1, 7, 8)


def _server_request(rng, server_id, has, step):
    """One downstream server's aggregated demand: most resources, 1-2
    bands each at random wire priorities (the composition churns round
    to round), now and then a resource with no bands (the default
    band), and the previous grant as `has`."""
    req = pb.GetServerCapacityRequest(server_id=server_id)
    if server_id == "down4" and step in LEARN_ROUNDS:
        rr = req.resource.add()
        rr.resource_id = "learn0"
        # What a downstream server reports to a root that just took
        # mastership: the lease it held before.
        rr.has.capacity = float(rng.integers(1, 60))
        rr.has.expiry_time = 6000
        for prio in (1, 5):
            band = rr.wants.add()
            band.priority = prio
            band.num_clients = int(rng.integers(1, 51))
            band.wants = float(rng.integers(1, 100))
    for rid in RESOURCES:
        if rng.random() < 0.2:
            continue
        rr = req.resource.add()
        rr.resource_id = rid
        lease = has.get((server_id, rid))
        if lease is not None:
            rr.has.CopyFrom(lease)
        if rng.random() < 0.05:
            continue
        n = int(rng.integers(1, 3))
        for prio in rng.choice(PRIORITIES, size=n, replace=False):
            band = rr.wants.add()
            band.priority = int(prio)
            band.num_clients = int(rng.integers(1, 51))
            band.wants = float(rng.integers(0, 100))
    return req


def _stores(server):
    return {
        rid: sorted(res.store.dump_rows())
        for rid, res in server.resources.items()
    }


async def _root_pair(clock, mode, native, config):
    ref = JServer("ref", JElection(), mode=mode, native_store=native,
                  clock=clock, tick_interval=1000.0, flightrec_capacity=0)
    port = TServer("port", TElection(), mode=mode, native_store=native,
                   clock=clock, tick_interval=1000.0, device="cpu")
    ports = [await s.start(0, host="127.0.0.1") for s in (ref, port)]
    await ref.load_config(j_parse(config))
    await port.load_config(t_parse(config))
    await asyncio.sleep(0)
    return (ref, port), ports


@pytest.mark.parametrize("mode,native", MODES)
def test_root_answers_get_server_capacity_as_the_reference(mode, native):
    async def body():
        t = [5000.0]
        clock = lambda: t[0]  # noqa: E731
        servers, ports = await _root_pair(clock, mode, native, PARITY_CONFIG)
        ref, port = servers
        channels = [grpc.aio.insecure_channel(f"127.0.0.1:{p}")
                    for p in ports]
        stubs = [CapacityStub(c) for c in channels]
        rng = np.random.default_rng(23)
        has = {}
        compared = 0
        swept = False
        try:
            for step in range(ROUNDS):
                for server_id in DOWNSTREAM:
                    if server_id == VANISHED and 2 <= step < 10:
                        continue
                    if step == RELEASE_ROUND and server_id == "down2":
                        rel = pb.ReleaseCapacityRequest(
                            client_id=server_id,
                            resource_id=["prop0", "prio0", "ghost"],
                        )
                        outs = [await s.ReleaseCapacity(rel) for s in stubs]
                        assert outs[0] == outs[1]
                        continue
                    req = _server_request(rng, server_id, has, step)
                    outs = [await s.GetServerCapacity(req) for s in stubs]
                    a, b = (o.SerializeToString() for o in outs)
                    assert a == b, f"step {step} {server_id}:\n{outs}"
                    for r in outs[0].response:
                        has[(server_id, r.resource_id)] = r.gets
                    compared += 1
                # A direct client beside the band sub-leases.
                creq = capacity_request(
                    "client0", "prio0", float(rng.integers(1, 80)),
                    priority=int(rng.choice(PRIORITIES)),
                )
                outs = [await s.GetCapacity(creq) for s in stubs]
                assert outs[0].SerializeToString() == (
                    outs[1].SerializeToString()
                )
                if mode == "batch":
                    for s in servers:
                        await s.tick_once()
                assert _stores(ref) == _stores(port), f"step {step}"
                assert ref._server_bands == port._server_bands
                assert ref._last_band_sweep == port._last_band_sweep
                if step == 9:
                    # Lapsed since round 1 + 20 s; the sweep at this
                    # round's clock dropped its band composition.
                    swept = not any(
                        sid == VANISHED for _, sid in port._server_bands
                    )
                t[0] += STEP_S
            assert swept
            assert compared == (ROUNDS * len(DOWNSTREAM) - 8 - 1)
            if mode == "batch":
                assert ref._ticks_done == port._ticks_done > 0
        finally:
            for c in channels:
                await c.close()
            for s in servers:
                await s.stop()

    run(body())


def test_release_drops_band_sub_leases_and_the_sweep_is_time_gated():
    async def body():
        t = [5000.0]
        clock = lambda: t[0]  # noqa: E731
        (ref, port), _ = await _root_pair(
            clock, "immediate", False, PARITY_CONFIG
        )
        try:
            req = pb.GetServerCapacityRequest(server_id="mid")
            rr = req.resource.add()
            rr.resource_id = "prio0"
            for prio, wants in ((1, 30.0), (5, 20.0)):
                band = rr.wants.add()
                band.priority, band.num_clients, band.wants = prio, 2, wants
            out = await port.GetServerCapacity(req, None)
            assert out.response[0].gets.capacity == 50.0
            # safe_capacity is the template's field: unset -> 0.0.
            assert out.response[0].HasField("safe_capacity")
            assert out.response[0].safe_capacity == 0.0
            store = port.resources["prio0"].store
            assert {c for c, *_ in store.dump_rows()} == {
                _band_key("mid", 1), _band_key("mid", 5)
            }
            assert port._last_band_sweep == 5000.0
            t[0] += BAND_SWEEP_INTERVAL - 1
            await port.GetServerCapacity(req, None)
            assert port._last_band_sweep == 5000.0
            rel = pb.ReleaseCapacityRequest(client_id="mid",
                                            resource_id=["prio0"])
            await port.ReleaseCapacity(rel, None)
            assert len(store) == 0 and not port._server_bands
            # A mastership change forgets every band composition.
            await port.GetServerCapacity(req, None)
            assert port._server_bands
            await port._on_is_master(True)
            assert not port._server_bands and not port.resources
        finally:
            await ref.stop()
            await port.stop()

    run(body())


# ---------------------------------------------------------------------------
# The intermediate: upstream request, parent exchange, parent expiry
# ---------------------------------------------------------------------------

MID_CONFIG = """
resources:
  - identifier_glob: prop*
    capacity: 40
    algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 20,
                refresh_interval: 5, learning_mode_duration: 0}
  - identifier_glob: prio*
    capacity: 25
    algorithm: {kind: PRIORITY_BANDS, lease_length: 20, refresh_interval: 5,
                learning_mode_duration: 0}
  - identifier_glob: "*"
    capacity: 30
    algorithm: {kind: FAIR_SHARE, lease_length: 20, refresh_interval: 5,
                learning_mode_duration: 0}
"""


def _parent_repo(parse, capacities):
    """A parent-derived repository (as the updater installs it): one
    template per resource, then the default "*"."""
    text = "resources:\n"
    for rid, (cap, kind) in capacities.items():
        text += (
            f"  - identifier_glob: {rid}\n    capacity: {cap}\n"
            f"    algorithm: {{kind: {kind}, lease_length: 20,"
            " refresh_interval: 5, learning_mode_duration: 0}\n"
        )
    repo = parse(text + "  - identifier_glob: '*'\n    capacity: 0\n"
                 "    algorithm: {kind: FAIR_SHARE, lease_length: 20,"
                 " refresh_interval: 1, learning_mode_duration: 20}\n")
    return repo


async def _mid_pair(clock, native, mode="immediate", parent="127.0.0.1:1"):
    ref = JServer("mid", JElection(), parent_addr=parent, mode=mode,
                  native_store=native, clock=clock, flightrec_capacity=0,
                  minimum_refresh_interval=0.5, tick_interval=1000.0)
    port = TServer("mid", TElection(), parent_addr=parent, mode=mode,
                   native_store=native, clock=clock, device="cpu",
                   minimum_refresh_interval=0.5, tick_interval=1000.0)
    return ref, port


@pytest.mark.parametrize("native", STORES)
def test_upstream_request_equals_the_reference(native):
    async def body():
        t = [5000.0]
        clock = lambda: t[0]  # noqa: E731
        ref, port = await _mid_pair(clock, native)
        await ref.load_config(j_parse(MID_CONFIG))
        await port.load_config(t_parse(MID_CONFIG))
        await asyncio.sleep(0)
        try:
            # No local demand: the probe request.
            probe = port._build_server_capacity_request()
            assert probe.resource[0].resource_id == "*"
            assert probe.SerializeToString() == (
                ref._build_server_capacity_request().SerializeToString()
            )
            rng = np.random.default_rng(3)
            rids = ("prop0", "prop1", "prio0", "prio1", "other0", "idle0")
            for _ in range(60):
                rid = str(rng.choice(rids[:-1]))
                client = f"c{int(rng.integers(12))}"
                prio = int(rng.choice(PRIORITIES))
                wants = float(rng.integers(0, 60))
                sub = int(rng.integers(1, 4))
                ref._decide(rid, JRequest(client, 0.0, wants, sub,
                                          priority=prio))
                port._decide(rid, TRequest(client, 0.0, wants, sub,
                                           priority=prio))
            for s in (ref, port):
                # A resource whose demand is all zero sends no line.
                s.get_or_create_resource("idle0")
            # A deeper intermediate's bands on this one.
            req = pb.GetServerCapacityRequest(server_id="leaf")
            for rid in ("prop0", "prio1"):
                rr = req.resource.add()
                rr.resource_id = rid
                for prio, wants in ((10, 12.0), (1, 7.0)):
                    band = rr.wants.add()
                    band.priority, band.num_clients = prio, 3
                    band.wants = wants
            for s, req_t in ((ref, JRequest), (port, TRequest)):
                # A band whose demand is all zero sends no band.
                s._decide("prop0", req_t("zero", 0.0, 0.0, 1, priority=7))
            outs = [await s.GetServerCapacity(req, None) for s in (ref, port)]
            assert outs[0].SerializeToString() == outs[1].SerializeToString()
            # Parent leases: live on prop0 / prio0, lapsed on prop1.
            caps = {"prop0": (40, "PROPORTIONAL_SHARE"),
                    "prop1": (35, "PROPORTIONAL_SHARE"),
                    "prio0": (25, "PRIORITY_BANDS")}
            expiry = {"prop0": 5030.0, "prop1": 4990.0, "prio0": 5010.5}
            await ref.load_config(_parent_repo(j_parse, caps), expiry)
            await port.load_config(_parent_repo(t_parse, caps), expiry)
            a = ref._build_server_capacity_request()
            b = port._build_server_capacity_request()
            assert b.SerializeToString() == a.SerializeToString()
            lines = {r.resource_id: r for r in b.resource}
            assert "idle0" not in lines
            assert lines["prop0"].has.capacity == 40.0
            assert lines["prop0"].has.expiry_time == 5030
            assert not lines["prop1"].HasField("has")
            assert [w.priority for w in lines["prio1"].wants]
            assert 7 not in [w.priority for w in lines["prop0"].wants]
        finally:
            await ref.stop()
            await port.stop()

    run(body())


class StubParent(CapacityServicer):
    """A parent that grants each requested resource a fixed share, with
    per-resource expiries and intervals, plus a line for a resource the
    intermediate does not hold and the probe's "*". `mode` "fail" aborts
    the RPC; "bad" answers an algorithm the config validation refuses."""

    def __init__(self):
        self.mode = "ok"
        self.requests = []

    async def GetServerCapacity(self, request, context):
        self.requests.append(request)
        if self.mode == "fail":
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, "refused")
        out = pb.GetServerCapacityResponse()
        ids = [r.resource_id for r in request.resource] + ["ghost", "*"]
        for i, rid in enumerate(ids):
            pr = out.response.add()
            pr.resource_id = rid
            pr.gets.capacity = 10.0 * (i + 1) + 0.25
            pr.gets.expiry_time = 5100 + i
            pr.gets.refresh_interval = 3 + i
            pr.algorithm.kind = pb.Algorithm.PROPORTIONAL_SHARE
            pr.algorithm.lease_length = 1 if self.mode == "bad" else 60
            pr.algorithm.refresh_interval = 3 + i
            pr.algorithm.learning_mode_duration = 0
            pr.safe_capacity = float(i)
        return out


async def _stub_parent():
    stub = StubParent()
    server = grpc.aio.server()
    add_capacity_servicer(server, stub)
    port = server.add_insecure_port("127.0.0.1:0")
    await server.start()
    return stub, server, f"127.0.0.1:{port}"


def _mid_state(server):
    return (
        server.config.SerializeToString(),
        {
            rid: (res.parent_expiry, res.capacity,
                  res.template.SerializeToString())
            for rid, res in server.resources.items()
        },
    )


def test_parent_exchange_equals_the_reference():
    async def body():
        t = [5000.0]
        clock = lambda: t[0]  # noqa: E731
        stub, parent, addr = await _stub_parent()
        ref, port = await _mid_pair(clock, False, parent=addr)
        try:
            for s in (ref, port):
                await s.load_config(
                    pb.ResourceRepository(
                        resources=[default_resource_template()]
                    ), {},
                )
            await asyncio.sleep(0)
            for s, req_t in ((ref, JRequest), (port, TRequest)):
                for rid, wants in (("a", 30.0), ("b", 12.0), ("c", 0.0)):
                    s._decide(rid, req_t("c1", 0.0, wants, 1, priority=2))
            # Success: three templates (c sends no demand line), the
            # "*" default, expiries, the interval (floored at the
            # minimum refresh interval) and retry 0.
            got = [await s._perform_parent_requests(4) for s in (ref, port)]
            assert got[0] == got[1] == (3.0, 0)
            assert stub.requests[0] == stub.requests[1]
            assert _mid_state(ref) == _mid_state(port)
            assert port.resources["a"].parent_expiry == 5100.0
            assert port.resources["a"].capacity == 10.25
            assert port.resources["c"].parent_expiry is None
            # RPC failure: backoff at the retry number, and the config
            # stays.
            stub.mode = "fail"
            got = [await s._perform_parent_requests(3) for s in (ref, port)]
            assert got[0] == got[1] and got[1][1] == 4
            assert _mid_state(ref) == _mid_state(port)
            # ConfigError (lease shorter than the refresh interval): the
            # same backoff; the last good config stays.
            stub.mode = "bad"
            before = _mid_state(port)
            got = [await s._perform_parent_requests(1) for s in (ref, port)]
            assert got[0] == got[1] and got[1][1] == 2
            assert _mid_state(port) == before == _mid_state(ref)
        finally:
            await ref.stop()
            await port.stop()
            await parent.stop(None)

    run(body())


EXPIRY_PARENT_LEASE = 10  # seconds the stub parent's grant lives


class ExpiringParent(CapacityServicer):
    """Grants every resource capacity 50 until `now + 10`."""

    def __init__(self, clock):
        self.clock = clock

    async def GetServerCapacity(self, request, context):
        out = pb.GetServerCapacityResponse()
        for r in request.resource:
            pr = out.response.add()
            pr.resource_id = r.resource_id
            pr.gets.capacity = 50.0
            pr.gets.expiry_time = int(self.clock()) + EXPIRY_PARENT_LEASE
            pr.gets.refresh_interval = 2
            pr.algorithm.kind = (
                pb.Algorithm.PRIORITY_BANDS if r.resource_id == "prio"
                else pb.Algorithm.PROPORTIONAL_SHARE
            )
            pr.algorithm.lease_length = 8
            pr.algorithm.refresh_interval = 2
            pr.algorithm.learning_mode_duration = 0
        return out


@pytest.mark.parametrize("mode,native", MODES)
def test_capacity_falls_to_zero_when_the_parent_lease_expires(mode, native):
    """One parent exchange, then the parent goes silent: no config load,
    no epoch bump. Past the parent lease's expiry the intermediate's
    capacity is 0 (Resource.capacity in immediate mode and for the
    BatchSolver, the resident config table's parent expiry in the
    resident tick), answering exactly as the reference's intermediate."""

    async def body():
        t = [5000.0]
        clock = lambda: t[0]  # noqa: E731
        parent_svc = ExpiringParent(clock)
        parent = grpc.aio.server()
        add_capacity_servicer(parent, parent_svc)
        parent_addr = f"127.0.0.1:{parent.add_insecure_port('127.0.0.1:0')}"
        await parent.start()
        ref, port = await _mid_pair(clock, native, mode=mode,
                                    parent="")
        servers = (ref, port)
        ports = [await s.start(0, host="127.0.0.1") for s in servers]
        for s in servers:
            # Started as a root so no updater runs on the real clock;
            # the exchange below is driven by hand.
            s.parent_addr = parent_addr
            await s.load_config(
                pb.ResourceRepository(
                    resources=[default_resource_template()]
                ), {},
            )
        await asyncio.sleep(0)
        channels = [grpc.aio.insecure_channel(f"127.0.0.1:{p}")
                    for p in ports]
        stubs = [CapacityStub(c) for c in channels]
        asks = (("c0", "lane", 30.0, 0), ("c1", "lane", 40.0, 0),
                ("c0", "prio", 45.0, 5), ("c1", "prio", 30.0, 1))
        seen = {}
        try:
            for step in range(12):
                for client, rid, wants, prio in asks:
                    req = capacity_request(client, rid, wants, prio)
                    outs = [await s.GetCapacity(req) for s in stubs]
                    a, b = (o.SerializeToString() for o in outs)
                    assert a == b, f"step {step}: {outs}"
                    seen.setdefault(step, []).append(
                        outs[1].response[0].gets.capacity
                    )
                if step == 0:
                    for s in servers:
                        for res in s.resources.values():
                            res.learning_mode_end = 0.0
                        assert await s._perform_parent_requests(0) == (2.0, 0)
                if mode == "batch":
                    for s in servers:
                        await s.tick_once()
                assert _stores(ref) == _stores(port), f"step {step}"
                t[0] += 2.0
            expiry = 5000 + EXPIRY_PARENT_LEASE
            res = port.resources["lane"]
            assert res.parent_expiry == expiry and res.capacity == 0.0
            # Granted while the parent lease lived, 0 after it lapsed.
            assert sum(seen[3]) > 0
            assert seen[11] == [0.0] * len(asks)
        finally:
            for c in channels:
                await c.close()
            for s in servers:
                await s.stop()
            await parent.stop(None)

    run(body())


# ---------------------------------------------------------------------------
# Mixed trees and the CLI
# ---------------------------------------------------------------------------

TREE_ROOT_CONFIG = """
resources:
  - identifier_glob: banded
    capacity: 100
    algorithm: {kind: PRIORITY_BANDS, lease_length: 60, refresh_interval: 1,
                learning_mode_duration: 0}
  - identifier_glob: "*"
    capacity: 100
    algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
                refresh_interval: 1, learning_mode_duration: 0}
"""


async def _tree(root_cls, mid_cls):
    """Root and intermediate of the given packages on one fake clock;
    four clients on the intermediate over loopback, the parent exchange
    driven by hand once a round. Returns every response's bytes."""
    t = [5000.0]
    clock = lambda: t[0]  # noqa: E731

    def make(cls, sid):
        if cls is JServer:
            return JServer(sid, JElection(), clock=clock,
                           minimum_refresh_interval=0.5,
                           flightrec_capacity=0)
        return TServer(sid, TElection(), clock=clock,
                       minimum_refresh_interval=0.5, device="cpu")

    root, mid = make(root_cls, "root"), make(mid_cls, "mid")
    root_port = await root.start(0, host="127.0.0.1")
    await root.load_config(j_parse(TREE_ROOT_CONFIG))
    mid_port = await mid.start(0, host="127.0.0.1")
    mid.parent_addr = f"127.0.0.1:{root_port}"
    await mid.load_config(
        pb.ResourceRepository(resources=[default_resource_template()]), {}
    )
    await asyncio.sleep(0)
    asks = (("c1", "shared", 90.0, 0), ("c2", "shared", 60.0, 0),
            ("hi", "banded", 60.0, 2), ("lo", "banded", 70.0, 1))
    out = []
    try:
        async with grpc.aio.insecure_channel(f"127.0.0.1:{mid_port}") as ch:
            stub = CapacityStub(ch)
            for step in range(5):
                for client, rid, wants, prio in asks:
                    resp = await stub.GetCapacity(
                        capacity_request(client, rid, wants, prio)
                    )
                    out.append(resp.SerializeToString())
                for res in mid.resources.values():
                    res.learning_mode_end = 0.0
                out.append(await mid._perform_parent_requests(0))
                t[0] += 1.0
        last = {r.resource_id: r.gets.capacity for r in (
            pb.GetCapacityResponse.FromString(b).response[0]
            for b in out[-5:-1]
        )}
        rows = {c: l for c, *l in root.resources["banded"].store.dump_rows()}
    finally:
        await mid.stop()
        await root.stop()
    return out, last, rows


@pytest.mark.parametrize("root_cls,mid_cls", [
    pytest.param(TServer, JServer, id="reference-mid-under-port-root"),
    pytest.param(JServer, TServer, id="port-mid-under-reference-root"),
    pytest.param(TServer, TServer, id="port-tree"),
])
def test_mixed_trees_answer_as_a_reference_tree(root_cls, mid_cls):
    want, want_last, want_rows = run(_tree(JServer, JServer))
    got, _, rows = run(_tree(root_cls, mid_cls))
    assert got == want
    assert rows == want_rows
    # The reference tree itself: the banded root served the high band
    # in full and the low band the rest.
    assert set(want_last) == {"shared", "banded"}
    assert sorted(r[2] for r in want_rows.values()) == [40.0, 60.0]


def test_parent_flag_makes_the_cli_server_an_intermediate(tmp_path):
    cfg = tmp_path / "root.yml"
    cfg.write_text(ROOT_CONFIG)
    parser = t_cmd.make_parser()
    with pytest.raises(SystemExit, match="needs --config"):
        run(t_cmd.serve(parser.parse_args(
            ["--port", "0", "--device", "cpu"]
        )))

    async def body():
        started = {}
        root_task = asyncio.create_task(t_cmd.serve(
            parser.parse_args(["--config", f"file:{cfg}", "--port", "0",
                               "--host", "127.0.0.1", "--device", "cpu"]),
            on_started=lambda s: started.setdefault("root", s),
        ))
        while "root" not in started:
            await asyncio.sleep(0.01)
        root_addr = f"127.0.0.1:{started['root'].port}"
        mid_task = asyncio.create_task(t_cmd.serve(
            parser.parse_args(["--parent", root_addr, "--port", "0",
                               "--host", "127.0.0.1", "--device", "cpu",
                               "--server-id", "mid"]),
            on_started=lambda s: started.setdefault("mid", s),
        ))
        try:
            while "mid" not in started:
                await asyncio.sleep(0.01)
            mid = started["mid"]
            assert mid.parent_addr == root_addr
            assert [tpl.identifier_glob for tpl in mid.config.resources] == [
                "*"
            ]
            mid._decide("res0", TRequest("c1", 0.0, 25.0, 1, priority=3))
            # The root's refresh interval (1 s) floored at the CLI's
            # --minimum-refresh-interval default.
            assert await mid._perform_parent_requests(0) == (5.0, 0)
            root_res = started["root"].resources["res0"]
            assert root_res.store.get(_band_key("mid", 3)).wants == 25.0
            assert mid.resources["res0"].capacity == 25.0
        finally:
            for task in (mid_task, root_task):
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass

    run(body())
