"""PRIORITY_BANDS with capacity groups through the port's server and
BatchSolver (device="cpu", the plain version of K3), against the JAX
package's on the native store.

  * the reference and port servers side by side over loopback gRPC, same
    YAML, clock and request sequence (clients at mixed wire priorities):
    identical GetCapacity responses after every tick, for a mixed config
    (priority resources in one group plus lane resources) and an
    all-priority one;
  * the port's BatchSolver.tick against the JAX BatchSolver.tick on
    identically filled native stores;
  * tests/test_priority_e2e.py's batch scenarios on the port: the group
    cap binds, the high band is served first, priorities survive the
    write-back, and a mixed config keeps the resident path.

f64, the reference's parity dtype, with integer demand.
"""

import asyncio

import grpc
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

from doorman_tpu import native as jnative
from doorman_tpu.core.resource import Resource as JResource
from doorman_tpu.proto import doorman_pb2 as jpb
from doorman_tpu.proto.grpc_api import CapacityStub
from doorman_tpu.server.config import parse_yaml_config as j_parse
from doorman_tpu.server.election import TrivialElection as JElection
from doorman_tpu.server.server import CapacityServer as JServer
from doorman_tpu.solver.batch import BatchSolver as JBatchSolver
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.core.resource import Resource as TResource
from doorman_tpu_torch.proto import doorman_pb2 as tpb
from doorman_tpu_torch.server.config import parse_yaml_config as t_parse
from doorman_tpu_torch.server.election import TrivialElection as TElection
from doorman_tpu_torch.server.server import CapacityServer as TServer
from doorman_tpu_torch.solver.batch import BatchSolver as TBatchSolver

pytestmark = pytest.mark.skipif(
    not (jnative.native_available() and tnative.native_available()),
    reason="native engine unavailable",
)

MIXED = """
groups:
  - name: upstream
    capacity: 150
resources:
  - identifier_glob: "prio-*"
    capacity: 100
    capacity_group: upstream
    algorithm: {kind: PRIORITY_BANDS, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0}
  - identifier_glob: "solo-*"
    capacity: 70
    algorithm: {kind: PRIORITY_BANDS, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0}
  - identifier_glob: "fair*"
    capacity: 120
    algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0}
  - identifier_glob: "*"
    capacity: 90
    algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
                refresh_interval: 5, learning_mode_duration: 0}
"""

CONFIGS = {
    "mixed": (MIXED, ("prio-a", "prio-b", "solo-c", "fair0", "prop0")),
    "all_priority": (MIXED, ("prio-a", "prio-b", "solo-c")),
}
CLIENTS = tuple(f"client{i}" for i in range(6))
PRIORITIES = (0, 1, 5, 10)


def _request(client, resources, rng, has_by_key):
    req = jpb.GetCapacityRequest(client_id=client)
    for rid in resources:
        r = req.resource.add()
        r.resource_id = rid
        r.priority = int(rng.choice(PRIORITIES))
        r.wants = float(rng.integers(1, 60))
        has = has_by_key.get((client, rid))
        if has is not None:
            r.has.capacity = has
    return req


async def _run(config: str, resources, ticks: int):
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
    await ref.load_config(j_parse(config))
    await port.load_config(t_parse(config))
    channels = [grpc.aio.insecure_channel(f"127.0.0.1:{p}") for p in ports]
    stubs = [CapacityStub(c) for c in channels]
    rngs = [np.random.default_rng(23) for _ in servers]
    has = [{}, {}]
    compared = 0
    try:
        for step in range(ticks):
            for client in CLIENTS:
                if step == 2 and client == "client1":
                    rel = jpb.ReleaseCapacityRequest(
                        client_id=client, resource_id=[resources[0]],
                    )
                    for s in stubs:
                        await s.ReleaseCapacity(rel)
                    continue
                outs = []
                for i, s in enumerate(stubs):
                    out = await s.GetCapacity(
                        _request(client, resources, rngs[i], has[i])
                    )
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
        assert ref._ticks_done == port._ticks_done
        st = port.status()
        assert st["priority"]["ticks"] == ticks
        assert set(st["priority"]["phase_s"]) == {
            "pack", "bands", "solve", "apply"
        }
        # The store of record: every lease equal in both servers.
        for rid in resources:
            a = dict(ref.resources[rid].store.items())
            b = dict(port.resources[rid].store.items())
            assert {c: (l.has, l.wants, l.priority) for c, l in a.items()} == {
                c: (l.has, l.wants, l.priority) for c, l in b.items()
            }
    finally:
        for c in channels:
            await c.close()
        for s in servers:
            await s.stop()
    return compared


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_port_server_answers_priority_bands_like_the_reference(config):
    yaml, resources = CONFIGS[config]
    compared = asyncio.run(_run(yaml, resources, ticks=4))
    assert compared == 4 * len(CLIENTS) - 1


def _prio_template(pb, name, capacity, group=None):
    tpl = pb.ResourceTemplate(
        identifier_glob=name, capacity=capacity,
        algorithm=pb.Algorithm(
            kind=pb.Algorithm.PRIORITY_BANDS, lease_length=60,
            refresh_interval=5, learning_mode_duration=0,
        ),
    )
    if group is not None:
        tpl.capacity_group = group
    return tpl


def _world(clock, engine_mod, resource_cls, pb, n_res=9, n_clients=12,
           seed=7):
    rng = np.random.default_rng(seed)
    engine = engine_mod.StoreEngine(clock=clock)
    resources = []
    for r in range(n_res):
        group = ("g0", "g1", None)[r % 3]
        res = resource_cls(
            f"p{r}", _prio_template(pb, f"p{r}", float(rng.integers(50, 400)),
                                    group),
            clock=clock, store_factory=engine.store,
        )
        resources.append(res)
        for c in range(int(rng.integers(1, n_clients + 1))):
            res.store.assign(
                f"c{r}_{c}", 60.0, 5.0, 0.0, float(rng.integers(1, 100)),
                int(rng.integers(1, 4)),
                priority=int(rng.choice(PRIORITIES)),
            )
    return resources


def test_port_batch_solver_tick_matches_the_reference():
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    res_j = _world(clock, jnative, JResource, jpb)
    res_t = _world(clock, tnative, TResource, tpb)
    groups = {"g0": 300.0, "g1": 250.0}
    ref = JBatchSolver(dtype=np.float64, clock=clock)
    port = TBatchSolver(dtype=np.float64, clock=clock, device="cpu")
    ref.set_groups(groups)
    port.set_groups(groups)
    for _ in range(2):
        got_j = ref.tick(res_j)
        got_t = port.tick(res_t)
        assert got_j.keys() == got_t.keys()
        for rid in got_j:
            assert got_j[rid].keys() == got_t[rid].keys()
            for c in got_j[rid]:
                assert got_t[rid][c] == pytest.approx(
                    got_j[rid][c], rel=1e-9, abs=1e-9
                )
        t[0] += 1.0
    assert port.ticks == 2 and port.last_tick_seconds >= 0.0
    for a, b in zip(res_j, res_t):
        ja = {c: l.has for c, l in a.store.items()}
        tb = {c: l.has for c, l in b.store.items()}
        assert ja.keys() == tb.keys()
        for c in ja:
            assert tb[c] == pytest.approx(ja[c], rel=1e-9, abs=1e-9)
    usage = {"g0": 0.0, "g1": 0.0}
    for i, res in enumerate(res_t):
        total = sum(l.has for _c, l in res.store.items())
        assert total <= res.capacity * (1 + 1e-9)
        group = ("g0", "g1", None)[i % 3]
        if group:
            usage[group] += total
    for g, cap in groups.items():
        assert usage[g] <= cap * (1 + 1e-9)


E2E_YAML = """
groups:
  - name: upstream
    capacity: 120
resources:
  - identifier_glob: "prio-*"
    capacity: 100
    capacity_group: upstream
    algorithm:
      kind: PRIORITY_BANDS
      lease_length: 60
      refresh_interval: 5
  - identifier_glob: "*"
    capacity: 100
    algorithm:
      kind: PROPORTIONAL_SHARE
      lease_length: 60
      refresh_interval: 5
"""


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _e2e_request(client, resource, wants, priority):
    req = tpb.GetCapacityRequest()
    req.client_id = client
    r = req.resource.add()
    r.resource_id = resource
    r.priority = priority
    r.wants = wants
    return req


async def _e2e_server(clock):
    server = TServer("s1", TElection(), clock=clock, mode="batch",
                     native_store=True, device="cpu")
    await server.load_config(t_parse(E2E_YAML))
    await server._on_is_master(True)
    server.became_master_at = clock() - 10_000  # skip learning mode
    return server


def test_batch_tick_priority_with_group_cap():
    async def scenario():
        clock = FakeClock()
        server = await _e2e_server(clock)
        for client, res, wants, prio in [
            ("a", "prio-a", 100.0, 5),
            ("b", "prio-a", 50.0, 1),
            ("c", "prio-b", 100.0, 5),
            ("d", "plain", 40.0, 0),
        ]:
            await server.GetCapacity(_e2e_request(client, res, wants, prio),
                                     None)
        await server.tick_once()
        await server.flush_ticks()
        stores = {
            rid: dict(server.resources[rid].store.items())
            for rid in ("prio-a", "prio-b", "plain")
        }
        # Group usage capped at 120 < 200 total capacity.
        total_prio = sum(
            l.has for s in (stores["prio-a"], stores["prio-b"])
            for l in s.values()
        )
        assert total_prio == pytest.approx(120.0, rel=1e-6)
        # Within prio-a, the high-priority client is served first.
        assert stores["prio-a"]["a"].has > 0
        assert stores["prio-a"]["b"].has == pytest.approx(0.0, abs=1e-9)
        # Symmetric resources with symmetric demand split the group cap.
        assert stores["prio-a"]["a"].has == pytest.approx(
            stores["prio-b"]["c"].has, rel=1e-9
        )
        # The plain resource solves on the lane path, unaffected.
        assert stores["plain"]["d"].has == pytest.approx(40.0)
        # Priorities survive the write-back.
        assert stores["prio-a"]["a"].priority == 5
        assert stores["prio-a"]["b"].priority == 1

    asyncio.run(scenario())


def test_mixed_config_keeps_resident_path_for_lane_resources():
    """The lane subset ticks device-resident while the priority part goes
    through the BatchSolver; no PRIORITY_BANDS row enters the resident
    tables."""
    async def scenario():
        clock = FakeClock()
        server = await _e2e_server(clock)
        for client, res, wants, prio in [
            ("a", "prio-a", 100.0, 5),
            ("b", "prio-a", 50.0, 1),
            ("d", "plain", 140.0, 0),
            ("e", "plain", 80.0, 0),
        ]:
            await server.GetCapacity(_e2e_request(client, res, wants, prio),
                                     None)
        for _ in range(3):
            await server.tick_once()
            clock.t += 1.0
        await server.flush_ticks()
        assert server._resident is not None and server._resident.ticks >= 1
        assert [r.id for r in server._resident._rows] == ["plain"]
        assert server._solver is not None and server._solver.ticks == 3
        plain = dict(server.resources["plain"].store.items())
        assert plain["d"].has + plain["e"].has == pytest.approx(100.0)
        assert plain["d"].has > plain["e"].has > 0
        prio_a = dict(server.resources["prio-a"].store.items())
        assert prio_a["a"].has == pytest.approx(100.0)
        assert prio_a["b"].has == pytest.approx(0.0, abs=1e-9)

    asyncio.run(scenario())


def test_newcomer_on_a_priority_resource_gets_the_scalar_first_response():
    async def scenario():
        clock = FakeClock()
        server = await _e2e_server(clock)
        out = await server.GetCapacity(
            _e2e_request("low", "prio-a", 80.0, 1), None
        )
        assert out.response[0].gets.capacity == 80.0
        out = await server.GetCapacity(
            _e2e_request("high", "prio-a", 100.0, 5), None
        )
        # The banded share is 100, but only unpromised capacity is
        # granted between ticks (the scalar discipline).
        assert out.response[0].gets.capacity == 20.0

    asyncio.run(scenario())
