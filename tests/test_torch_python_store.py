"""The Python lease store (the reference server's default) through the
port's BatchSolver and batch server, on the CPU (device="cpu": the plain
versions of K3), against the JAX package's.

  * core.snapshot: `pack_snapshot`, `Snapshot.keys` and `unpack` against
    the reference's, array for array;
  * BatchSolver.tick on Python stores against the reference's, ticks of
    churn over every lane kind and PRIORITY_BANDS resources in two
    capacity groups and ungrouped, at f64 and f32. The lane part (the
    edge list) is bit-identical, as tests/test_torch_edges.py pins the
    edge-list solve. The priority part: grouped rows within 1e-9 (f64)
    / 1e-5 (f32) of capacity (ROADMAP C: the theta bisection turns an
    ulp of group usage into another feasible theta), ungrouped rows
    within 1e-12 / F32_PARITY_REL_BOUND of max(capacity, max wants), as
    tests/test_torch_priority.py holds the banded water-fill;
  * the port's and the reference's batch servers on the Python store
    over loopback: identical GetCapacity responses after every tick (f64,
    integer demand);
  * the group-cap tick of the reference's tests/test_priority_e2e.py:172
    on both stores;
  * the port's Python-store and native-store priority parts on the same
    leases: the same tables, the same grants bit for bit.
"""

import asyncio

import grpc
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401

from doorman_tpu.core.resource import Resource as JResource
from doorman_tpu.core.snapshot import ResourceSpec as JSpec
from doorman_tpu.core.snapshot import pack_snapshot as j_pack
from doorman_tpu.core.store import LeaseStore as JStore
from doorman_tpu.proto import doorman_pb2 as jpb
from doorman_tpu.proto.grpc_api import CapacityStub
from doorman_tpu.server.config import parse_yaml_config as j_parse
from doorman_tpu.server.election import TrivialElection as JElection
from doorman_tpu.server.server import CapacityServer as JServer
from doorman_tpu.solver.batch import BatchSolver as JBatchSolver
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
from doorman_tpu_torch.core.resource import Resource as TResource
from doorman_tpu_torch.core.snapshot import ResourceSpec as TSpec
from doorman_tpu_torch.core.snapshot import pack_snapshot as t_pack
from doorman_tpu_torch.core.store import LeaseStore as TStore
from doorman_tpu_torch.proto import doorman_pb2 as tpb
from doorman_tpu_torch.server.config import parse_yaml_config as t_parse
from doorman_tpu_torch.server.election import TrivialElection as TElection
from doorman_tpu_torch.server.server import CapacityServer as TServer
from doorman_tpu_torch.solver.batch import BatchSolver as TBatchSolver

DTYPES = {"f64": np.float64, "f32": np.float32}
PRIORITIES = (0, 1, 5, 10)
# (wire kind, variant) of each lane resource: every lane of the solve.
LANES = ((0, None), (1, None), (2, None), (3, None), (2, "topup"),
         (3, "maxmin"), (3, "balanced"), (2, "logutil"))
GROUPS = {"g0": 260.0, "g1": 180.0}


def _template(pb, r):
    """Lane resources first, then PRIORITY_BANDS ones in g0, g1 or none."""
    if r < len(LANES):
        kind, variant = LANES[r]
        params = ([pb.NamedParameter(name="variant", value=variant)]
                  if variant else [])
        cap = 15.0 if kind == 1 else 80.0 + 37.0 * r
        return pb.ResourceTemplate(
            identifier_glob=f"r{r}", capacity=cap,
            algorithm=pb.Algorithm(kind=kind, lease_length=60,
                                   refresh_interval=5, parameters=params),
        )
    tpl = pb.ResourceTemplate(
        identifier_glob=f"r{r}", capacity=50.0 + 23.0 * r,
        algorithm=pb.Algorithm(kind=pb.Algorithm.PRIORITY_BANDS,
                               lease_length=60, refresh_interval=5),
    )
    group = ("g0", "g1", None)[r % 3]
    if group:
        tpl.capacity_group = group
    return tpl


def _world(clock, resource_cls, store_cls, pb, n_prio=6, seed=5,
           store_factory=None):
    """Python-store resources (or, with `store_factory`, any store):
    integer demand, 1-3 subclients, mixed wire priorities, up to 40
    clients a resource."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(len(LANES) + n_prio):
        factory = store_factory or (lambda rid: store_cls(rid, clock=clock))
        res = resource_cls(f"r{r}", _template(pb, r), clock=clock,
                           store_factory=factory)
        for c in range(int(rng.integers(3, 41))):
            res.store.assign(
                f"c{r}_{c}", 60.0, 5.0, 0.0, float(rng.integers(0, 100)),
                int(rng.integers(1, 4)),
                priority=int(rng.choice(PRIORITIES)),
            )
        out.append(res)
    return out


def _churn(resources, step, rng):
    """New demand on a few leases (has, subclients and priority kept),
    a release and a new client."""
    for res in resources[step % 3::3]:
        client, lease = next(iter(res.store.items()))
        res.store.assign(client, 60.0, 5.0, lease.has,
                         float(rng.integers(0, 100)), lease.subclients,
                         priority=lease.priority)
    victim = resources[(step * 5) % len(resources)]
    victim.store.release(next(iter(victim.store.items()))[0])
    grow = resources[(step * 7 + 1) % len(resources)]
    grow.store.assign(f"new{step}", 60.0, 5.0, 0.0,
                      float(rng.integers(0, 100)), 2,
                      priority=int(rng.choice(PRIORITIES)))


def test_pack_snapshot_keys_and_unpack_match_the_reference():
    clock = lambda: 100.0  # noqa: E731
    res_j = _world(clock, JResource, JStore, jpb, n_prio=0)
    res_t = _world(clock, TResource, TStore, tpb, n_prio=0)
    specs = [(r.id, r.capacity, int(r.template.algorithm.kind), i == 3,
              float(r.template.capacity)) for i, r in enumerate(res_t)]

    def rows(resources):
        by_id = {r.id: r for r in resources}
        return lambda rid: [(c, l.wants, l.has, l.subclients)
                            for c, l in by_id[rid].store.items()]

    for dt in DTYPES.values():
        js = j_pack([JSpec(*s) for s in specs], rows(res_j), dtype=dt)
        ts = t_pack([TSpec(*s) for s in specs], rows(res_t), dtype=dt,
                    to_device=torch.from_numpy)
        assert ts.num_edges == js.num_edges > 0
        for f in ("resource", "wants", "has", "subclients", "active"):
            a, b = np.asarray(getattr(js.edges, f)), getattr(ts.edges, f)
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f)
        for f in ("capacity", "algo_kind", "learning", "static_capacity"):
            a, b = np.asarray(getattr(js.resources, f)), getattr(
                ts.resources, f)
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f)
        assert ts.keys() == js.keys() == ts.edge_keys
        assert ts.learning == js.learning and ts.engine is None
        gets = np.arange(len(ts.edges.wants), dtype=dt) / 7.0
        assert ts.unpack(gets) == js.unpack(gets)
    assert len(t_pack([], rows(res_t)).keys()) == 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_batch_solver_on_python_stores_matches_the_reference(dtype):
    dt = DTYPES[dtype]
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    res_j = _world(clock, JResource, JStore, jpb)
    res_t = _world(clock, TResource, TStore, tpb)
    ref = JBatchSolver(dtype=dt, clock=clock)
    port = TBatchSolver(dtype=dt, clock=clock, device="cpu")
    ref.set_groups(GROUPS)
    port.set_groups(GROUPS)
    n_lane = len(LANES)
    grp_tol = 1e-9 if dtype == "f64" else 1e-5
    band_tol = 1e-12 if dtype == "f64" else F32_PARITY_REL_BOUND
    rng_j, rng_t = (np.random.default_rng(13) for _ in range(2))
    for step in range(4):
        if step:
            _churn(res_j, step, rng_j)
            _churn(res_t, step, rng_t)
        got_j = ref.tick(res_j)
        got_t = port.tick(res_t)
        assert got_j.keys() == got_t.keys()
        for i, (rj, rt) in enumerate(zip(res_j, res_t)):
            a, b = got_j.get(rj.id, {}), got_t.get(rt.id, {})
            assert a.keys() == b.keys() == dict(rt.store.items()).keys()
            if i < n_lane:
                assert a == b, f"step {step} lane resource {rt.id}"
                continue
            grouped = rt.template.HasField("capacity_group")
            wants = max(l.wants for _c, l in rt.store.items())
            scale = rt.capacity if grouped else max(rt.capacity, wants)
            tol = grp_tol if grouped else band_tol
            for c in a:
                assert abs(b[c] - a[c]) <= tol * scale, (step, rt.id, c)
        snap = port.last_snapshot
        assert snap.engine is None and snap.edges is not None
        part = snap.priority_part
        assert part.engine is None and len(part.clients) == len(res_t) - n_lane
        # The store of record holds the grants; caps hold.
        usage = dict.fromkeys(GROUPS, 0.0)
        for rt in res_t:
            total = sum(l.has for _c, l in rt.store.items())
            for c, l in rt.store.items():
                assert l.has == got_t[rt.id][c]
            if rt.template.algorithm.kind in (2, 3):
                assert total <= rt.capacity * (1 + 1e-6)
            if rt.template.HasField("capacity_group"):
                usage[rt.template.capacity_group] += total
        for g, cap in GROUPS.items():
            assert usage[g] <= cap * (1 + 1e-6), g
        t[0] += 1.0
    assert port.ticks == 4 and set(port.phase_s) == {
        "pack", "bands", "solve", "apply"}


def test_python_store_write_back_rules():
    """Grants only (expiry untouched); a client released between the pack
    and the write-back stays released; a resource in learning mode keeps
    the store's live has (a report landing mid-solve wins)."""
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    res = _world(clock, TResource, TStore, tpb, n_prio=3)
    learn_lane, learn_prio = res[3], res[len(LANES)]
    for r in (learn_lane, learn_prio):
        r.learning_mode_end = t[0] + 10.0
    solver = TBatchSolver(dtype=np.float64, clock=clock, device="cpu")
    snap = solver.prepare(res)
    gets = solver.solve(snap)
    t[0] += 1.0
    gone = [(r, next(iter(r.store.items()))[0]) for r in (res[2], res[-1])]
    for r, c in gone:
        r.store.release(c)
    for r in (learn_lane, learn_prio):
        c, lease = next(iter(r.store.items()))
        r.store.assign(c, 60.0, 5.0, 7.25, lease.wants, lease.subclients,
                       priority=lease.priority)
    expiry = {(r.id, c): l.expiry for r in res for c, l in r.store.items()}
    out = solver.apply(res, snap, gets)
    for r, c in gone:
        assert not r.store.has_client(c) and c not in out.get(r.id, {})
    for r in (learn_lane, learn_prio):
        c, lease = next(iter(r.store.items()))
        assert lease.has == out[r.id][c] == 7.25
    assert {(r.id, c): l.expiry for r in res
            for c, l in r.store.items()} == expiry


LOOPBACK = """
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
  - identifier_glob: "topup*"
    capacity: 75
    algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
                refresh_interval: 5, learning_mode_duration: 0,
                parameters: [{name: variant, value: topup}]}
  - identifier_glob: "*"
    capacity: 90
    algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
                refresh_interval: 5, learning_mode_duration: 0}
"""
LOOPBACK_RESOURCES = ("prio-a", "prio-b", "solo-c", "fair0", "topup0",
                      "prop0")
CLIENTS = tuple(f"client{i}" for i in range(6))


def _request(client, rng, has_by_key):
    req = jpb.GetCapacityRequest(client_id=client)
    for rid in LOOPBACK_RESOURCES:
        r = req.resource.add()
        r.resource_id = rid
        r.priority = int(rng.choice(PRIORITIES))
        r.wants = float(rng.integers(1, 60))
        has = has_by_key.get((client, rid))
        if has is not None:
            r.has.capacity = has
    return req


async def _loopback(ticks: int):
    t = [5000.0]
    clock = lambda: t[0]  # noqa: E731
    ref = JServer("ref", JElection(), mode="batch", solver_dtype="f64",
                  clock=clock, tick_interval=1000.0, flightrec_capacity=0)
    port = TServer("port", TElection(), mode="batch", solver_dtype="f64",
                   clock=clock, tick_interval=1000.0, device="cpu")
    servers = [ref, port]
    ports = [await s.start(0, host="127.0.0.1") for s in servers]
    await ref.load_config(j_parse(LOOPBACK))
    await port.load_config(t_parse(LOOPBACK))
    channels = [grpc.aio.insecure_channel(f"127.0.0.1:{p}") for p in ports]
    stubs = [CapacityStub(c) for c in channels]
    rngs = [np.random.default_rng(19) for _ in servers]
    has = [{}, {}]
    compared = 0
    try:
        for step in range(ticks):
            for client in CLIENTS:
                if step == 2 and client == "client1":
                    rel = jpb.ReleaseCapacityRequest(
                        client_id=client, resource_id=["prio-a", "fair0"],
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
        assert ref._ticks_done == port._ticks_done == ticks
        st = port.status()
        assert st["native_store"] is False
        assert st["priority"]["ticks"] == ticks and st["scope"] is None
        assert st["leases"] == sum(len(r.store)
                                   for r in port.resources.values())
        for rid in LOOPBACK_RESOURCES:
            a, b = (
                {c: (l.has, l.wants, l.priority, l.expiry)
                 for c, l in s.resources[rid].store.items()}
                for s in servers
            )
            assert a == b, rid
    finally:
        for c in channels:
            await c.close()
        for s in servers:
            await s.stop()
    return compared


def test_python_store_batch_server_answers_like_the_reference():
    compared = asyncio.run(_loopback(ticks=4))
    assert compared == 4 * len(CLIENTS) - 1


GROUP_CAP_YAML = """
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


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_batch_tick_priority_with_group_cap(native):
    if native and not tnative.native_available():
        pytest.skip("native engine unavailable")

    async def scenario():
        t = [1000.0]
        clock = lambda: t[0]  # noqa: E731
        server = TServer("s1", TElection(), clock=clock, mode="batch",
                         native_store=native, device="cpu")
        await server.load_config(t_parse(GROUP_CAP_YAML))
        await server._on_is_master(True)
        server.became_master_at = clock() - 10_000  # skip learning mode
        for client, res, wants, prio in [
            ("a", "prio-a", 100.0, 5),
            ("b", "prio-a", 50.0, 1),
            ("c", "prio-b", 100.0, 5),
            ("d", "plain", 40.0, 0),
        ]:
            req = tpb.GetCapacityRequest(client_id=client)
            r = req.resource.add()
            r.resource_id, r.priority, r.wants = res, prio, wants
            await server.GetCapacity(req, None)
        await server.tick_once()
        await server.flush_ticks()
        stores = {
            rid: dict(server.resources[rid].store.items())
            for rid in ("prio-a", "prio-b", "plain")
        }
        total_prio = sum(
            l.has for s in (stores["prio-a"], stores["prio-b"])
            for l in s.values()
        )
        assert total_prio == pytest.approx(120.0, rel=1e-6)
        assert stores["prio-a"]["a"].has > 0
        assert stores["prio-a"]["b"].has == pytest.approx(0.0, abs=1e-9)
        assert stores["prio-a"]["a"].has == pytest.approx(
            stores["prio-b"]["c"].has, rel=1e-9
        )
        assert stores["plain"]["d"].has == pytest.approx(40.0)
        assert stores["prio-a"]["a"].priority == 5
        assert stores["prio-a"]["b"].priority == 1
        assert (server._resident is not None) is native

    asyncio.run(scenario())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_python_and_native_store_priority_parts_agree(dtype):
    """The same leases, in the same order, on Python stores and on one
    native engine: the priority part packs the same tables (band ranks
    from the wire priorities, highest first) and solves to the same
    grants bit for bit."""
    if not tnative.native_available():
        pytest.skip("native engine unavailable")
    dt = DTYPES[dtype]
    clock = lambda: 1000.0  # noqa: E731
    engine = tnative.StoreEngine(clock=clock)
    py = _world(clock, TResource, TStore, tpb, n_prio=9)[len(LANES):]
    nat = _world(clock, TResource, None, tpb, n_prio=9,
                 store_factory=engine.store)[len(LANES):]
    parts = []
    for res in (py, nat):
        solver = TBatchSolver(dtype=dt, clock=clock, device="cpu")
        solver.set_groups(GROUPS)
        snap = solver.prepare(res)
        solver.solve(snap)
        parts.append(snap.priority_part)
    a, b = parts
    assert a.engine is None and b.engine is engine
    assert a.num_bands == b.num_bands == 4
    for f in ("wants", "weights", "band", "active", "capacity", "group",
              "group_cap"):
        assert torch.equal(getattr(a.batch, f), getattr(b.batch, f)), f
    np.testing.assert_array_equal(a.ridx, b.ridx)
    np.testing.assert_array_equal(a.pos, b.pos)
    np.testing.assert_array_equal(a.gets, b.gets)
