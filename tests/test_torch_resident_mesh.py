"""The port's mesh-sharded resident ticks (`mesh=`) on an 8-shard CPU mesh
against the port's unmeshed ticks (the same tail on a one-shard mesh)
and the JAX package's mesh ticks on its 8 virtual CPU devices
(tests/conftest.py forces them).

The contract is the reference's (tests/test_resident_mesh.py):
BYTE-IDENTICAL store contents versus the single-device solver over
multi-tick churn — assignments, releases, new clients, a learning-mode
flip — including wide resources whose chunks STRADDLE shard boundaries,
on one mesh axis and two. With a delivery rotation the mesh rotates per
shard, so against the single-device solver only the device tables and
the fixpoint agree; against the JAX package's mesh solver the stores
agree tick by tick. Also: the rotation's balance across shards, the
shard traffic gauges, the spec parsing, the scoped frontier's per-shard
extents next to the reference's (which does not drain: ROADMAP C), and
a CapacityServer with mesh= against an unmeshed one.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

from doorman_tpu import native as jnative
from doorman_tpu.core.resource import Resource as JResource
from doorman_tpu.parallel import make_mesh as jmake_mesh
from doorman_tpu.proto import doorman_pb2 as jpb
from doorman_tpu.solver.resident import ResidentDenseSolver as JNarrow
from doorman_tpu.solver.resident_wide import WideResidentSolver as JWide
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.core.resource import Resource as TResource
from doorman_tpu_torch.parallel import make_mesh, make_mesh_from_spec
from doorman_tpu_torch.parallel.mesh import mesh_for_device
from doorman_tpu_torch.solver.resident import ResidentDenseSolver
from doorman_tpu_torch.solver.resident_wide import WideResidentSolver
from tests.test_engine import conformance_churn
from tests.test_torch_resident import all_leases
from tests.test_torch_resident import make_world as narrow_world
from tests.test_torch_resident_wide import make_world as wide_world

pytestmark = pytest.mark.skipif(
    not (jnative.native_available() and tnative.native_available()),
    reason="native engine unavailable",
)

CPU8 = [torch.device("cpu")] * 8
CHUNK_W = 8  # 21 clients / resource -> 3 chunks: every resource straddles


def _worlds(kind, clock):
    """(port world, port twin, JAX world), each on its own engine."""
    if kind == "narrow":
        return (narrow_world(clock, tnative, TResource),
                narrow_world(clock, tnative, TResource),
                narrow_world(clock, jnative, JResource))
    return (wide_world(clock), wide_world(clock),
            wide_world(clock, engine_mod=jnative, resource_cls=JResource,
                       proto=jpb))


def _solvers(kind, engines, clock, mesh, jmesh, rotate=1, **kw):
    if kind == "narrow":
        make = dict(dtype=np.float64, clock=clock, rotate_ticks=rotate, **kw)
        return (ResidentDenseSolver(engines[0], mesh=mesh, **make),
                ResidentDenseSolver(engines[1], device="cpu", **make),
                JNarrow(engines[2], mesh=jmesh, **make))
    make = dict(dtype=np.float64, clock=clock, rotate_ticks=rotate,
                chunk_width=CHUNK_W, **kw)
    return (WideResidentSolver(engines[0], mesh=mesh, **make),
            WideResidentSolver(engines[1], device="cpu", **make),
            JWide(engines[2], mesh=jmesh, **make))


@pytest.mark.parametrize("kind,axes", [
    ("narrow", "8"), ("wide", "8"), ("wide", "2x4"),
    ("narrow", "two-groups"), ("wide", "two-groups"),
], ids=["narrow", "wide-straddling", "wide-2x4", "narrow-two-groups",
        "wide-straddling-two-groups"])
def test_mesh_byte_identical_to_single_device_and_reference(kind, axes):
    """"two-groups" puts shards 0-3 and 4-7 on distinct device objects
    (cpu and cpu:0): each group solves in a thread of its own, and the
    wide reduces assemble across the groups through the combine."""
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    (eng_m, res_m), (eng_o, res_o), (eng_j, res_j) = _worlds(kind, clock)
    shape, names = ([2, 4], ("dc", "clients")) if axes == "2x4" else (
        [8], ("clients",))
    devices = CPU8 if axes != "two-groups" else (
        CPU8[:4] + [torch.device("cpu:0")] * 4)
    mesh = make_mesh(shape, names, devices)
    assert len(mesh.device_groups()) == (2 if axes == "two-groups" else 1)
    sm, so, sj = _solvers(kind, (eng_m, eng_o, eng_j), clock, mesh,
                          jmake_mesh(shape, names))
    rngs = [np.random.default_rng(99) for _ in range(3)]
    worlds = (res_m, res_o, res_j)
    for step in range(6):
        for res, rng in zip(worlds, rngs):
            conformance_churn(res, step, rng)
        if step == 3:
            for res in worlds:
                res[2].learning_mode_end = t[0] + 100
        epoch = 1 if step >= 3 else 0
        for solver, res in zip((sm, so, sj), worlds):
            solver.step(res, config_epoch=epoch)
        a = all_leases(res_m)
        assert a == all_leases(res_o), f"tick {step}: mesh vs one device"
        assert a == all_leases(res_j), f"tick {step}: port vs reference"
        assert sm.last_solve_mode == so.last_solve_mode == sj.last_solve_mode
        t[0] += 1.0
    assert sm.solve_modes["scoped"] >= 3
    if kind == "wide":
        # The layout straddles: 4 resources x 3 chunks over 8 shards of
        # 2 rows — resource 0's chunks span shards 0 and 1, etc.
        assert sm._Rp == 16 and sm._R == 12
        assert sm._Rp // sm._meshrows.n_dev == 2


def test_wide_rotation_reaches_the_single_device_fixpoint():
    """rotate_ticks=3: the mesh rotates PER SHARD, so its stores follow
    the JAX package's mesh tick for tick, while against the port's
    single-device solver only the device tables agree every tick and
    the stores meet at the fixpoint (the reference's own bound: one
    contraction step, rtol 1e-13)."""
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    (eng_m, res_m), (eng_o, res_o), (eng_j, res_j) = _worlds("wide", clock)
    sm, so, sj = _solvers("wide", (eng_m, eng_o, eng_j), clock,
                          make_mesh(devices=CPU8), jmake_mesh(), rotate=3)
    worlds = ((eng_m, res_m), (eng_o, res_o), (eng_j, res_j))

    def wants_churn(engine, resources, step, rng):
        res = resources[step % len(resources)]
        i = resources.index(res)
        engine.bulk_refresh(
            np.array([res.store._rid], np.int32),
            np.array([engine.client_handle(f"c{i}_0")], np.int64),
            np.array([t[0] + 60.0]), np.array([5.0]),
            np.array([float(rng.integers(1, 200))]),
        )

    rngs = [np.random.default_rng(7) for _ in range(3)]
    for step in range(5):
        for (eng, res), rng in zip(worlds, rngs):
            wants_churn(eng, res, step, rng)
        for solver, (_e, res) in zip((sm, so, sj), worlds):
            solver.step(res)
        assert all_leases(res_m) == all_leases(res_j), f"tick {step}"
        t[0] += 1.0
    for quiet in range(9):  # three full rotations, no churn
        for solver, (_e, res) in zip((sm, so, sj), worlds):
            solver.step(res)
        np.testing.assert_array_equal(
            sm.table().has.numpy(), so.table().has.numpy())
        assert all_leases(res_m) == all_leases(res_j), f"quiet {quiet}"
        t[0] += 1.0
    a, b = all_leases(res_m), all_leases(res_o)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=1e-13, atol=0,
                                   err_msg=f"fixpoint lease {key}")


def test_mesh_rotation_is_balanced_across_shards():
    """Each quiet tick's delivery spreads over the shards: no shard
    delivers more than ceil(its rows / rotate) rotation rows."""
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    eng, res = wide_world(clock)
    solver = WideResidentSolver(
        eng, dtype=np.float64, clock=clock, rotate_ticks=2,
        chunk_width=CHUNK_W, mesh=make_mesh(devices=CPU8),
    )
    solver.step(res)  # the rebuild tick delivers everything
    handle = solver.dispatch(res)
    assert handle.shard_counts is not None
    # 12 real rows over shards of 2 -> 6 populated shards; rotate=2
    # delivers 1 row per populated shard per tick.
    assert max(handle.shard_counts) <= 1 + 1  # rotation + dirty
    assert all(c >= 1 for c in handle.shard_counts[:6])
    solver.collect(handle)


def test_shard_traffic_gauges_published():
    """Mesh ticks publish per-shard byte gauges and a skew ratio in the
    default registry (obs/phases.py)."""
    from doorman_tpu_torch.obs import metrics as metrics_mod
    from doorman_tpu_torch.obs.phases import last_shard_bytes

    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    for kind, make in (("resident_wide", WideResidentSolver),
                       ("resident", ResidentDenseSolver)):
        eng, res = (wide_world(clock) if kind == "resident_wide"
                    else narrow_world(clock, tnative, TResource))
        extra = {"chunk_width": CHUNK_W} if kind == "resident_wide" else {}
        make(eng, dtype=np.float64, clock=clock, rotate_ticks=1,
             mesh=make_mesh(devices=CPU8), **extra).step(res)
        reg = metrics_mod.default_registry()
        per = reg.gauge(
            "doorman_tick_shard_bytes",
            "Per-shard host-link payload bytes of the last mesh-sharded "
            "tick (direction: upload/download).",
            labels=("component", "direction", "shard"),
        )
        skew = reg.gauge(
            "doorman_tick_shard_skew",
            "max/mean ratio of per-shard payload bytes for the last "
            "mesh-sharded tick (1.0 = perfectly balanced).",
            labels=("component", "direction"),
        )
        # The rebuild tick delivered every row: shard 0 downloaded bytes.
        assert per.value(kind, "download", "0") > 0
        assert skew.value(kind, "download") >= 1.0
        assert len(last_shard_bytes()[(kind, "upload")]) == 8


def test_mesh_spec_parsing():
    m = make_mesh_from_spec("auto", CPU8)
    assert m.shape == {"clients": 8}
    m = make_mesh_from_spec("2x4", CPU8)
    assert m.shape == {"dc": 2, "clients": 4}
    assert make_mesh_from_spec("8", CPU8).shape == {"clients": 8}
    assert make_mesh_from_spec("2x2x2", CPU8).shape == {
        "ax0": 2, "ax1": 2, "ax2": 2}
    with pytest.raises(ValueError):
        make_mesh_from_spec("2xbanana", CPU8)
    with pytest.raises(ValueError):
        make_mesh_from_spec("3x5", CPU8)  # does not cover 8 devices
    # A repeated device is one device group: its shards share it.
    assert [s for _d, s in make_mesh(devices=CPU8).device_groups()] == [
        list(range(8))]
    # The binary's --mesh: CPU shards only when asked for by count.
    assert mesh_for_device("2x2", "cpu").shape == {"dc": 2, "clients": 2}
    with pytest.raises(ValueError):
        mesh_for_device("auto", "cpu")
    if not torch.cuda.is_available():
        # 'auto' takes the visible CUDA devices and never drops to the CPU.
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh_from_spec("auto")


def test_cli_mesh_fails_fast_with_exit_2(tmp_path):
    from doorman_tpu_torch.cmd import server as cmd_server

    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        "resources:\n  - identifier_glob: '*'\n    capacity: 10\n"
        "    algorithm: {kind: FAIR_SHARE, lease_length: 60,"
        " refresh_interval: 5}\n"
    )
    for spec in ("2xbanana", "auto"):
        args = cmd_server.make_parser().parse_args(
            ["--config", f"file:{cfg}", "--port", "0", "--host",
             "127.0.0.1", "--debug-port", "-1", "--mode", "batch",
             "--native-store", "--device", "cpu", "--mesh", spec])
        with pytest.raises(SystemExit) as exc:
            asyncio.run(cmd_server.serve(args))
        assert exc.value.code == 2, spec


def test_mesh_scope_extents_and_frontier_follow_the_reference():
    """Narrow scoped mesh ticks group the scope by owning shard: the
    handle's per-shard counts sum to the global scope and equal the
    reference's, and the frontier after every tick is the reference's —
    which keeps one row whose fixpoint never settles (on one device as
    on the mesh; ROADMAP C), so it does not drain."""
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    (eng_m, res_m), _o, (eng_j, res_j) = _worlds("narrow", clock)
    sm = ResidentDenseSolver(eng_m, dtype=np.float64, clock=clock,
                             rotate_ticks=2, mesh=make_mesh(devices=CPU8))
    sj = JNarrow(eng_j, dtype=np.float64, clock=clock, rotate_ticks=2,
                 mesh=jmake_mesh())
    for s, res in ((sm, res_m), (sj, res_j)):
        s.step(res, 0)
    t[0] += 1.0
    handles = []
    for s, res in ((sm, res_m), (sj, res_j)):
        for i in (0, 11):
            res[i].store.assign(
                f"c{i}_0", 60.0, 5.0, res[i].store.get(f"c{i}_0").has,
                51.0 + i, 1,
            )
        handles.append(s.dispatch(res, 0))
    hm, hj = handles
    assert hm.scope_counts is not None
    assert sum(hm.scope_counts) == len(hm.scope_ids)
    np.testing.assert_array_equal(hm.scope_ids, hj.scope_ids)
    np.testing.assert_array_equal(hm.scope_counts, hj.scope_counts)
    sm.collect(hm)
    sj.collect(hj)
    t[0] += 1.0
    for tick in range(8):
        sm.step(res_m, 0)
        sj.step(res_j, 0)
        assert len(sm._scope) == len(sj._scope), f"tick {tick}"
        np.testing.assert_array_equal(sm._scope.ids(), sj._scope.ids())
        assert all_leases(res_m) == all_leases(res_j), f"tick {tick}"
        t[0] += 1.0
    assert len(sj._scope) > 0  # the reference's frontier keeps its row


def test_server_mesh_matches_single_device_server(monkeypatch):
    """A batch + native CapacityServer with mesh= gives byte-identical
    stores to an unmeshed one over the same ticks — narrow resources on
    the narrow resident solver, a wide (past the patched cap) resource
    on the chunked one — and status() gives the mesh's axis sizes."""
    from doorman_tpu_torch.algorithms import Request
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from tests.test_torch_server_wide import patch_cap

    patch_cap(monkeypatch, 16)
    config = """
resources:
- identifier_glob: "wide"
  capacity: 1000
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
- identifier_glob: "*"
  capacity: 500
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
"""

    async def body():
        servers = []
        for mesh in (make_mesh(devices=CPU8), None):
            server = CapacityServer(
                f"srv_{'mesh' if mesh is not None else 'one'}",
                TrivialElection(), mode="batch", tick_interval=3600.0,
                minimum_refresh_interval=0.0, native_store=True,
                device="cpu", mesh=mesh,
            )
            await server.start(0, host="127.0.0.1")
            await server.load_config(parse_yaml_config(config))
            servers.append(server)
            for i in range(8):
                server._decide("narrow", Request(f"n{i}", 0.0, 7.0, 1))
            engine = server._store_factory.__self__
            wide = server.get_or_create_resource("wide")
            n = 40
            engine.bulk_assign(
                np.full(n, wide.store._rid, np.int32),
                np.array([engine.client_handle(f"w{i}") for i in range(n)],
                         np.int64),
                np.full(n, time.time() + 60.0), np.full(n, 1.0),
                np.zeros(n), np.arange(1.0, n + 1.0), np.ones(n, np.int32),
            )
        mesh_srv, one_srv = servers
        assert mesh_srv.status()["mesh"] == {"clients": 8}
        assert one_srv.status()["mesh"] is None
        for _ in range(4):
            await mesh_srv.tick_once()
            await one_srv.tick_once()
        for rid in ("narrow", "wide"):
            a = dict(mesh_srv.resources[rid].store.items())
            b = dict(one_srv.resources[rid].store.items())
            assert a.keys() == b.keys()
            for key in a:
                assert (a[key].has, a[key].wants) == (
                    b[key].has, b[key].wants), (rid, key)
        assert mesh_srv._resident.mesh is not None
        assert mesh_srv._resident_wide.mesh is not None
        assert "wide" in mesh_srv._wide_ids
        for s in servers:
            await s.stop()

    asyncio.run(body())
