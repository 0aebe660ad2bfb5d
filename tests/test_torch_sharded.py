"""The port's sharded solves (doorman_tpu_torch.parallel.sharded) on an
8-shard CPU mesh against the JAX package's on its 8 virtual CPU devices
(tests/conftest.py forces them), on the same seeded inputs, at the
reference tests' own equality or tolerance (tests/test_sharded.py):
the edge list on one and two axes, dc_aggregates, the dense solve, the
grouped priority solve (padding to 24 rows) and the chunked solve on one
and two axes. Each is also held to the port's single-device solve, and
the edge solve runs once more over two device groups, whose combine
meets at a barrier across threads."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

import jax

from doorman_tpu.parallel import make_mesh as jmake_mesh
from doorman_tpu.parallel import make_sharded_solver as jmake_sharded_solver
from doorman_tpu.parallel import shard_edges as jshard_edges
from doorman_tpu.parallel.sharded import dc_aggregates as jdc_aggregates
from doorman_tpu.parallel.sharded import replicate_resources as jreplicate
from doorman_tpu_torch.parallel import (
    make_mesh,
    make_sharded_chunked_solver,
    make_sharded_dense_solver,
    make_sharded_priority_solver,
    make_sharded_solver,
    shard_chunked,
    shard_dense,
    shard_edges,
    shard_priority,
)
from doorman_tpu_torch.parallel.sharded import dc_aggregates, replicate_resources
from doorman_tpu_torch.solver.dense import (
    ChunkedDenseBatch,
    DenseBatch,
    solve_chunked,
    solve_dense,
)
from doorman_tpu_torch.solver.kernels import EdgeBatch, ResourceBatch, solve_tick
from doorman_tpu_torch.solver.priority import PriorityBatch, solve_priority
from tests.test_sharded import random_tables
from tests.test_solver_kernels import build_batch

CPU8 = [torch.device("cpu")] * 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_edges(edges, resources):
    return (
        EdgeBatch(**{k: _t(getattr(edges, k)) for k in
                     ("resource", "wants", "has", "subclients", "active")}),
        ResourceBatch(**{k: _t(getattr(resources, k)) for k in
                         ("capacity", "algo_kind", "learning",
                          "static_capacity")}),
    )


def _jax_edge_solve(mesh, edges, resources):
    return np.asarray(jmake_sharded_solver(mesh)(
        jshard_edges(mesh, edges), jreplicate(mesh, resources)))


@pytest.mark.parametrize("seed", range(3))
def test_sharded_matches_reference_and_single_device(seed):
    edges, resources = build_batch(random_tables(seed), pad_edges=64)
    want = _jax_edge_solve(jmake_mesh(), edges, resources)
    te, tr = _port_edges(edges, resources)
    mesh = make_mesh(devices=CPU8)
    got = make_sharded_solver(mesh)(
        shard_edges(mesh, te), replicate_resources(mesh, tr)).numpy()
    np.testing.assert_array_equal(got, want)
    single = solve_tick(te, tr).numpy()
    np.testing.assert_array_equal(got[: single.shape[0]], single)
    assert np.all(got[single.shape[0]:] == 0.0)


@pytest.mark.parametrize("layout", ["2x4", "two-groups"])
def test_two_level_tree_mesh_matches(layout):
    """A ('dc', 'clients') 2x4 mesh; and the same over two device groups
    (cpu and cpu:0 are distinct device objects: the solve runs one thread
    per group and the combines meet at a barrier)."""
    edges, resources = build_batch(random_tables(7), pad_edges=64)
    want = _jax_edge_solve(
        jmake_mesh([2, 4], ("dc", "clients")), edges, resources)
    devices = CPU8 if layout == "2x4" else (
        [torch.device("cpu")] * 4 + [torch.device("cpu", 0)] * 4)
    mesh = make_mesh([2, 4], ("dc", "clients"), devices)
    assert len(mesh.device_groups()) == (1 if layout == "2x4" else 2)
    te, tr = _port_edges(edges, resources)
    got = make_sharded_solver(mesh)(
        shard_edges(mesh, te), replicate_resources(mesh, tr)).numpy()
    np.testing.assert_array_equal(got, want)


def test_dc_aggregates_match_the_reference():
    edges, resources = build_batch(random_tables(11, n_resources=6),
                                   pad_edges=64)
    jmesh = jmake_mesh([2, 4], ("dc", "clients"))
    want = jdc_aggregates(jmesh, jshard_edges(jmesh, edges),
                          resources.num_resources)
    mesh = make_mesh([2, 4], ("dc", "clients"), CPU8)
    te, _tr = _port_edges(edges, resources)
    got = dc_aggregates(mesh, shard_edges(mesh, te), resources.num_resources)
    for g, w in zip(got, want):
        assert g.shape == (2, resources.num_resources)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sharded_dense_matches_reference():
    """K1's plain version once per shard; R=23 pads to 24 over 8."""
    from doorman_tpu.parallel import (
        make_sharded_dense_solver as jsolver,
        shard_dense as jshard,
    )
    from doorman_tpu.solver.dense import DenseBatch as JDenseBatch

    rng = np.random.default_rng(3)
    R, K, C = 23, 128, 100
    active = np.zeros((R, K), bool)
    active[:, :C] = True
    host = dict(
        wants=(rng.integers(0, 100, (R, K)) * active).astype(np.float64),
        has=(rng.integers(0, 50, (R, K)) * active).astype(np.float64),
        subclients=active.astype(np.float64),
        active=active,
        capacity=rng.integers(100, 10_000, R).astype(np.float64),
        algo_kind=rng.integers(0, 5, R).astype(np.int32),
        learning=rng.random(R) < 0.2,
        static_capacity=rng.integers(1, 100, R).astype(np.float64),
    )
    jmesh = jmake_mesh([8], ("clients",), jax.devices()[:8])
    want = np.asarray(jsolver(jmesh)(jshard(jmesh, JDenseBatch(**host))))
    mesh = make_mesh(devices=CPU8)
    got = make_sharded_dense_solver(mesh)(
        shard_dense(mesh, DenseBatch(**{k: _t(v) for k, v in host.items()}))
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    single = solve_dense(DenseBatch(**{k: _t(v) for k, v in host.items()}))
    np.testing.assert_array_equal(got[:R], single.numpy())
    assert (got[R:] == 0).all()  # padded rows are inactive


def _priority_host():
    rng = np.random.default_rng(9)
    R, K, G = 21, 64, 3
    active = np.zeros((R, K), bool)
    for r in range(R):
        active[r, : rng.integers(1, K)] = True
    capacity = rng.integers(100, 5000, R).astype(np.float64)
    group = rng.choice(np.array([-1, 0, 1, 2], np.int32), R)
    group_cap = np.asarray(
        [max(capacity[group == g].sum() * 0.4, 1.0) for g in range(G)],
        np.float64,
    )
    return dict(
        wants=(rng.integers(0, 200, (R, K)) * active).astype(np.float64),
        weights=(rng.integers(1, 4, (R, K)) * active).astype(np.float64),
        band=(rng.integers(0, 4, (R, K)) * active).astype(np.int32),
        active=active,
        capacity=capacity,
        group=group,
        group_cap=group_cap,
    )


def test_sharded_priority_matches_reference_and_single_device():
    """Group caps couple rows across shards: the combine sums the
    per-shard [G] usage once per bisection evaluation. R=21 pads to 24
    with ungrouped rows. Held at test_sharded.py's 1e-9."""
    from doorman_tpu.parallel import (
        make_sharded_priority_solver as jsolver,
        shard_priority as jshard,
    )
    from doorman_tpu.solver.priority import PriorityBatch as JPriorityBatch

    host = _priority_host()
    R = host["capacity"].shape[0]
    jmesh = jmake_mesh([8], ("clients",), jax.devices()[:8])
    want = np.asarray(jsolver(jmesh, num_bands=4)(
        jshard(jmesh, JPriorityBatch(**host))))
    mesh = make_mesh(devices=CPU8)
    tb = PriorityBatch(**{k: _t(v) for k, v in host.items()})
    got = make_sharded_priority_solver(mesh, num_bands=4)(
        shard_priority(mesh, tb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    single = solve_priority(tb, num_bands=4).numpy()
    np.testing.assert_allclose(got[:R], single, rtol=1e-9, atol=1e-9)
    assert (got[R:] == 0).all()  # padded rows inactive and ungrouped
    for g in range(host["group_cap"].shape[0]):
        usage = got[:R][host["group"] == g].sum()
        assert usage <= host["group_cap"][g] * (1 + 1e-9) + 1e-6


def _chunked_host(case):
    rng = np.random.default_rng(9 if case == "straddling" else 21)
    if case == "straddling":
        K = 16
        n_chunks = [5, 7, 2]
        S = len(n_chunks) + 1
        R = sum(n_chunks)
        row_seg = np.repeat(np.arange(len(n_chunks)), n_chunks).astype(
            np.int32)
        counts = [int(rng.integers((n - 1) * K + 1, n * K + 1))
                  for n in n_chunks]
        active = np.zeros((R, K), bool)
        base = 0
        for n, cnt in zip(n_chunks, counts):
            slots = np.arange(cnt)
            active[base + slots // K, slots % K] = True
            base += n
        return dict(
            wants=(rng.integers(0, 100, (R, K)) * active).astype(np.float64),
            has=(rng.integers(0, 50, (R, K)) * active).astype(np.float64),
            subclients=active.astype(np.float64),
            active=active,
            row_seg=row_seg,
            capacity=np.append(rng.integers(100, 10_000, len(n_chunks)),
                               0.0).astype(np.float64),
            algo_kind=np.append(np.array([2, 3, 4]), 0).astype(np.int32),
            learning=np.zeros(S, bool),
            static_capacity=np.zeros(S, np.float64),
        )
    K, R, S = 8, 6, 2
    active = np.ones((R, K), bool)
    active[-1, 5:] = False
    return dict(
        wants=(rng.integers(1, 100, (R, K)) * active).astype(np.float64),
        has=np.zeros((R, K)),
        subclients=active.astype(np.float64),
        active=active,
        row_seg=np.zeros(R, np.int32),
        capacity=np.array([900.0, 0.0]),
        algo_kind=np.array([3, 0], np.int32),
        learning=np.zeros(S, bool),
        static_capacity=np.zeros(S, np.float64),
    )


@pytest.mark.parametrize("case", ["straddling", "two-axis"])
def test_sharded_chunked_matches_reference(case):
    """Chunk rows sharded: resources straddle shards, so per-segment
    totals need the combine (test_sharded.py's 1e-12)."""
    from doorman_tpu.parallel.sharded import (
        make_sharded_chunked_solver as jsolver,
        shard_chunked as jshard,
    )
    from doorman_tpu.solver.dense import ChunkedDenseBatch as JBatch

    host = _chunked_host(case)
    R = host["row_seg"].shape[0]
    shape, names = ([8], ("clients",)) if case == "straddling" else (
        [2, 4], ("dc", "clients"))
    jmesh = jmake_mesh(shape, names, jax.devices()[:8])
    want = np.asarray(jsolver(jmesh)(jshard(jmesh, JBatch(**host))))
    mesh = make_mesh(shape, names, CPU8)
    tb = ChunkedDenseBatch(**{k: _t(v) for k, v in host.items()})
    got = make_sharded_chunked_solver(mesh)(shard_chunked(mesh, tb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    single = solve_chunked(tb).numpy()
    np.testing.assert_allclose(got[:R], single, rtol=1e-12, atol=1e-12)
    assert (got[R:] == 0).all()
    if case == "two-axis":
        # Oversubscribed fair share: grants fill the capacity exactly.
        np.testing.assert_allclose(got[:R].sum(), 900.0, rtol=1e-9)


def test_fairshare_and_priority_name_their_mesh_half():
    """The edge list's module says where its mesh combine lives (it was
    'not ported' before parallel/ was), and solve_priority's combine is
    the counterpart of the reference's combine_axes: with one batch and
    no combine, the single-device arithmetic, bit for bit; shards with
    no combine are refused (their group usage would be partial)."""
    from doorman_tpu_torch.parallel import combine as combine_mod
    from doorman_tpu_torch.solver import fairshare

    assert "not ported" not in fairshare.__doc__
    assert "parallel.combine" in fairshare.__doc__
    assert "shard_map" in combine_mod.__doc__  # why compat.py has no twin
    host = _priority_host()
    tb = PriorityBatch(**{k: _t(v) for k, v in host.items()})
    one = solve_priority(tb, num_bands=4)
    listed = solve_priority([tb], num_bands=4,
                            combine=lambda parts: parts[0])
    np.testing.assert_array_equal(listed[0].numpy(), one.numpy())
    with pytest.raises(ValueError, match="need a combine"):
        solve_priority([tb, tb], num_bands=4)
