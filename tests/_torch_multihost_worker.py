"""One process of the port's two-process sharded solve over
torch.distributed (gloo).

    DOORMAN_COORDINATOR=file:///path/store DOORMAN_NUM_PROCESSES=2 \\
    DOORMAN_PROCESS_ID=<0|1> DOORMAN_DIST_BACKEND=gloo \\
        python tests/_torch_multihost_worker.py [--device cpu|cuda] \\
        [--dtype f64|f32]

Each process holds 2 shards on `--device` and only ITS half of the edge
table (parallel.multihost: initialize from the DOORMAN_* env, the
process-ordered ("dc", "clients") mesh, pack_process_edges), runs the
sharded edge solve and the sharded grouped priority solve, and holds
its own shards against the single-process f64 result: at f64 the edge
grants at 1e-12 and the priority grants at 1e-9 (tests/test_sharded.py's
tolerances), at f32 both within 1e-5 of capacity. Prints one line
"MULTIHOST WORKER OK {json}" on success; any mismatch raises.
"""

import json
import os
import sys

import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def edge_world(dtype, E=96, R=12, seed=0):
    from doorman_tpu_torch.solver.kernels import EdgeBatch, ResourceBatch

    rng = np.random.default_rng(seed)
    edges = EdgeBatch(
        resource=np.sort(rng.integers(0, R, E).astype(np.int32)),
        wants=rng.integers(0, 100, E).astype(dtype),
        has=rng.integers(0, 50, E).astype(dtype),
        subclients=np.ones(E, dtype),
        active=np.ones(E, bool),
    )
    resources = ResourceBatch(
        capacity=rng.integers(100, 5000, R).astype(dtype),
        algo_kind=rng.integers(0, 5, R).astype(np.int32),
        learning=np.zeros(R, bool),
        static_capacity=rng.integers(1, 100, R).astype(dtype),
    )
    return edges, resources


def priority_world(dtype, R=22, K=64, G=3, seed=9):
    from doorman_tpu_torch.solver.priority import PriorityBatch

    rng = np.random.default_rng(seed)
    active = np.zeros((R, K), bool)
    for r in range(R):
        active[r, : rng.integers(1, K)] = True
    capacity = rng.integers(100, 5000, R).astype(dtype)
    group = rng.choice(np.array([-1, 0, 1, 2], np.int32), R)
    # Every group spans both processes' rows.
    group[:G] = np.arange(G)
    group[-G:] = np.arange(G)
    return PriorityBatch(
        wants=(rng.integers(0, 200, (R, K)) * active).astype(dtype),
        weights=(rng.integers(1, 4, (R, K)) * active).astype(dtype),
        band=(rng.integers(0, 4, (R, K)) * active).astype(np.int32),
        active=active,
        capacity=capacity,
        group=group,
        group_cap=np.asarray([max(capacity[group == g].sum() * 0.4, 1.0)
                              for g in range(G)], dtype),
    )


def _f64(batch):
    """The batch as CPU tensors, floats at f64 (the single-process
    reference)."""
    from dataclasses import fields, replace

    out = {}
    for f in fields(batch):
        if getattr(batch, f.name) is None:
            continue
        t = torch.from_numpy(np.array(getattr(batch, f.name)))
        out[f.name] = t.double() if t.is_floating_point() else t
    return replace(batch, **out)


def main() -> None:
    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    dev = torch.device(args.get("--device", "cpu"))
    f32 = args.get("--dtype", "f64") == "f32"
    np_dt = np.float32 if f32 else np.float64
    from doorman_tpu_torch.parallel import multihost
    from doorman_tpu_torch.parallel.combine import Combine
    from doorman_tpu_torch.parallel.sharded import (
        make_sharded_priority_solver,
        make_sharded_solver,
        replicate_resources,
        shard_priority,
    )
    from doorman_tpu_torch.solver.kernels import solve_tick
    from doorman_tpu_torch.solver.priority import solve_priority

    multihost.initialize()  # DOORMAN_* env wiring under test
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 2, world
    mesh = multihost.make_multihost_mesh(("dc", "clients"), [dev] * 2)
    assert mesh.shape == {"dc": 2, "clients": 2}, mesh.shape
    assert mesh.local_shards() == [2 * rank, 2 * rank + 1]
    combine = Combine(mesh)

    # The edge solve: each process packs only its own half.
    edges, resources = edge_world(np_dt)
    n_edges = int(edges.active.shape[0])
    local = multihost.split_edges_by_host(edges, world)[rank]
    eph = n_edges // 2 + 6  # an uneven block: exercises the padding
    packed = multihost.pack_process_edges(mesh, local, eph)
    got = make_sharded_solver(mesh, combine=combine)(
        packed, replicate_resources(mesh, resources)).numpy()
    full = solve_tick(_f64(edges), _f64(resources)).numpy()
    eph += eph % 2  # a multiple of the process's 2 shards
    half = n_edges // 2
    mine = np.zeros(eph)
    mine[:half] = full[rank * half:(rank + 1) * half]
    edge_err = float(np.abs(got - mine).max())
    cap_max = float(resources.capacity.max())
    if f32:
        assert edge_err <= 1e-5 * cap_max, f"edge grants off by {edge_err}"
    else:
        np.testing.assert_allclose(got, mine, rtol=1e-12, atol=1e-12)

    # The grouped priority solve: every group spans both processes.
    host = priority_world(np_dt)
    R = host.capacity.shape[0]
    pg = make_sharded_priority_solver(mesh, num_bands=4, combine=combine)(
        shard_priority(mesh, host)).numpy()
    single = solve_priority(_f64(host), num_bands=4).numpy()
    rows = pg.shape[0]  # this process's rows (padded to 24 over 4)
    want = np.zeros_like(pg, dtype=np.float64)
    seg = single[rank * rows:(rank + 1) * rows]
    want[: seg.shape[0]] = seg
    cap = np.ones(rows)
    cap[: seg.shape[0]] = host.capacity[rank * rows:(rank + 1) * rows]
    prio_err = float((np.abs(pg - want).max(axis=1) / cap).max())
    if f32:
        assert prio_err <= 1e-5, f"priority off by {prio_err} of capacity"
    else:
        np.testing.assert_allclose(pg, want, rtol=1e-9, atol=1e-9)
    assert R == 22 and (pg[seg.shape[0]:] == 0).all()
    print("MULTIHOST WORKER OK " + json.dumps({
        "rank": rank, "device": str(dev), "backend": combine.backend,
        "staged_through_host": combine.staged_through_host,
        "dtype": "f32" if f32 else "f64",
        "edge_max_abs_err": edge_err, "priority_rel_err": prio_err,
    }), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
