"""The port's multi-process packing math and runtime wiring
(doorman_tpu_torch.parallel.multihost) against the JAX package's
(tests/test_multihost.py): the per-process block padding, the
deal/reassemble identity, the process-ordered mesh layout and its
refusal of uneven device counts, the single-process
`pack_process_edges` path solved end to end, and `initialize`'s
DOORMAN_* env wiring. Last, the real thing: two OS processes joined by
torch.distributed over gloo (a file:// rendezvous under tmp_path), each
holding 2 CPU shards and only its half of the edge table
(tests/_torch_multihost_worker.py), whose shards must equal the
single-process result.

torch.distributed runs in the child processes only: the test process
never initialises a process group (the env cases use monkeypatch)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

import jax

from doorman_tpu.parallel import make_sharded_solver as jmake_sharded_solver
from doorman_tpu.parallel import pack_process_edges as jpack
from doorman_tpu.parallel.multihost import (
    make_multihost_mesh as jmultihost_mesh,
    pad_edge_block as jpad,
)
from doorman_tpu.parallel.sharded import replicate_resources as jreplicate
from doorman_tpu_torch.parallel import make_sharded_solver, multihost
from doorman_tpu_torch.parallel.multihost import (
    make_multihost_mesh,
    pack_process_edges,
    pad_edge_block,
    split_edges_by_host,
)
from doorman_tpu_torch.parallel.sharded import replicate_resources
from doorman_tpu_torch.solver.kernels import EdgeBatch, ResourceBatch, solve_tick
from tests.test_multihost import edge_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8


def _torch(batch_cls, batch, names):
    return batch_cls(**{k: torch.from_numpy(np.array(getattr(batch, k)))
                        for k in names})


EDGE = ("resource", "wants", "has", "subclients", "active")
RES = ("capacity", "algo_kind", "learning", "static_capacity")


def test_pad_and_split_math_match_the_reference():
    edges, _ = edge_world(E=10)
    block = pad_edge_block(edges, 16)
    want = jpad(edges, 16)
    for k in EDGE:
        np.testing.assert_array_equal(getattr(block, k),
                                      np.asarray(getattr(want, k)))
    assert block.active[10:].sum() == 0  # padding inactive
    rid = block.resource
    assert (np.diff(rid) >= 0).all() and (rid[10:] == rid[9]).all()
    np.testing.assert_array_equal(pad_edge_block(edges, 10).wants,
                                  np.asarray(edges.wants))
    with pytest.raises(ValueError):
        pad_edge_block(edges, 9)
    edges, _ = edge_world(E=97)  # deliberately not divisible
    parts = split_edges_by_host(edges, 4)
    assert sum(p.active.shape[0] for p in parts) == 97
    for k in EDGE:
        np.testing.assert_array_equal(
            np.concatenate([getattr(p, k) for p in parts]),
            np.asarray(getattr(edges, k)))


def test_multihost_mesh_layout_follows_process_blocks(monkeypatch):
    mesh = make_multihost_mesh(("dc", "clients"), CPU8)
    # Single process: one dc block holding all its devices.
    assert mesh.shape == {"dc": 1, "clients": 8}
    assert mesh.local_shards() == list(range(8))
    assert mesh.n_processes == 1
    assert make_multihost_mesh(("clients",), CPU8).shape == {"clients": 8}
    # Uneven devices per process are refused (the dc rows would mix
    # processes): a stand-in for a 2-process world with 3 + 5 devices.
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)

    def gather(out, obj):
        out[0], out[1] = obj, ["cpu"] * 5

    monkeypatch.setattr(dist, "all_gather_object", gather)
    with pytest.raises(ValueError, match="uneven"):
        make_multihost_mesh(("dc", "clients"), CPU8[:3])
    # Even: process 0's devices are the first dc row.
    monkeypatch.setattr(dist, "all_gather_object",
                        lambda out, obj: out.__setitem__(slice(0, 2),
                                                         [obj, obj]))
    mesh = make_multihost_mesh(("dc", "clients"), CPU8[:3])
    assert mesh.shape == {"dc": 2, "clients": 3}
    assert mesh.local_shards() == [0, 1, 2]
    assert mesh.processes.tolist() == [0, 0, 0, 1, 1, 1]


def test_pack_process_edges_solves_to_the_reference_and_single_device():
    edges, resources = edge_world(E=90, R=11, seed=3)
    jmesh = jmultihost_mesh(("dc", "clients"), jax.devices("cpu")[:8])
    want = np.asarray(jmake_sharded_solver(jmesh)(
        jpack(jmesh, edges, edges_per_host=96), jreplicate(jmesh, resources)))
    mesh = make_multihost_mesh(("dc", "clients"), CPU8)
    packed = pack_process_edges(mesh, edges, edges_per_host=96)
    assert packed.active.numpy().shape == (96,)
    tr = _torch(ResourceBatch, resources, RES)
    got = make_sharded_solver(mesh)(
        packed, replicate_resources(mesh, tr)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    single = solve_tick(_torch(EdgeBatch, edges, EDGE), tr).numpy()
    np.testing.assert_allclose(got[:90], single, rtol=1e-12, atol=1e-12)
    assert (got[90:] == 0).all()  # padded edges granted nothing


def test_initialize_wires_env_fallbacks(monkeypatch):
    """initialize() plumbs the DOORMAN_* env into init_process_group (the
    real call needs peers, so record the arguments); without a
    coordinator it is a no-op, and it is idempotent."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(multihost, "_initialized", False)
    for var in ("DOORMAN_COORDINATOR", "DOORMAN_NUM_PROCESSES",
                "DOORMAN_PROCESS_ID", "DOORMAN_DIST_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize()
    assert calls == []

    monkeypatch.setenv("DOORMAN_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("DOORMAN_NUM_PROCESSES", "4")
    monkeypatch.setenv("DOORMAN_PROCESS_ID", "2")
    monkeypatch.setenv("DOORMAN_DIST_BACKEND", "gloo")
    multihost.initialize()
    assert calls == [{
        "backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
        "world_size": 4, "rank": 2,
    }]
    multihost.initialize()  # idempotent
    assert len(calls) == 1

    # Explicit arguments win over env; a URL passes through as given.
    monkeypatch.setattr(multihost, "_initialized", False)
    monkeypatch.delenv("DOORMAN_DIST_BACKEND")
    multihost.initialize(coordinator_address="file:///tmp/x",
                         num_processes=2, process_id=1, backend="gloo")
    assert calls[-1] == {"backend": "gloo", "init_method": "file:///tmp/x",
                         "world_size": 2, "rank": 1}
    # The default backend: nccl only where this process owns a GPU.
    assert multihost.default_backend() == (
        "nccl" if torch.cuda.is_available() else "gloo")
    monkeypatch.setattr(multihost, "_initialized", False)
    monkeypatch.delenv("DOORMAN_NUM_PROCESSES")
    monkeypatch.delenv("DOORMAN_PROCESS_ID")
    with pytest.raises(ValueError):
        multihost.initialize()


def test_two_process_sharded_solves_over_gloo(tmp_path):
    """Two OS processes, each with 2 CPU shards and only its half of the
    edge table, joined by multihost.initialize through a file://
    rendezvous: the sharded edge solve (1e-12) and the sharded grouped
    priority solve (1e-9, groups spanning both processes) equal the
    single-process result on every shard each process holds."""
    worker = os.path.join(ROOT, "tests", "_torch_multihost_worker.py")
    store = tmp_path / "rendezvous"
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("DOORMAN_", "MASTER_", "JAX_", "XLA_"))}
    procs = []
    try:
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, worker, "--device", "cpu"],
                env=dict(base, DOORMAN_COORDINATOR=f"file://{store}",
                         DOORMAN_NUM_PROCESSES="2",
                         DOORMAN_PROCESS_ID=str(rank),
                         DOORMAN_DIST_BACKEND="gloo",
                         OMP_NUM_THREADS="1"),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=ROOT,
            ))
        results = [(p.communicate(timeout=240)[0], p.returncode)
                   for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (out, rc) in enumerate(results):
        assert rc == 0, f"worker {rank} failed:\n{out}"
        line = [x for x in out.splitlines()
                if x.startswith("MULTIHOST WORKER OK ")]
        assert line, out
        info = json.loads(line[0][len("MULTIHOST WORKER OK "):])
        assert info["rank"] == rank and info["backend"] == "gloo"
        assert not info["staged_through_host"]  # CPU tensors: no staging
