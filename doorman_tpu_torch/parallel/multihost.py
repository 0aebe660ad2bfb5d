"""Multi-process execution: runtime wiring + process-local shard packing
(port of doorman_tpu/parallel/multihost.py).

The reference spans hosts by construction — its server tree is
processes on different machines talking gRPC. The port's equivalent for
the *solve* is one program in several processes over
`torch.distributed`: the mesh spans every process's devices, each
process holds only its own shards, and the combine (parallel.combine)
all-reduces the per-shard partials across processes:

  * `initialize()` — `torch.distributed.init_process_group` with
    `DOORMAN_*` env fallbacks (utils/flagenv.py convention), idempotent,
    a no-op without a coordinator;
  * `make_multihost_mesh()` — a ("dc", "clients") mesh whose leading
    axis follows process boundaries, so each process's devices form its
    own "dc" block (the intermediate-server role of the fused tree);
  * `pad_edge_block()` / `pack_process_edges()` — each process packs
    ONLY its own clients' edges (the leases its RPC frontends own) into
    its own shards, so edge tables never cross processes; the combine's
    all-reduce is the only cross-process traffic.
"""

from __future__ import annotations

import logging
import os
from collections import Counter
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from doorman_tpu_torch.parallel.mesh import Mesh, visible_cuda_devices
from doorman_tpu_torch.solver.kernels import EdgeBatch

log = logging.getLogger(__name__)

_initialized = False


def default_backend() -> str:
    """DOORMAN_DIST_BACKEND, else nccl when this process owns a GPU and
    gloo otherwise (every rank must agree: init fails when they do
    not)."""
    env = os.environ.get("DOORMAN_DIST_BACKEND")
    if env:
        return env
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: "Optional[Sequence[int]]" = None,
    backend: Optional[str] = None,
) -> None:
    """`torch.distributed.init_process_group` with DOORMAN_* env
    fallbacks.

    Call once per process before any collective, on every process of
    the job. No-ops when already initialised or when neither arguments
    nor env vars name a coordinator (single-process runs). Env:
    DOORMAN_COORDINATOR (host:port, or a tcp:// / file:// URL),
    DOORMAN_NUM_PROCESSES, DOORMAN_PROCESS_ID, DOORMAN_DIST_BACKEND.
    `local_device_ids` pins this process's CUDA device (the first one
    named) before the group starts."""
    global _initialized
    if _initialized:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "DOORMAN_COORDINATOR"
    )
    if coordinator_address is None:
        return  # single process: nothing to join
    if num_processes is None and "DOORMAN_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DOORMAN_NUM_PROCESSES"])
    if process_id is None and "DOORMAN_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DOORMAN_PROCESS_ID"])
    if num_processes is None or process_id is None:
        raise ValueError(
            "a coordinator needs the process count and this process's id "
            "(DOORMAN_NUM_PROCESSES, DOORMAN_PROCESS_ID)"
        )
    init_method = coordinator_address
    if "://" not in init_method:
        init_method = f"tcp://{init_method}"
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    import torch.distributed as dist

    dist.init_process_group(
        backend=backend or default_backend(),
        init_method=init_method,
        world_size=int(num_processes),
        rank=int(process_id),
    )
    _initialized = True
    log.info("multi-process runtime up: process %d/%d (%s)",
             process_id, num_processes, backend or default_backend())


def make_multihost_mesh(
    axis_names: Tuple[str, ...] = ("dc", "clients"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over every process's devices with the leading axis following
    process boundaries: process i's devices are block i of the first
    axis. `devices` are THIS process's devices (default: its visible
    CUDA devices); without torch.distributed running the mesh is this
    process's alone. Falls back to a single axis when `axis_names` has
    one name."""
    local = [d if isinstance(d, torch.device) else torch.device(d)
             for d in (devices if devices is not None
                       else visible_cuda_devices())]
    rank, world = 0, 1
    per_proc = [[str(d) for d in local]]
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        per_proc = [None] * world
        dist.all_gather_object(per_proc, [str(d) for d in local])
    # Every process must contribute the SAME device count, else a
    # process's devices would land in another's "dc" row and the
    # process-local packing would break.
    counts = Counter({p: len(ds) for p, ds in enumerate(per_proc)})
    if len(set(counts.values())) > 1:
        raise ValueError(
            f"uneven devices per process {dict(counts)}: the dc-axis layout "
            "requires every process to contribute the same device count"
        )
    devs, procs = [], []
    for p, ds in enumerate(per_proc):
        devs.extend(local if p == rank else [torch.device(d) for d in ds])
        procs.extend([p] * len(ds))
    n = len(devs)
    sizes = [n] if len(axis_names) == 1 else [world, n // world]
    return Mesh(devs, sizes, tuple(axis_names), processes=procs,
                process_index=rank)


# -- process-local edge packing (pure math, unit-testable) ----------------


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def pad_edge_block(edges: EdgeBatch, size: int) -> EdgeBatch:
    """Pad a process's local edge arrays to the agreed per-process block
    `size` with inactive edges (the solve masks them out). The fill
    resource id repeats the block's last id so per-shard edge lists stay
    sorted by segment — the segment reductions rely on it."""
    arrs = {
        "resource": _np(edges.resource),
        "wants": _np(edges.wants),
        "has": _np(edges.has),
        "subclients": _np(edges.subclients),
        "active": _np(edges.active),
    }
    e = arrs["active"].shape[0]
    if e > size:
        raise ValueError(
            f"process holds {e} edges, over the per-process block size {size}"
        )
    pad = size - e
    if pad == 0:
        return EdgeBatch(**arrs)
    last_rid = arrs["resource"][-1] if e else 0
    fills = {
        "resource": last_rid, "wants": 0, "has": 0, "subclients": 0,
        "active": False,
    }
    return EdgeBatch(**{
        k: np.concatenate([v, np.full((pad,), fills[k], dtype=v.dtype)])
        for k, v in arrs.items()
    })


def pack_process_edges(mesh: Mesh, local_edges: EdgeBatch,
                       edges_per_host: int) -> EdgeBatch:
    """This process's shards of the global sharded EdgeBatch, from THIS
    process's edges only.

    Every process calls this with its own clients' edge list (padded
    here to `edges_per_host`, which all processes must agree on — it is
    config, not data), rounded up to a multiple of its shard count so
    the block splits into equal shards. The result feeds
    parallel.sharded.make_sharded_solver directly. Single process:
    equivalent to shard_edges (the same layout)."""
    from doorman_tpu_torch.parallel.sharded import place_local

    n_local = len(mesh.local_shards())
    edges_per_host += (-edges_per_host) % max(n_local, 1)
    block = pad_edge_block(local_edges, edges_per_host)

    def put(arr):
        arr = np.asarray(arr)
        return place_local(mesh, arr.reshape((n_local, -1) + arr.shape[1:]))

    return EdgeBatch(
        resource=put(block.resource),
        wants=put(block.wants),
        has=put(block.has),
        subclients=put(block.subclients),
        active=put(block.active.astype(bool)),
    )


def split_edges_by_host(edges: EdgeBatch, n_hosts: int) -> "list[EdgeBatch]":
    """Deal a global edge list into `n_hosts` contiguous blocks (test
    and simulation helper: it models which edges each process's RPC
    frontends would own). Blocks keep global order, so reassembly by
    concatenation is the identity."""
    e = int(_np(edges.active).shape[0])
    bounds = np.linspace(0, e, n_hosts + 1).astype(int)
    return [
        EdgeBatch(
            resource=_np(edges.resource)[a:b],
            wants=_np(edges.wants)[a:b],
            has=_np(edges.has)[a:b],
            subclients=_np(edges.subclients)[a:b],
            active=_np(edges.active)[a:b],
        )
        for a, b in zip(bounds[:-1], bounds[1:])
    ]
