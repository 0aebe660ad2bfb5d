"""Snapshot packing: native lease store -> padded device batches (port of
doorman_tpu/core/snapshot.py: the bucket helper, the resource specs, the
Snapshot and the edge-list packer).

At each batch tick the lane resources' leases are snapshotted — as a
dense [R, K] table (solver.batch._pack_dense) or, when a resource is
wider than the dense row cap, as an edge list padded to a power-of-two
bucket — solved on the device in one shot, and the grants written back.
Requests that arrive while a solve is in flight mutate the NEXT
snapshot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import numpy as np

from doorman_tpu_torch.solver.kernels import EdgeBatch, ResourceBatch


def _bucket(n: int, minimum: int = 64) -> int:
    """Round up to the next power of two (>= minimum) to bound the
    number of distinct table shapes."""
    size = minimum
    while size < n:
        size *= 2
    return size


@dataclass
class ResourceSpec:
    """Host-side description of one resource entering a tick."""

    resource_id: str
    capacity: float
    algo_kind: int  # AlgoKind
    learning: bool = False
    static_capacity: float = 0.0


@dataclass
class Snapshot:
    """A packed tick of lane resources from one native engine: the
    device batches plus the flat handle arrays (`ridx` segment per
    edge, `cids` client handle per edge) the write-back needs.

    Edge-list pack: `edges` / `resources` are set. Dense pack
    (solver.batch._pack_dense): `dense` is the [R, K] DenseBatch, `pos`
    each edge's lane within its row, and `dense_fill` the (rows, lanes)
    extent the download slices to; `edges` / `resources` are None."""

    edges: "EdgeBatch | None"
    resources: "ResourceBatch | None"
    resource_ids: List[str]
    num_edges: int
    # Per-segment learning flags as captured at pack time; apply() keeps
    # the store's live `has` for these instead of the solved replay.
    learning: "List[bool] | None" = None
    engine: object = None
    ridx: "np.ndarray | None" = None  # [num_edges] segment per edge
    cids: "np.ndarray | None" = None  # [num_edges] client handles
    dense: object = None
    pos: "np.ndarray | None" = None
    dense_fill: "Tuple[int, int] | None" = None
    # Host lane knowledge of the dense pack (solver.lanes fast paths).
    dense_lanes: "frozenset | None" = None
    dense_iter: "dict | None" = None
    # The PRIORITY_BANDS resources of the tick, in their own dense part
    # (solver.batch.PrioritySnapshot; None when the tick has none).
    priority_part: object = None


def pack_edge_arrays(
    specs: Sequence[ResourceSpec],
    rid: np.ndarray,
    wants: np.ndarray,
    has: np.ndarray,
    sub: np.ndarray,
    *,
    dtype=np.float64,
    edge_bucket_min: int = 64,
    resource_bucket_min: int = 16,
    to_device: "Callable[[np.ndarray], object] | None" = None,
    engine: object = None,
    cids: "np.ndarray | None" = None,
) -> Snapshot:
    """Pad flat, resource-major edge arrays (the native engine's bulk
    pack) into an edge-list Snapshot. Padding edges are inactive and
    belong to the last resource slot."""
    n = len(rid)
    E = _bucket(max(n, 1), edge_bucket_min)
    R = _bucket(max(len(specs), 1), resource_bucket_min)

    def fpad(xs: np.ndarray) -> np.ndarray:
        arr = np.zeros(E, dtype=dtype)
        arr[:n] = xs
        return arr

    rid_pad = np.full(E, R - 1, dtype=np.int32)
    rid_pad[:n] = rid
    active = np.zeros(E, dtype=bool)
    active[:n] = True

    cap = np.zeros(R, dtype=dtype)
    kind = np.zeros(R, dtype=np.int32)
    learning = np.zeros(R, dtype=bool)
    static_cap = np.zeros(R, dtype=dtype)
    for r, spec in enumerate(specs):
        cap[r] = spec.capacity
        kind[r] = int(spec.algo_kind)
        learning[r] = spec.learning
        static_cap[r] = spec.static_capacity

    dev = to_device if to_device is not None else (lambda a: a)
    edges = EdgeBatch(
        resource=dev(rid_pad),
        wants=dev(fpad(wants)),
        has=dev(fpad(has)),
        subclients=dev(fpad(sub)),
        active=dev(active),
        lengths=dev(np.bincount(rid_pad, minlength=R).astype(np.int64)),
    )
    resources = ResourceBatch(
        capacity=dev(cap),
        algo_kind=dev(kind),
        learning=dev(learning),
        static_capacity=dev(static_cap),
    )
    return Snapshot(
        edges=edges,
        resources=resources,
        resource_ids=[s.resource_id for s in specs],
        num_edges=n,
        learning=[bool(s.learning) for s in specs],
        engine=engine,
        ridx=rid if engine is not None else None,
        cids=cids,
    )
