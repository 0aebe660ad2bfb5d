"""Snapshot packing: lease stores -> padded device batches (port of
doorman_tpu/core/snapshot.py: the bucket helper, the resource specs, the
Snapshot and the edge-list packers).

At each batch tick the lane resources' leases are snapshotted — from the
native store as a dense [R, K] table (solver.batch._pack_dense) or, when
a resource is wider than the dense row cap, as an edge list padded to a
power-of-two bucket; from Python stores always as an edge list
(`pack_snapshot`) — solved on the device in one shot, and the grants
written back. Requests that arrive while a solve is in flight mutate the
NEXT snapshot.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

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
    """A packed tick of lane resources: the device batches plus what
    the write-back needs to find each edge's lease. The Python-store
    pack (`pack_snapshot`) carries `edge_keys`, one (resource_id,
    client_id) per edge; the native pack carries the flat handle arrays
    (`ridx` segment per edge, `cids` client handle per edge) and the
    engine, and resolves names only when asked.

    Edge-list pack: `edges` / `resources` are set. Dense pack
    (solver.batch._pack_dense): `dense` is the [R, K] DenseBatch, `pos`
    each edge's lane within its row, and `dense_fill` the (rows, lanes)
    extent the download slices to; `edges` / `resources` are None."""

    edges: "EdgeBatch | None"
    resources: "ResourceBatch | None"
    resource_ids: List[str]
    num_edges: int
    # Parallel to the packed edge order (Python-store pack only).
    edge_keys: List[Tuple[str, str]] = field(default_factory=list)
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

    def keys(self) -> List[Tuple[str, str]]:
        """(resource_id, client_id) per packed edge, either flavor."""
        if self.edge_keys:
            return self.edge_keys
        if self.engine is None:
            return []
        name = self.engine.client_name
        return [
            (self.resource_ids[int(r)], name(int(c)))
            for r, c in zip(self.ridx, self.cids)
        ]

    def unpack(self, gets: np.ndarray) -> Dict[Tuple[str, str], float]:
        """Map a solved gets[E] array back to {(resource_id, client_id):
        grant}."""
        arr = np.asarray(gets)
        return {key: float(arr[i]) for i, key in enumerate(self.keys())}


def pack_snapshot(
    specs: Sequence[ResourceSpec],
    rows: Callable[[str], Sequence[Tuple[str, float, float, int]]],
    *,
    dtype=np.float64,
    edge_bucket_min: int = 64,
    resource_bucket_min: int = 16,
    to_device: "Callable[[np.ndarray], object] | None" = None,
) -> Snapshot:
    """Pack resources held in Python lease stores into an edge-list
    Snapshot. `rows(resource_id)` yields (client_id, wants, has,
    subclients) tuples, as LeaseStore.items() adapted by the caller.
    Edges are laid out resource-major, so segment ids arrive sorted."""
    edge_keys: List[Tuple[str, str]] = []
    wants_l: List[float] = []
    has_l: List[float] = []
    sub_l: List[float] = []
    rid_l: List[int] = []
    for r, spec in enumerate(specs):
        for client_id, wants, has, subclients in rows(spec.resource_id):
            edge_keys.append((spec.resource_id, client_id))
            rid_l.append(r)
            wants_l.append(wants)
            has_l.append(has)
            sub_l.append(subclients)
    return pack_edge_arrays(
        specs,
        np.asarray(rid_l, np.int32),
        np.asarray(wants_l, dtype),
        np.asarray(has_l, dtype),
        np.asarray(sub_l, dtype),
        dtype=dtype,
        edge_bucket_min=edge_bucket_min,
        resource_bucket_min=resource_bucket_min,
        to_device=to_device,
        edge_keys=edge_keys,
    )


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
    edge_keys: "List[Tuple[str, str]] | None" = None,
    engine: object = None,
    cids: "np.ndarray | None" = None,
) -> Snapshot:
    """Pad flat, resource-major edge arrays (the native engine's bulk
    pack, or `pack_snapshot`'s lists) into an edge-list Snapshot.
    Padding edges are inactive and belong to the last resource slot."""
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
        edge_keys=edge_keys or [],
        learning=[bool(s.learning) for s in specs],
        engine=engine,
        ridx=rid if engine is not None else None,
        cids=cids,
    )
