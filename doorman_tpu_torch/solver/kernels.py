"""The batched per-tick allocation, edge-list layout (port of
doorman_tpu/solver/kernels.py, single device).

An edge is one client's lease on one resource; the edge list is
segmented by resource id:

    EdgeBatch:     wants/has/subclients/resource-id/active per edge  [E]
    ResourceBatch: capacity, algo_kind, learning flag, static cap    [R]

`solve_tick` computes every edge's grant in one pass: segment sums give
the per-resource aggregates and the lane math is solver.lanes', shared
with the dense layouts. The layout is general (ragged, any mix of
widths); the BatchSolver takes it when a resource is wider than the
dense row cap. It is plain PyTorch on either device: the JAX package
computes it outside any Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from doorman_tpu_torch.solver.fairshare import (
    SegmentReduce,
    local_segment_max,
    local_segment_sum,
    segment_lengths,
)
from doorman_tpu_torch.solver.lanes import solve_lanes


@dataclass
class EdgeBatch:
    """One edge per (client, resource) lease. Edges are sorted by
    resource id (the packer guarantees it); `active` masks padding.
    `lengths` [R] (edges per resource), when the packer knows it, saves
    counting it from `resource`."""

    resource: torch.Tensor  # int32 [E]
    wants: torch.Tensor  # float [E]
    has: torch.Tensor  # float [E] — grants outstanding from the last tick
    subclients: torch.Tensor  # float [E]
    active: torch.Tensor  # bool [E]
    lengths: Optional[torch.Tensor] = None  # int64 [R]


@dataclass
class ResourceBatch:
    """Per-resource configuration, padded to R."""

    capacity: torch.Tensor  # float [R]
    algo_kind: torch.Tensor  # int32 [R], AlgoKind values
    learning: torch.Tensor  # bool [R] — learning mode: grant = has
    static_capacity: torch.Tensor  # float [R] — STATIC lane's cap

    @property
    def num_resources(self) -> int:
        return self.capacity.shape[0]


def solve_edges(
    edges: EdgeBatch,
    resources: ResourceBatch,
    segsum: SegmentReduce,
    segmax: SegmentReduce,
) -> torch.Tensor:
    """Edge-list solve with the per-resource reductions given ([E]
    values -> [R] totals)."""
    rid = edges.resource.long()
    return solve_lanes(
        edges.wants,
        edges.has,
        edges.subclients,
        edges.active,
        resources.capacity,
        resources.algo_kind,
        resources.learning,
        resources.static_capacity,
        segsum=segsum,
        segmax=segmax,
        expand=lambda totals: totals[rid],
    )


def solve_tick(edges: EdgeBatch, resources: ResourceBatch) -> torch.Tensor:
    """Single-device edge-list solve: gets [E] (padding edges get 0)."""
    R = resources.num_resources
    rid = edges.resource.long()
    lengths = edges.lengths
    if lengths is None:
        lengths = segment_lengths(rid, R)
    return solve_edges(
        edges,
        resources,
        local_segment_sum(rid, R, lengths),
        local_segment_max(rid, R, lengths),
    )
