"""The edge-list layout's per-resource reductions (port of
doorman_tpu/solver/fairshare.py, single device).

An edge list is sorted by resource id, so each resource's edges are
consecutive and a per-resource total is a segment reduction over them.
`torch.segment_reduce` adds a segment's values in edge order from 0 —
the order of XLA's sorted segment_sum on the CPU — and does so without
atomics on either device, so a re-solve gives the same bits.

The mesh half (the reference's psum / pmax across devices): a sharded
solve reduces each shard's edges on its own (`stacked_segment_reduces`,
per-shard partials [n, R] of a device group's stacked shards) and
combines the partials across shards with parallel.combine.Combine.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# [E] values -> [R] per-resource reduction.
SegmentReduce = Callable[[torch.Tensor], torch.Tensor]


def segment_lengths(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Elements per segment of a sorted segment-id vector."""
    return torch.bincount(segment_ids.long(), minlength=num_segments)


def local_segment_sum(segment_ids, num_segments,
                      lengths: Optional[torch.Tensor] = None) -> SegmentReduce:
    """The segment sum over consecutive segments of `lengths` (counted
    from `segment_ids` when not given). unsafe=True skips torch's check
    that the lengths cover the values, a device sync on the card: they
    come from the same sorted map as the values."""
    if lengths is None:
        lengths = segment_lengths(segment_ids, num_segments)

    def segsum(values):
        return torch.segment_reduce(values, "sum", lengths=lengths, unsafe=True)

    return segsum


def local_segment_max(segment_ids, num_segments,
                      lengths: Optional[torch.Tensor] = None) -> SegmentReduce:
    """Empty segments max to -inf, as jax.ops.segment_max leaves them."""
    if lengths is None:
        lengths = segment_lengths(segment_ids, num_segments)

    def segmax(values):
        return torch.segment_reduce(values, "max", lengths=lengths, unsafe=True)

    return segmax



def stacked_segment_reduces(segment_ids: torch.Tensor, num_segments: int):
    """(segsum, segmax) over a device group's stacked shards: values and
    `segment_ids` are [n, E] (each shard's ids sorted), and each reducer
    returns the per-shard partials [n, num_segments] — shard i's
    segments offset by i * num_segments, so the flattened ids stay
    sorted and one segment op covers every shard. Combine the partials
    across shards with the mesh's psum / pmax (parallel.combine)."""
    n = segment_ids.shape[0]
    offset = torch.arange(n, device=segment_ids.device)[:, None] * num_segments
    flat = (segment_ids.long() + offset).reshape(-1)
    lengths = segment_lengths(flat, n * num_segments)
    ssum = local_segment_sum(flat, n * num_segments, lengths)
    smax = local_segment_max(flat, n * num_segments, lengths)
    return (
        lambda v: ssum(v.reshape(-1)).reshape(n, num_segments),
        lambda v: smax(v.reshape(-1)).reshape(n, num_segments),
    )
