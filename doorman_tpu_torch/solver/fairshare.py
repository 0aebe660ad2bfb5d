"""The edge-list layout's per-resource reductions (port of
doorman_tpu/solver/fairshare.py, single device).

An edge list is sorted by resource id, so each resource's edges are
consecutive and a per-resource total is a segment reduction over them.
`torch.segment_reduce` adds a segment's values in edge order from 0 —
the order of XLA's sorted segment_sum on the CPU — and does so without
atomics on either device, so a re-solve gives the same bits. (The
reference's mesh combine, psum / pmax across devices, is not ported.)
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

