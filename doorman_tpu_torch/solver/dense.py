"""Dense bucketed solve: the [R, K] row layout (port of
doorman_tpu/solver/dense.py).

Each resource's clients pack into one row of a [R, K] table (K = bucket
width, a power of two), so per-resource aggregation is a row reduction
and the per-lease math is elementwise. `solve_dense` is the plain
PyTorch version of the lane solve; on the card the same function runs
as the hand-written kernel K1 (solver.dense_cuda).

`solve_chunked` is the wide-resource layout: a resource wider than a
row spans consecutive rows ("chunks"), and a per-resource total is a
row sum followed by a segment sum over the row totals. The JAX package
computes it outside any Pallas kernel, so it stays plain PyTorch on the
card too. Its reductions have a fixed order on either device — no
atomics (`index_add_`, `scatter_add_` and `scatter_reduce` add in an
order that changes from run to run on CUDA): the scoped tick's fixpoint
test needs a re-solve to give the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import torch

from doorman_tpu_torch.solver.fairshare import (
    local_segment_max,
    local_segment_sum,
)
from doorman_tpu_torch.solver.lanes import (
    expand_rows,
    rowmax,
    rowsum,
    solve_lanes,
)


@dataclass
class DenseBatch:
    """One bucket: R resources x up to K clients each."""

    wants: torch.Tensor  # [R, K] float
    has: torch.Tensor  # [R, K] float
    subclients: torch.Tensor  # [R, K] float
    active: torch.Tensor  # [R, K] bool
    capacity: torch.Tensor  # [R] float
    algo_kind: torch.Tensor  # [R] int32
    learning: torch.Tensor  # [R] bool
    static_capacity: torch.Tensor  # [R] float

    def rows(self, idx: torch.Tensor) -> "DenseBatch":
        """The sub-batch of the given rows (a gather of every field)."""
        idx = idx.long()
        return DenseBatch(
            **{f.name: getattr(self, f.name)[idx] for f in fields(self)}
        )


def solve_dense(
    batch: DenseBatch, lanes=None, fair_rows=None, lane_rows=None
) -> torch.Tensor:
    """Grants [R, K] (the plain version of kernel K1).

    `lanes` (a frozenset of AlgoKind ints present in the batch),
    `fair_rows` and `lane_rows` ({int(AlgoKind): row indices}) are the
    host-knowledge fast paths of solve_lanes: absent lanes are skipped
    and each iterative fill runs only over its own rows — both
    byte-identical to the default full computation."""
    return solve_lanes(
        batch.wants,
        batch.has,
        batch.subclients,
        batch.active,
        batch.capacity,
        batch.algo_kind,
        batch.learning,
        batch.static_capacity,
        segsum=rowsum,
        segmax=rowmax,
        expand=expand_rows,
        lanes=lanes,
        fair_rows=fair_rows,
        lane_rows=lane_rows,
    )


def fused_tick_plain(
    batch: DenseBatch,
    prev: torch.Tensor,  # [R, K] previous DELIVERED grants (download dtype)
    delivered: torch.Tensor,  # [R] bool: rows this tick delivers
    lanes=None,
    lane_rows=None,
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """The plain version of kernel K2: (gets, prev_new, changed).

    `gets` is solve_dense's; `changed[r]` is True exactly when row r is
    delivered AND its grants, cast to prev's dtype, differ from prev[r];
    `prev_new` advances delivered rows and keeps the rest (the epilogue
    of doorman_tpu/solver/resident.py:727-732 in row-mask form)."""
    gets = solve_dense(batch, lanes=lanes, lane_rows=lane_rows)
    return (gets, *delivered_delta(gets, prev, delivered))


def delivered_delta(
    gets: torch.Tensor, prev: torch.Tensor, delivered: torch.Tensor
) -> "tuple[torch.Tensor, torch.Tensor]":
    """K2's epilogue on grants `gets`: (prev_new, changed) as
    fused_tick_plain returns them."""
    out = gets.to(prev.dtype)
    deliv = delivered.bool()[:, None]
    changed = deliv[:, 0] & (out != prev).any(dim=1)
    prev_new = torch.where(deliv, out, prev)
    return prev_new, changed


@dataclass
class ChunkedDenseBatch:
    """The wide-resource layout: a resource wider than the row width
    spans CONSECUTIVE rows ("chunks") of the [R, K] table; `row_seg`
    maps each row to its resource segment, and the per-resource arrays
    are per SEGMENT [S]. Slot s of a resource based at row b lives at
    (b + s // K, s % K), so at flat index b*K + s — which makes a
    slot-granular upload a single 1D scatter.

    Rows are resource-major, so `row_seg` is sorted and each segment's
    rows are consecutive: `lengths` [S] (rows per segment, summing to R)
    describes the same map, and the caller that knows it passes it;
    otherwise it is counted from `row_seg`."""

    wants: torch.Tensor  # [R, K]
    has: torch.Tensor  # [R, K]
    subclients: torch.Tensor  # [R, K]
    active: torch.Tensor  # [R, K] bool
    row_seg: torch.Tensor  # [R] int, sorted; padding rows -> padding seg
    capacity: torch.Tensor  # [S]
    algo_kind: torch.Tensor  # [S] int32
    learning: torch.Tensor  # [S] bool
    static_capacity: torch.Tensor  # [S]
    lengths: Optional[torch.Tensor] = None  # [S] int64 rows per segment


def chunked_reduces(row_seg: torch.Tensor, num_segments: int,
                    lengths: "torch.Tensor | None" = None):
    """The two halves of the chunk reduction: a row reduction (rowsum /
    rowmax, as the dense layout's), then the edge list's segment
    reduction (solver.fairshare) over the [R] row totals of each
    segment's consecutive rows — in row order from 0, XLA's order on
    the CPU, and without atomics on either device. An empty segment
    sums to 0 and maxes to -inf, as jax.ops.segment_max leaves it
    (solve_lanes guards its segmax uses against non-finite values)."""
    seg_sum = local_segment_sum(row_seg, num_segments, lengths)
    seg_max = local_segment_max(row_seg, num_segments, lengths)
    return (lambda v: seg_sum(rowsum(v))), (lambda v: seg_max(rowmax(v)))


def solve_chunked(batch: ChunkedDenseBatch, lanes=None) -> torch.Tensor:
    """Grants [R, K]; the lane semantics of solve_dense, with the
    two-level reductions. `lanes` is the kind-subset fast path; the
    chunked layout has no per-row compaction of the iterative fills (a
    segment spans rows)."""
    seg = batch.row_seg.long()
    segsum, segmax = chunked_reduces(
        seg, batch.capacity.shape[0], batch.lengths
    )
    return solve_lanes(
        batch.wants,
        batch.has,
        batch.subclients,
        batch.active,
        batch.capacity,
        batch.algo_kind,
        batch.learning,
        batch.static_capacity,
        segsum=segsum,
        segmax=segmax,
        expand=lambda totals: totals[seg][:, None],
        lanes=lanes,
    )
