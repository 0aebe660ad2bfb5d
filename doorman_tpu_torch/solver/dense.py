"""Dense bucketed solve: the [R, K] row layout (port of
doorman_tpu/solver/dense.py).

Each resource's clients pack into one row of a [R, K] table (K = bucket
width, a power of two), so per-resource aggregation is a row reduction
and the per-lease math is elementwise. `solve_dense` is the plain
PyTorch version of the lane solve; on the card the same function runs
as the hand-written kernel K1 (solver.dense_cuda).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

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
