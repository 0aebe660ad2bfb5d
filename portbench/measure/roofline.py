"""The yardstick of the kernels' rooflines: the card's published peaks
and the bytes and operations the ticks' work needs.

`lane_ops` and `lane_bytes` are frozen copies of chip_smoke.py's `_ops`
and `_bytes` (commit 37ca06e); they read a batch's fields by name, so the
benchmark hands them its own tables (every row exactly as wide as its
clients: the work the inputs need, not a kernel's padded launch shape).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit.
H100_BYTES_PER_S = 3.35e12  # HBM3
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores


def lane_ops(torch, batch):
    """Floating-point operations the lane solve needs on these inputs,
    per row ([R] float64), counted per lane element by the row's lane
    and load (overloaded iterative rows run their bounded loops; fitting
    rows do not)."""
    K = batch.wants.shape[1]
    n = batch.active.sum(dim=1).double()
    kind = batch.algo_kind
    over = (torch.where(batch.active, batch.wants, 0).sum(1) > batch.capacity)
    per = torch.full_like(n, 4.0)  # mask + sum of wants + final mask
    per += torch.where(kind == 1, 1.0, 0.0)
    per += torch.where(kind == 2, 6.0, 0.0)
    per += torch.where(kind == 4, 14.0, 0.0)
    fair_it = 30 if batch.wants.dtype == torch.float32 else 48
    per += torch.where((kind == 3) & over, 4.0 + 3.0 * fair_it + 8.0 + 2.0, 0.0)
    per += torch.where(((kind == 7) | (kind == 9)) & over, 1.0 + 16 * 4.0 + 2.0, 0.0)
    per += torch.where((kind == 8) & over, 9 * 6.0 + 8 * 3.0 + 3.0, 0.0)
    per = torch.where(batch.learning, 1.0, per)
    # Every lane of the row is visited (padding lanes too).
    return per * K


def lane_bytes(torch, batch):
    """Bytes the lane solve must move on these inputs, per row ([R]
    float64): the row's four per-row values and its whole active mask
    are read; of the [R, K] arrays only those its lane reads, and only
    at active elements — wants on every row but a learning one; has on
    PROPORTIONAL_SHARE, PROPORTIONAL_TOPUP and learning rows;
    subclients on PROPORTIONAL_TOPUP rows and on FAIR_SHARE,
    BALANCED_FAIRNESS and PROPORTIONAL_FAIRNESS rows that overflow
    (MAX_MIN_FAIR weighs every client 1); the row of grants is written."""
    K = batch.wants.shape[1]
    it = batch.wants.element_size()
    kind, learn = batch.algo_kind, batch.learning
    n = batch.active.sum(dim=1).double()
    over = (torch.where(batch.active, batch.wants, 0).sum(1) > batch.capacity)
    reads_has = learn | (kind == 2) | (kind == 4)
    reads_sub = ~learn & (
        (kind == 4) | (over & ((kind == 3) | (kind == 8) | (kind == 9))))
    arrays = (~learn).double() + reads_has.double() + reads_sub.double()
    return (2 * it + 4 + 1) + K + n * it * arrays + K * it


def lane_work(kind, capacity, wants, dtype=torch.float32):
    """(bytes, operations) of solving these lane rows once ([n] kinds and
    capacities, [n, K] wants) at the tick's precision."""
    w = torch.as_tensor(wants, dtype=dtype)
    batch = SimpleNamespace(
        wants=w, active=torch.ones_like(w, dtype=torch.bool),
        algo_kind=torch.as_tensor(np.asarray(kind)),
        capacity=torch.as_tensor(capacity, dtype=dtype),
        learning=torch.zeros(len(kind), dtype=torch.bool),
    )
    return (float(lane_bytes(torch, batch).sum()),
            float(lane_ops(torch, batch).sum()))


def bound_s(nbytes: float, ops: float) -> "tuple[float, str]":
    """Least seconds the published peaks allow, and which bound sets it."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / H100_F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

