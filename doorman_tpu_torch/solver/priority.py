"""Batched priority-banded, group-capped solve (port of
doorman_tpu/solver/priority.py).

All PRIORITY_BANDS resources at once in the dense [R, K] layout, with

  * lexicographic priority bands — a loop over band ranks, each band
    water-filled (the bisection + snap level finder of solver.lanes)
    within the capacity the higher bands left over;
  * cross-resource group caps — a per-group theta in [0, 1] scaling the
    member resources' capacities, found by an outer bisection; usage is
    monotone in theta, so the fixpoint is exact to the bisection depth.

Band ranks are dense per resource (0 = highest); the host maps raw wire
priorities (doorman.proto ResourceRequest.priority) to ranks when
packing (solver.batch).

`_alloc_banded` is the plain version of kernel K3 (csrc/dense_solve.cu,
wrapper solver.priority_cuda.alloc_banded_k3): the CPU path runs it, the
tests hold it against the JAX package, and chip_smoke.py holds K3
against it on the card. The theta bisection runs as device tensors:
every step is a handful of elementwise ops on [G] tensors, with no host
sync inside the loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from doorman_tpu_torch.solver.lanes import (
    expand_rows,
    rowmax,
    rowsum,
    waterfill_level,
)

THETA_ITERS = 64  # matches algorithms.priority.THETA_ITERS (f64)


def _theta_iters(dtype: torch.dtype) -> int:
    """f64 runs the oracle's full 64 plain-bisection iterations for
    strict parity. f32 runs 32 and then recovers RELATIVE precision for
    tiny theta (a heavily over-capped group has theta* below the 2^-32
    absolute bisection granularity) with the multiplicative refinement
    of solve_priority — usage is ~linear in theta there, so one
    proportional step lands on theta* to f32 precision."""
    return THETA_ITERS if torch.finfo(dtype).bits >= 64 else 32


def _theta_refine_steps(dtype: torch.dtype) -> int:
    return 0 if torch.finfo(dtype).bits >= 64 else 2


def alloc_evaluations(dtype: torch.dtype, grouped: bool) -> int:
    """Banded allocations one solve_priority call runs: one without
    groups; with them fits_at_one, the bisection, two per refine step
    and the final pass (38 at f32, 66 at f64)."""
    if not grouped:
        return 1
    return 1 + _theta_iters(dtype) + 2 * _theta_refine_steps(dtype) + 1


@dataclass
class PriorityBatch:
    """Dense bucket layout: R resources x up to K clients, plus groups."""

    wants: torch.Tensor  # [R, K]
    weights: torch.Tensor  # [R, K] (subclients)
    band: torch.Tensor  # [R, K] int32 dense rank, 0 = highest
    active: torch.Tensor  # [R, K] bool
    capacity: torch.Tensor  # [R]
    group: torch.Tensor  # [R] int32 group id, -1 = uncoupled
    group_cap: torch.Tensor  # [G]


def _alloc_banded(
    wants: torch.Tensor,
    weights: torch.Tensor,
    band: torch.Tensor,
    active: torch.Tensor,
    capacity: torch.Tensor,
    num_bands: int,
) -> torch.Tensor:
    """Grants [R, K] for the given per-resource capacities: bands in
    rank order, each water-filled in the remainder."""
    zero = torch.zeros((), dtype=wants.dtype, device=wants.device)
    gets = torch.zeros_like(wants)
    remaining = capacity
    for rank in range(num_bands):
        m = active & (band == rank)
        w = torch.where(m, wants, zero)
        wt = torch.where(m, weights, zero)
        level = waterfill_level(
            w, wt, m, remaining, rowsum, rowmax, expand_rows
        )
        fits = expand_rows(rowsum(w) <= remaining)
        share = torch.where(
            fits, w, torch.minimum(w, expand_rows(level) * wt)
        )
        share = torch.where(m, share, zero)
        gets = gets + share
        remaining = torch.maximum(remaining - rowsum(share), zero)
    return gets


def solve_priority(
    batch,
    num_bands: int = 4,
    use_kernel: bool = False,
    combine=None,
):
    """Grants [R, K]; matches algorithms.priority.grouped_priority_alloc.

    `num_bands` bounds the band loop (the host packs dense ranks <
    num_bands; edges with band >= num_bands are never served).
    `use_kernel` runs each banded allocation through K3's wrapper
    (solver.priority_cuda.alloc_banded_k3: the kernel on CUDA tensors,
    the plain version on CPU tensors); False runs the plain version on
    any device.

    Row-sharded (parallel.sharded.make_sharded_priority_solver): `batch`
    is then the list of shards this process holds, in mesh order (rows
    of one PriorityBatch each, group_cap replicated), and the result the
    list of their grants. Group caps are the one coupling across rows,
    so `combine` — the counterpart of the reference's `combine_axes`,
    e.g. parallel.combine.Combine.sum — takes the per-shard [G] usage
    partials of each bisection evaluation and returns their total; the
    bisection then runs on the same totals everywhere. With one batch
    and combine=None the arithmetic is the single-device solve's.

    Group usage is summed per group in a fixed order (a masked [G, R]
    row sum, no atomics: left to right up to rowsum's sequential width,
    as the reference's segment sum adds on the CPU), so two calls on the
    same batch give bit-identical grants: `usage <= group_cap` cannot
    flip between identical ticks."""
    single = isinstance(batch, PriorityBatch)
    shards = [batch] if single else list(batch)
    if len(shards) > 1 and combine is None:
        raise ValueError(
            f"{len(shards)} shards need a combine for their group usage"
        )
    gets = _solve_shards(shards, num_bands, use_kernel, combine)
    return gets[0] if single else gets


def _solve_shards(shards, num_bands, use_kernel, combine):
    home = shards[0].wants
    dtype, dev = home.dtype, home.device
    one = torch.ones((), dtype=dtype, device=dev)
    allocs = [_allocator(b, num_bands, use_kernel) for b in shards]
    group_cap = shards[0].group_cap
    G = group_cap.shape[0]
    if G == 0:
        # No cross-resource caps configured: a single banded pass.
        return [alloc(b.capacity) for b, alloc in zip(shards, allocs)]
    # Per shard: the grouped mask, the gather index (clamped for
    # uncoupled resources, group id -1) and the [G, rows] membership.
    members = []
    for b in shards:
        grouped = b.group >= 0
        gidx = torch.where(grouped, b.group, 0).long()
        member = (
            gidx[None, :] == torch.arange(G, device=b.wants.device)[:, None]
        ) & grouped[None, :]
        members.append((grouped, gidx, member))

    def theta_rows(theta_g, b, grouped, gidx):
        t = theta_g.to(b.wants.device)
        return torch.where(grouped, t[gidx], torch.ones_like(t[0]))

    def usage_per_group(theta_g):  # [G] -> [G]
        parts = []
        for b, alloc, (grouped, gidx, member) in zip(shards, allocs, members):
            _gets, per_resource = alloc(
                b.capacity * theta_rows(theta_g, b, grouped, gidx),
                totals=True,
            )
            zero = torch.zeros((), dtype=dtype, device=b.wants.device)
            parts.append(
                rowsum(torch.where(member, per_resource[None, :], zero))
            )
        if combine is None:
            return parts[0]
        return combine(parts).to(dev)

    lo = torch.zeros(G, dtype=dtype, device=dev)
    hi = torch.ones(G, dtype=dtype, device=dev)
    # theta = 1 feasible => skip straight to 1 (matches the oracle's
    # early-out, which never bisects a group that already fits).
    fits_at_one = usage_per_group(hi) <= group_cap
    for _ in range(_theta_iters(dtype)):
        mid = (lo + hi) * 0.5
        feasible = usage_per_group(mid) <= group_cap
        lo, hi = torch.where(feasible, mid, lo), torch.where(feasible, hi, mid)
    tiny = torch.tensor(torch.finfo(dtype).tiny, dtype=dtype, device=dev)
    for _ in range(_theta_refine_steps(dtype)):
        # Proportional (relative-precision) refinement: scale the feasible
        # lo toward the cap; keep the candidate only if still feasible.
        u = usage_per_group(lo)
        cand = torch.where(u > 0, lo * group_cap / torch.maximum(u, tiny), lo)
        cand = torch.minimum(torch.maximum(cand, lo), hi)
        feasible = usage_per_group(cand) <= group_cap
        lo = torch.where(feasible, cand, lo)
    theta_g = torch.where(fits_at_one, one, lo)
    return [
        alloc(b.capacity * theta_rows(theta_g, b, grouped, gidx))
        for b, alloc, (grouped, gidx, _m) in zip(shards, allocs, members)
    ]


def _allocator(batch: PriorityBatch, num_bands: int, use_kernel: bool):
    """alloc(eff_cap, totals=False) -> gets (and each row's total) for
    one batch: K3's wrapper, or the plain banded fill."""
    zero = torch.zeros((), dtype=batch.wants.dtype, device=batch.wants.device)
    wants = torch.where(batch.active, batch.wants, zero)
    weights = torch.where(batch.active, batch.weights, zero)
    if use_kernel:
        from doorman_tpu_torch.solver.priority_cuda import alloc_banded_k3

        def alloc(eff_cap, totals=False):
            return alloc_banded_k3(
                wants, weights, batch.band, batch.active, eff_cap,
                num_bands, totals=totals,
            )
    else:
        def alloc(eff_cap, totals=False):
            gets = _alloc_banded(
                wants, weights, batch.band, batch.active, eff_cap,
                num_bands,
            )
            return (gets, rowsum(gets)) if totals else gets
    return alloc
