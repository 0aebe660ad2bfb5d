"""The algorithm lanes in plain PyTorch, written once over abstract
reductions (the port of doorman_tpu/solver/lanes.py).

This is the plain version of the dense solve kernels
(csrc/dense_solve.cu): the CPU path runs it, the tests hold it against
the JAX package's lanes, and chip_smoke.py holds the CUDA kernels
against it on the card. The reductions are supplied by the layout; the
dense row layout (solver.dense) sums and maxes within a row:

  segsum = rowsum(v), segmax = v.amax(dim=1), expand = totals[:, None]

`rowsum` adds a row left to right for rows up to SEQUENTIAL_ROW_MAX
lanes — a fixed, stated order, which is also the order XLA's CPU
reduction uses at those widths, so the CPU tests hold the port to the
JAX package bit-for-bit on the same inputs — and is torch's own
reduction beyond. Every elementwise expression is the reference's,
expression for expression, including the one multiply-add that XLA
contracts into a fused multiply-add (the top-up lane's `topped`, an
addcmul here); only the order of a sum may differ between the two
implementations and the kernels.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from doorman_tpu_torch.algorithms.kinds import AlgoKind
from doorman_tpu_torch.algorithms.tick import BALANCED_ROUNDS, FILL_ITERS

_REFINE_ITERS = 2

# Rows this narrow are summed left to right (see the module docstring).
SEQUENTIAL_ROW_MAX = 32

# The lanes whose fill is an iterative per-row computation in the row
# layout: row-layout callers may restrict each to its own rows via the
# compact gather→solve→scatter (lane_rows / fair_rows below).
ITERATIVE_KINDS = frozenset({
    int(AlgoKind.FAIR_SHARE),
    int(AlgoKind.MAX_MIN_FAIR),
    int(AlgoKind.BALANCED_FAIRNESS),
    int(AlgoKind.PROPORTIONAL_FAIRNESS),
})

Reduce = Callable[[torch.Tensor], torch.Tensor]
Expand = Callable[[torch.Tensor], torch.Tensor]


def bisect_iters(dtype: torch.dtype) -> int:
    """Bisection only needs to separate the saturation ratios (the final
    closed-form snap recovers exact arithmetic); 2^-30 relative suffices
    for f32, 2^-48 for f64."""
    return 48 if torch.finfo(dtype).bits >= 64 else 30


def rowsum(v: torch.Tensor) -> torch.Tensor:
    """Per-row sum of a [R, K] table: left to right up to
    SEQUENTIAL_ROW_MAX lanes, torch's reduction beyond."""
    K = v.shape[1]
    if K == 0 or K > SEQUENTIAL_ROW_MAX:
        return v.sum(dim=1)
    acc = v[:, 0]
    for j in range(1, K):
        acc = acc + v[:, j]
    return acc


def rowmax(v: torch.Tensor) -> torch.Tensor:
    return v.amax(dim=1)


def expand_rows(totals: torch.Tensor) -> torch.Tensor:
    return totals[:, None]


def _consts(like: torch.Tensor):
    dtype, dev = like.dtype, like.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    tiny = torch.tensor(torch.finfo(dtype).tiny, dtype=dtype, device=dev)
    return zero, one, tiny


def waterfill_level(
    wants: torch.Tensor,  # lease-shaped, already masked (inactive -> 0)
    weights: torch.Tensor,  # lease-shaped, masked
    active: torch.Tensor,  # lease-shaped bool
    capacity: torch.Tensor,  # per-resource
    segsum: Reduce,
    segmax: Reduce,
    expand: Expand,
) -> torch.Tensor:
    """Per-resource water level for weighted max-min fair share: bisection
    to locate the saturated set, then a closed-form snap
    L = (capacity - sum_sat_wants) / sum_unsat_weights that reproduces the
    sorting-based numpy oracle's arithmetic exactly. For underloaded
    resources the level is the max saturation ratio (everyone satisfied)."""
    zero, _one, tiny = _consts(wants)
    ninf = torch.full((), float("-inf"), dtype=wants.dtype, device=wants.device)
    sum_wants = segsum(wants)
    safe_w = torch.maximum(weights, tiny)
    ratio = torch.where(weights > 0, wants / safe_w, zero)
    max_ratio = segmax(torch.where(active, ratio, ninf))
    max_ratio = torch.where(torch.isfinite(max_ratio), max_ratio, zero)
    underloaded = sum_wants <= capacity

    lo = torch.zeros_like(capacity)
    hi = torch.maximum(max_ratio, zero)
    for _ in range(bisect_iters(wants.dtype)):
        mid = (lo + hi) * 0.5
        need_more = segsum(torch.minimum(wants, expand(mid) * weights)) < capacity
        lo, hi = torch.where(need_more, mid, lo), torch.where(need_more, hi, mid)
    level = hi
    for _ in range(_REFINE_ITERS):
        sat = wants <= expand(level) * weights
        sat_wants = segsum(torch.where(sat, wants, zero))
        unsat_weight = segsum(torch.where(sat, zero, weights))
        exact = torch.where(
            unsat_weight > 0,
            (capacity - sat_wants) / torch.maximum(unsat_weight, tiny),
            level,
        )
        level = torch.where(underloaded, level, torch.maximum(exact, zero))
    return torch.where(underloaded, max_ratio, level)


def _scatter_rows(like: torch.Tensor, rows: torch.Tensor, values: torch.Tensor):
    """zeros_like(like) with `values` written at `rows` (repeated rows
    carry identical values, so the duplicate writes agree)."""
    out = torch.zeros_like(like)
    out[rows.long()] = values
    return out


def waterfill_level_compact(wants, weights, active, capacity, fair_rows):
    """Row-layout water level with the bisection restricted to the rows
    that actually run FAIR_SHARE: gather, bisect on the [F, K] subtable,
    scatter the levels back — bit-identical per row because every
    reduction stays within a row. Non-fair rows read level 0, which no
    lane consumes."""
    r = fair_rows.long()
    lvl = waterfill_level(
        wants[r], weights[r], active[r], capacity[r],
        segsum=rowsum, segmax=rowmax, expand=expand_rows,
    )
    return _scatter_rows(capacity, r, lvl)


def iterfill_level(
    wants: torch.Tensor,  # lease-shaped, masked (inactive -> 0)
    weights: torch.Tensor,  # lease-shaped, masked
    capacity: torch.Tensor,  # per-resource
    segsum: Reduce,
    expand: Expand,
) -> torch.Tensor:
    """Per-resource water level by the fast-converging direct fill
    iteration (arxiv 2310.09699; oracle arithmetic in
    algorithms.tick.waterfill_level_iterative): start at the even split,
    freeze the saturated set, re-level the remainder; FILL_ITERS bounds
    the unroll. Only meaningful for overloaded rows."""
    zero, _one, tiny = _consts(wants)
    level = capacity / torch.maximum(segsum(weights), tiny)
    for _ in range(FILL_ITERS):
        sat = wants <= expand(level) * weights
        sat_wants = segsum(torch.where(sat, wants, zero))
        unsat_w = segsum(torch.where(sat, zero, weights))
        level_new = (capacity - sat_wants) / torch.maximum(unsat_w, tiny)
        level = torch.where(unsat_w > 0, torch.maximum(level, level_new), level)
    return level


def iterfill_level_compact(wants, weights, capacity, rows):
    """Row-layout iterative fill restricted to this lane's rows (same
    gather→solve→scatter as waterfill_level_compact)."""
    r = rows.long()
    lvl = iterfill_level(
        wants[r], weights[r], capacity[r], segsum=rowsum, expand=expand_rows,
    )
    return _scatter_rows(capacity, r, lvl)


def balanced_fill(
    wants: torch.Tensor,  # lease-shaped, masked
    weights: torch.Tensor,  # lease-shaped, masked (subclients)
    active: torch.Tensor,  # lease-shaped bool
    capacity: torch.Tensor,  # per-resource
    segsum: Reduce,
    segmax: Reduce,
    expand: Expand,
) -> torch.Tensor:
    """Balanced-fairness grants by the recursive cap-peeling formula
    (arxiv 1711.02880; oracle arithmetic in algorithms.tick
    .balanced_theta): each round the classes at the max cap ratio freeze
    at their wants (exact float equality against their own max, so the
    argmax class always peels); BALANCED_ROUNDS bounds the unroll.
    Overload form only; the caller's fits-where handles underload."""
    zero, one, tiny = _consts(wants)
    live0 = torch.where(active, one, zero)

    def ratios(fixed, remcap):
        livef = torch.where(fixed > 0, zero, live0)
        X = segsum(livef * weights)
        cap_ratio = X / torch.maximum(remcap, tiny)
        ratio = torch.where(
            (livef > 0) & (wants > 0),
            weights / torch.maximum(wants, tiny),
            zero,
        )
        max_ratio = torch.maximum(segmax(ratio), zero)
        return cap_ratio, ratio, max_ratio

    fixed = torch.zeros_like(wants)
    remcap = capacity
    for _ in range(BALANCED_ROUNDS):
        cap_ratio, ratio, max_ratio = ratios(fixed, remcap)
        peel = (ratio >= expand(max_ratio)) & expand(max_ratio > cap_ratio)
        fixed = torch.where(peel, one, fixed)
        remcap = remcap - segsum(torch.where(peel, wants, zero))
    cap_ratio, _ratio, max_ratio = ratios(fixed, remcap)
    theta = torch.maximum(cap_ratio, max_ratio)
    nu = one / torch.maximum(theta, tiny)
    return torch.where(
        fixed > 0, wants, torch.minimum(wants, weights * expand(nu))
    )


def balanced_fill_compact(wants, weights, active, capacity, rows):
    """Row-layout balanced fill restricted to this lane's rows; the
    scatter carries whole grant rows. Non-selected rows read grant 0."""
    r = rows.long()
    gets = balanced_fill(
        wants[r], weights[r], active[r], capacity[r],
        segsum=rowsum, segmax=rowmax, expand=expand_rows,
    )
    return _scatter_rows(wants, r, gets)


def solve_lanes(
    wants: torch.Tensor,  # lease-shaped
    has: torch.Tensor,
    subclients: torch.Tensor,
    active: torch.Tensor,  # bool
    capacity: torch.Tensor,  # per-resource
    algo_kind: torch.Tensor,  # per-resource int
    learning: torch.Tensor,  # per-resource bool
    static_capacity: torch.Tensor,  # per-resource
    segsum: Reduce,
    segmax: Reduce,
    expand: Expand,
    lanes: "Optional[frozenset]" = None,
    fair_rows: "Optional[torch.Tensor]" = None,
    lane_rows: "Optional[dict]" = None,
) -> torch.Tensor:
    """Grants, lease-shaped; inactive lanes produce 0.

    `lanes`: the AlgoKind values present in `algo_kind` (host knowledge);
    absent lanes are skipped — byte-identical, since the where-chain would
    never select them. None computes every lane. The LEARN replay is
    always applied.

    `fair_rows` / `lane_rows`: row-layout callers may restrict each
    ITERATIVE_KINDS lane's fill to its own rows ({int(AlgoKind): [F] row
    indices}; `fair_rows` folds in as the FAIR_SHARE entry) — the compact
    gather→solve→scatter, bit-identical per row."""
    zero, one, tiny = _consts(wants)
    wants = torch.where(active, wants, zero)
    has = torch.where(active, has, zero)
    sub = torch.where(active, subclients, zero)
    cap_e = expand(capacity)

    def need(kind_value) -> bool:
        return lanes is None or int(kind_value) in lanes

    rows_of = dict(lane_rows) if lane_rows else {}
    if fair_rows is not None:
        rows_of.setdefault(int(AlgoKind.FAIR_SHARE), fair_rows)

    sum_wants = segsum(wants)

    # ---- Lane: LEARN — replay the client's self-reported grant.
    gets_learn = has

    lane_outs = []

    # ---- Lane: NO_ALGORITHM — everyone gets what they want.
    if need(AlgoKind.NO_ALGORITHM):
        lane_outs.append((AlgoKind.NO_ALGORITHM, wants))

    # ---- Lane: STATIC — per-client configured cap.
    if need(AlgoKind.STATIC):
        lane_outs.append(
            (AlgoKind.STATIC, torch.minimum(expand(static_capacity), wants))
        )

    # `free` feeds the proportional lanes; `fits` the topup/fair lanes.
    if need(AlgoKind.PROPORTIONAL_SHARE) or need(AlgoKind.PROPORTIONAL_TOPUP):
        free = torch.maximum(cap_e - (expand(segsum(has)) - has), zero)
    if (
        need(AlgoKind.PROPORTIONAL_TOPUP)
        or need(AlgoKind.FAIR_SHARE)
        or need(AlgoKind.MAX_MIN_FAIR)
        or need(AlgoKind.BALANCED_FAIRNESS)
        or need(AlgoKind.PROPORTIONAL_FAIRNESS)
    ):
        fits = expand(sum_wants <= capacity)

    # ---- Lane: PROPORTIONAL_SHARE (simulation semantics): pure scaling
    # by capacity / all_wants in overload, clamped by the free capacity
    # as seen from the snapshot.
    if need(AlgoKind.PROPORTIONAL_SHARE):
        underloaded = expand(sum_wants < capacity)
        scaled = wants * (cap_e / expand(torch.maximum(sum_wants, tiny)))
        lane_outs.append((
            AlgoKind.PROPORTIONAL_SHARE,
            torch.where(
                underloaded,
                torch.minimum(wants, free),
                torch.minimum(scaled, free),
            ),
        ))

    # ---- Lane: FAIR_SHARE — full weighted max-min water-filling.
    if need(AlgoKind.FAIR_SHARE):
        fair = rows_of.get(int(AlgoKind.FAIR_SHARE))
        if fair is not None:
            level = waterfill_level_compact(wants, sub, active, capacity, fair)
        else:
            level = waterfill_level(
                wants, sub, active, capacity, segsum, segmax, expand
            )
        lane_outs.append((
            AlgoKind.FAIR_SHARE,
            torch.where(fits, wants, torch.minimum(wants, expand(level) * sub)),
        ))

    # ---- Lane: MAX_MIN_FAIR — client-granular (unweighted) max-min by
    # the direct fill (oracle algorithms.tick.max_min_fair_tick).
    if need(AlgoKind.MAX_MIN_FAIR):
        ones = torch.where(active, one, zero)
        rows = rows_of.get(int(AlgoKind.MAX_MIN_FAIR))
        if rows is not None:
            mm_level = iterfill_level_compact(wants, ones, capacity, rows)
        else:
            mm_level = iterfill_level(wants, ones, capacity, segsum, expand)
        lane_outs.append((
            AlgoKind.MAX_MIN_FAIR,
            torch.where(
                fits, wants, torch.minimum(wants, expand(mm_level) * ones)
            ),
        ))

    # ---- Lane: BALANCED_FAIRNESS — recursive cap-peeling shares
    # (oracle algorithms.tick.balanced_fairness_tick).
    if need(AlgoKind.BALANCED_FAIRNESS):
        rows = rows_of.get(int(AlgoKind.BALANCED_FAIRNESS))
        if rows is not None:
            bal = balanced_fill_compact(wants, sub, active, capacity, rows)
        else:
            bal = balanced_fill(
                wants, sub, active, capacity, segsum, segmax, expand
            )
        lane_outs.append((
            AlgoKind.BALANCED_FAIRNESS, torch.where(fits, wants, bal)
        ))

    # ---- Lane: PROPORTIONAL_FAIRNESS — Kelly log-utility dual fixpoint,
    # subclient-weighted (oracle algorithms.tick
    # .proportional_fairness_tick).
    if need(AlgoKind.PROPORTIONAL_FAIRNESS):
        rows = rows_of.get(int(AlgoKind.PROPORTIONAL_FAIRNESS))
        if rows is not None:
            pf_level = iterfill_level_compact(wants, sub, capacity, rows)
        else:
            pf_level = iterfill_level(wants, sub, capacity, segsum, expand)
        lane_outs.append((
            AlgoKind.PROPORTIONAL_FAIRNESS,
            torch.where(
                fits, wants, torch.minimum(wants, expand(pf_level) * sub)
            ),
        ))

    # ---- Lane: PROPORTIONAL_TOPUP (Go semantics, snapshot form): equal
    # share + top-up funded by clients under their equal share.
    if need(AlgoKind.PROPORTIONAL_TOPUP):
        count = segsum(sub)
        equal = (cap_e / expand(torch.maximum(count, tiny))) * sub
        under = wants < equal
        extra_capacity = expand(segsum(torch.where(under, equal - wants, zero)))
        extra_need = expand(segsum(torch.where(under, zero, wants - equal)))
        # One fused multiply-add, as XLA contracts this expression (and
        # as kernel K1 writes it with an explicit fma).
        topped = torch.addcmul(
            equal, wants - equal,
            extra_capacity / torch.maximum(extra_need, tiny),
        )
        lane_outs.append((
            AlgoKind.PROPORTIONAL_TOPUP,
            torch.where(
                fits | (wants <= equal),
                torch.minimum(wants, free),
                torch.minimum(topped, free),
            ),
        ))

    # The where-chain: each row takes its own kind's lane; a kind with no
    # lane here (e.g. PRIORITY_BANDS) solves to 0.
    kind_e = expand(algo_kind)
    gets = torch.zeros_like(wants)
    for kind_value, lane in lane_outs:
        gets = torch.where(kind_e == int(kind_value), lane, gets)
    # Learning-mode resources replay reported grants regardless of lane
    # (reference resource.go:108-111).
    gets = torch.where(expand(learning), gets_learn, gets)
    return torch.where(active, gets, zero)
