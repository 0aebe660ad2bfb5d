"""Per-tick (batch snapshot) allocation semantics — numpy oracles.

The TPU solver recomputes every lease of a resource at once from a coherent
snapshot taken at the start of a tick, instead of the reference's
per-request incremental updates. These numpy implementations DEFINE that
batch semantics; the batched solvers in `doorman_tpu_torch.solver` must match them
bit-for-bit (given exactly-representable inputs), and tests relate them back
to the reference's incremental semantics (they share fixed points).

Semantics notes (decisions the reference leaves implicit, recorded here per
SURVEY.md §7 "hard parts"):

  * Proportional share follows the simulation form
    (reference simulation/algo_proportional.py:31-65): in overload
    every client is scaled by capacity / all_wants, clamped by the free
    capacity. Two flavors:
      - `proportional_snapshot`: free capacity for every client is computed
        from the pre-tick grants (embarrassingly parallel; the headline
        kernel semantics);
      - `proportional_sequential`: exact replay of the simulation's
        client-by-client order, where earlier grants in the tick shrink the
        free capacity seen by later clients (the parity-oracle mode; the
        solver implements it as a lax.scan lane).
  * Fair share in batch form is FULL weighted max-min water-filling (the
    ideal the reference documents in doc/algorithms.md:59-69); the Go code's
    two-round redistribution (algorithm.go:95-211) is its truncation and is
    kept only as the scalar per-request algorithm. In a whole-tick solve the
    sum constraint is enforced exactly by the water level, so the per-client
    "available" clamp of the incremental form is unnecessary.
  * Static / None / Learn are pointwise.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "none_tick",
    "static_tick",
    "learn_tick",
    "proportional_snapshot",
    "proportional_sequential",
    "proportional_topup_snapshot",
    "fair_share_waterfill",
    "waterfill_level",
    "waterfill_level_iterative",
    "balanced_theta",
    "max_min_fair_tick",
    "balanced_fairness_tick",
    "proportional_fairness_tick",
    "oracle_row",
    "F32_PARITY_REL_BOUND",
    "FILL_ITERS",
    "BALANCED_ROUNDS",
]

# Fixed unroll bounds for the portfolio's iterative fills (device and
# host run the SAME bounded iteration, which is what makes the parity
# pin bit-level rather than tolerance-level). FILL_ITERS bounds the
# fast-converging water-fill of arxiv 2310.09699 (one bottleneck
# saturates per step at worst, so rows with up to FILL_ITERS distinct
# saturation cascades solve exactly; deeper cascades freeze at the last
# — still feasible — level). BALANCED_ROUNDS bounds the balanced-
# fairness cap-peeling recursion of arxiv 1711.02880 (one ratio class
# peels per round; unconverged rows keep slack, the documented
# insensitivity truncation).
FILL_ITERS = 16
BALANCED_ROUNDS = 8


def none_tick(wants: np.ndarray) -> np.ndarray:
    return wants.copy()


def static_tick(per_client_capacity: float, wants: np.ndarray) -> np.ndarray:
    return np.minimum(per_client_capacity, wants)


def learn_tick(has: np.ndarray) -> np.ndarray:
    return has.copy()


def proportional_snapshot(
    capacity: float, wants: np.ndarray, has_prev: np.ndarray
) -> np.ndarray:
    """Proportional share for one resource, all clients from one snapshot.

    `has_prev` are the grants outstanding from the previous tick; the free
    capacity seen by client i excludes its own previous grant (the sim
    clears the requester's `has` before summing leases).
    """
    all_wants = float(np.sum(wants))
    sum_leases = float(np.sum(has_prev))
    free = np.maximum(capacity - (sum_leases - has_prev), 0.0)
    if all_wants < capacity:
        return np.minimum(wants, free)
    proportion = capacity / all_wants
    return np.minimum(wants * proportion, free)


def proportional_sequential(
    capacity: float, wants: np.ndarray, has_prev: np.ndarray
) -> np.ndarray:
    """Exact replay of the simulation's per-client processing order within
    one tick: client i's free capacity reflects the new grants of clients
    0..i-1 and the previous grants of clients i+1.. ."""
    n = wants.shape[0]
    gets = np.zeros_like(wants)
    all_wants = float(np.sum(wants))
    sum_leases = float(np.sum(has_prev))  # running total of live leases
    proportion = capacity / all_wants if all_wants >= capacity else None
    for i in range(n):
        free = max(capacity - (sum_leases - has_prev[i]), 0.0)
        if proportion is None:
            g = min(wants[i], free)
        else:
            g = min(wants[i] * proportion, free)
        gets[i] = g
        sum_leases += g - has_prev[i]
    return gets


def proportional_topup_snapshot(
    capacity: float,
    wants: np.ndarray,
    has_prev: np.ndarray,
    subclients: np.ndarray,
) -> np.ndarray:
    """Snapshot form of the Go proportional share (equal share plus a top-up
    proportional to excess demand, reference algorithm.go:213-292): clients
    under their equal share (or when total wants fit) get their wants;
    otherwise equal_share_i + (wants_i - equal_share_i) * extra_capacity /
    extra_need. Grants are clamped by the capacity unused as of the
    snapshot. With all clients recomputed from one snapshot the reference's
    request-order dependence disappears."""
    wants = np.asarray(wants, dtype=np.float64)
    has_prev = np.asarray(has_prev, dtype=np.float64)
    sub = np.asarray(subclients, dtype=np.float64)
    count = float(np.sum(sub))
    sum_wants = float(np.sum(wants))
    sum_has = float(np.sum(has_prev))
    equal = (capacity / count) * sub
    # Unlike the Go form this clamps at 0 (a store overcommitted by a
    # previous learning phase must not produce negative grants); the sim's
    # free-capacity rule does the same.
    unused = np.maximum(capacity - (sum_has - has_prev), 0.0)
    if sum_wants <= capacity:
        return np.minimum(wants, unused)
    under = wants < equal
    extra_capacity = float(np.sum(np.where(under, equal - wants, 0.0)))
    extra_need = float(np.sum(np.where(under, 0.0, wants - equal)))
    topped = equal + (wants - equal) * (extra_capacity / extra_need)
    return np.where(
        wants <= equal, np.minimum(wants, unused), np.minimum(topped, unused)
    )


def waterfill_level(
    capacity: float, wants: np.ndarray, weights: np.ndarray
) -> float:
    """Exact water level L for weighted max-min fairness: each client gets
    min(wants_i, L * w_i) and the grants sum to `capacity` (assuming
    sum(wants) >= capacity; otherwise returns max ratio so everyone is
    satisfied). Computed by sorting the saturation ratios wants_i / w_i."""
    w = np.asarray(weights, dtype=np.float64)
    wants = np.asarray(wants, dtype=np.float64)
    if float(np.sum(wants)) <= capacity:
        ratios = np.where(w > 0, wants / np.maximum(w, 1e-300), 0.0)
        return float(np.max(ratios, initial=0.0))
    order = np.argsort(np.where(w > 0, wants / np.maximum(w, 1e-300), np.inf))
    r = (wants / np.maximum(w, 1e-300))[order]
    w_sorted = w[order]
    wants_sorted = wants[order]
    # After the first k clients saturate (get their wants), the rest share
    # the remainder at level L = remaining / remaining_weight; L is valid
    # when r[k-1] <= L <= r[k]. Zero-weight clients sort last (infinite
    # ratio) and can absorb no water: once the weighted clients are all
    # saturated, the level is the largest finite saturation ratio — NOT
    # zero, which would wrongly zero the already-saturated grants.
    remaining = capacity
    remaining_weight = float(np.sum(w_sorted))
    last_ratio = 0.0
    for k in range(len(r)):
        if remaining_weight <= 0:
            return last_ratio
        level = remaining / remaining_weight
        if level <= r[k]:
            return level
        remaining -= wants_sorted[k]
        remaining_weight -= w_sorted[k]
        if np.isfinite(r[k]):
            last_ratio = float(r[k])
    return (
        remaining / remaining_weight if remaining_weight > 0 else last_ratio
    )


def fair_share_waterfill(
    capacity: float, wants: np.ndarray, subclients: np.ndarray
) -> np.ndarray:
    """Full weighted max-min fair share: if total wants fit, grant wants;
    otherwise grant min(wants_i, L * subclients_i) at the exact water level."""
    wants = np.asarray(wants, dtype=np.float64)
    sub = np.asarray(subclients, dtype=np.float64)
    if float(np.sum(wants)) <= capacity:
        return wants.copy()
    level = waterfill_level(capacity, wants, sub)
    return np.minimum(wants, level * sub)


def waterfill_level_iterative(
    capacity: float,
    wants: np.ndarray,
    weights: np.ndarray,
    iters: int = FILL_ITERS,
) -> float:
    """Water level by the fast-converging direct fill iteration (arxiv
    2310.09699): start from the even split, repeatedly freeze the
    saturated set and re-level the remainder. The level is monotonically
    non-decreasing (frozen clients consume less than their level share),
    so `max` IS the convergence mask: a converged row rewrites its own
    level. Exact once every bottleneck cascade has frozen (at most one
    new ratio class per step); truncation keeps the last — still
    feasible — level. This is the oracle arithmetic for the
    MAX_MIN_FAIR (weights = 1) and PROPORTIONAL_FAIRNESS (weights =
    subclients; the Kelly dual fixpoint — on a single capacity the
    KKT point of Σ wᵢ·log(gᵢ) s.t. Σ g ≤ C, g ≤ wants is exactly
    min(wants, ν·w)) device lanes: solver.lanes runs the SAME bounded
    iteration."""
    tiny = np.finfo(np.float64).tiny
    wants = np.asarray(wants, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    level = capacity / max(float(np.sum(w)), tiny)
    for _ in range(iters):
        sat = wants <= level * w
        sat_wants = float(np.sum(np.where(sat, wants, 0.0)))
        unsat_w = float(np.sum(np.where(sat, 0.0, w)))
        if unsat_w > 0:
            level = max(level, (capacity - sat_wants) / max(unsat_w, tiny))
    return level


def max_min_fair_tick(capacity: float, wants: np.ndarray) -> np.ndarray:
    """Client-granular (unweighted) max-min fairness: gets =
    min(wants, L) at the iterative water level; subclient counts do not
    weight the fill (that is FAIR_SHARE's semantics)."""
    wants = np.asarray(wants, dtype=np.float64)
    if float(np.sum(wants)) <= capacity:
        return wants.copy()
    level = waterfill_level_iterative(
        capacity, wants, np.ones_like(wants)
    )
    return np.minimum(wants, level)


def proportional_fairness_tick(
    capacity: float, wants: np.ndarray, subclients: np.ndarray
) -> np.ndarray:
    """Weighted proportional fairness (Kelly log-utility, arxiv
    1404.2266): maximize Σ subᵢ·log(gᵢ) subject to Σ g ≤ capacity and
    g ≤ wants. The KKT point is min(wants, ν·sub) with the dual level ν
    solved by the bounded fixpoint iteration — on one capacity this
    coincides with FAIR_SHARE's weighted water-fill objective, but the
    level arithmetic is the dual iteration, not the bisection+snap (the
    two lanes agree to ~1 ulp when both converge; doc/algorithms.md)."""
    wants = np.asarray(wants, dtype=np.float64)
    sub = np.asarray(subclients, dtype=np.float64)
    if float(np.sum(wants)) <= capacity:
        return wants.copy()
    level = waterfill_level_iterative(capacity, wants, sub)
    return np.minimum(wants, level * sub)


def balanced_theta(
    capacity: float,
    wants: np.ndarray,
    weights: np.ndarray,
    rounds: int = BALANCED_ROUNDS,
) -> "tuple[float, np.ndarray]":
    """Balanced-fairness binding ratio θ and the cap-fixed class mask,
    by the recursive cap-peeling formula (arxiv 1711.02880, the
    single-pool instantiation): shares are proportional to weights
    (per-class job counts), scaled by the MOST binding constraint —
    the pool (θ = Σx/Ĉ) or some class's rate cap (θ = xᵢ/wantsᵢ).
    Each round the classes achieving the max cap ratio freeze at their
    wants and leave the recursion (exactly one ratio class per round,
    mirroring the paper's one-job-removal recursion); the pool ratio
    takes over when it dominates — the convergence mask is the peel
    set emptying. Truncation after `rounds` leaves capacity unclaimed
    (the insensitivity tax; documented, and why BALANCED_FAIRNESS
    carries no Pareto-efficiency invariant)."""
    tiny = np.finfo(np.float64).tiny
    wants = np.asarray(wants, dtype=np.float64)
    x = np.asarray(weights, dtype=np.float64)
    fixed = np.zeros(wants.shape, dtype=bool)
    remcap = float(capacity)

    def ratios(fixed):
        live = ~fixed
        X = float(np.sum(np.where(live, x, 0.0)))
        cap_ratio = X / max(remcap, tiny)
        ratio = np.where(
            live & (wants > 0), x / np.maximum(wants, tiny), 0.0
        )
        return cap_ratio, ratio, float(np.max(ratio, initial=0.0))

    for _ in range(rounds):
        cap_ratio, ratio, max_ratio = ratios(fixed)
        if max_ratio > cap_ratio:
            peel = (~fixed) & (wants > 0) & (ratio >= max_ratio)
            fixed = fixed | peel
            remcap = remcap - float(np.sum(np.where(peel, wants, 0.0)))
    cap_ratio, _ratio, max_ratio = ratios(fixed)
    return max(cap_ratio, max_ratio), fixed


def balanced_fairness_tick(
    capacity: float, wants: np.ndarray, subclients: np.ndarray
) -> np.ndarray:
    """Balanced fairness for one pool: cap-fixed classes get their
    wants; the rest get their weight share xᵢ/θ at the final binding
    ratio (clamped at wants — θ is not monotone across rounds)."""
    tiny = np.finfo(np.float64).tiny
    wants = np.asarray(wants, dtype=np.float64)
    x = np.asarray(subclients, dtype=np.float64)
    if float(np.sum(wants)) <= capacity:
        return wants.copy()
    theta, fixed = balanced_theta(capacity, wants, x)
    nu = 1.0 / max(theta, tiny)
    return np.where(fixed, wants, np.minimum(wants, x * nu))


# The ONE f32 parity bound (BASELINE.md "parity ladder"): the f32 /
# pallas solve must stay within this of the f64 oracles, relative to the
# row's grant scale. Enforced off-chip by tests/test_f32_parity.py and
# on-chip by bench.gate_pallas_kernels — both import it from here so a
# re-characterization cannot desynchronize the two gates.
F32_PARITY_REL_BOUND = 1e-6


def oracle_row(
    kind: int,
    capacity: float,
    static_capacity: float,
    wants: np.ndarray,
    has: np.ndarray,
    subclients: np.ndarray,
) -> np.ndarray:
    """Dispatch one resource row to its lane oracle — the shared
    comparison helper for every f32/pallas parity check."""
    from doorman_tpu_torch.algorithms.kinds import AlgoKind

    if kind == AlgoKind.NO_ALGORITHM:
        return none_tick(wants)
    if kind == AlgoKind.STATIC:
        return static_tick(static_capacity, wants)
    if kind == AlgoKind.PROPORTIONAL_SHARE:
        return proportional_snapshot(capacity, wants, has)
    if kind == AlgoKind.PROPORTIONAL_TOPUP:
        return proportional_topup_snapshot(
            capacity, wants, has, subclients
        )
    if kind == AlgoKind.FAIR_SHARE:
        return fair_share_waterfill(capacity, wants, subclients)
    if kind == AlgoKind.MAX_MIN_FAIR:
        return max_min_fair_tick(capacity, wants)
    if kind == AlgoKind.BALANCED_FAIRNESS:
        return balanced_fairness_tick(capacity, wants, subclients)
    if kind == AlgoKind.PROPORTIONAL_FAIRNESS:
        return proportional_fairness_tick(capacity, wants, subclients)
    raise ValueError(f"no scalar oracle for algorithm lane {kind}")
