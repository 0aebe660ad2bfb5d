"""Priority-banded, group-capped allocation — the numpy oracle.

BASELINE.json config 5 ("weighted multi-resource LP: client priorities +
cross-resource caps") made concrete as a water-filling scheme, the
lexicographic max-min relaxation of that LP:

  * Within a resource, clients are served in priority-band order (band 0
    first). Each band gets a weighted max-min (water-filling) share of
    the capacity left over from higher bands — the same fair-share
    semantics as AlgoKind.FAIR_SHARE (doc/algorithms.md), band by band.
    The reference leaves priority interpretation to the algorithm
    (reference doc/design.md:279: "The interpretation of the priority is
    up to the algorithm"; bands on the wire: doorman.proto
    PriorityBandAggregate) — this is doorman-tpu's priority-aware
    algorithm.
  * Resources may share a group cap (a shared upstream: Σ grants over
    the group <= group_cap, on top of each per-resource capacity). The
    coupling is resolved by uniformly scaling each member resource's
    effective capacity by theta in [0, 1], bisected per group to the
    largest feasible value — usage is monotone in theta, so this is
    well-defined and deterministic.

The batched solve (doorman_tpu_torch.solver.priority) must match these
numbers; tests drive both with the same tables.
"""

from __future__ import annotations

import numpy as np

from doorman_tpu_torch.algorithms.tick import fair_share_waterfill

THETA_ITERS = 64  # group-cap bisection depth (f64)


def band_waterfill(
    capacity: float, wants: np.ndarray, weights: np.ndarray
) -> np.ndarray:
    """Weighted max-min within one band: the exact sorting-based water
    fill shared with AlgoKind.FAIR_SHARE."""
    wants = np.asarray(wants, np.float64)
    if len(wants) == 0:
        return np.zeros_like(wants)
    if capacity <= 0:
        return np.zeros_like(wants)
    return fair_share_waterfill(capacity, wants, weights)


def priority_alloc(
    capacity: float,
    wants: np.ndarray,
    weights: np.ndarray,
    bands: np.ndarray,
) -> np.ndarray:
    """One resource: bands served lexicographically (0 = highest), each
    water-filled within the capacity the higher bands left over."""
    wants = np.asarray(wants, np.float64)
    weights = np.asarray(weights, np.float64)
    bands = np.asarray(bands)
    gets = np.zeros_like(wants)
    remaining = float(capacity)
    for band in sorted(set(bands.tolist())):
        m = bands == band
        share = band_waterfill(remaining, wants[m], weights[m])
        gets[m] = share
        remaining -= share.sum()
        if remaining <= 0:
            break
    return gets


def grouped_priority_alloc(
    capacities: np.ndarray,  # [R]
    wants: list,  # per resource: [n_r]
    weights: list,
    bands: list,
    group: np.ndarray,  # [R] group id, -1 = uncoupled
    group_cap: np.ndarray,  # [G]
) -> list:
    """All resources, with cross-resource group caps.

    Returns per-resource grant arrays. For each group, theta — the
    uniform scale on members' effective capacities — is bisected to the
    largest value whose total usage fits the group cap."""
    capacities = np.asarray(capacities, np.float64)
    group = np.asarray(group)
    R = len(capacities)

    def solve_all(theta_per_resource):
        return [
            priority_alloc(
                capacities[r] * theta_per_resource[r],
                wants[r], weights[r], bands[r],
            )
            for r in range(R)
        ]

    theta = np.ones(R, np.float64)
    for g in range(len(group_cap)):
        members = np.nonzero(group == g)[0]
        if len(members) == 0:
            continue

        def usage(t):
            total = 0.0
            for r in members:
                total += priority_alloc(
                    capacities[r] * t, wants[r], weights[r], bands[r]
                ).sum()
            return total

        if usage(1.0) <= group_cap[g]:
            continue
        lo, hi = 0.0, 1.0
        for _ in range(THETA_ITERS):
            mid = (lo + hi) / 2.0
            if usage(mid) <= group_cap[g]:
                lo = mid
            else:
                hi = mid
        theta[members] = lo
    return solve_all(theta)
