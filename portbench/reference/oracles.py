"""Frozen copy of the port's numpy oracles of the upstream wire kinds'
per-tick semantics (doorman_tpu_torch/algorithms/tick.py at commit
37ca06e: the none, static, proportional-share snapshot and fair-share
ticks, and `oracle_row` with AlgoKind written as its values). Kept here
so that a later change to the port cannot move the yardstick; the
benchmark's vectorised reference (reference/vector.py) is held to these
in the benchmark's own tests.
"""

from __future__ import annotations

import numpy as np


def none_tick(wants: np.ndarray) -> np.ndarray:
    return wants.copy()


def static_tick(per_client_capacity: float, wants: np.ndarray) -> np.ndarray:
    return np.minimum(per_client_capacity, wants)


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
    if kind == 0:
        return none_tick(wants)
    if kind == 1:
        return static_tick(static_capacity, wants)
    if kind == 2:
        return proportional_snapshot(capacity, wants, has)
    if kind == 3:
        return fair_share_waterfill(capacity, wants, subclients)
    raise ValueError(f"no scalar oracle for algorithm lane {kind}")
