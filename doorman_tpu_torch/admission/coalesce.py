"""The grouped per-resource decide pass (port of
doorman_tpu/admission/coalesce.py `decide_grouped`; the Coalescer that
also uses it is not ported yet)."""

from __future__ import annotations

from typing import List, Tuple

from doorman_tpu_torch.algorithms import Request

__all__ = ["decide_grouped"]


def decide_grouped(server, work: List[Tuple[str, Request]]) -> List[tuple]:
    """`work` is (resource_id, Request) pairs; returns `(lease, resource,
    safe_capacity)` per pair IN INPUT ORDER, decided grouped by resource
    with each resource's requests replayed in arrival order. That is
    byte-identical to running the same stream through the per-request
    path: different resources touch disjoint stores, and safe_capacity
    is computed immediately after each decide, exactly where the
    per-request path computes it."""
    slots: List[tuple] = [None] * len(work)  # type: ignore[list-item]
    groups: dict = {}
    for i, (resource_id, request) in enumerate(work):
        groups.setdefault(resource_id, []).append((i, request))
    for resource_id, entries in groups.items():
        for i, request in entries:
            lease, res = server._decide(resource_id, request)
            slots[i] = (lease, res, res.safe_capacity())
    return slots
