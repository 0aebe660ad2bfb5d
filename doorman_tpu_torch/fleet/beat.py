"""The reconcile beat's wire form.

doc/federation.md promised it: a wire deployment runs the POP
reconciliation step over the EXISTING RPC surface. Each shard reports
its straddle summary as a `GetServerCapacity` — the compact per-band
aggregate shape the protocol already carries, never per-client rows —
and receives its share back as the response lease, expiry included.
This module is that promise made concrete:

  * the codec: ShardSummary <-> ServerCapacityResourceRequest. One
    PriorityBandAggregate per demand-curve breakpoint (priority is the
    breakpoint index, num_clients the aggregated weight, wants the
    aggregated wants), `has` carries the shard's granted sum. O(distinct
    ratios) on the wire, exactly like the in-process summary.
  * `shard_server_id` / `parse_shard_server_id`: the server_id
    convention ("fleet-shard-<k>") that marks a GetServerCapacity as a
    beat report and names the reporting shard.
  * BeatCore: the transport-free beat state for the PUSH deployment —
    each report folds into the per-resource reconciler together with
    the other shards' last-known summaries; shards that have not
    reported within `stale_after` count as unreachable, so their shares
    freeze and drain exactly as a partition does in-process.

Breakpoint ratios are recomputed on decode as Σwants/Σweight — exact
whenever a breakpoint's clients share a representable wants/weight
quotient (they share the exact ratio by construction; integer weights
keep the round-trip lossless), and within 1 ulp otherwise, which the
level comparisons tolerate by the same argument as the local solves.

Port of doorman_tpu/fleet/beat.py: a copy apart from import paths.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Set, Tuple

from doorman_tpu_torch.federation.reconcile import (
    ShardSummary,
    StraddleReconciler,
)
from doorman_tpu_torch.proto import doorman_pb2 as pb

__all__ = [
    "BeatCore",
    "SHARD_REPORT_PREFIX",
    "decode_summary",
    "encode_summary",
    "parse_shard_server_id",
    "shard_server_id",
]

SHARD_REPORT_PREFIX = "fleet-shard-"


def shard_server_id(shard: int) -> str:
    """The server_id a shard reports under — what marks the RPC as a
    beat report rather than an intermediate's aggregation."""
    return f"{SHARD_REPORT_PREFIX}{int(shard)}"


def parse_shard_server_id(server_id: str) -> Optional[int]:
    """Inverse of shard_server_id; None for ordinary server ids."""
    if not server_id.startswith(SHARD_REPORT_PREFIX):
        return None
    try:
        return int(server_id[len(SHARD_REPORT_PREFIX):])
    except ValueError:
        return None


def encode_summary(
    summary: ShardSummary, resource_id: str
) -> pb.ServerCapacityResourceRequest:
    """ShardSummary -> the wire aggregate. priority indexes the
    breakpoint (the curve is sorted by ratio, so the index IS the
    order), num_clients carries the aggregated weight, wants the
    aggregated wants; `has` reports the shard's granted sum."""
    req = pb.ServerCapacityResourceRequest(resource_id=resource_id)
    req.has.capacity = float(summary.has)
    for i, (_ratio, wants, weight) in enumerate(summary.breakpoints):
        req.wants.add(
            priority=i,
            num_clients=int(round(weight)),
            wants=float(wants),
        )
    return req


def decode_summary(
    req: pb.ServerCapacityResourceRequest, shard: int
) -> ShardSummary:
    """Wire aggregate -> ShardSummary. Ratios are recomputed from the
    aggregated sums (see module docstring for the exactness bound);
    bands arrive breakpoint-ordered but are re-sorted defensively —
    the curve's invariant, not the sender's, is what the fill math
    needs."""
    breakpoints = []
    wants_sum = 0.0
    weight_sum = 0.0
    for band in req.wants:
        weight = float(band.num_clients) or 1.0
        wants = float(band.wants)
        breakpoints.append((wants / weight, wants, weight))
        wants_sum += wants
        weight_sum += weight
    breakpoints.sort(key=lambda b: b[0])
    return ShardSummary(
        shard=int(shard),
        wants=wants_sum,
        has=float(req.has.capacity),
        weight=weight_sum,
        breakpoints=tuple(breakpoints),
    )


class BeatCore:
    """Push-mode beat state: one StraddleReconciler per straddling
    resource, fed one shard report at a time.

    The pull deployment (FleetController) sweeps every shard in one
    step, so Σ installed shares ≤ capacity holds within a single beat.
    Push-mode installs are staggered — each shard's share lands when
    ITS report arrives — so the pointwise bound holds at report-round
    granularity: every fresh shard re-reports within `stale_after`, a
    silent shard freezes at its last share, and the frozen window
    (share expiry + lease length) covers every grant issued under a
    stale share, exactly the in-process drain argument.

    `template(rid)` supplies (capacity, kind, lease_length) for a
    straddling resource — the fleet head reads it from the same config
    file the shards serve, the one copy of truth the whole straddle
    answers to."""

    def __init__(
        self,
        template: Callable[[str], Optional[Tuple[float, int, float]]],
        *,
        expected: Iterable[int],
        share_ttl: float = 10.0,
        stale_after: Optional[float] = None,
        clock: Callable[[], float] = time.time,
    ):
        self._template = template
        self.expected: Set[int] = set(int(s) for s in expected)
        self.share_ttl = float(share_ttl)
        # A shard is presumed partitioned after 2 missed report
        # intervals unless the caller says otherwise.
        self.stale_after = (
            float(stale_after) if stale_after is not None
            else 2.0 * self.share_ttl
        )
        self._clock = clock
        self._reconcilers: Dict[str, StraddleReconciler] = {}
        # Last fresh report per (resource, shard) — the push analog of
        # the pull sweep's summaries dict.
        self._reports: Dict[str, Dict[int, Tuple[ShardSummary, float]]] = {}
        self.reports = 0

    def set_expected(self, expected: Iterable[int]) -> None:
        """Reshard seam: the active set changed. Departed shards stop
        being expected, so their silence is drain, not partition alarm
        — either way the freeze covers them."""
        self.expected = set(int(s) for s in expected)

    def _reconciler(self, rid: str) -> Optional[StraddleReconciler]:
        rec = self._reconcilers.get(rid)
        if rec is not None:
            return rec
        tpl = self._template(rid)
        if tpl is None:
            return None
        capacity, kind, lease_length = tpl
        rec = StraddleReconciler(
            rid,
            float(capacity),
            int(kind),
            share_ttl=self.share_ttl,
            lease_length=float(lease_length),
        )
        self._reconcilers[rid] = rec
        return rec

    def offer(
        self, shard: int, rid: str, summary: ShardSummary
    ) -> Optional[Tuple[float, float]]:
        """Fold one shard's report in and compute its share. Returns
        (share, expiry) to send back as the response lease, or None
        when the resource has no reconciler (not straddling / no
        template)."""
        rec = self._reconciler(rid)
        if rec is None:
            return None
        now = self._clock()
        self.reports += 1
        reports = self._reports.setdefault(rid, {})
        reports[int(shard)] = (summary, now)
        fresh: Dict[int, ShardSummary] = {}
        for s, (summ, at) in list(reports.items()):
            if s != int(shard) and now - at > self.stale_after:
                continue
            if s in self.expected or s == int(shard):
                fresh[s] = summ
        unreachable = self.expected - set(fresh)
        shares = rec.reconcile(fresh, now, unreachable=unreachable)
        value = shares.get(int(shard))
        if value is None:
            return None
        return float(value), now + rec.share_ttl

    def straddle_capacities(self) -> Dict[str, float]:
        return {
            rid: rec.capacity for rid, rec in self._reconcilers.items()
        }

    def has_sums(self) -> Dict[str, float]:
        """Σ reported grants per resource over every shard's LAST
        report — stale reports included, because a silent shard's
        grants still exist until they drain. This is the wire-plane
        reading of the fed_capacity_sum invariant (the smoke asserts
        it against straddle_capacities every beat round)."""
        return {
            rid: sum(s.has for (s, _at) in reports.values())
            for rid, reports in self._reports.items()
        }

    def status(self) -> dict:
        now = self._clock()
        return {
            "expected": sorted(self.expected),
            "share_ttl": self.share_ttl,
            "stale_after": self.stale_after,
            "reports": self.reports,
            "resources": {
                rid: {
                    "reconciler": rec.status(),
                    "last_report": {
                        s: round(now - at, 3)
                        for s, (_summ, at) in sorted(
                            self._reports.get(rid, {}).items()
                        )
                    },
                }
                for rid, rec in sorted(self._reconcilers.items())
            },
        }
