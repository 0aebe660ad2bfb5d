"""POP-style straddling-capacity reconciliation.

A straddling resource's configured capacity is split across every root
shard; each shard solves its LOCAL clients against its share through the
completely ordinary tick/decide machinery. What makes the split
near-lossless (POP, arxiv 2110.11927) is a small per-tick reconciliation
step: every shard reports a compact demand summary (sums and — for
FAIR_SHARE — the piecewise-linear demand curve's breakpoints, NOT
per-client rows), the resource's home reconciler recomputes the shard
shares from the merged summaries, and slack freed on one shard is
re-offered to the others next tick.

Share math per algorithm lane (doc/federation.md derives these):

  * NO_ALGORITHM / STATIC — pointwise per-client semantics: the
    capacity template is a per-client parameter, not a shared total, so
    every shard keeps the FULL configured value and the capacity-sum
    invariant does not apply (a single root overcommits identically).
  * PROPORTIONAL_SHARE (and the topup variant) — demand-proportional:
    under total demand W <= C each shard gets its demand plus an even
    split of the slack (so a local spike next tick is not capped at
    yesterday's demand); in overload c_s = W_s * (C / W), which makes
    the local solve's scale factor c_s / W_s recover the global C / W —
    the single-root allocation (bit-identical whenever that quotient
    round-trips exactly, e.g. any dyadic global ratio; within 1 ulp
    otherwise).
  * FAIR_SHARE — the exact global water level L is computed from the
    merged breakpoint curves (waterfill_level over pseudo-clients, one
    per distinct wants/weight ratio per shard — merging equal-ratio
    clients preserves the level exactly), and each shard's share is its
    own curve evaluated at L. The local water-fill then re-derives a
    level within 1 ulp of L, so grants match the single root to 1 ulp.
  * MAX_MIN_FAIR / PROPORTIONAL_FAIRNESS — same curve decomposition,
    but the global level comes from the lane's OWN bounded fill
    iteration (algorithms.tick.waterfill_level_iterative) so the level
    a shard re-derives locally is the reconciler's: MAX_MIN_FAIR's
    curve aggregates client-granular (weight 1), PROPORTIONAL_FAIRNESS
    by wants/subclients.
  * BALANCED_FAIRNESS — the bounded cap-peeling recursion
    (algorithms.tick.balanced_theta) runs over the merged
    pseudo-clients; a shard's share is the sum of its own clients'
    balanced grants (wants when cap-fixed, weight/θ otherwise). The
    local recursion re-peels the shard's restriction of the global
    fixed set, recovering the global allocation whenever it converges
    within BALANCED_ROUNDS.

Failure containment: a shard the reconciler cannot reach keeps serving
its LAST granted share until that share's expiry (the share is installed
as a parent-style capacity lease), then decays to zero capacity — the
blast radius of a partitioned shard is that shard alone. Its frozen
share keeps counting against the pool until expiry PLUS the resource's
lease length (grants issued under the stale share live that long), so
the hard invariant Σ shard shares <= configured capacity — and with it
Σ shard grants <= configured capacity — holds on every tick, partition
or not. Only after that drain window is the lost shard's slack
re-offered to the survivors.

Port of doorman_tpu/federation/reconcile.py: a copy apart from import paths.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

import numpy as np

from doorman_tpu_torch.algorithms.kinds import AlgoKind
from doorman_tpu_torch.algorithms.tick import (
    balanced_theta,
    waterfill_level,
    waterfill_level_iterative,
)

__all__ = [
    "ShardSummary",
    "StraddleReconciler",
    "summarize_resource",
    "CAPACITY_SPLIT_KINDS",
]

# Lanes whose capacity is a shared total the reconciler splits; the
# pointwise lanes (NO_ALGORITHM, STATIC) keep the full template value on
# every shard. PRIORITY_BANDS straddling is not supported: band
# preemption is a cross-client coupling the compact summaries cannot
# carry — route banded resources whole (ShardRouter overrides).
CAPACITY_SPLIT_KINDS = frozenset({
    int(AlgoKind.PROPORTIONAL_SHARE),
    int(AlgoKind.PROPORTIONAL_TOPUP),
    int(AlgoKind.FAIR_SHARE),
    int(AlgoKind.MAX_MIN_FAIR),
    int(AlgoKind.BALANCED_FAIRNESS),
    int(AlgoKind.PROPORTIONAL_FAIRNESS),
})

# Lanes whose breakpoint curve aggregates by the CLIENT-granular ratio
# wants/1 rather than wants/subclients: MAX_MIN_FAIR's fill ignores
# subclient weights, so merging by the weighted ratio would fuse
# clients that saturate at different levels.
_UNWEIGHTED_KINDS = frozenset({int(AlgoKind.MAX_MIN_FAIR)})


@dataclass(frozen=True)
class ShardSummary:
    """One shard's compact per-resource demand report: sums plus the
    fair-share demand curve aggregated by saturation ratio. O(distinct
    ratios), never O(clients)."""

    shard: int
    wants: float = 0.0
    has: float = 0.0
    weight: float = 0.0  # Σ subclients
    # ((wants/weight ratio, Σ wants at that ratio, Σ weight), ...) —
    # sorted by ratio; enough to evaluate Σ min(w_i, L * sub_i) for any
    # level L without per-client data.
    breakpoints: Tuple[Tuple[float, float, float], ...] = ()

    def demand_at_level(self, level: float) -> float:
        """Σ min(wants_i, level * weight_i) over this shard's clients —
        exact from the breakpoint curve (clients at one ratio saturate
        together)."""
        total = 0.0
        for ratio, wants, weight in self.breakpoints:
            total += wants if ratio <= level else level * weight
        return total


def summarize_resource(
    resource, shard: int, kind: "int | None" = None
) -> ShardSummary:
    """Build a shard's summary from its live store rows. The caller
    sweeps expiries first (store.clean()) so lapsed leases do not haunt
    the demand curve; dump_rows is the stores' bulk drain (one C call on
    the native engine). `kind` selects the lane's weighting for the
    breakpoint curve: MAX_MIN_FAIR aggregates client-granular (weight
    1 per client); the weighted lanes aggregate by wants/subclients."""
    unweighted = kind is not None and int(kind) in _UNWEIGHTED_KINDS
    by_ratio: Dict[float, list] = {}
    wants_sum = 0.0
    has_sum = 0.0
    weight_sum = 0.0
    for (_client, _expiry, _refresh, has, wants, subclients,
         _priority) in resource.store.dump_rows():
        weight = 1.0 if unweighted else (float(subclients) or 1.0)
        ratio = wants / weight
        acc = by_ratio.setdefault(ratio, [0.0, 0.0])
        acc[0] += wants
        acc[1] += weight
        wants_sum += wants
        has_sum += has
        weight_sum += weight
    return ShardSummary(
        shard=shard,
        wants=wants_sum,
        has=has_sum,
        weight=weight_sum,
        breakpoints=tuple(
            (r, by_ratio[r][0], by_ratio[r][1]) for r in sorted(by_ratio)
        ),
    )


@dataclass
class _ShareState:
    value: float
    expiry: float


class StraddleReconciler:
    """The per-resource reconciliation state machine (one per straddling
    resource, owned by the resource's home shard — in-process harnesses
    hold them all in FederatedRoots)."""

    def __init__(
        self,
        resource_id: str,
        capacity: float,
        kind: int,
        *,
        share_ttl: float,
        lease_length: float = 0.0,
    ):
        if int(kind) == int(AlgoKind.PRIORITY_BANDS):
            raise ValueError(
                f"straddling resource {resource_id!r} uses "
                "PRIORITY_BANDS: band preemption does not decompose "
                "into compact per-shard summaries — route it whole "
                "(ShardRouter overrides) instead of straddling it"
            )
        self.resource_id = resource_id
        self.capacity = float(capacity)
        self.kind = int(kind)
        self.share_ttl = float(share_ttl)
        self.lease_length = float(lease_length)
        # Last summary and last granted share per shard; unreachable
        # shards coast on these until the drain window closes.
        self._summaries: Dict[int, ShardSummary] = {}
        self._shares: Dict[int, _ShareState] = {}
        # Per-reconcile stats for flight recorders / status pages.
        self.last: dict = {}

    # -- the reconciliation step ---------------------------------------

    def reconcile(
        self,
        summaries: Dict[int, ShardSummary],
        now: float,
        *,
        unreachable: Optional[Set[int]] = None,
    ) -> Dict[int, float]:
        """One step: fold the reachable shards' fresh summaries in,
        compute every reachable shard's new share, and return the
        shares to install ({shard: capacity}). Unreachable shards get
        nothing installed (nothing could deliver it) but their frozen
        shares stay charged against the pool through the drain window."""
        unreachable = set(unreachable or ())
        self._summaries.update(summaries)
        live = sorted(summaries.keys() - unreachable)
        frozen = 0.0
        for shard, share in list(self._shares.items()):
            if shard in live:
                continue
            if now >= share.expiry + self.lease_length:
                # Share lapsed AND every grant issued under it has
                # drained: the slack is finally safe to re-offer.
                del self._shares[shard]
                self._summaries.pop(shard, None)
            else:
                frozen += share.value
        shares = self._compute_shares(live, max(self.capacity - frozen, 0.0))
        expiry = now + self.share_ttl
        for shard, value in shares.items():
            self._shares[shard] = _ShareState(value, expiry)
        self.last = {
            "live": list(live),
            "frozen": round(frozen, 6),
            "shares": {s: round(v, 6) for s, v in sorted(shares.items())},
        }
        return shares

    def _compute_shares(self, live, pool: float) -> Dict[int, float]:
        if not live:
            return {}
        if self.kind not in CAPACITY_SPLIT_KINDS:
            # Pointwise lanes: the template value is per-client config;
            # every shard keeps the full configured value.
            return {shard: self.capacity for shard in live}
        summaries = [self._summaries[s] for s in live]
        wants = [s.wants for s in summaries]
        total = float(sum(wants))
        if total <= pool:
            # Underloaded: demand plus an even split of the slack, so a
            # shard-local spike next tick is not capped at this tick's
            # demand (the POP re-offer in its quiet form).
            slack = (pool - total) / len(live)
            return {
                s.shard: s.wants + slack for s in summaries
            }
        if self.kind == int(AlgoKind.FAIR_SHARE):
            return self._fair_shares(summaries, pool)
        if self.kind in (
            int(AlgoKind.MAX_MIN_FAIR),
            int(AlgoKind.PROPORTIONAL_FAIRNESS),
        ):
            return self._level_shares(summaries, pool)
        if self.kind == int(AlgoKind.BALANCED_FAIRNESS):
            return self._balanced_shares(summaries, pool)
        # Proportional lanes: the global scale factor, distributed so
        # each local solve recovers it (c_s / W_s == pool / total up to
        # the quotient round-trip).
        prop = pool / total
        shares = {s.shard: s.wants * prop for s in summaries}
        return self._clamp(shares, pool)

    @staticmethod
    def _merged(summaries):
        """Flat (wants, weights, shard-slice) arrays over every shard's
        breakpoint pseudo-clients. A pseudo-client is exact for every
        portfolio fill: its saturation test W <= L·U is equivalent to
        the common per-client ratio r <= L, and its sums enter the
        level updates exactly as the per-client sums do."""
        wants = np.array(
            [w for s in summaries for (_r, w, _wt) in s.breakpoints],
            np.float64,
        )
        weights = np.array(
            [wt for s in summaries for (_r, _w, wt) in s.breakpoints],
            np.float64,
        )
        slices = []
        pos = 0
        for s in summaries:
            n = len(s.breakpoints)
            slices.append(slice(pos, pos + n))
            pos += n
        return wants, weights, slices

    def _fair_shares(self, summaries, pool: float) -> Dict[int, float]:
        """Exact global water level over the merged breakpoint curves,
        then each shard's share is its own curve at that level."""
        wants, weights, _slices = self._merged(summaries)
        if wants.size == 0:
            return {s.shard: pool / len(summaries) for s in summaries}
        level = waterfill_level(pool, wants, weights)
        shares = {
            s.shard: s.demand_at_level(level) for s in summaries
        }
        return self._clamp(shares, pool)

    def _level_shares(self, summaries, pool: float) -> Dict[int, float]:
        """MAX_MIN_FAIR / PROPORTIONAL_FAIRNESS: the global level from
        the lane's OWN bounded fill iteration over the merged
        pseudo-clients (matching the local solves' arithmetic, so the
        level each shard re-derives from its share is the global one to
        ~1 ulp), then each shard's share is its curve at that level.
        MAX_MIN_FAIR's curve is client-granular (weight 1; see
        summarize_resource), so one demand_at_level serves both."""
        wants, weights, _slices = self._merged(summaries)
        if wants.size == 0:
            return {s.shard: pool / len(summaries) for s in summaries}
        level = waterfill_level_iterative(pool, wants, weights)
        shares = {
            s.shard: s.demand_at_level(level) for s in summaries
        }
        return self._clamp(shares, pool)

    def _balanced_shares(self, summaries, pool: float) -> Dict[int, float]:
        """BALANCED_FAIRNESS: run the bounded cap-peeling recursion
        over the merged pseudo-clients to get the global binding ratio
        θ and the cap-fixed set, then each shard's share is the sum of
        its own pseudo-clients' balanced grants — wants when fixed,
        min(wants, weight/θ) otherwise. The local recursion at that
        share re-peels the shard's restriction of the fixed set (same
        ratios, fewer classes per round), recovering the global
        allocation whenever it converges within BALANCED_ROUNDS."""
        tiny = np.finfo(np.float64).tiny
        wants, weights, slices = self._merged(summaries)
        if wants.size == 0:
            return {s.shard: pool / len(summaries) for s in summaries}
        theta, fixed = balanced_theta(pool, wants, weights)
        nu = 1.0 / max(theta, tiny)
        gets = np.where(fixed, wants, np.minimum(wants, weights * nu))
        shares = {
            s.shard: float(np.sum(gets[slices[i]]))
            for i, s in enumerate(summaries)
        }
        return self._clamp(shares, pool)

    def _clamp(self, shares: Dict[int, float], pool: float) -> Dict[int, float]:
        """The hard invariant: Σ shares never exceeds the pool. The
        share math sums to the pool mathematically; floating summation
        can land an ulp over, and the invariant is a contract, not a
        tolerance — shave any excess off the largest share."""
        total = sum(shares.values())
        if total > pool and shares:
            top = max(shares, key=lambda s: shares[s])
            shares[top] = max(shares[top] - (total - pool), 0.0)
        return shares

    def status(self) -> dict:
        return {
            "resource": self.resource_id,
            "capacity": self.capacity,
            "share_ttl": self.share_ttl,
            "shares": {
                s: {"value": st.value, "expiry": st.expiry}
                for s, st in sorted(self._shares.items())
            },
            "last": self.last,
        }
