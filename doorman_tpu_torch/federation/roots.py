"""FederatedRoots: the root-shard coordinator.

Owns the shard map for one federated deployment's root tier: N ordinary
CapacityServers, each master of its own shard (per-shard election lock,
per-shard persist namespace), plus one StraddleReconciler per straddling
resource. `reconcile_once()` is the POP reconciliation beat: sweep +
summarize every reachable shard's straddling stores, recompute the
shares, and install each share on its shard as a parent-style capacity
lease (CapacityServer.set_straddle_share) that EXPIRES if the
reconciler stops renewing it — which is the whole failure story: a
partitioned shard coasts on its last share until the ttl lapses, then
decays to zero capacity, and nobody else moves.

This class is the in-process harness (tests, bench, chaos) and the
reference implementation of the beat; a wire deployment runs the same
step over GetServerCapacity — each shard reports its summary to the
resource's home shard and receives its share as the response lease
(doc/federation.md, "Deploying the beat over RPC").

Port of doorman_tpu/federation/roots.py: a copy apart from import paths.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional, Set

from doorman_tpu_torch.core.resource import algo_kind_for
from doorman_tpu_torch.federation.reconcile import (
    ShardSummary,
    StraddleReconciler,
    summarize_resource,
)
from doorman_tpu_torch.federation.router import ShardRouter
from doorman_tpu_torch.obs import trace as trace_mod
from doorman_tpu_torch.server import config as config_mod

log = logging.getLogger(__name__)

# A share must outlive the gap between reconcile beats with margin, or
# healthy shards flap to zero capacity between renewals.
DEFAULT_SHARE_TTL = 10.0


class FederatedRoots:
    """Coordinator over {shard index -> CapacityServer}."""

    def __init__(
        self,
        router: ShardRouter,
        servers: Dict[int, object],
        *,
        share_ttl: float = DEFAULT_SHARE_TTL,
        clock: Callable[[], float] = time.time,
    ):
        if set(servers) != set(range(router.n_shards)):
            raise ValueError(
                f"servers {sorted(servers)} do not cover shards "
                f"[0, {router.n_shards})"
            )
        self.router = router
        self.servers = servers
        self.share_ttl = float(share_ttl)
        self._clock = clock
        # Partition seam: shards listed here are unreachable from the
        # reconciler (the chaos runner's shard_partition fault toggles
        # it; a wire deployment's RPC failures feed the same set).
        self.blocked: Set[int] = set()
        self._reconcilers: Dict[str, StraddleReconciler] = {}
        self.beats = 0

    def _reconciler(self, resource_id: str) -> Optional[StraddleReconciler]:
        rec = self._reconcilers.get(resource_id)
        if rec is not None:
            return rec
        # Capacity + lane come from the home shard's configured
        # template — the one copy of config the whole straddle answers
        # to (shards share one repository in a sane deployment).
        home = self.servers[self.router.shard_of(resource_id)]
        if home.config is None:
            return None
        tpl = config_mod.find_template(home.config, resource_id)
        if tpl is None:
            return None
        rec = StraddleReconciler(
            resource_id,
            float(tpl.capacity),
            algo_kind_for(tpl),
            share_ttl=self.share_ttl,
            lease_length=float(tpl.algorithm.lease_length),
        )
        self._reconcilers[resource_id] = rec
        return rec

    def reconcile_once(self) -> dict:
        """One reconciliation beat over every straddling resource.
        Returns {resource_id: {shard: share}} for the shares installed
        this beat (the chaos runner logs it; status pages read
        `status()`)."""
        self.beats += 1
        now = self._clock()
        installed: Dict[str, Dict[int, float]] = {}
        with trace_mod.default_tracer().span(
            "federation.reconcile", cat="federation",
            args={"straddle": len(self.router.straddle),
                  "blocked": len(self.blocked)},
        ):
            for rid in sorted(self.router.straddle):
                rec = self._reconciler(rid)
                if rec is None:
                    continue
                summaries = {}
                unreachable = set(self.blocked)
                for shard, server in self.servers.items():
                    if shard in unreachable:
                        continue
                    if not server.is_master:
                        # A masterless shard is unreachable in the same
                        # sense as a partitioned one: its share must
                        # freeze, not reset.
                        unreachable.add(shard)
                        continue
                    res = server.resources.get(rid)
                    if res is not None:
                        res.store.clean()
                        summaries[shard] = summarize_resource(
                            res, shard, kind=rec.kind
                        )
                    else:
                        summaries[shard] = ShardSummary(shard=shard)
                shares = rec.reconcile(
                    summaries, now, unreachable=unreachable
                )
                for shard, value in shares.items():
                    self.servers[shard].set_straddle_share(
                        rid, value, now + self.share_ttl
                    )
                installed[rid] = shares
        return installed

    def straddle_capacities(self) -> Dict[str, float]:
        """{resource_id: configured capacity} for every straddling
        resource with a built reconciler — the capacity-sum invariant's
        bound (chaos.invariants.check_federation)."""
        return {
            rid: rec.capacity
            for rid, rec in self._reconcilers.items()
        }

    def status(self) -> dict:
        return {
            "router": self.router.status(),
            "share_ttl": self.share_ttl,
            "beats": self.beats,
            "blocked": sorted(self.blocked),
            "straddle": {
                rid: rec.status()
                for rid, rec in sorted(self._reconcilers.items())
            },
        }
