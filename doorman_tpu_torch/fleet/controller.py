"""FleetController: the in-process fleet runtime.

Interface-compatible with federation.FederatedRoots (`reconcile_once`,
`straddle_capacities`, `blocked`, `status`) so the chaos and workload
harnesses drive a fleet exactly like a fixed federation — plus the two
things FederatedRoots cannot do:

  * an ACTIVE SET smaller than the provisioned server pool, changed
    live by `reshard(m)` (routing epochs, fleet/epoch.py);
  * drain semantics on shrink that reuse the reconciler's frozen-share
    machinery verbatim: a shard leaving the active set simply stops
    appearing in the beat's summaries, so its last share freezes
    (charged against the pool), decays at expiry, and its slack is
    re-offered only after expiry + lease_length — identical to how a
    partitioned shard drains, because shrink IS a deliberate partition.

Reshard mechanics per resource class:

  * straddling — nothing moves; the next beat sees the new live set
    and re-splits the shares (grow: the new shard enters with an empty
    summary and receives an even slack split; shrink: the departed
    shard freezes and drains as above). Σ shares ≤ capacity holds
    pointwise through both directions because every install lands in
    one beat and the frozen window covers stragglers.
  * ordinary (hash-routed) — owners change only where the stable hash
    changes (EpochChange.moved). The old owner gets an epoch-stamped
    redirect table (CapacityServer.set_fleet_routing) so stale clients
    chase to the new owner at RPC speed; the old owner's rows drain by
    lease expiry (the client stops renewing there) and the new owner's
    learning-mode warm-up carries each client's reported `has` across
    the move, so grants are lease-continuous and never double-issued
    to one client.

The wall-clock deployment (fleet/rpc.py + fleet/supervisor.py) runs the
same decisions over GetServerCapacity; this class is the deterministic
twin the acceptance tests pin.

Port of doorman_tpu/fleet/controller.py: a copy apart from import
paths. The shards are the port's CapacityServers, so a batch-mode shard
on the native store ticks its resident K1/K2 solve on its own device:
the new owner's tables take a moved resource's rows through its next
ticks, and every beat's share install is a config-epoch full tick.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Mapping, Optional, Set

from doorman_tpu_torch.core.resource import algo_kind_for
from doorman_tpu_torch.federation.reconcile import (
    ShardSummary,
    StraddleReconciler,
    summarize_resource,
)
from doorman_tpu_torch.fleet.epoch import EpochChange, EpochRouter
from doorman_tpu_torch.obs import trace as trace_mod
from doorman_tpu_torch.server import config as config_mod

log = logging.getLogger(__name__)

DEFAULT_SHARE_TTL = 10.0

__all__ = ["FleetController", "DEFAULT_SHARE_TTL"]


class FleetController:
    """Coordinator over a provisioned pool {shard -> CapacityServer},
    of which the first `active` are serving. `addrs` maps shard index
    to the address clients dial (the redirect targets); omit it in
    harnesses that never exercise server-side redirects."""

    def __init__(
        self,
        servers: Dict[int, object],
        *,
        straddle: Iterable[str] = (),
        overrides: Optional[Mapping[str, int]] = None,
        active: Optional[int] = None,
        addrs: Optional[Mapping[int, str]] = None,
        share_ttl: float = DEFAULT_SHARE_TTL,
        clock: Callable[[], float] = time.time,
    ):
        if set(servers) != set(range(len(servers))):
            raise ValueError(
                f"servers {sorted(servers)} are not a dense pool "
                f"[0, {len(servers)})"
            )
        n_active = len(servers) if active is None else int(active)
        if not 1 <= n_active <= len(servers):
            raise ValueError(
                f"active {n_active} outside [1, {len(servers)}] "
                "(provisioned pool)"
            )
        self.servers = dict(servers)
        self.addrs: Dict[int, str] = dict(addrs or {})
        self.epochs = EpochRouter(
            n_active, straddle=straddle, overrides=overrides
        )
        self.share_ttl = float(share_ttl)
        self._clock = clock
        # Partition seam, same contract as FederatedRoots.blocked.
        self.blocked: Set[int] = set()
        self._reconcilers: Dict[str, StraddleReconciler] = {}
        self.beats = 0
        self.reshards = 0

    # -- routing ------------------------------------------------------

    @property
    def router(self):
        return self.epochs.router

    @property
    def epoch(self) -> int:
        return self.epochs.epoch

    @property
    def active(self) -> int:
        return self.epochs.n_shards

    @property
    def provisioned(self) -> int:
        return len(self.servers)

    def note_resources(self, resource_ids: Iterable[str]) -> None:
        self.epochs.note_resources(resource_ids)

    # -- live resharding ----------------------------------------------

    def reshard(self, n_shards: int) -> EpochChange:
        """Publish a new epoch serving `n_shards` of the provisioned
        pool. Grow and shrink are both live: nothing restarts, no store
        rows are copied — routing changes and the lease machinery
        drains the rest."""
        n_shards = int(n_shards)
        if not 1 <= n_shards <= self.provisioned:
            raise ValueError(
                f"reshard to {n_shards} outside provisioned pool "
                f"[1, {self.provisioned}]"
            )
        change = self.epochs.advance(n_shards)
        self.reshards += 1
        self._push_routing(change)
        trace_mod.default_tracer().instant(
            "fleet.epoch", cat="fleet", args=change.as_log()
        )
        return change

    def _push_routing(self, change: EpochChange) -> None:
        """Install epoch-stamped redirect tables: every server learns
        where every tracked resource it does NOT own now lives, so a
        stale-epoch client's next refresh gets a mastership redirect
        to the new owner instead of a silently wrong answer. The table
        is computed from the FULL tracked set under the new router and
        replaces the previous epoch's — a resource that moved back
        simply drops out."""
        router = self.router
        owners = {
            rid: router.shard_of(rid)
            for rid in self.epochs.tracked
            if not router.is_straddling(rid)
        }
        for shard, server in self.servers.items():
            routed_away = {
                rid: self.addrs.get(owner, "")
                for rid, owner in owners.items()
                if owner != shard
            }
            install = getattr(server, "set_fleet_routing", None)
            if install is not None:
                install(change.epoch, routed_away)

    # -- the reconcile beat -------------------------------------------

    def _reconciler(self, resource_id: str) -> Optional[StraddleReconciler]:
        rec = self._reconcilers.get(resource_id)
        if rec is not None:
            return rec
        # Home shard's template first (the one copy of config the
        # straddle answers to), any configured active shard as the
        # fallback — a freshly-activated shard may still be loading.
        home = self.router.shard_of(resource_id)
        order = [home] + [s for s in range(self.active) if s != home]
        tpl = None
        for shard in order:
            server = self.servers[shard]
            if server.config is None:
                continue
            tpl = config_mod.find_template(server.config, resource_id)
            if tpl is not None:
                break
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
        """One beat over every straddling resource, scoped to the
        ACTIVE shards. A shard outside the active set is simply absent
        from the summaries — the reconciler freezes its last share and
        drains it exactly like a partition, which is the shrink story.
        Returns {resource_id: {shard: installed share}}."""
        self.beats += 1
        now = self._clock()
        installed: Dict[str, Dict[int, float]] = {}
        with trace_mod.default_tracer().span(
            "fleet.beat", cat="fleet",
            args={"epoch": self.epoch, "active": self.active,
                  "blocked": len(self.blocked)},
        ):
            for rid in sorted(self.router.straddle):
                rec = self._reconciler(rid)
                if rec is None:
                    continue
                summaries: Dict[int, ShardSummary] = {}
                unreachable = {s for s in self.blocked if s < self.active}
                for shard in range(self.active):
                    if shard in unreachable:
                        continue
                    server = self.servers[shard]
                    if not server.is_master:
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
        """{resource_id: configured capacity} — the capacity-sum
        invariant's bound, summed by chaos.invariants.check_federation
        over EVERY provisioned shard so draining shards stay covered."""
        return {
            rid: rec.capacity for rid, rec in self._reconcilers.items()
        }

    def status(self) -> dict:
        return {
            "epochs": self.epochs.status(),
            "active": self.active,
            "provisioned": self.provisioned,
            "share_ttl": self.share_ttl,
            "beats": self.beats,
            "reshards": self.reshards,
            "blocked": sorted(self.blocked),
            "straddle": {
                rid: rec.status()
                for rid, rec in sorted(self._reconcilers.items())
            },
        }
