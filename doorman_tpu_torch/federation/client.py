"""FederatedClient: one logical client over N root shards.

Holds one ordinary background-refresh Client per shard it actually
talks to (created lazily through ShardDiscovery), routes each claimed
resource to its owning shard (ShardRouter), and fans a refresh batch out
as one bulk GetCapacity PER OWNING SHARD — the per-shard clients keep
every existing behavior (lease expiry fallback, retry-after pacing,
stream mode) because they ARE the existing client.

Redirect handling: each per-shard connection's mastership chase reports
into the discovery cache (`Connection.on_redirect` ->
`ShardDiscovery.note_master`), so a shard flip updates every routing
decision at RPC speed and a re-resolution storm never forms.

Straddling resources: a straddling resource is served by EVERY shard;
which shard a given client attaches to is a placement decision (client
locality), taken once at claim time via the `shard=` override and
defaulting to the resource's home shard.

Port of doorman_tpu/federation/client.py: a copy apart from import paths.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Optional

from doorman_tpu_torch.client.client import Client, ClientResource
from doorman_tpu_torch.federation.discovery import ShardDiscovery
from doorman_tpu_torch.federation.router import ShardRouter

log = logging.getLogger(__name__)


class FederatedClient:
    """The federated analog of Client.connect(): claim resources, let
    the per-shard refresh loops run. Pass `background=False` to drive
    refreshes explicitly with `refresh_once()` (stepped harnesses)."""

    def __init__(
        self,
        router: ShardRouter,
        discovery: ShardDiscovery,
        *,
        client_id: Optional[str] = None,
        background: bool = True,
        clock: Callable[[], float] = time.time,
        **client_kwargs,
    ):
        self.router = router
        self.discovery = discovery
        self.id = client_id
        self._background = background
        self._clock = clock
        self._client_kwargs = dict(client_kwargs)
        self._clients: Dict[int, Client] = {}
        self._closed = False

    async def _client(self, shard: int) -> Client:
        client = self._clients.get(shard)
        if client is not None:
            return client
        addr = await self.discovery.master(shard)
        if self._background:
            client = await Client.connect(
                addr, self.id, clock=self._clock, **self._client_kwargs
            )
        else:
            client = Client(
                addr, self.id, clock=self._clock, **self._client_kwargs
            )
        if self.id is None:
            # One logical identity across every shard: adopt the first
            # per-shard client's generated id (ids are per-shard lease
            # namespaces, so sharing it cannot collide).
            self.id = client.id
        # Invalidate-on-redirect: the connection's mastership chase is
        # the freshest resolution there is.
        client.conn.on_redirect = (
            lambda addr, s=shard: self.discovery.note_master(s, addr)
        )
        self._clients[shard] = client
        return client

    async def resource(
        self,
        resource_id: str,
        wants: float,
        priority: int = 0,
        *,
        shard: Optional[int] = None,
    ) -> ClientResource:
        """Claim a resource on its owning shard. `shard=` overrides
        placement for straddling resources (every shard serves them;
        pick the local one); overriding a NON-straddling resource onto
        a foreign shard is a routing error and raises."""
        owner = self.router.shard_of(resource_id)
        if shard is None:
            shard = owner
        elif shard != owner and not self.router.is_straddling(resource_id):
            raise ValueError(
                f"resource {resource_id!r} is owned by shard {owner}, "
                f"not {shard}; only straddling resources take a "
                "placement override"
            )
        client = await self._client(shard)
        return await client.resource(resource_id, wants, priority=priority)

    async def apply_epoch(
        self, router: ShardRouter, moved: Iterable[str] = ()
    ) -> dict:
        """Adopt a new routing epoch (fleet reshard). Swaps the router
        and re-homes exactly this client's claims on the `moved`
        resources: the live ClientResource object — lease included —
        migrates to the new owner's per-shard client, so the next
        refresh reports the same `has` there and the new owner's
        learning-mode warm-up carries the grant across (lease
        continuity; doc/federation.md). Everything else is untouched:
        unmoved shards' clients keep their connections and cache
        entries, so an epoch bump causes at most one Discovery
        resolution (the new shard), never a stampede."""
        self.router = router
        rehomed = []
        for rid in moved:
            if router.is_straddling(rid):
                continue
            new_shard = router.shard_of(rid)
            for shard, client in list(self._clients.items()):
                if shard == new_shard:
                    continue
                res = client.resources.pop(rid, None)
                if res is None:
                    continue
                target = await self._client(new_shard)
                res._client = target
                target.resources[rid] = res
                target._wake.set()
                rehomed.append(rid)
        return {"rehomed": rehomed}

    async def refresh_once(self) -> bool:
        """One fan-out refresh: every shard client runs one bulk
        refresh cycle; True when every shard's RPC succeeded. Stepped
        harnesses drive this (background=False)."""
        ok = True
        for client in self._clients.values():
            if client.resources:
                ok = await client.refresh_once() and ok
        return ok

    def current_capacity(self, resource_id: str) -> float:
        for client in self._clients.values():
            res = client.resources.get(resource_id)
            if res is not None:
                return res.current_capacity()
        raise KeyError(resource_id)

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for client in self._clients.values():
            try:
                await client.close()
            except Exception:
                log.exception("shard client close failed")
        self._clients.clear()

    def status(self) -> dict:
        return {
            "id": self.id,
            "shards": {
                shard: {
                    "master": client.master(),
                    "resources": sorted(client.resources),
                }
                for shard, client in sorted(self._clients.items())
            },
            "discovery": self.discovery.status(),
        }
