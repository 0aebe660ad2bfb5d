"""Client-side per-shard master resolution with a jittered-TTL cache.

Every federated caller (clients fanning a refresh batch, intermediates
fanning upstream requests) needs "who is shard k's master right now".
Resolving that with a Discovery RPC per refresh would turn every shard
flip into a Discovery stampede — the exact herd admission control exists
to prevent, self-inflicted. The cache rules:

  * a resolution is reused until its deadline; deadlines carry ±jitter
    so a fleet whose caches were warmed together does not re-resolve
    together;
  * a mastership redirect observed on a live connection IS a
    resolution — `note_master` replaces the cache entry in place
    (invalidate-on-redirect), so the flip propagates at RPC speed with
    zero extra Discovery traffic;
  * `invalidate` drops one shard's entry (a failed dial) without
    touching the others.

Resolution itself walks the shard's seed addresses and asks Discovery;
a seed that answers "not master, the master is X" resolves to X without
another hop (the reference's Discovery contract).

Port of doorman_tpu/federation/discovery.py: a copy apart from import paths.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import grpc

from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto.grpc_api import CapacityStub

log = logging.getLogger(__name__)

DEFAULT_TTL = 30.0
DEFAULT_JITTER = 0.2  # fraction of ttl, both directions
RESOLVE_TIMEOUT = 5.0


class ShardResolveError(ConnectionError):
    """No seed of the shard produced a usable master address."""


class ShardDiscovery:
    """The per-shard master cache. `seeds` maps shard index to one seed
    address or a list of them (any election candidate works as a seed —
    non-masters answer Discovery with the master's address)."""

    def __init__(
        self,
        seeds: Mapping[int, Union[str, Sequence[str]]],
        *,
        ttl: float = DEFAULT_TTL,
        jitter: float = DEFAULT_JITTER,
        clock: Callable[[], float] = time.time,
        rng: Optional[random.Random] = None,
        resolver: Optional[Callable] = None,
    ):
        """`resolver(shard, seed_addrs) -> addr` substitutes the gRPC
        Discovery walk (tests; a wire deployment's service-mesh lookup).
        `rng` is the jitter seam — pass a seeded random.Random for
        deterministic replays (unseeded only when nothing is injected)."""
        self._seeds: Dict[int, Tuple[str, ...]] = {}
        for shard, addrs in seeds.items():
            if isinstance(addrs, str):
                addrs = (addrs,)
            self._seeds[int(shard)] = tuple(addrs)
        self.ttl = float(ttl)
        self.jitter = float(jitter)
        self._clock = clock
        self._rng = rng if rng is not None else random.Random()
        self._resolver = resolver or self._grpc_resolve
        self._cache: Dict[int, Tuple[str, float]] = {}
        # Counters the stampede tests (and status pages) read.
        self.resolutions = 0
        self.hits = 0
        self.invalidations = 0

    def _deadline(self, now: float) -> float:
        spread = self.ttl * self.jitter
        return now + self.ttl + self._rng.uniform(-spread, spread)

    async def master(self, shard: int) -> str:
        """The shard's master address — cached, or freshly resolved."""
        now = self._clock()
        entry = self._cache.get(shard)
        if entry is not None and now < entry[1]:
            self.hits += 1
            return entry[0]
        seeds = self._seeds.get(shard)
        if not seeds:
            raise ShardResolveError(f"no seeds configured for shard {shard}")
        addr = await self._resolver(shard, seeds)
        self.resolutions += 1
        self._cache[shard] = (addr, self._deadline(now))
        return addr

    def add_seeds(
        self, seeds: Mapping[int, Union[str, Sequence[str]]]
    ) -> None:
        """Extend the seed map in place — the fleet supervisor calls
        this when a reshard activates shards that did not exist when
        the cache was built. Existing entries are replaced; cached
        resolutions are NOT touched (a new seed list says nothing
        about who is master right now)."""
        for shard, addrs in seeds.items():
            if isinstance(addrs, str):
                addrs = (addrs,)
            self._seeds[int(shard)] = tuple(addrs)

    def note_master(self, shard: int, addr: str) -> None:
        """Invalidate-on-redirect: a live connection just learned the
        shard's real master from a mastership redirect — that IS the
        freshest possible resolution, so the cache takes it instead of
        scheduling a Discovery round."""
        self.invalidations += 1
        self._cache[shard] = (addr, self._deadline(self._clock()))

    def invalidate(self, shard: int) -> None:
        """Drop one shard's entry (a dial against it failed); the next
        `master()` call re-resolves just that shard."""
        if self._cache.pop(shard, None) is not None:
            self.invalidations += 1

    async def _grpc_resolve(self, shard: int, seeds: Sequence[str]) -> str:
        last_error: Optional[Exception] = None
        for seed in seeds:
            try:
                async with grpc.aio.insecure_channel(seed) as channel:
                    out = await CapacityStub(channel).Discovery(
                        pb.DiscoveryRequest(), timeout=RESOLVE_TIMEOUT
                    )
                if out.is_master:
                    return seed
                addr = out.mastership.master_address
                if addr:
                    return addr
            except Exception as e:
                last_error = e
                log.warning(
                    "shard %d seed %s discovery failed: %r", shard, seed, e
                )
        raise ShardResolveError(
            f"shard {shard}: no seed produced a master "
            f"(last error: {last_error!r})"
        )

    def status(self) -> dict:
        now = self._clock()
        return {
            "ttl": self.ttl,
            "jitter": self.jitter,
            "resolutions": self.resolutions,
            "hits": self.hits,
            "invalidations": self.invalidations,
            "cache": {
                shard: {"addr": addr, "fresh_for": round(dl - now, 3)}
                for shard, (addr, dl) in sorted(self._cache.items())
            },
        }
