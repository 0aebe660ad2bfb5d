"""Resource -> root-shard routing for the federated capacity tree.

The reference scales past one master with a tree of intermediates; this
layer scales the ROOT itself: the resource space is partitioned across N
root shards, each an ordinary CapacityServer winning its own per-shard
mastership (election.shard_lock_key) and persisting to its own
journal/snapshot namespace (persist.parse_backend(namespace=...)). The
router is the one place that decides ownership, shared verbatim by
clients (fan a refresh batch out to the owning shards), intermediates
(one upstream GetServerCapacity per resource, to the owner), and the
straddle reconciler (which shard is a straddling resource's home).

Routing is a STABLE hash — blake2b over the resource id, mod the shard
count — so every client, intermediate, and operator tool in a
deployment computes the same owner with no coordination, across
processes and Python versions (never the process-seeded builtin
`hash`). Explicit overrides pin named resources to chosen shards
(operational escape hatch: drain a shard, co-locate a family), and
`straddle` names the resources whose capacity is SPLIT across every
shard — POP-style (arxiv 2110.11927): each shard solves its local
subproblem against a reconciled capacity share, and the small
reconciliation step (federation/reconcile.py) converges the shares to
the single-root allocation.

Port of doorman_tpu/federation/router.py: a copy apart from import paths.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = ["ShardRouter", "stable_shard"]


def stable_shard(resource_id: str, n_shards: int) -> int:
    """The stable hash route: blake2b(resource_id) mod n_shards.

    8 digest bytes keep the modulo bias unmeasurable at any plausible
    shard count while staying a single int conversion."""
    if n_shards <= 0:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    digest = hashlib.blake2b(
        resource_id.encode("utf-8"), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") % n_shards


class ShardRouter:
    """The resource->shard map: stable hash + explicit overrides +
    the straddle set.

    * `shard_of(rid)` — the single OWNING shard (a straddling
      resource's owner is its home shard: the one that runs its
      reconciler in a wire deployment).
    * `owners(rid)` — every shard holding capacity for the resource:
      just the owner for normal resources, all shards for straddling
      ones.
    * `split(rids)` — partition a request batch by owning shard (the
      client/intermediate fan-out shape).
    """

    def __init__(
        self,
        n_shards: int,
        *,
        overrides: Optional[Mapping[str, int]] = None,
        straddle: Iterable[str] = (),
    ):
        if n_shards <= 0:
            raise ValueError(f"n_shards must be positive, got {n_shards}")
        self.n_shards = int(n_shards)
        self.overrides: Dict[str, int] = dict(overrides or {})
        for rid, shard in self.overrides.items():
            if not 0 <= shard < self.n_shards:
                raise ValueError(
                    f"override {rid!r} -> shard {shard} outside "
                    f"[0, {self.n_shards})"
                )
        self.straddle = frozenset(straddle)

    def shard_of(self, resource_id: str) -> int:
        override = self.overrides.get(resource_id)
        if override is not None:
            return override
        return stable_shard(resource_id, self.n_shards)

    def is_straddling(self, resource_id: str) -> bool:
        return resource_id in self.straddle

    def owners(self, resource_id: str) -> Tuple[int, ...]:
        if resource_id in self.straddle:
            return tuple(range(self.n_shards))
        return (self.shard_of(resource_id),)

    def split(
        self, resource_ids: Sequence[str]
    ) -> Dict[int, List[str]]:
        """Partition a batch by owning shard, preserving request order
        within each shard (response merge order stays deterministic)."""
        out: Dict[int, List[str]] = {}
        for rid in resource_ids:
            out.setdefault(self.shard_of(rid), []).append(rid)
        return out

    def status(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "overrides": dict(self.overrides),
            "straddle": sorted(self.straddle),
        }
