"""Routing epochs: versioned shard maps for live resharding N→M.

The ShardRouter is a pure function of (resource id, shard count), so a
shard-count change is a ROUTING change: every resource whose
`stable_shard(rid, N) != stable_shard(rid, M)` has a new owner, and
everything else stays put. `stable_shard` is a hash mod N, so that
locality is small: a resource keeps its owner only where h mod N equals
h mod M, and an N→N+1 move touches ~N/(N+1) of the space (2 → 3 moves
about two thirds; only ~1/(N+1) stays). A consistent hash would move
~1/(N+1), but it would change the wire-visible routing.
The epoch number versions the map: servers stamp their redirect tables
with it, clients apply it to move exactly the affected routes, and the
flight recorder logs it so an operator can line a grant wiggle up with
the reshard that caused it.

Straddling resources never "move": they are served by every active
shard, so a reshard re-splits their shares (the reconciler sees the new
live set on the next beat) rather than rerouting them. Overrides pin a
resource to a fixed shard across epochs; an override pointing past the
new shard count is a configuration error and fails the advance.

Port of doorman_tpu/fleet/epoch.py: a copy apart from import paths.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from doorman_tpu_torch.federation.router import ShardRouter

__all__ = ["EpochChange", "EpochRouter"]


@dataclass(frozen=True)
class EpochChange:
    """One published reshard: the epoch it created and the diff the
    fleet must act on."""

    epoch: int
    n_from: int
    n_to: int
    # Shards entering / leaving the active set.
    added: Tuple[int, ...]
    removed: Tuple[int, ...]
    # Known (tracked) non-straddling resources whose owner changed,
    # with their old and new owners — the redirect/drain worklist.
    moved: Tuple[Tuple[str, int, int], ...]

    def as_log(self) -> dict:
        return {
            "epoch": self.epoch,
            "from": self.n_from,
            "to": self.n_to,
            "added": list(self.added),
            "removed": list(self.removed),
            "moved": [[rid, old, new] for rid, old, new in self.moved],
        }


class EpochRouter:
    """A ShardRouter with a version number and an advance() that
    computes the move diff.

    The moved-resource diff is computed over the TRACKED resource set
    (`note_resources`): the router itself is a hash and needs no
    enumeration, but redirect tables and drain verification do — the
    fleet feeds it every resource id it has seen (config templates,
    claimed resources), which is exactly the set a diff could matter
    for."""

    def __init__(
        self,
        n_shards: int,
        *,
        straddle: Iterable[str] = (),
        overrides: Optional[Mapping[str, int]] = None,
        resources: Iterable[str] = (),
    ):
        self.straddle = tuple(sorted(set(straddle)))
        self.overrides: Dict[str, int] = dict(overrides or {})
        self.epoch = 0
        self.router = ShardRouter(
            n_shards,
            straddle=self.straddle,
            overrides=self.overrides or None,
        )
        self._tracked: List[str] = []
        self._tracked_set = set()
        self.note_resources(self.straddle)
        self.note_resources(resources)

    @property
    def n_shards(self) -> int:
        return self.router.n_shards

    @property
    def tracked(self) -> Tuple[str, ...]:
        """Every resource id the diff covers, in first-seen order."""
        return tuple(self._tracked)

    def note_resources(self, resource_ids: Iterable[str]) -> None:
        """Track resource ids for the advance() move diff (idempotent,
        order-stable)."""
        for rid in resource_ids:
            if rid not in self._tracked_set:
                self._tracked_set.add(rid)
                self._tracked.append(rid)

    def advance(self, n_shards: int) -> EpochChange:
        """Publish a new epoch routing to `n_shards` shards. Returns
        the change record; raises on a no-op or an override stranded
        outside the new range (ShardRouter validates)."""
        n_shards = int(n_shards)
        if n_shards == self.router.n_shards:
            raise ValueError(
                f"reshard to current shard count {n_shards} is a no-op"
            )
        old = self.router
        new = ShardRouter(
            n_shards,
            straddle=self.straddle,
            overrides=self.overrides or None,
        )
        moved = tuple(
            (rid, old.shard_of(rid), new.shard_of(rid))
            for rid in sorted(self._tracked)
            if not old.is_straddling(rid)
            and old.shard_of(rid) != new.shard_of(rid)
        )
        grow = n_shards > old.n_shards
        self.router = new
        self.epoch += 1
        return EpochChange(
            epoch=self.epoch,
            n_from=old.n_shards,
            n_to=n_shards,
            added=tuple(range(old.n_shards, n_shards)) if grow else (),
            removed=tuple(range(n_shards, old.n_shards)) if not grow else (),
            moved=moved,
        )

    def status(self) -> dict:
        return {
            "epoch": self.epoch,
            "router": self.router.status(),
            "tracked": len(self._tracked),
        }
