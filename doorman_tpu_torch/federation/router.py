"""The stable shard hash (port of doorman_tpu/federation/router.py
`stable_shard`; the ShardRouter is not ported yet).

Routing is blake2b over the id, mod the shard count, so every process
computes the same owner with no coordination, across processes and
Python versions (never the process-seeded builtin `hash`). The stream
registry partitions subscribers by it.
"""

from __future__ import annotations

import hashlib

__all__ = ["stable_shard"]


def stable_shard(resource_id: str, n_shards: int) -> int:
    """blake2b(resource_id) mod n_shards. 8 digest bytes keep the modulo
    bias unmeasurable at any plausible shard count while staying a
    single int conversion."""
    if n_shards <= 0:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    digest = hashlib.blake2b(
        resource_id.encode("utf-8"), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") % n_shards
