"""doorman_tpu_torch.federation — POP-sharded multi-master roots (port of
doorman_tpu/federation).

The resource space partitions across N root shards (router.py), each an
ordinary CapacityServer with its own per-shard mastership
(election.shard_lock_key) and persist namespace
(persist.parse_backend(namespace=...)); clients and intermediates fan
their batches out to the owning shards through a jittered-TTL master
cache (discovery.py, client.py); intermediates aggregate their subtree
on the device (aggregate.py); and resources whose capacity straddles
shards reconcile POP-style each beat (reconcile.py, roots.py) with the
hard invariant that the sum of shard grants never exceeds the configured
capacity and convergence to the single-root allocation.
tests/test_torch_federation.py holds it against the reference.
"""

from doorman_tpu_torch.federation.aggregate import (  # noqa: F401
    AggregationTickAdapter,
    FederatedIntermediate,
)
from doorman_tpu_torch.federation.client import FederatedClient  # noqa: F401
from doorman_tpu_torch.federation.discovery import (  # noqa: F401
    ShardDiscovery,
    ShardResolveError,
)
from doorman_tpu_torch.federation.reconcile import (  # noqa: F401
    ShardSummary,
    StraddleReconciler,
    summarize_resource,
)
from doorman_tpu_torch.federation.roots import FederatedRoots  # noqa: F401
from doorman_tpu_torch.federation.router import (  # noqa: F401
    ShardRouter,
    stable_shard,
)

__all__ = [
    "AggregationTickAdapter",
    "FederatedClient",
    "FederatedIntermediate",
    "FederatedRoots",
    "ShardDiscovery",
    "ShardResolveError",
    "ShardRouter",
    "ShardSummary",
    "StraddleReconciler",
    "stable_shard",
    "summarize_resource",
]
