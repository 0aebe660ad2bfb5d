"""Multi-device parallelism: device meshes, the mesh combine and the
sharded solves (port of doorman_tpu/parallel/).

The reference scales by a tree of servers — intermediate servers
aggregate their clients' demand into priority bands and forward it to
the root. On a device mesh the same structure is fused: the edge list
shards across devices over a mesh axis ("clients" = the leaf /
intermediate role), per-resource aggregates combine across shards
(parallel.combine: in shard order within a process, all_reduce across
processes) and every shard then computes its own grants from the
combined totals (= the root solve). A second mesh axis ("dc") models
the two-level tree. The reference's parallel/compat.py (a shard_map
version shim) has no counterpart: torch has no shard_map, and
parallel.combine takes its place.
"""

from doorman_tpu_torch.parallel.combine import Combine  # noqa: F401
from doorman_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    make_mesh_from_spec,
)
from doorman_tpu_torch.parallel.multihost import (  # noqa: F401
    make_multihost_mesh,
    pack_process_edges,
)
from doorman_tpu_torch.parallel.sharded import (  # noqa: F401
    make_sharded_chunked_solver,
    make_sharded_dense_solver,
    make_sharded_priority_solver,
    make_sharded_solver,
    shard_chunked,
    shard_dense,
    shard_edges,
    shard_priority,
)
