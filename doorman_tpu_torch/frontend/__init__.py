"""Serving-plane scale-out: the multi-process SO_REUSEPORT front-end
(port of doorman_tpu/frontend; host code only, no torch: the listener
workers import nothing that imports torch).

One device-owning tick process keeps the solve, the stream registry,
and the admission controller; N listener workers hold the WatchCapacity
streams and forward unary RPCs back. The two planes meet at a
shared-memory push ring (ring.py): the tick edge publishes the
already-pre-serialized per-shard push bytes as seq-stamped, checksummed
frames, and each worker pumps exactly the frames of the stream shards
it owns out to its subscribers — the bytes cross the process boundary
with zero re-encode (proto/grpc_api.py's bytes-as-is stream
serializer). doc/serving.md is the subsystem's design + runbook.

Layering (everything below the process boundary is process-agnostic,
which is what makes the pooled push byte-sequences pinnable against
the in-process StreamRegistry path and the chaos arcs replayable on
the virtual clock):

  * ring.py        — frame format, single writer, per-reader cursors;
  * publisher.py   — the StreamShard.enqueue seam: routes a pooled
                     subscription's push bytes to its worker's ring;
  * worker.py      — WorkerCore (ring pump + stream table + per-worker
                     deadline wheel) and the real SO_REUSEPORT gRPC
                     listener process built on it (uvloop when
                     available);
  * control.py     — the tick-process control surface workers forward
                     establishment/teardown/heartbeats through;
  * pool.py        — InlineFrontendPool (same-process, deterministic:
                     tests, chaos, workload harness) and FrontendPool
                     (real worker processes: cmd/server, chip_smoke.py,
                     cmd/frontend_smoke).

The ring's bytes are the reference's: a ring written by either
package's publisher reads in the other's worker
(tests/test_torch_frontend.py).
"""

from doorman_tpu_torch.frontend.ring import (  # noqa: F401
    KIND_BEAT,
    KIND_PUSH,
    KIND_TERMINAL,
    Frame,
    Ring,
    RingReader,
    RingWriter,
)
from doorman_tpu_torch.frontend.publisher import RingPublisher  # noqa: F401
from doorman_tpu_torch.frontend.worker import WorkerCore  # noqa: F401
from doorman_tpu_torch.frontend.control import (  # noqa: F401
    FrontendControl,
    add_frontend_control,
)
from doorman_tpu_torch.frontend.pool import (  # noqa: F401
    FrontendPool,
    InlineFrontendPool,
)

__all__ = [
    "Frame",
    "FrontendControl",
    "FrontendPool",
    "InlineFrontendPool",
    "KIND_BEAT",
    "KIND_PUSH",
    "KIND_TERMINAL",
    "Ring",
    "RingPublisher",
    "RingReader",
    "RingWriter",
    "WorkerCore",
    "add_frontend_control",
]
