"""RingPublisher: the tick process's side of the push ring.

This is the StreamShard.enqueue seam (server/streams.py): when a
registry has a publisher attached and a subscription is pooled
(sub.worker is set), the shard hands the SAME pre-serialized push
bytes it would have queued locally to `publish()` instead, and they
land in the owning worker's ring as one KIND_PUSH frame — nothing
about the payload changes, which is why the pooled byte-sequence
parity pin against the in-process path is an equality of bytes, not a
semantic argument. Terminal redirects (message objects in-process)
serialize once here and ride KIND_TERMINAL frames; the worker sends
the bytes and ends the stream.

Shard ownership: stream shard i belongs to worker `route[i]` —
initially `i % workers`, remapped by `reassign()` when a worker dies
(pool.crash / a real worker process exiting). The map is the handoff
contract: new establishments on a dead worker's shards route to
survivors immediately, while the dead worker's existing streams are
dropped by the registry (their clients re-establish and resume from
seq — doc/serving.md "worker lifecycle").

`beat()` stamps one empty KIND_BEAT frame per push edge into every
live ring, so worker deadline wheels can distinguish a quiet tick
(beat arrives, no pushes) from a stalled ring (no beat past the
margin) — the never-silent-lapse leg of the chaos verdicts.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from doorman_tpu_torch.frontend.ring import (
    KIND_BEAT,
    KIND_PUSH,
    KIND_TERMINAL,
    Ring,
    RingWriter,
)

__all__ = ["RingPublisher"]

DEFAULT_RING_BYTES = 1 << 20


class RingPublisher:
    def __init__(self, workers: int, *,
                 ring_bytes: int = DEFAULT_RING_BYTES,
                 rings: Optional[List[Ring]] = None):
        if workers < 1:
            raise ValueError("a frontend pool needs at least one worker")
        self.workers = int(workers)
        self.ring_bytes = int(ring_bytes)
        self.rings: List[Ring] = rings if rings is not None else [
            Ring.in_memory(self.ring_bytes) for _ in range(self.workers)
        ]
        if len(self.rings) != self.workers:
            raise ValueError("one ring per worker")
        self._writers = [RingWriter(r) for r in self.rings]
        self._live = [True] * self.workers
        # shard index -> worker index; lazily grown (the registry's
        # shard count is not known here, and routing must stay stable
        # for any shard index the registry hands us).
        self._route: Dict[int, int] = {}
        self.published_frames = 0
        self.published_bytes = 0
        self.terminals = 0
        self.per_worker_frames = [0] * self.workers

    # -- routing -------------------------------------------------------

    def live_workers(self) -> List[int]:
        return [w for w in range(self.workers) if self._live[w]]

    def shard_worker(self, shard: int) -> int:
        """The worker owning this stream shard. Deterministic: the
        home slot is shard % workers; a dead home is remapped to the
        next live worker in index order (the reassign sweep), so every
        process that knows the live set derives the same map."""
        w = self._route.get(shard)
        if w is None or not self._live[w]:
            w = self._home(shard)
            self._route[shard] = w
        return w

    def _home(self, shard: int) -> int:
        live = self.live_workers()
        if not live:
            raise RuntimeError("no live frontend workers")
        home = shard % self.workers
        if self._live[home]:
            return home
        return live[shard % len(live)]

    def reassign(self, dead: int) -> Dict[int, int]:
        """Mark one worker dead and remap every shard it owned.
        Returns {shard: new worker} for the moved shards."""
        if not self._live[dead]:
            return {}
        self._live[dead] = False
        moved: Dict[int, int] = {}
        for shard, w in list(self._route.items()):
            if w == dead:
                self._route[shard] = self._home(shard)
                moved[shard] = self._route[shard]
        return moved

    def revive(self, worker: int) -> None:
        """A restarted worker rejoins: its home shards route back to it
        (streams established while it was down stay where they are —
        the registry pins a subscription's worker at establishment)."""
        self._live[worker] = True
        self._writers[worker] = RingWriter(self.rings[worker])
        for shard, w in list(self._route.items()):
            if shard % self.workers == worker and self._live[worker]:
                self._route[shard] = worker

    # -- the enqueue seam ----------------------------------------------

    def publish(self, worker: int, shard: int, stream_id: int,
                payload: bytes) -> bool:
        """One push frame. False means the worker is dead (the caller
        drops the stream; its client re-establishes elsewhere)."""
        if not self._live[worker]:
            return False
        self._writers[worker].append(shard, KIND_PUSH, stream_id, payload)
        self.published_frames += 1
        self.published_bytes += len(payload)
        self.per_worker_frames[worker] += 1
        return True

    def publish_terminal(self, worker: int, shard: int, stream_id: int,
                         payload: bytes) -> bool:
        if not self._live[worker]:
            return False
        self._writers[worker].append(
            shard, KIND_TERMINAL, stream_id, payload
        )
        self.published_frames += 1
        self.terminals += 1
        self.per_worker_frames[worker] += 1
        return True

    def beat(self) -> None:
        for w in self.live_workers():
            self._writers[w].append(0, KIND_BEAT, 0)

    # -- introspection -------------------------------------------------

    def status(self) -> dict:
        return {
            "workers": self.workers,
            "live": self.live_workers(),
            "ring_bytes": self.ring_bytes,
            "published_frames": self.published_frames,
            "published_bytes": self.published_bytes,
            "terminals": self.terminals,
            "per_worker_frames": list(self.per_worker_frames),
            "routed_shards": {
                str(s): w for s, w in sorted(self._route.items())
            },
        }

    def close(self) -> None:
        for ring in self.rings:
            ring.close()

    def unlink(self) -> None:
        for ring in self.rings:
            ring.unlink()
