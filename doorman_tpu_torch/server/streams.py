"""Tick-edge lease push: the sharded WatchCapacity subscription registry
(port of doorman_tpu/server/streams.py).

One `StreamRegistry` per server owns every open WatchCapacity stream.
The subscriber space is partitioned across N `StreamShard`s keyed by
the federation router's stable blake2b hash of the client id
(federation/router.stable_shard — the same cross-process contract that
routes resources to root shards), each shard owning its subscriptions,
outbound queues, band counts, silent-refresh deadline wheel, and seq
counter. At every tick edge the server hands the registry the work the
device matcher extracted — exactly the (subscription, changed row)
pairs (server/match.py intersects the engine's device-extracted
changed-rid set with a device-resident incidence structure) — plus the
subscriptions due their silent refresh beat, and each shard runs ONE
grouped per-resource decide pass over its slice (the same grouped
machinery the admission coalescer uses, admission/coalesce.py
decide_grouped), so per-tick fanout cost scales with
changed rows x affected subscribers, never with total subscribers.

A push carries exactly the bytes a poll at the same instant would have
carried; change detection compares the decide RESULT against the last
pushed lease, so parity with poll-every-tick holds even when the delta
filter over-approximates (it may only ever over-approximate — a missed
resource is caught at the subscription's next refresh beat, the same
staleness bound a polling client lives with). Sharding never changes
the bytes, by construction: the tick edge is TWO passes with different
partitions. The decide pass groups the whole edge's (subscription,
row) work per RESOURCE and replays each resource's decides in global
subscription-establishment order — scalar-regime decides (learning
mode, pre-first-solve warmup) water-fill against live store state and
are order-sensitive across clients of one resource, so the canonical
order must not depend on the shard count; different resources touch
disjoint stores (the admission coalescer's parity argument), which is
what makes the decide pass safely parallel ACROSS RESOURCE GROUPS.
The assemble pass then partitions per SHARD: change detection against
each subscription's last pushed key, row serialization, and message
building touch only shard-owned state and run one thread per shard.
tests/test_torch_streaming.py pins the sharded push sequence
byte-identical to the single-shard path, and every pushed message
byte-identical to the reference's, over churn, a flip, and both stores.

Wire batching: pushed messages are assembled as pre-serialized bytes.
Each changed row serializes ONCE per shard per tick edge — N
subscribers of one hot row share the serialized `ResourceResponse`
submessage (keyed by the observable lease value) — and a message is
the serialized header plus the framed row bytes, handed to gRPC as-is
(proto/grpc_api.py's stream serializer passes bytes through). Terminal
redirects stay message objects; the handler ends the stream on them.

Silent refresh: each subscription is refreshed (decide, no push unless
the lease moved) on its resources' refresh-interval cadence, exactly
like a polling client. Deadlines live in a per-shard bucket wheel
(granularity = the tick interval), so a quiet tick touches only the
due bucket — never all subscriptions; with nothing due and nothing
changed the fanout walks ZERO subscriptions (pinned by test).

Ordering / exactly-once: every pushed message carries a seq — the
persist journal's sequence number when persistence is configured, else
a per-shard counter. A stream is a single writer living on exactly one
shard, so seqs are strictly increasing per stream; clients
drop seq <= the last applied and offer the last seen seq back as
`resume_seq` on reconnect. Resume does not REPLAY history (none is
retained): the reconnect request's `has` fields are the client's
baseline, and the first message carries only the rows whose current
lease differs from it.

Concurrency: establishment, unsubscribe, and termination run on the
server's event loop; no locks. The post-tick fanout also runs on the
loop (push_streams blocks it), fanning the per-shard decide +
serialize passes to worker threads when that is safe — the native
store, the admission coalescer's executor rule — with each shard's
state touched by exactly one thread and all queue enqueues applied back
on the loop after the shard passes join.

Not ported yet: the frontend pool's push-ring seam (publisher, pooled
stream ids, worker teardown).
"""

from __future__ import annotations

import asyncio
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from doorman_tpu_torch.admission.coalesce import decide_grouped
from doorman_tpu_torch.admission.policy import Shed
from doorman_tpu_torch.algorithms import Request
from doorman_tpu_torch.federation.router import stable_shard
from doorman_tpu_torch.obs import trace as trace_mod
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto import doorman_stream_pb2 as spb

log = logging.getLogger(__name__)

__all__ = ["StreamRegistry", "StreamShard", "Subscription"]

# Outbound queue depth per stream. A consumer this far behind (the
# fanout produces at tick cadence; a healthy stream drains in
# microseconds) is reset with a redirect-to-self terminal message — the
# client reconnects and resumes from its has-baseline, which is both
# cheaper and more correct than dropping arbitrary deltas.
QUEUE_SIZE = 256

# WatchCapacityResponse.response is field 3, wire type 2 (length-
# delimited): the tag byte every framed row chunk starts with. A
# serialized message is the header fields' bytes plus any permutation
# of framed submessage chunks — proto parsers accept fields in any
# order, so concatenation IS serialization.
_ROW_TAG = b"\x1a"


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _frame_row(payload: bytes) -> bytes:
    """One repeated `response` field chunk: tag + length + row bytes."""
    return _ROW_TAG + _varint(len(payload)) + payload


class Subscription:
    """One open WatchCapacity stream (owned by exactly one shard)."""

    __slots__ = (
        "client_id", "band", "lines", "last", "queue", "next_refresh",
        "terminated", "shard", "match_slot", "order",
    )

    def __init__(self, client_id: str, band: int,
                 lines: Dict[str, Tuple[float, int]], shard: int = 0):
        self.client_id = client_id
        self.band = band
        # Global establishment sequence (set by the registry): the
        # canonical per-resource decide order of the fanout's decide
        # pass, independent of the shard count.
        self.order = 0
        # resource_id -> (wants, priority), fixed at establishment
        # (clients change wants by re-establishing the stream).
        self.lines = lines
        # resource_id -> (capacity, safe_capacity, refresh_interval):
        # the change-detection key of the last served lease.
        self.last: Dict[str, tuple] = {}
        self.queue: "asyncio.Queue" = asyncio.Queue(maxsize=QUEUE_SIZE)
        self.next_refresh = 0.0
        self.terminated = False
        self.shard = shard
        # Device-matcher slot (server/match.py); owned by the server.
        self.match_slot: "int | None" = None


class StreamShard:
    """One shard's subscriptions, queues, band counts, deadline wheel,
    and seq counter. Mutators run on the event loop; `fanout_build`
    additionally runs on a worker thread during the parallel post-tick
    fanout — safe because the loop is blocked for the fanout's duration
    and each shard is built by exactly one thread."""

    def __init__(self, registry: "StreamRegistry", index: int):
        self._registry = registry
        self._server = registry._server
        self.index = index
        # Insertion-ordered sub set: fanout order (and therefore the
        # grouped decide order) is establishment order, deterministic
        # across runs — a set's arbitrary iteration order would make
        # the sharded-vs-single-shard parity pin unfalsifiable.
        self._subs: Dict[Subscription, None] = {}
        self._band_counts: Dict[int, int] = {}
        self._seq = 0
        # Silent-refresh deadline wheel: bucket index -> subscriptions
        # whose next_refresh lands in [b*g, (b+1)*g). A tick pops only
        # the due buckets, so quiet ticks never walk the sub set.
        self._wheel: Dict[int, List[Subscription]] = {}
        self._wheel_g = max(
            float(getattr(self._server, "tick_interval", 1.0) or 1.0),
            1e-3,
        )
        # Lifetime counters (status) and per-tick counters (flight
        # recorder). The tick counters are written by this shard's
        # fanout thread and read/reset by the coordinator after the
        # fanout joins — single-writer by construction.
        self.total_messages = 0
        self.total_deltas = 0
        self.total_bytes = 0
        self.total_resets = 0
        self.tick_deltas = 0
        self.tick_bytes = 0
        self.tick_messages = 0
        self.tick_serialized = 0
        self.tick_shared = 0
        self.tick_walked = 0

    def __len__(self) -> int:
        return len(self._subs)

    def subs(self) -> List[Subscription]:
        return list(self._subs)

    def band_count(self, band: int) -> int:
        return self._band_counts.get(band, 0)

    # -- establishment -------------------------------------------------

    def subscribe(self, request, sub: Subscription) -> None:
        """Register one stream and enqueue its first message: a
        seq-stamped snapshot of every subscribed resource — or, on a
        resume (resume_seq > 0 with `has` baselines), only the rows
        whose current lease differs from what the client already
        holds."""
        now = self._server._clock()
        resume = request.resume_seq > 0
        baseline: Dict[str, float] = {
            rr.resource_id: rr.has.capacity
            for rr in request.resource
            if rr.HasField("has")
        }
        self._subs[sub] = None
        self._band_counts[sub.band] = self._band_counts.get(sub.band, 0) + 1
        rows: List[bytes] = []
        for rid in sub.lines:
            # The establishment decide carries the client-reported
            # lease as `has` — byte-for-byte what this client's next
            # poll would have carried (scalar algorithms read it).
            lease, res = self._decide(
                sub, rid, first=True, has=baseline.get(rid)
            )
            safe = res.safe_capacity()
            sub.last[rid] = (lease.has, safe, int(lease.refresh_interval))
            prev = baseline.get(rid) if resume else None
            if prev is None or lease.has != prev:
                payload = _row(rid, lease, safe).SerializeToString()
                self.tick_serialized += len(payload)
                rows.append(_frame_row(payload))
        sub.next_refresh = now + self._refresh_interval(sub)
        self.wheel_insert(sub)
        # The first message is pushed even when a resume found nothing
        # moved: it carries the current seq and proves liveness.
        self.enqueue(sub, self._message_bytes(rows, snapshot=True),
                     len(rows))

    def unsubscribe(self, sub: Subscription) -> None:
        """Drop one stream (the handler's finally; idempotent). The
        wheel entry is left to lapse — pops skip dead subs."""
        if sub in self._subs:
            del self._subs[sub]
            n = self._band_counts.get(sub.band, 0) - 1
            if n > 0:
                self._band_counts[sub.band] = n
            else:
                self._band_counts.pop(sub.band, None)

    # -- the deadline wheel --------------------------------------------

    def wheel_insert(self, sub: Subscription) -> None:
        b = int(sub.next_refresh // self._wheel_g)
        self._wheel.setdefault(b, []).append(sub)

    def pop_due(self, now: float) -> List[Subscription]:
        """Drain every subscription whose silent-refresh deadline
        passed. Cost is O(due + current bucket), independent of the
        shard's subscriber count; dead entries are skipped lazily."""
        if not self._wheel:
            return []
        nb = int(now // self._wheel_g)
        due: List[Subscription] = []
        for b in sorted(self._wheel):
            if b > nb:
                break
            pending = self._wheel.pop(b)
            if b == nb:
                keep = [s for s in pending if s.next_refresh > now]
                pending = [s for s in pending if s.next_refresh <= now]
                if keep:
                    self._wheel[b] = keep
            for sub in pending:
                if sub in self._subs and not sub.terminated:
                    due.append(sub)
        return due

    def advance_refresh(self, now: float, due: List[Subscription]) -> None:
        """Re-arm the refresh beat for the subs served as due this
        tick; the interval reads the leases the fanout just served,
        floored like a polling client's loop."""
        for sub in due:
            if sub in self._subs and not sub.terminated:
                sub.next_refresh = now + self._refresh_interval(sub)
                self.wheel_insert(sub)

    # -- the tick-edge fanout ------------------------------------------

    def build_work(
        self,
        entries: List[Tuple[Subscription, Optional[List[str]]]],
        work: List[Tuple[str, Request]],
        meta: List[Tuple[Subscription, str]],
    ) -> None:
        """Expand this shard's (subscription, rows) entries — rows=None
        re-decides every line (due refresh / check_all) — into the
        edge-global decide work list. Runs on the event loop; the
        caller owns the canonical ordering."""
        for sub, rows in entries:
            if sub.terminated or sub not in self._subs:
                continue
            self.tick_walked += 1
            rids = sub.lines if rows is None else rows
            for rid in rids:
                line = sub.lines.get(rid)
                if line is None:
                    continue
                wants, priority = line
                last = sub.last.get(rid)
                has = last[0] if last else 0.0
                work.append((
                    rid,
                    Request(sub.client_id, has, wants, 1,
                            priority=priority),
                ))
                meta.append((sub, rid))

    def assemble(
        self, tick: int,
        items: List[Tuple[Subscription, str, object, float]],
    ) -> List[Tuple[Subscription, bytes, int]]:
        """One shard's assemble pass: change-detect each decided
        (subscription, row, lease, safe) against the last pushed key
        and build the pre-serialized push messages. Returns the built
        messages; the caller enqueues them on the event loop. May run
        on a worker thread — touches only shard-owned state."""
        with trace_mod.default_tracer().span(
            "stream.shard", cat="server",
            args={"server": self._server.id, "shard": self.index,
                  "rows": len(items)},
        ):
            # Serialization sharing: identical observable leases of one
            # row serialize once per shard per tick edge.
            cache: Dict[tuple, bytes] = {}
            out_rows: Dict[Subscription, List[bytes]] = {}
            for sub, rid, lease, safe in items:
                key = (lease.has, safe, int(lease.refresh_interval))
                if key == sub.last.get(rid):
                    continue
                sub.last[rid] = key
                ck = (rid, lease.has, safe, int(lease.refresh_interval),
                      int(lease.expiry))
                chunk = cache.get(ck)
                if chunk is None:
                    payload = _row(rid, lease, safe).SerializeToString()
                    self.tick_serialized += len(payload)
                    chunk = _frame_row(payload)
                    cache[ck] = chunk
                else:
                    self.tick_shared += 1
                out_rows.setdefault(sub, []).append(chunk)
            return [
                (sub, self._message_bytes(rows, tick=tick), len(rows))
                for sub, rows in out_rows.items()
            ]

    # -- termination ---------------------------------------------------

    def terminate(self, sub: Subscription, mastership) -> None:
        """End one stream with a terminal redirect message (kept as a
        message object — the handler ends the stream on it). A full
        queue is drained first — the terminal supersedes any deltas the
        consumer never read (it will resume from its has-baseline)."""
        if sub.terminated:
            return
        sub.terminated = True
        msg = spb.WatchCapacityResponse(seq=self._next_seq())
        msg.mastership.CopyFrom(mastership)
        while True:
            try:
                sub.queue.put_nowait(msg)
                return
            except asyncio.QueueFull:
                try:
                    sub.queue.get_nowait()
                except asyncio.QueueEmpty:  # pragma: no cover - racy only
                    pass

    def reset(self, sub: Subscription) -> None:
        """Slow-consumer reset: terminal redirect pointing at the
        CURRENT master (normally this server) — reconnect and resume.
        Confined to this shard; other shards' streams are untouched."""
        self.total_resets += 1
        self.terminate(sub, self._server._mastership())

    # -- the decide path (byte-identical to a poll) --------------------

    def _decide(self, sub: Subscription, rid: str, *, first: bool,
                has: "Optional[float]" = None):
        wants, priority = sub.lines[rid]
        if has is None:
            last = sub.last.get(rid)
            has = last[0] if last else 0.0
        lease, res = self._server._decide(
            rid, Request(sub.client_id, has, wants, 1, priority=priority)
        )
        if first:
            # The establishment decide registers a new client in the
            # row (wants write + membership bump) outside the admission
            # coalescer's tracked pass: a staged pack of this row
            # predates it (engine.FusedStaging's freshness contract).
            # Steady-state refreshes rewrite the same wants — the
            # packed fields are byte-unchanged, so they need no
            # invalidation (the same argument FusedStaging makes for
            # its one-tick drain window).
            self._server._fused_invalidate(rid)
        return lease, res

    def _refresh_interval(self, sub: Subscription) -> float:
        """The silent-refresh cadence: the shortest served refresh
        interval, floored like a polling client's loop."""
        interval = min(
            (key[2] for key in sub.last.values()), default=None
        )
        if interval is None:
            interval = self._server.tick_interval
        return max(
            float(interval), self._server.minimum_refresh_interval,
            self._server.tick_interval,
        )

    # -- plumbing ------------------------------------------------------

    def _next_seq(self) -> int:
        persist = self._server._persist
        if persist is not None:
            # The decides that built this push are journal deltas; the
            # journal seq therefore stamps the push with a durable,
            # replayable position. max() keeps seqs strictly increasing
            # even when a message carried no journaled decide (terminal
            # redirects).
            self._seq = max(self._seq + 1, persist.journal.seq)
        else:
            self._seq += 1
        return self._seq

    def _message_bytes(self, rows: Sequence[bytes], *,
                       snapshot: bool = False, tick: int = 0) -> bytes:
        """One pushed message: the serialized header concatenated with
        the framed row chunks (serialized exactly once each)."""
        head = spb.WatchCapacityResponse(
            seq=self._next_seq(), tick=tick, snapshot=snapshot
        )
        return head.SerializeToString() + b"".join(rows)

    def enqueue(self, sub: Subscription, payload: bytes,
                n_rows: int) -> None:
        if sub.terminated:
            return
        try:
            sub.queue.put_nowait(payload)
        except asyncio.QueueFull:
            self.reset(sub)
            return
        size = len(payload)
        self.total_messages += 1
        self.total_deltas += n_rows
        self.total_bytes += size
        self.tick_messages += 1
        self.tick_deltas += n_rows
        self.tick_bytes += size

    def take_tick_stats(self) -> dict:
        out = {
            "deltas_pushed": self.tick_deltas,
            "push_bytes": self.tick_bytes,
            "messages": self.tick_messages,
            "serialized_bytes": self.tick_serialized,
            "shared_rows": self.tick_shared,
            "subs_walked": self.tick_walked,
        }
        self.tick_deltas = self.tick_bytes = self.tick_messages = 0
        self.tick_serialized = self.tick_shared = self.tick_walked = 0
        return out

    def status(self) -> dict:
        return {
            "subscribers": len(self._subs),
            "seq": self._seq,
            "resets": self.total_resets,
            "wheel_buckets": len(self._wheel),
        }


def _row(rid: str, lease, safe: float) -> pb.ResourceResponse:
    """One pushed row, field-for-field what GetCapacity builds."""
    row = pb.ResourceResponse()
    row.resource_id = rid
    row.gets.expiry_time = int(lease.expiry)
    row.gets.refresh_interval = int(lease.refresh_interval)
    row.gets.capacity = lease.has
    row.safe_capacity = safe
    return row


class StreamRegistry:
    """All open streams of one CapacityServer, partitioned across
    `shards` StreamShards by the stable client-id hash (see module
    docstring). shards=1 is the single-shard reference path the sharded
    fanout is pinned byte-identical to."""

    def __init__(self, server, *, max_streams_per_band: int = 0,
                 shards: int = 1):
        self._server = server
        # 0 = unlimited. The cap is per wire-priority band ACROSS all
        # shards (a flood of low-band stream establishment can never
        # crowd the fanout out from under high-band subscribers,
        # however it hashes).
        self.max_streams_per_band = int(max_streams_per_band)
        self._shards = [
            StreamShard(self, i) for i in range(max(int(shards), 1))
        ]
        self._executor: "ThreadPoolExecutor | None" = None
        self.last_fanout_seconds = 0.0
        self._tick_matched = 0
        self._order = 0  # establishment sequence (canonical decide order)
        # Tick-edge fanouts that raised (the server's push_streams
        # catches them so the tick survives; status reports the count).
        self.fanout_errors = 0

    # -- routing -------------------------------------------------------

    @property
    def shards(self) -> List[StreamShard]:
        return self._shards

    def shard_of(self, client_id: str) -> StreamShard:
        """The owning shard: the federation router's stable blake2b
        hash of the client id, mod the shard count — deterministic
        across processes and Python versions."""
        if len(self._shards) == 1:
            return self._shards[0]
        return self._shards[stable_shard(client_id, len(self._shards))]

    def iter_subs(self) -> List[Subscription]:
        return [sub for shard in self._shards for sub in shard.subs()]

    # -- establishment -------------------------------------------------

    def check_cap(self, band: int) -> Optional[Shed]:
        """Per-band stream cap (enforced with or without the admission
        front-end; the AIMD gate is admission.check_watch)."""
        cap = self.max_streams_per_band
        if cap and sum(
            s.band_count(band) for s in self._shards
        ) >= cap:
            s = self._server
            return Shed(
                reason=(
                    f"stream cap: band {band} already holds {cap} "
                    "streams on this server"
                ),
                retry_after=max(
                    s.tick_interval, s.minimum_refresh_interval, 1.0
                ),
                band=band,
                kind="stream_cap",
            )
        return None

    def subscribe(self, request) -> Subscription:
        band = max((rr.priority for rr in request.resource), default=0)
        lines = {
            rr.resource_id: (rr.wants, rr.priority)
            for rr in request.resource
        }
        shard = self.shard_of(request.client_id)
        sub = Subscription(request.client_id, band, lines,
                           shard=shard.index)
        self._order += 1
        sub.order = self._order
        shard.subscribe(request, sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        self._shards[sub.shard].unsubscribe(sub)

    # -- the tick-edge fanout ------------------------------------------

    def on_tick(
        self,
        check_all: bool,
        matched: "Dict[Subscription, List[str]]",
    ) -> None:
        """Push deltas for one tick edge.

        `matched` is the subscription matcher's output — subscription ->
        exactly the changed resource ids it watches; `check_all=True`
        means no tracked source of deltas existed this tick (python
        store, config epoch move, overflow tick) and every subscription
        line is re-decided, `matched` unread. A quiet tick — nothing
        matched, nothing due — walks zero subscriptions."""
        server = self._server
        now = server._clock()
        tick = server._ticks_done
        t0 = time.perf_counter()
        due_by_shard = [shard.pop_due(now) for shard in self._shards]
        plans: List[List[Tuple[Subscription, Optional[List[str]]]]] = []
        for shard, due in zip(self._shards, due_by_shard):
            if check_all:
                entries = [(sub, None) for sub in shard.subs()]
            else:
                entries = [(sub, None) for sub in due]
                due_set = set(due)
                for sub, rows in matched.items():
                    if sub.shard == shard.index and sub not in due_set:
                        entries.append((sub, rows))
                        self._tick_matched += len(rows)
            plans.append(entries)
        # Decide pass: one edge-global work list in canonical order —
        # establishment order across subscriptions, line order within
        # one — so the grouped per-resource replay is byte-identical
        # for any shard count (see the module docstring).
        flat = [e for entries in plans for e in entries]
        flat.sort(key=lambda e: e[0].order)
        work: List[Tuple[str, Request]] = []
        meta: List[Tuple[Subscription, str]] = []
        for sub, rows in flat:
            self._shards[sub.shard].build_work([(sub, rows)], work, meta)
        if not work:
            for shard, due in zip(self._shards, due_by_shard):
                shard.advance_refresh(now, due)
            self.last_fanout_seconds = time.perf_counter() - t0
            return
        decided = self._decide_all(work)
        # Assemble pass: split the decided rows per owning shard (in
        # canonical order) and build each shard's messages — change
        # detection, row serialization sharing, seq stamping all touch
        # only shard-owned state, so shards assemble in parallel.
        per_shard: Dict[int, List[tuple]] = {}
        for (sub, rid), (lease, _res, safe) in zip(meta, decided):
            per_shard.setdefault(sub.shard, []).append(
                (sub, rid, lease, safe)
            )
        live = [
            (self._shards[i], items)
            for i, items in sorted(per_shard.items())
        ]
        built: List[List[Tuple[Subscription, bytes, int]]]
        if len(live) > 1 and self._parallel_ok():
            import contextvars

            pool = self._pool()
            futures = [
                pool.submit(
                    contextvars.copy_context().run,
                    shard.assemble, tick, items,
                )
                for shard, items in live
            ]
            built = [f.result() for f in futures]
        else:
            built = [
                shard.assemble(tick, items) for shard, items in live
            ]
        # Enqueues land back on the event loop (asyncio queues are not
        # thread-safe); shard order keeps the sequence deterministic.
        for (shard, _), messages in zip(live, built):
            for sub, payload, n_rows in messages:
                shard.enqueue(sub, payload, n_rows)
        for shard, due in zip(self._shards, due_by_shard):
            shard.advance_refresh(now, due)
        self.last_fanout_seconds = time.perf_counter() - t0

    def _decide_all(self, work: List[Tuple[str, Request]]) -> List[tuple]:
        """The edge-global decide pass. Sequential it is exactly
        decide_grouped; when leaving the loop is safe (the native
        engine's mutex guards store writes) the
        per-resource groups fan to worker threads — different resources
        touch disjoint stores, so the parallel replay is byte-identical
        to the sequential one."""
        server = self._server
        groups: Dict[str, List[Tuple[int, Request]]] = {}
        for i, (resource_id, request) in enumerate(work):
            groups.setdefault(resource_id, []).append((i, request))
        if (
            len(self._shards) < 2
            or len(groups) < 2
            or not self._parallel_ok()
        ):
            return decide_grouped(server, work)
        import contextvars

        pool = self._pool()
        slots: List[tuple] = [None] * len(work)  # type: ignore[list-item]

        def run_group(entries: List[Tuple[int, Request]],
                      resource_id: str) -> None:
            for i, request in entries:
                lease, res = server._decide(resource_id, request)
                slots[i] = (lease, res, res.safe_capacity())

        futures = [
            pool.submit(
                contextvars.copy_context().run, run_group, entries,
                resource_id,
            )
            for resource_id, entries in groups.items()
        ]
        for f in futures:
            f.result()
        return slots

    def _parallel_ok(self) -> bool:
        """Shard fanouts may leave the event loop only when that is
        safe — the admission coalescer's executor rule: the native
        engine's mutex guards concurrent store writes (the reference
        also requires no persist journal, which is loop-only; the port
        has none)."""
        return self._server._native_store

    def _pool(self) -> ThreadPoolExecutor:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=len(self._shards),
                thread_name_prefix="stream-shard",
            )
        return self._executor

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None

    # -- termination ---------------------------------------------------

    def terminate(self, sub: Subscription, mastership) -> None:
        self._shards[sub.shard].terminate(sub, mastership)

    def terminate_all(self, mastership) -> int:
        """Mastership lost (or shutting down): every stream on every
        shard ends with a redirect so clients chase the new master —
        atomic across shards (runs on the loop with no awaits; no RPC
        can interleave a subscribe between two shards' sweeps).
        Returns streams terminated."""
        n = 0
        for shard in self._shards:
            for sub in shard.subs():
                if not sub.terminated:
                    shard.terminate(sub, mastership)
                    n += 1
        if n:
            log.info(
                "%s: terminated %d capacity stream(s) with a mastership "
                "redirect", self._server.id, n,
            )
        return n

    def reset(self, sub: Subscription) -> None:
        self._shards[sub.shard].reset(sub)

    # -- introspection -------------------------------------------------

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    @property
    def total_messages(self) -> int:
        return sum(s.total_messages for s in self._shards)

    @property
    def total_deltas(self) -> int:
        return sum(s.total_deltas for s in self._shards)

    @property
    def total_bytes(self) -> int:
        return sum(s.total_bytes for s in self._shards)

    @property
    def total_resets(self) -> int:
        return sum(s.total_resets for s in self._shards)

    def take_tick_stats(self) -> dict:
        """Per-tick counters for the flight recorder; resets on read.
        Σ per-shard outbound is the invariant the sharded-parity test
        holds against the single-shard path."""
        per_shard = [s.take_tick_stats() for s in self._shards]
        out = {
            "subscribers": len(self),
            "deltas_pushed": sum(s["deltas_pushed"] for s in per_shard),
            "push_bytes": sum(s["push_bytes"] for s in per_shard),
            "messages": sum(s["messages"] for s in per_shard),
            "stream_shards": len(self._shards),
            "matched_pairs": self._tick_matched,
            "serialized_bytes": sum(
                s["serialized_bytes"] for s in per_shard
            ),
            "shared_rows": sum(s["shared_rows"] for s in per_shard),
            "subs_walked": sum(s["subs_walked"] for s in per_shard),
        }
        self._tick_matched = 0
        return out

    def status(self) -> dict:
        band_counts: Dict[int, int] = {}
        for shard in self._shards:
            for band, n in shard._band_counts.items():
                band_counts[band] = band_counts.get(band, 0) + n
        return {
            # The federated root shard this registry serves (None: the
            # port serves no federation yet); resume tokens are scoped
            # to it.
            "shard": getattr(self._server, "shard", None),
            "shards": len(self._shards),
            "subscribers": len(self),
            "by_band": {
                str(b): n for b, n in sorted(band_counts.items())
            },
            "max_streams_per_band": self.max_streams_per_band,
            "seq": max(s._seq for s in self._shards),
            "messages_total": self.total_messages,
            "deltas_total": self.total_deltas,
            "bytes_total": self.total_bytes,
            "resets_total": self.total_resets,
            "last_fanout_ms": round(self.last_fanout_seconds * 1000.0, 3),
            "per_shard": [s.status() for s in self._shards],
            # The frontend pool's status in the reference (not ported).
            "frontend": None,
            "fanout_errors": self.fanout_errors,
        }
