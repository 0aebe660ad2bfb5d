"""The serving-plane frontend in the port (doorman_tpu_torch/frontend/
and the stream registry's push-ring seam), against the reference on the
CPU (the port's servers on device="cpu").

Mirrors tests/test_frontend.py on the port — the ring (round trip, wrap,
torn frames, checksum resync, laps, fresh readers, the seqlock, the
shared-memory backing), the publisher's routing, the worker core's
parking and deadline wheel, the establishment ramp, and the pooled
parity pin (a pooled server and an in-process one on one virtual clock,
byte-identical pushes across a worker crash and restart) — and pins the
port to the reference:

  * ring frames written by one package's writer and read by the other's
    reader (in memory and over a shared-memory block): the frame format
    and the seqlock control block are byte-compatible;
  * the pooled push frames of a port server and a reference server on
    the same churn (reference :424) byte-equal, frame for frame, both
    stores.
"""

import asyncio
import subprocess
import sys
from pathlib import Path

import pytest

import tests.conftest  # noqa: F401

from doorman_tpu.algorithms import Request as JRequest
from doorman_tpu.frontend import ring as j_ring
from doorman_tpu.frontend.publisher import RingPublisher as JRingPublisher
from doorman_tpu_torch import native
from doorman_tpu_torch.admission.ramp import EstablishmentRamp
from doorman_tpu_torch.algorithms import Request
from doorman_tpu_torch.frontend.control import FrontendControl
from doorman_tpu_torch.frontend.publisher import RingPublisher
from doorman_tpu_torch.frontend.ring import (
    CTRL_SIZE,
    HEADER_SIZE,
    KIND_BEAT,
    KIND_PUSH,
    KIND_TERMINAL,
    Ring,
    RingReader,
    RingWriter,
)
from doorman_tpu_torch.frontend.worker import WorkerCore
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.server.config import parse_yaml_config
from doorman_tpu_torch.server.election import TrivialElection
from doorman_tpu_torch.server.server import CapacityServer
from tests.test_streaming import (
    CHURN,
    CONFIG,
    TOTAL_TICKS,
    _drain_queue,
    watch_request,
)
from tests.test_streaming import make_server as make_ref_server

ROOT = Path(__file__).resolve().parent.parent


async def make_server(clock, *, native_store, stream_push,
                      tick_interval=1.0, config_yaml=CONFIG, **kwargs):
    """tests/test_streaming.py's batch stream server, in the port."""
    server = CapacityServer(
        "srv", TrivialElection(), mode="batch",
        tick_interval=tick_interval, minimum_refresh_interval=0.0,
        clock=clock, native_store=native_store, stream_push=stream_push,
        device="cpu", **kwargs,
    )
    port = await server.start(0, host="127.0.0.1")
    await server.load_config(parse_yaml_config(config_yaml))
    await asyncio.sleep(0)
    server.current_master = f"127.0.0.1:{port}"
    for task in server._tasks:
        task.cancel()
    server._tasks.clear()
    return server, f"127.0.0.1:{port}"


NATIVE_PARAMS = [
    False,
    pytest.param(
        True,
        marks=pytest.mark.skipif(
            not native.native_available(),
            reason="native engine unavailable",
        ),
    ),
]


def run(coro):
    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# The ring.
# ---------------------------------------------------------------------------


class TestRing:
    def test_round_trip(self):
        ring = Ring.in_memory(512)
        w = RingWriter(ring)
        r = RingReader(ring)
        w.append(3, KIND_PUSH, 42, b"hello")
        w.append(1, KIND_TERMINAL, 7, b"bye")
        w.append(0, KIND_BEAT, 0)
        res = r.poll()
        assert not res.lapped and res.corrupt == 0 and res.gap == 0
        assert [
            (f.seq, f.shard, f.kind, f.stream_id, f.payload)
            for f in res.frames
        ] == [
            (1, 3, KIND_PUSH, 42, b"hello"),
            (2, 1, KIND_TERMINAL, 7, b"bye"),
            (3, 0, KIND_BEAT, 0, b""),
        ]
        assert r.poll().frames == []  # drained

    def test_wrap(self):
        """Frames straddling the physical end split into two slices and
        reassemble byte-exact, across hundreds of logical laps."""
        ring = Ring.in_memory(256)
        w = RingWriter(ring)
        r = RingReader(ring)
        for i in range(300):
            payload = bytes([i % 251]) * (17 + i % 13)
            w.append(i % 7, KIND_PUSH, i, payload)
            res = r.poll()
            assert len(res.frames) == 1
            assert res.frames[0].payload == payload
            assert res.frames[0].seq == i + 1
            assert not res.lapped and res.corrupt == 0

    def test_torn_frame_never_read(self):
        """Bytes past the published write_pos — a writer that died
        mid-frame — are invisible: the reader stops at the control
        block's position."""
        ring = Ring.in_memory(256)
        w = RingWriter(ring)
        r = RingReader(ring)
        w.append(0, KIND_PUSH, 1, b"published")
        # Torn frame: bytes in place, control NOT published.
        ring.write_at(w.write_pos, b"\xde\xad\xbe\xef" * 10)
        res = r.poll()
        assert [f.payload for f in res.frames] == [b"published"]
        assert res.corrupt == 0

    def test_checksum_reject_resyncs(self):
        ring = Ring.in_memory(512)
        w = RingWriter(ring)
        r = RingReader(ring)
        w.append(0, KIND_PUSH, 1, b"ok-1")
        pos = w.write_pos
        w.append(0, KIND_PUSH, 2, b"victim")
        w.append(0, KIND_PUSH, 3, b"after")
        # Flip one payload byte of the middle frame in place.
        off = (pos + HEADER_SIZE) % ring.capacity
        ring.buf[CTRL_SIZE + off] ^= 0xFF
        res = r.poll()
        assert [f.payload for f in res.frames] == [b"ok-1"]
        assert res.corrupt == 1
        assert res.gap >= 1  # the victim (and the tail) accounted
        # Resynced to write_pos: new frames flow again.
        w.append(0, KIND_PUSH, 4, b"fresh")
        res = r.poll()
        assert [f.payload for f in res.frames] == [b"fresh"]
        assert res.corrupt == 0

    def test_lap_detection_counts_gap(self):
        ring = Ring.in_memory(256)
        w = RingWriter(ring)
        r = RingReader(ring)
        w.append(0, KIND_PUSH, 0, b"seen")
        assert len(r.poll().frames) == 1
        for i in range(20):  # far more than capacity: reader lapped
            w.append(0, KIND_PUSH, i, b"x" * 40)
        res = r.poll()
        assert res.lapped
        assert res.gap == 20  # every unread frame accounted, none silent
        assert res.frames == []
        w.append(0, KIND_PUSH, 99, b"recovered")
        res = r.poll()
        assert [f.payload for f in res.frames] == [b"recovered"]
        assert not res.lapped

    def test_fresh_reader_starts_at_write_pos(self):
        """A restarted worker must not replay frames: resume rides the
        push-seq contract, not ring replay."""
        ring = Ring.in_memory(512)
        w = RingWriter(ring)
        w.append(0, KIND_PUSH, 1, b"old-1")
        w.append(0, KIND_PUSH, 2, b"old-2")
        r = RingReader(ring)  # fresh cursor: at write_pos
        assert r.poll().frames == []
        w.append(0, KIND_PUSH, 3, b"new")
        res = r.poll()
        assert [f.payload for f in res.frames] == [b"new"]
        assert res.gap == 0

    def test_oversized_frame_rejected(self):
        ring = Ring.in_memory(128)
        w = RingWriter(ring)
        with pytest.raises(ValueError):
            w.append(0, KIND_PUSH, 1, b"x" * 128)

    def test_control_block_seqlock_roundtrip(self):
        """The control block is a seqlock: writes land between an
        odd/even version bump, reads see exactly what was published
        and the version rests even."""
        import struct

        ring = Ring.in_memory(512)
        ring.write_control(123, 7)
        assert ring.read_control() == (123, 7)
        ver = struct.unpack_from("<Q", ring.buf, 0)[0]
        assert ver == 2  # one publish: +1 busy, +1 published

    def test_control_read_survives_writer_death_mid_update(self):
        """A version stuck odd (writer died mid-update) must not hang
        the reader: the bounded retry falls through with the last copy
        — the crc/lap checks downstream keep it loud."""
        import struct

        ring = Ring.in_memory(512)
        ring.write_control(100, 1)
        struct.pack_into("<Q", ring.buf, 0, 5)  # odd, never clears
        assert ring.read_control() == (100, 1)

    def test_shared_memory_backing(self):
        """The same framing over a named SharedMemory block: writer in
        one mapping, reader attached through a second mapping."""
        name = "doorman-torch-test-ring"
        ring = Ring.shared(name, 1024, create=True)
        try:
            w = RingWriter(ring)
            attached = Ring.shared(name, 1024)
            r = RingReader(attached)
            w.append(2, KIND_PUSH, 5, b"cross-mapping")
            res = r.poll()
            assert [f.payload for f in res.frames] == [b"cross-mapping"]
            attached.close()
        finally:
            ring.close()
            ring.unlink()


# ---------------------------------------------------------------------------
# Publisher routing.
# ---------------------------------------------------------------------------


class TestPublisher:
    def test_home_routing_and_reassign(self):
        p = RingPublisher(3, ring_bytes=1024)
        assert [p.shard_worker(s) for s in range(6)] == [0, 1, 2, 0, 1, 2]
        moved = p.reassign(1)
        assert moved and all(w != 1 for w in moved.values())
        assert p.shard_worker(1) != 1 and p.shard_worker(4) != 1
        # Deterministic: same dead set, same map.
        assert p.shard_worker(1) == p.shard_worker(1)
        p.revive(1)
        assert p.shard_worker(1) == 1 and p.shard_worker(4) == 1

    def test_publish_to_dead_worker_fails_loudly(self):
        p = RingPublisher(2, ring_bytes=1024)
        assert p.publish(0, 0, 1, b"live")
        p.reassign(0)
        assert not p.publish(0, 0, 1, b"dead")
        assert not p.publish_terminal(0, 0, 1, b"dead")
        assert p.publish(1, 1, 2, b"live")

    def test_beat_only_live_rings(self):
        p = RingPublisher(2, ring_bytes=1024)
        r0, r1 = RingReader(p.rings[0]), RingReader(p.rings[1])
        p.reassign(0)
        p.beat()
        assert r0.poll().frames == []
        frames = r1.poll().frames
        assert len(frames) == 1 and frames[0].kind == KIND_BEAT


# ---------------------------------------------------------------------------
# The worker core: parking + the deadline wheel.
# ---------------------------------------------------------------------------


def _make_core(ring, events, **kwargs):
    return WorkerCore(
        0, ring,
        deliver=lambda sid, h, p: events.append(("push", sid, p)),
        terminal=lambda sid, h, p: events.append(("term", sid, p)),
        on_stall=lambda sid, h, reason: events.append(
            ("stall", sid, reason)
        ),
        **kwargs,
    )


class TestWorkerCore:
    def test_parking_flushes_at_registration(self):
        ring = Ring.in_memory(1024)
        w = RingWriter(ring)
        events = []
        core = _make_core(ring, events)
        w.append(0, KIND_PUSH, 7, b"early")
        core.pump(0.0)
        assert events == []  # parked, not lost
        core.register(7, object(), 0.0)
        assert events == [("push", 7, b"early")]
        w.append(0, KIND_PUSH, 7, b"late")
        core.pump(0.0)
        assert events[-1] == ("push", 7, b"late")

    def test_parking_is_bounded_evicts_oldest(self):
        """A full park buffer evicts the OLDEST parked stream — its
        registration is the furthest overdue — so the frame arriving
        now (the stream registering next) still parks."""
        ring = Ring.in_memory(1 << 16)
        w = RingWriter(ring)
        events = []
        core = _make_core(ring, events, park_limit=4)
        for i in range(10):
            w.append(0, KIND_PUSH, 100 + i, b"x")
        core.pump(0.0)
        assert core.parked_frames == 10  # every frame parked on arrival
        assert core.parked_dropped == 6  # the 6 oldest streams evicted
        core.register(100, object(), 0.0)  # evicted: nothing to flush
        assert events == []
        core.register(109, object(), 0.0)  # newest survived
        assert events == [("push", 109, b"x")]

    def test_parked_orphans_expire_after_margin(self):
        """Frames for a stream that never registers (dropped between
        publish and the Drop RPC, cancelled establish) expire after one
        stall margin — orphans cannot permanently pin the bounded park
        buffer toward PARK_LIMIT."""
        ring = Ring.in_memory(1024)
        w = RingWriter(ring)
        events = []
        core = _make_core(ring, events, tick_interval=1.0,
                          stall_margin=3.0)
        w.append(0, KIND_PUSH, 7, b"orphan")
        core.pump(0.0)
        core.check_deadlines(2.9)
        assert core.parked_expired == 0  # inside the margin
        core.check_deadlines(3.1)
        assert core.parked_expired == 1  # reclaimed
        core.register(7, object(), 3.1)  # late registration: no flush
        assert events == []

    def test_deadline_wheel_resets_silent_streams(self):
        """No frames AND no beats for a full margin: every held stream
        resets loudly (the never-silent-lapse leg)."""
        ring = Ring.in_memory(1024)
        w = RingWriter(ring)
        events = []
        core = _make_core(ring, events, tick_interval=1.0,
                          stall_margin=3.0)
        core.register(1, object(), 0.0)
        core.register(2, object(), 0.0)
        assert core.check_deadlines(2.9) == 0  # inside the margin
        # A beat re-arms everything: the ring demonstrably flows.
        w.append(0, KIND_BEAT, 0)
        core.pump(2.9)
        assert core.check_deadlines(4.0) == 0
        # Then silence past the margin: both streams reset.
        assert core.check_deadlines(6.0) == 2
        assert sorted(e[1] for e in events if e[0] == "stall") == [1, 2]
        assert core.held() == 0

    def test_desync_resets_every_stream(self):
        ring = Ring.in_memory(256)
        w = RingWriter(ring)
        events = []
        core = _make_core(ring, events)
        core.register(1, object(), 0.0)
        for _ in range(20):  # lap the reader
            w.append(0, KIND_PUSH, 1, b"y" * 40)
        core.pump(0.0)
        assert ("stall", 1, "ring_lap") in events
        assert core.desyncs == 1 and core.held() == 0


# ---------------------------------------------------------------------------
# The establishment ramp.
# ---------------------------------------------------------------------------


class TestEstablishmentRamp:
    def test_inline_when_window_zero(self):
        async def body():
            ramp = EstablishmentRamp(window=0.0)
            out = await ramp.submit(lambda: "now")
            assert out == "now"
            assert ramp.flushes == 0  # never parked

        run(body())

    def test_window_batches_in_arrival_order(self):
        async def body():
            ramp = EstablishmentRamp(window=0.02)
            order = []

            def mk(i):
                def thunk():
                    order.append(i)
                    return i
                return thunk

            outs = await asyncio.gather(
                *[ramp.submit(mk(i)) for i in range(5)]
            )
            assert outs == [0, 1, 2, 3, 4]
            assert order == [0, 1, 2, 3, 4]  # arrival order preserved
            assert ramp.flushes == 1  # one loop callback for the burst
            assert ramp.batched == 5
            ramp.close()

        run(body())

    def test_exceptions_propagate(self):
        async def body():
            ramp = EstablishmentRamp(window=0.01)

            def boom():
                raise RuntimeError("gate exploded")

            with pytest.raises(RuntimeError, match="gate exploded"):
                await ramp.submit(boom)
            ramp.close()

        run(body())


# ---------------------------------------------------------------------------
# THE parity pin: pooled vs in-process, across a worker restart.
# ---------------------------------------------------------------------------

RESTART_TICK = 7
WORKERS = 2
SHARDS = 4


@pytest.mark.parametrize("native_store", NATIVE_PARAMS,
                         ids=["python-store", "native-store"])
def test_pooled_parity_with_in_process(native_store):
    """The tentpole pin: a pooled server (pushes ride per-worker rings
    and a worker-core pump) and a plain in-process server on one
    virtual clock produce byte-identical (seq, row) push sequences per
    watcher for the same churn — including across a mid-sequence
    worker crash + restart, where the affected streams resume from seq
    with NO replay (the has-baseline suppresses unchanged rows) and NO
    gap (per-shard seq counters continue), and per-tick outbound stats
    match exactly."""

    async def body():
        t = [4000.0]
        clock = lambda: t[0]  # noqa: E731
        plain, _ = await make_server(
            clock, native_store=native_store, stream_push=True,
            stream_shards=SHARDS, flightrec_capacity=0,
        )
        pooled, _ = await make_server(
            clock, native_store=native_store, stream_push=True,
            stream_shards=SHARDS, flightrec_capacity=0,
        )
        pool = pooled.attach_frontend(WORKERS, ring_bytes=1 << 20)
        servers = {"plain": plain, "pooled": pooled}
        watchers = [f"w{i}" for i in range(6)]
        subs = {n: {} for n in servers}
        pushed = {n: {w: [] for w in watchers} for n in servers}
        last_lease = {n: {w: {} for w in watchers} for n in servers}
        last_seq = {n: {w: 0 for w in watchers} for n in servers}

        def establish(n, w, req=None):
            server = servers[n]
            sub = server._streams.subscribe(req or watch_request(w, {}))
            server._stream_match_add(sub)
            subs[n][w] = sub

        def drain(n):
            terms = {}
            for w, sub in subs[n].items():
                for msg in _drain_queue(sub):
                    if msg.HasField("mastership"):
                        terms[w] = msg
                        continue
                    last_seq[n][w] = int(msg.seq)
                    for row in msg.response:
                        pushed[n][w].append(
                            (int(msg.seq), row.resource_id,
                             row.SerializeToString())
                        )
                        lease = pb.Lease()
                        lease.CopyFrom(row.gets)
                        last_lease[n][w][row.resource_id] = lease
            return terms

        def churn(tick):
            for at, cid, rid, wants in CHURN:
                if at != tick:
                    continue
                for server in servers.values():
                    server._decide(
                        rid, Request(cid, 0.0, wants, 1, priority=1)
                    )

        try:
            for n in servers:
                for w in watchers:
                    establish(n, w)
            # Every pooled watcher is pinned to its shard's home worker.
            for w in watchers:
                sub = subs["pooled"][w]
                assert sub.worker == sub.shard % WORKERS
                assert sub.stream_id > 0
            assert subs["plain"]["w0"].worker is None
            pool.pump_all()
            for n in servers:
                drain(n)
            assert pushed["pooled"] == pushed["plain"], (
                "establishment snapshots diverged"
            )

            for tick in range(1, TOTAL_TICKS):
                if tick == RESTART_TICK:
                    # Worker 0 dies mid-sequence. Its streams terminate
                    # with redirects (never silently); the plain server
                    # mirrors the same terminations so the per-shard
                    # seq streams stay comparable. Both sides then
                    # re-establish with resume_seq + has-baselines.
                    affected = [
                        w for w in watchers
                        if subs["pooled"][w].worker == 0
                    ]
                    assert affected, "schedule needs worker-0 streams"
                    dropped = pool.crash(0)
                    assert dropped == len(affected)
                    for w in affected:
                        plain._streams.terminate(
                            subs["plain"][w], plain._mastership()
                        )
                        plain._streams.unsubscribe(subs["plain"][w])
                        plain._stream_match_remove(subs["plain"][w])
                    terms = {n: drain(n) for n in servers}
                    for w in affected:
                        assert terms["pooled"][w].seq == (
                            terms["plain"][w].seq
                        )
                    pool.restore(0)
                    for n in servers:
                        for w in affected:
                            establish(n, w, watch_request(
                                w, last_lease[n][w],
                                resume_seq=last_seq[n][w],
                            ))
                            assert not subs[n][w].terminated
                    pool.pump_all()
                    for n in servers:
                        drain(n)
                    # Resume parity: same seqs (no gap), and the resume
                    # baseline suppressed unchanged rows (no replay).
                    assert pushed["pooled"] == pushed["plain"]
                    for w in affected:
                        assert subs["pooled"][w].worker == 0  # re-homed
                    churn(tick)
                    continue
                churn(tick)
                t[0] += 1.0
                totals = {}
                for n, server in servers.items():
                    await server.tick_once()
                    if n == "pooled":
                        pool.pump_all()
                    totals[n] = server._streams.take_tick_stats()
                    drain(n)
                for key in ("messages", "deltas_pushed", "push_bytes"):
                    assert totals["pooled"][key] == totals["plain"][key], (
                        f"tick {tick}: {key} diverged: {totals}"
                    )
                for w in watchers:
                    assert pushed["pooled"][w] == pushed["plain"][w], (
                        f"tick {tick}: watcher {w} diverged"
                    )
            total = sum(len(v) for v in pushed["plain"].values())
            assert total >= 6, f"schedule produced only {total} pushes"
            # The ring really was in the path.
            assert pool.publisher.published_frames > 0
            assert sum(c.pushes for c in pool.cores.values()) > 0
        finally:
            for server in servers.values():
                await server.stop()

    run(body())


@pytest.mark.parametrize("native_store", NATIVE_PARAMS,
                         ids=["python-store", "native-store"])
def test_worker_crash_streams_reset_to_redirect(native_store):
    """A dead worker's streams end with a mastership redirect (the
    client re-establishes, routed to a survivor) — never a silent
    lapse; surviving workers' streams are untouched."""

    async def body():
        t = [5000.0]
        clock = lambda: t[0]  # noqa: E731
        server, _ = await make_server(
            clock, native_store=native_store, stream_push=True,
            stream_shards=SHARDS, flightrec_capacity=0,
        )
        pool = server.attach_frontend(WORKERS, ring_bytes=1 << 18)
        watchers = [f"w{i}" for i in range(8)]
        subs = {}
        try:
            for w in watchers:
                sub = server._streams.subscribe(watch_request(w, {}))
                server._stream_match_add(sub)
                subs[w] = sub
            pool.pump_all()
            for sub in subs.values():
                _drain_queue(sub)
            on_w0 = [w for w in watchers if subs[w].worker == 0]
            survivors = [w for w in watchers if subs[w].worker != 0]
            assert on_w0 and survivors
            dropped = pool.crash(0)
            assert dropped == len(on_w0)
            for w in on_w0:
                msgs = _drain_queue(subs[w])
                assert msgs and msgs[-1].HasField("mastership"), (
                    f"{w}: crash must end the stream with a redirect"
                )
                assert subs[w].terminated
            for w in survivors:
                assert not subs[w].terminated
                assert _drain_queue(subs[w]) == []
            # Re-establishment lands on a survivor until restore.
            sub = server._streams.subscribe(
                watch_request(on_w0[0], {})
            )
            assert sub.worker == 1
            pool.restore(0)
            sub2 = server._streams.subscribe(watch_request("fresh", {}))
            assert sub2.worker == sub2.shard % WORKERS  # homes restored
        finally:
            await server.stop()

    run(body())


def test_ring_stall_resets_loudly_on_resume():
    """A stalled worker (pump frozen) whose ring laps resets every held
    stream on resume — redirects, not silently-missing pushes."""

    async def body():
        t = [6000.0]
        clock = lambda: t[0]  # noqa: E731
        server, _ = await make_server(
            clock, native_store=False, stream_push=True,
            stream_shards=SHARDS, flightrec_capacity=0,
        )
        # Tiny rings: a few ticks of pushes + beats lap a frozen reader.
        pool = server.attach_frontend(WORKERS, ring_bytes=512)
        watchers = [f"w{i}" for i in range(8)]
        subs = {}
        try:
            for w in watchers:
                sub = server._streams.subscribe(watch_request(w, {}))
                server._stream_match_add(sub)
                subs[w] = sub
            pool.pump_all()
            for sub in subs.values():
                _drain_queue(sub)
            pool.stall(0)
            for tick in range(6):
                for i, w in enumerate(watchers):
                    server._decide(
                        "prop",
                        Request(f"c{tick}", 0.0, 10.0 + tick + i, 1,
                                priority=1),
                    )
                t[0] += 1.0
                await server.tick_once()
                pool.pump_all()
            pool.unstall(0)
            out = pool.pump_all()
            assert out["lapped"] >= 1
            on_w0 = [w for w in watchers if subs[w].shard % WORKERS == 0]
            for w in on_w0:
                msgs = _drain_queue(subs[w])
                assert msgs and msgs[-1].HasField("mastership"), (
                    f"{w}: lap must reset the stream loudly"
                )
            for w in watchers:
                if w not in on_w0:
                    assert not subs[w].terminated
        finally:
            await server.stop()

    run(body())


# ---------------------------------------------------------------------------
# Byte compatibility with the reference's rings.
# ---------------------------------------------------------------------------

_FRAMES = [
    (3, KIND_PUSH, 42, b"hello"),
    (1, KIND_TERMINAL, 7, b"bye"),
    (0, KIND_BEAT, 0, b""),
] + [(i % 5, KIND_PUSH, 100 + i, bytes([i]) * (11 + i % 7))
     for i in range(40)]


@pytest.mark.parametrize("writer_pkg", ["port", "reference"])
def test_ring_frames_cross_between_the_packages(writer_pkg):
    """One package's writer, the other's reader, over one buffer that
    wraps many times: every frame reads back byte-exact with its seq,
    and the two packages' writers leave identical bytes."""
    mods = {"port": (Ring, RingWriter, RingReader),
            "reference": (j_ring.Ring, j_ring.RingWriter,
                          j_ring.RingReader)}
    reader_pkg = "reference" if writer_pkg == "port" else "port"
    WRing, WWriter, _ = mods[writer_pkg]
    _, _, RReader = mods[reader_pkg]
    ring = WRing.in_memory(512)
    w = WWriter(ring)
    r = RReader(ring)
    got = []
    for shard, kind, sid, payload in _FRAMES:
        w.append(shard, kind, sid, payload)
        res = r.poll()
        assert not res.lapped and res.corrupt == 0 and res.gap == 0
        got += [(f.seq, f.shard, f.kind, f.stream_id, f.payload)
                for f in res.frames]
    assert got == [(i + 1, *f) for i, f in enumerate(_FRAMES)]
    # Same appends through the other package's writer: the same bytes.
    OtherRing, OtherWriter, _ = mods[reader_pkg]
    other = OtherRing.in_memory(512)
    ow = OtherWriter(other)
    for f in _FRAMES:
        ow.append(*f)
    assert bytes(other.buf) == bytes(ring.buf)


def test_shared_memory_ring_written_by_the_reference_reads_in_the_port():
    """The reference's publisher over a named shared-memory block, the
    port's worker core attached through its own mapping: pushes,
    terminals and beats arrive as written."""
    name = "doorman-torch-xpkg-ring"
    ring = j_ring.Ring.shared(name, 4096, create=True)
    try:
        pub = JRingPublisher(1, ring_bytes=4096, rings=[ring])
        attached = Ring.shared(name, 4096)
        events = []
        core = WorkerCore(
            0, attached,
            deliver=lambda sid, h, p: events.append(("push", sid, p)),
            terminal=lambda sid, h, p: events.append(("term", sid, p)),
            on_stall=lambda sid, h, r: events.append(("stall", sid, r)),
        )
        core.register(5, object(), 0.0)
        pub.publish(0, 2, 5, b"pushed")
        pub.beat()
        pub.publish_terminal(0, 2, 5, b"terminal")
        out = core.pump(0.0)
        assert out["frames"] == 3 and not out["lapped"]
        assert events == [("push", 5, b"pushed"), ("term", 5, b"terminal")]
        assert core.beats == 1
        attached.close()
    finally:
        ring.close()
        ring.unlink()


# ---------------------------------------------------------------------------
# Pooled push frames against the reference's.
# ---------------------------------------------------------------------------


def _ring_frames(pool):
    """Every frame each worker's ring holds, read with a fresh cursor
    from position 0 (the rings here never wrap)."""
    out = []
    for ring in pool.publisher.rings:
        r = RingReader(ring)
        r.pos, r.next_seq = 0, 1
        res = r.poll()
        assert not res.lapped and res.corrupt == 0 and res.gap == 0
        out.append([(f.seq, f.shard, f.kind, f.stream_id, f.payload)
                    for f in res.frames])
    return out


@pytest.mark.parametrize("native_store", NATIVE_PARAMS,
                         ids=["python-store", "native-store"])
def test_pooled_push_frames_equal_the_reference(native_store):
    """A pooled port server and a pooled reference server on one
    virtual clock and the same churn (reference :424's schedule): the
    frames on every worker's ring are byte-equal — seq, shard, kind,
    stream id and the pre-serialized payload — and so is every push the
    worker cores hand their subscribers."""

    async def body():
        t = [4000.0]
        clock = lambda: t[0]  # noqa: E731
        port, _ = await make_server(
            clock, native_store=native_store, stream_push=True,
            stream_shards=SHARDS, flightrec_capacity=0,
        )
        ref, _ = await make_ref_server(
            clock, native_store=native_store, stream_push=True,
            stream_shards=SHARDS, flightrec_capacity=0,
        )
        servers = {"port": port, "ref": ref}
        pools = {n: s.attach_frontend(WORKERS, ring_bytes=1 << 20)
                 for n, s in servers.items()}
        watchers = [f"w{i}" for i in range(6)]
        subs = {n: {} for n in servers}
        pushed = {n: {w: [] for w in watchers} for n in servers}
        try:
            for n, server in servers.items():
                for w in watchers:
                    sub = server._streams.subscribe(watch_request(w, {}))
                    server._stream_match_add(sub)
                    subs[n][w] = sub
            for tick in range(1, TOTAL_TICKS):
                for at, cid, rid, wants in CHURN:
                    if at == tick:
                        port._decide(rid, Request(cid, 0.0, wants, 1,
                                                  priority=1))
                        ref._decide(rid, JRequest(cid, 0.0, wants, 1,
                                                  priority=1))
                t[0] += 1.0
                for n, server in servers.items():
                    await server.tick_once()
                    pools[n].pump_all()
                    for w, sub in subs[n].items():
                        for msg in _drain_queue(sub):
                            pushed[n][w].append(msg.SerializeToString())
            assert _ring_frames(pools["port"]) == _ring_frames(pools["ref"])
            assert pushed["port"] == pushed["ref"]
            assert sum(len(v) for v in pushed["port"].values()) >= 6
            assert (pools["port"].publisher.status()
                    == pools["ref"].publisher.status())
        finally:
            for server in servers.values():
                await server.stop()

    run(body())


# ---------------------------------------------------------------------------
# The server's frontend seams.
# ---------------------------------------------------------------------------


def test_status_and_flight_record_carry_the_pool():
    async def body():
        t = [7000.0]
        clock = lambda: t[0]  # noqa: E731
        server, _ = await make_server(
            clock, native_store=False, stream_push=True,
            stream_shards=SHARDS, flightrec_capacity=8,
        )
        pool = server.attach_frontend(WORKERS, ring_bytes=1 << 16,
                                      ramp_window=0.0)
        try:
            for w in ("a", "b", "c"):
                sub = server._streams.subscribe(watch_request(w, {}))
                server._stream_match_add(sub)
            t[0] += 1.0
            await server.tick_once()
            pool.pump_all()
            st = server.status()["frontend"]
            assert st["mode"] == "inline" and st["workers"] == WORKERS
            assert st["held"] == 3
            assert st["ramp"]["window"] == 0.0
            assert server.status()["streams"]["frontend"][
                "published_frames"] == pool.publisher.published_frames
            rec = server.flightrec.snapshot()[-1]
            assert rec["frontend_held"] == 3
            assert rec["frontend_frames"] == pool.publisher.published_frames
        finally:
            await server.stop()
        assert server._frontend is None and server._frontend_ramp is None

    run(body())


class _Ctx:
    def __init__(self, worker):
        self._md = (("doorman-frontend-worker", str(worker)),)

    def invocation_metadata(self):
        return self._md


def test_control_establish_drop_and_heartbeat():
    """The control surface a real worker forwards to: Establish pins
    the stream to the calling worker's ring, Drop releases it, and a
    heartbeat's tallies land in the per-worker attribution."""
    import json

    from doorman_tpu_torch.admission import Admission

    async def body():
        t = [8000.0]
        clock = lambda: t[0]  # noqa: E731
        server, _ = await make_server(
            clock, native_store=False, stream_push=True,
            stream_shards=SHARDS, flightrec_capacity=0,
            admission=Admission(coalesce_window=0.0),
        )
        server.attach_frontend(WORKERS, ring_bytes=1 << 16)
        control = FrontendControl(server)
        try:
            req = watch_request("ctl", {}).SerializeToString()
            reply = json.loads(await control.Establish(req, _Ctx(1)))
            assert reply["worker"] == 1 and reply["stream_id"] > 0
            sub = server._streams.stream_by_id(reply["stream_id"])
            assert sub is not None and sub.worker == 1
            assert server._admission.tallies[("WatchCapacity", 2)][
                "admitted"] == 1
            await control.Drop(
                json.dumps({"stream_id": reply["stream_id"]}).encode(),
                _Ctx(1))
            assert server._streams.stream_by_id(reply["stream_id"]) is None
            await control.Heartbeat(json.dumps({
                "worker": 1, "held": 4,
                "tallies": {"WatchCapacity/0": {"shed": 2}},
            }).encode(), _Ctx(1))
            assert control.status()["worker_held"] == {"1": 4}
            assert server._admission.worker_tallies[1][
                "WatchCapacity/0"]["shed"] == 2
            server.is_master = False
            reply = json.loads(await control.Establish(req, _Ctx(0)))
            assert "terminal" in reply
        finally:
            await server.stop()

    run(body())


# The smoke's own --timeout bounds the arc from server start to resume;
# the child's imports (torch, mostly) run before that deadline starts.
# On eight cores they took ~2 s idle, 44.8 s of a 69.7 s run beside ten
# busy numpy processes (load average ~78) and 51.1 s of 91.7 s beside
# sixteen (load ~100-123; workers_ready 18.5 s, teardown 2.0 s). This
# limit covers the imports under such load as well as the arc.
SMOKE_LIMIT_S = 300


def test_frontend_smoke_runs_the_real_pool_on_the_cpu(tmp_path):
    """cmd/frontend_smoke on the CPU: two spawned listener workers, a
    stream held through a worker kill, resumed with no replay. On a
    timeout the child is killed and its stderr (the step laps it has
    logged so far) is the failure message."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "doorman_tpu_torch.cmd.frontend_smoke",
         "--workers", "2", "--device", "cpu", "--timeout", "60"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    try:
        stdout, stderr = proc.communicate(timeout=SMOKE_LIMIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
        raise AssertionError(
            f"frontend smoke still running after {SMOKE_LIMIT_S} s; "
            f"stderr:\n{stderr[-3000:]}"
        )
    assert proc.returncode == 0, stderr[-3000:]
    assert '"ok": true' in stdout
    assert '"steps_s"' in stdout
