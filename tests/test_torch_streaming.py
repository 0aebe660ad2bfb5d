"""Streaming lease push (WatchCapacity) in the port, against the reference
on the CPU (the port's servers on device="cpu": the plain versions of its
kernels; the reference's with JAX on the CPU).

  * the port's stream server and the reference's over loopback gRPC on one
    virtual clock, with tests/test_streaming.py's config, churn schedule,
    mastership flip (tick 6) and disconnect / resume-from-seq reconnect
    (ticks 10 and 12), on the Python and the native store: every pushed
    WatchCapacityResponse is byte-identical to the reference's (seq, tick
    and snapshot included; the flip's terminal mastership redirect too),
    the per-tick fanout counters are equal, and every pushed row equals,
    byte for byte, the row a poll of the same tick returns from a third
    (port, poll-only) server — the pushed sequence is exactly the polls'
    changed subsequence (reference tests/test_streaming.py:245). The port
    runs with 1 and with 4 stream shards against the reference's single
    shard: the sharded parity pin of reference :841;
  * establishment refusals with the reference's wire answers: the per-band
    stream cap (RESOURCE_EXHAUSTED with the retry-after trailing metadata)
    and UNIMPLEMENTED when stream push is off;
  * the quiet tick walks zero subscriptions (reference :956) and the delta
    filter limits the fanout's decides (reference :704), on the native
    store with delta tracking;
  * the slow-consumer reset, confined to its shard (reference :597);
  * a fanout that raises is counted in status()["streams"]["fanout_errors"]
    and the tick still completes;
  * the CLI flags' defaults equal the reference's, and `--stream-push`
    serves WatchCapacity from the server binary.
"""

import asyncio

import grpc
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu.algorithms import Request as JRequest
from doorman_tpu.cmd import server as j_cmd
from doorman_tpu.proto import doorman_pb2 as pb
from doorman_tpu.proto import doorman_stream_pb2 as spb
from doorman_tpu.proto.grpc_api import CapacityStub
from doorman_tpu.server.config import parse_yaml_config as j_parse
from doorman_tpu.server.election import TrivialElection as JElection
from doorman_tpu.server.server import CapacityServer as JServer
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.algorithms import Request
from doorman_tpu_torch.cmd import server as t_cmd
from doorman_tpu_torch.server.config import parse_yaml_config as t_parse
from doorman_tpu_torch.server.election import TrivialElection as TElection
from doorman_tpu_torch.server.server import CapacityServer as TServer
from doorman_tpu_torch.server.streams import QUEUE_SIZE, Subscription
from tests.test_streaming import (
    CONFIG,
    DISCONNECT_TICK,
    FLIP_TICK,
    RECONNECT_TICK,
    RESOURCES,
    TOTAL_TICKS,
    PollSide,
    StreamReader,
    drive_churn,
    reregister_after_flip,
    watch_request,
)

# Both stream servers name the same master in their redirects, so the
# flip's terminal messages can be compared byte for byte.
MASTER = "127.0.0.1:15000"
WATCH = "/doorman_tpu.Capacity/WatchCapacity"
NATIVE = pytest.param(
    True, id="native-store",
    marks=pytest.mark.skipif(
        not tnative.native_available(), reason="native engine unavailable"
    ),
)
STORES = [pytest.param(False, id="python-store"), NATIVE]
FANOUT_KEYS = ("messages", "deltas_pushed", "push_bytes", "subs_walked",
               "matched_pairs")


async def _start(server, config):
    """Start on loopback, load the config, let the election land; the
    harness owns the tick cadence."""
    if isinstance(server, JServer):
        port = await server.start(0, host="127.0.0.1")
    else:
        port = await server.start(0, host="127.0.0.1", tick_loop=False)
    await server.load_config(config)
    await asyncio.sleep(0)
    server.current_master = MASTER
    if isinstance(server, JServer):
        for task in server._tasks:
            task.cancel()
        server._tasks.clear()
    return f"127.0.0.1:{port}"


def _port(clock, native_store, **kw):
    # No flight recorder: it would take the per-tick fanout counters.
    kw.setdefault("minimum_refresh_interval", 0.0)
    kw.setdefault("flightrec_capacity", 0)
    return TServer("srv", TElection(), mode="batch", tick_interval=1.0,
                   clock=clock, native_store=native_store, device="cpu",
                   **kw)


def _ref(clock, native_store, **kw):
    # No flight recorder: it would take the per-tick fanout counters.
    kw.setdefault("minimum_refresh_interval", 0.0)
    kw.setdefault("flightrec_capacity", 0)
    return JServer("srv", JElection(), mode="batch", tick_interval=1.0,
                   clock=clock, native_store=native_store, **kw)


class Side:
    """One stream server's watcher "w", read as raw bytes."""

    def __init__(self, server, channel):
        self.server = server
        self.watch = channel.unary_stream(
            WATCH, request_serializer=spb.WatchCapacityRequest.SerializeToString,
            response_deserializer=None,
        )
        self.reader = None
        self.leases = {}
        self.last_seq = 0
        self.pushed = {rid: [] for rid in RESOURCES}
        self.raw = []

    def apply(self, raw):
        self.raw.append(raw)
        msg = spb.WatchCapacityResponse.FromString(raw)
        if msg.HasField("mastership"):
            return msg
        assert msg.seq > self.last_seq or msg.snapshot
        self.last_seq = int(msg.seq)
        for row in msg.response:
            self.pushed[row.resource_id].append(row.SerializeToString())
            lease = pb.Lease()
            lease.CopyFrom(row.gets)
            self.leases[row.resource_id] = lease
        return msg

    async def open(self, resume):
        self.reader = StreamReader(self.watch(watch_request(
            "w", self.leases, resume_seq=self.last_seq if resume else 0
        )))
        msg = self.apply(await self.reader.read())
        assert msg.snapshot
        return msg

    async def tick(self):
        """One tick and the messages it pushed; returns the tick's fanout
        counters."""
        registry = self.server._streams
        before = registry.total_messages
        await self.server.tick_once()
        for raw in await self.reader.read_exactly(
            registry.total_messages - before
        ):
            self.apply(raw)
        return registry.take_tick_stats()


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("native_store", STORES)
def test_pushes_equal_the_reference_and_the_polls(native_store, shards):
    async def body():
        t = [1000.0]
        clock = lambda: t[0]  # noqa: E731
        ref = _ref(clock, native_store, stream_push=True)
        port = _port(clock, native_store, stream_push=True,
                     stream_shards=shards)
        poller = _port(clock, native_store)
        addrs = [await _start(ref, j_parse(CONFIG)),
                 await _start(port, t_parse(CONFIG)),
                 await _start(poller, t_parse(CONFIG))]
        channels = [grpc.aio.insecure_channel(a) for a in addrs]
        servers = (ref, port, poller)
        try:
            stubs = [CapacityStub(c) for c in channels]
            sides = [Side(ref, channels[0]), Side(port, channels[1])]
            poll = PollSide(stubs[2])
            churn_leases = {id(s): {} for s in stubs}

            def check(where):
                assert sides[1].raw == sides[0].raw, where
                for rid in RESOURCES:
                    assert sides[1].pushed[rid] == poll.changed[rid], (
                        f"{where}: {rid} pushed {len(sides[1].pushed[rid])}"
                        f" vs {len(poll.changed[rid])} polled changes"
                    )

            await poll.poll()
            for side in sides:
                snap = await side.open(resume=False)
                assert sorted(r.resource_id for r in snap.response) == sorted(
                    RESOURCES)
            check("establishment")
            disconnected = False
            for tick in range(1, TOTAL_TICKS):
                if tick == FLIP_TICK:
                    for s in servers:
                        await s._on_is_master(False)
                    for side in sides:
                        term = side.apply(await side.reader.read())
                        assert term.mastership.master_address == MASTER
                        side.reader.cancel()
                    for s in servers:
                        await s._on_is_master(True)
                    await reregister_after_flip(tick, stubs, churn_leases)
                    for side in sides:
                        await side.open(resume=True)
                    await poll.poll()
                    check(f"flip at tick {tick}")
                    continue
                if tick == DISCONNECT_TICK:
                    for side in sides:
                        side.reader.cancel()
                    await asyncio.sleep(0.05)  # the servers see the cancel
                    disconnected = True
                if tick == RECONNECT_TICK:
                    disconnected = False
                await drive_churn(tick, stubs, churn_leases)
                t[0] += 1.0
                if disconnected or tick == RECONNECT_TICK:
                    for s in servers:
                        await s.tick_once()
                    await poll.poll()
                if disconnected:
                    continue
                if tick == RECONNECT_TICK:
                    for side in sides:
                        resumed = await side.open(resume=True)
                    for row in resumed.response:
                        assert (row.SerializeToString()
                                == poll.rows[row.resource_id])
                    assert sides[1].raw == sides[0].raw
                    # The stream never saw the gap's flapping: both
                    # sequences restart from the resumed state.
                    for rid in RESOURCES:
                        poll.changed[rid] = list(sides[1].pushed[rid])
                    continue
                stats = [await side.tick() for side in sides]
                await poller.tick_once()
                await poll.poll()
                for key in FANOUT_KEYS:
                    assert stats[1][key] == stats[0][key], (tick, key, stats)
                assert stats[1]["stream_shards"] == shards
                check(f"tick {tick}")
            total = sum(len(v) for v in sides[1].pushed.values())
            assert 6 <= total < TOTAL_TICKS * len(RESOURCES)
            # The native store's changed rows go through the matcher
            # (torch ops on CPU tensors; the watcher, due every tick at a
            # 1 s refresh, is decided as due, so no pair is counted as
            # matched fanout work); the Python store has no matcher.
            if native_store:
                matchers = (port._stream_matcher, ref._stream_matcher)
                assert matchers[0].status()["device"]
                assert matchers[0].matched_total == matchers[1].matched_total
                assert matchers[0].matched_total > 0
            else:
                assert port._stream_matcher is None
            st = port.status()["streams"]
            assert st["fanout_errors"] == 0 and st["shards"] == shards
            ref_st = ref.status()["streams"]
            assert sorted(st) == sorted([*ref_st, "fanout_errors"])
            for key in ("subscribers", "by_band", "seq", "messages_total",
                        "deltas_total", "bytes_total", "resets_total"):
                assert st[key] == ref_st[key], key
            for side in sides:
                side.reader.cancel()
        finally:
            for c in channels:
                await c.close()
            for s in servers:
                await s.stop()

    asyncio.run(body())


@pytest.mark.parametrize("case", ["band-cap", "push-off"])
def test_refusals_answer_as_the_reference(case):
    """The per-band stream cap sheds establishment with RESOURCE_EXHAUSTED
    and the retry-after trailing metadata (another band is admitted);
    without stream push, UNIMPLEMENTED. Code, details and metadata equal
    the reference's."""

    async def body():
        clock = lambda: 500.0  # noqa: E731
        kw = {"stream_push": True, "max_streams_per_band": 1} \
            if case == "band-cap" else {}
        ref, port = _ref(clock, False, **kw), _port(clock, False, **kw)
        addrs = [await _start(ref, j_parse(CONFIG)),
                 await _start(port, t_parse(CONFIG))]
        channels = [grpc.aio.insecure_channel(a) for a in addrs]

        def req(cid, prio):
            r = spb.WatchCapacityRequest(client_id=cid)
            rr = r.resource.add()
            rr.resource_id, rr.priority, rr.wants = "prop", prio, 10.0
            return r

        async def refused(stub, r):
            reader = StreamReader(stub.WatchCapacity(r))
            with pytest.raises(grpc.aio.AioRpcError) as err:
                await reader.read()
            e = err.value
            return e.code(), e.details(), tuple(e.trailing_metadata() or ())

        try:
            answers, readers = [], []
            for ch in channels:
                stub = CapacityStub(ch)
                if case == "push-off":
                    answers.append(await refused(stub, req("a", 0)))
                    continue
                first = StreamReader(stub.WatchCapacity(req("a", 0)))
                assert (await first.read()).snapshot
                answers.append(await refused(stub, req("b", 0)))
                other = StreamReader(stub.WatchCapacity(req("c", 1)))
                assert (await other.read()).snapshot
                readers += [first, other]
            assert answers[1] == answers[0]
            code, details, meta = answers[1]
            if case == "push-off":
                assert code == grpc.StatusCode.UNIMPLEMENTED
                assert "--stream-push" in details
            else:
                assert code == grpc.StatusCode.RESOURCE_EXHAUSTED
                hints = [float(v) for k, v in meta
                         if k == "doorman-retry-after"]
                assert hints == [1.0]
                assert port.status()["streams"]["by_band"] == {"0": 1, "1": 1}
            for r in readers:
                r.cancel()
        finally:
            for c in channels:
                await c.close()
            for s in (ref, port):
                await s.stop()

    asyncio.run(body())


LONG_REFRESH = (
    "resources:\n"
    "- identifier_glob: \"*\"\n"
    "  capacity: 100\n"
    "  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 600,\n"
    "              refresh_interval: 30,\n"
    "              learning_mode_duration: 0}\n"
)


def _watch(client_id, rid, wants=30.0):
    req = spb.WatchCapacityRequest(client_id=client_id)
    rr = req.resource.add()
    rr.resource_id, rr.wants = rid, wants
    return req


def _drain(sub):
    out = []
    while not sub.queue.empty():
        item = sub.queue.get_nowait()
        if isinstance(item, (bytes, bytearray)):
            item = spb.WatchCapacityResponse.FromString(bytes(item))
        out.append(item)
    return out


@pytest.mark.parametrize("native_store", [NATIVE])
def test_quiet_ticks_walk_nothing_and_churn_decides_only_its_row(
    native_store
):
    """Delta tracking on, refresh intervals longer than the tick: quiet
    ticks walk zero subscriptions and decide nothing; the due refresh beat
    walks exactly the due set; one churned resource re-decides and walks
    only its subscriber, through the matcher's pairs (reference
    tests/test_streaming.py:704 and :956)."""

    async def body():
        t = [5000.0]
        server = _port(lambda: t[0], native_store, stream_push=True,
                       stream_shards=2)
        await _start(server, t_parse(LONG_REFRESH))
        try:
            registry = server._streams
            subs = []
            for i, rid in enumerate(("ra", "rb", "rc")):
                sub = registry.subscribe(_watch(f"w{i}", rid))
                server._stream_match_add(sub)
                subs.append(sub)
            decides = []
            orig = server._decide
            server._decide = lambda rid, request: (
                decides.append(rid), orig(rid, request)
            )[1]
            for _ in range(4):  # warm: deliveries converge
                t[0] += 1.0
                await server.tick_once()
            registry.take_tick_stats()
            decides.clear()
            for _ in range(3):
                t[0] += 1.0
                await server.tick_once()
                st = registry.take_tick_stats()
                assert (st["subs_walked"], st["messages"],
                        st["matched_pairs"]) == (0, 0, 0), st
            assert decides == [] and len(registry) == 3
            assert server._resident.delta_tracking
            t[0] += 31.0  # past the refresh interval: the wheel's beat
            await server.tick_once()
            assert registry.take_tick_stats()["subs_walked"] == 3
            server._decide("rb", Request("x", 0.0, 500.0, 1, priority=0))
            decides.clear()
            for _ in range(2):
                t[0] += 1.0
                await server.tick_once()
            st = registry.take_tick_stats()
            assert set(decides) == {"rb"}, decides
            assert st["subs_walked"] == 1 and st["matched_pairs"] >= 1, st
            pushed = [m for m in _drain(subs[1]) if not m.snapshot]
            assert pushed and pushed[-1].response[0].resource_id == "rb"
            status = server._stream_matcher.status()
            assert status["device"] and status["slots"] == 3
            assert server.status()["phase_s"]["stream.match"] > 0.0
        finally:
            await server.stop()

    asyncio.run(body())


FANOUT_CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 600
  safe_capacity: 1
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 7200,
              refresh_interval: 3600, learning_mode_duration: 0}
"""


@pytest.mark.parametrize("native_store", [NATIVE])
def test_fanout_tier_walks_and_pushes_as_the_reference(native_store):
    """bench.py's fanout-scaling shape at 500 subscriptions (10 rows of
    50, 4 shards): 3 warm ticks, 6 ticks each churning 4 rows with the
    churner's 500 <-> 1 flip, 2 settle and 3 quiet ticks. Every tick's
    fanout counters and every subscriber's pushed bytes equal the
    reference's. Its quiet ticks still walk the subscribers of churned
    rows whose last grant move reaches the store with the delivery
    rotation (one row a tick at a 3600 s refresh), in both packages
    (ROADMAP C)."""

    async def body():
        t = [9000.0]
        servers = [
            _ref(lambda: t[0], native_store, stream_push=True,
                 stream_shards=4),
            _port(lambda: t[0], native_store, stream_push=True,
                  stream_shards=4),
        ]
        await _start(servers[0], j_parse(FANOUT_CONFIG))
        await _start(servers[1], t_parse(FANOUT_CONFIG))
        try:
            subs = [[], []]
            for i in range(500):
                for k, s in enumerate(servers):
                    sub = s._streams.subscribe(_watch(f"s{i}", f"r{i % 10}",
                                                      wants=10.0))
                    s._stream_match_add(sub)
                    subs[k].append(sub)
            quiet = []
            for tick in range(14):
                kind = ("warm" if tick < 3 else "churn" if tick < 9
                        else "settle" if tick < 11 else "quiet")
                t[0] += 1.0
                stats = []
                for s, req in zip(servers, (JRequest, Request)):
                    if kind == "churn":
                        k = tick - 3
                        for j in range(4):
                            s._decide(f"r{(k * 4 + j) % 10}", req(
                                "churner", 0.0, 500.0 if k % 2 == 0 else 1.0,
                                1, priority=0))
                    await s.tick_once()
                    stats.append(s._streams.take_tick_stats())
                pushes = [[[bytes(m) for m in _drain_raw(sub)]
                           for sub in group] for group in subs]
                assert pushes[1] == pushes[0], tick
                for key in FANOUT_KEYS:
                    assert stats[1][key] == stats[0][key], (tick, key, stats)
                if kind == "quiet":
                    quiet.append(stats[1]["subs_walked"])
                    assert stats[1]["subs_walked"] == stats[1]["matched_pairs"]
            assert quiet == [50, 50, 50]
        finally:
            for s in servers:
                await s.stop()

    asyncio.run(body())


def _drain_raw(sub):
    out = []
    while not sub.queue.empty():
        out.append(sub.queue.get_nowait())
    return out


def test_slow_consumer_reset_stays_in_its_shard():
    async def body():
        server = _port(lambda: 100.0, False, stream_push=True,
                       stream_shards=4)
        await _start(server, t_parse(CONFIG))
        try:
            registry = server._streams
            shard = registry.shard_of("c")
            other = registry.shards[(shard.index + 1) % 4]
            sub = Subscription("c", 0, {"prop": (10.0, 0)},
                               shard=shard.index)
            shard._subs[sub] = None
            bystander = Subscription("d", 0, {"prop": (10.0, 0)},
                                     shard=other.index)
            other._subs[bystander] = None
            for _ in range(QUEUE_SIZE + 4):
                shard.enqueue(sub, shard._message_bytes([]), 0)
            assert sub.terminated and shard.total_resets == 1
            assert registry.total_resets == 1 and other.total_resets == 0
            assert not bystander.terminated
            last = _drain(sub)[-1]
            assert not isinstance(last, bytes)
            assert last.mastership.master_address == MASTER
        finally:
            await server.stop()

    asyncio.run(body())


@pytest.mark.parametrize("native_store", STORES)
def test_fanout_fault_is_counted_and_the_tick_completes(native_store,
                                                         monkeypatch):
    """A fanout that raises — in the device match on the native store, in
    the registry's decide on the Python store — is counted once a tick,
    the tick completes, and the next tick re-decides every subscription,
    so the delta the faulted ticks drained still reaches its subscriber
    (refresh interval 30 s: no silent refresh beat covers it)."""

    async def body():
        t = [700.0]
        server = _port(lambda: t[0], native_store, stream_push=True)
        await _start(server, t_parse(LONG_REFRESH))
        try:
            sub = server._streams.subscribe(_watch("w", "ra", wants=80.0))
            server._stream_match_add(sub)
            for _ in range(3):  # warm: the establishment grant settles
                t[0] += 1.0
                await server.tick_once()
            granted = [m for m in _drain(sub) if not m.snapshot]
            before = (granted or [None])[-1]

            faults = []

            def boom(*a, **k):
                # The device matcher keeps failing (the check-all tick
                # after a fault does not reach it); the Python store's
                # every tick is check-all, so its fault strikes once.
                if native_store or not faults:
                    faults.append(1)
                    raise RuntimeError("fanout fault")
                return real(*a, **k)

            if native_store:
                monkeypatch.setattr(
                    type(server._stream_matcher_sync()), "_match_device",
                    boom)
            else:
                real = server._streams._decide_all
                monkeypatch.setattr(server._streams, "_decide_all", boom)
            # A second client's wants shrink the watcher's grant. The
            # fault stays on for every tick the churn takes to settle:
            # the tick after the first fault must still push it.
            server._decide("ra", Request("x", 0.0, 90.0, 1, priority=0))
            ticks = server._ticks_done
            pushes = []
            for n in range(1, 4):
                t[0] += 1.0
                await server.tick_once()
                assert server._ticks_done == ticks + n
                errors = server.status()["streams"]["fanout_errors"]
                assert errors == len(faults)
                pushes.append((errors, _drain(sub)))
            first = next(i for i, (e, _) in enumerate(pushes) if e)
            assert pushes[first][1] == []
            assert first + 1 < len(pushes) and pushes[first + 1][1]
            monkeypatch.undo()
            t[0] += 1.0
            await server.tick_once()
            assert server.status()["streams"]["fanout_errors"] == errors
            pushed = [m for _, ms in pushes for m in ms] + _drain(sub)
            assert pushed and not pushed[-1].snapshot
            row = pushed[-1].response[0]
            assert row.resource_id == "ra"
            assert before is None or row.gets.capacity < (
                before.response[0].gets.capacity)
        finally:
            await server.stop()

    asyncio.run(body())


def test_cli_stream_flags_match_the_reference_and_serve(tmp_path):
    ref, port = j_cmd.make_parser(), t_cmd.make_parser()
    flags = ("stream_push", "max_streams_per_band", "stream_shards",
             "minimum_refresh_interval")
    for dest in flags:
        assert port.get_default(dest) == ref.get_default(dest), dest
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(CONFIG)
    args = port.parse_args([
        "--config", f"file:{cfg}", "--port", "0", "--host", "127.0.0.1",
        "--device", "cpu", "--debug-port", "-1",
        "--stream-push", "--max-streams-per-band", "3",
        "--stream-shards", "2", "--minimum-refresh-interval", "0",
        "--tick-interval", "0.05",
    ])

    async def scenario():
        started = asyncio.get_running_loop().create_future()
        task = asyncio.create_task(t_cmd.serve(
            args, lambda server, _debug: started.set_result(server)
        ))
        try:
            server = await asyncio.wait_for(started, 10)
            assert server.mode == "immediate"
            assert server._streams.max_streams_per_band == 3
            assert len(server._streams.shards) == 2
            assert server.minimum_refresh_interval == 0.0
            async with grpc.aio.insecure_channel(
                f"127.0.0.1:{server.port}"
            ) as ch:
                stub = CapacityStub(ch)
                reader = StreamReader(stub.WatchCapacity(_watch("w", "prop")))
                snap = await reader.read()
                assert snap.snapshot and snap.response[0].gets.capacity == 30.0
                # Immediate mode has no tick: the stream beat re-decides
                # every subscription at the tick interval.
                server._streams.take_tick_stats()
                await asyncio.sleep(0.3)
                assert server._streams.take_tick_stats()["subs_walked"] >= 2
                assert server.status()["streams"]["fanout_errors"] == 0
                reader.cancel()
        finally:
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task

    asyncio.run(scenario())
