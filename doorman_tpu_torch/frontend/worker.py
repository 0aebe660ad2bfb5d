"""Listener workers: the ring-pump core and the real SO_REUSEPORT
gRPC worker process built on it.

`WorkerCore` is the process-agnostic half: it owns one worker's slice
of the stream space — the stream table, the ring reader cursor, and
the per-worker deadline wheel that turns a missing silent-refresh beat
into a loud reset instead of a silent lapse. The inline pool (pool.py)
drives a WorkerCore per worker on the virtual clock inside the tick
process — that is the form the tier-1 parity pin, the chaos arcs, and
the workload harness exercise. The real worker process (`run_worker`)
wraps the same core in a grpc.aio server that binds the public port
with SO_REUSEPORT (the kernel spreads accept() across the pool; uvloop
when importable), holds the WatchCapacity streams, and forwards every
unary RPC to the tick process as raw bytes — zero re-encode in either
direction.

Deadline wheel: each held stream is armed `margin` ticks ahead; every
frame that reaches it (a push OR the tick edge's KIND_BEAT, which the
pump fans to all local streams' liveness) re-arms it. A stream whose
deadline lapses — ring stalled, writer dead, frames lost — is reset
loudly: the core's on_stall callback ends it (inline: a registry
reset whose terminal redirect rides the ring; real: the worker ends
the gRPC stream so the client re-establishes). Pop cost is O(due +
current bucket), the StreamShard wheel's discipline.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
from typing import Callable, Dict, List, Optional

from doorman_tpu_torch.frontend.ring import (
    KIND_BEAT,
    KIND_PUSH,
    KIND_TERMINAL,
    Ring,
    RingReader,
)

log = logging.getLogger(__name__)

__all__ = ["WorkerCore", "main", "run_worker"]

# Frames addressed to a stream the worker has not registered yet: the
# establishment snapshot can land on the ring before the Establish
# reply reaches the worker. Parked frames flush at registration; the
# buffer is bounded AND self-cleaning — frames for streams that never
# register (dropped between publish and the Drop RPC, cancelled
# establishes, a predecessor worker's table) expire after one stall
# margin, and when the global limit is hit the oldest parked stream is
# evicted to make room, so transient orphans can never permanently
# poison the buffer for the stream registering next.
PARK_LIMIT = 1024

# A stream is stalled when `margin` silent-refresh beats pass without
# any frame reaching it (the tick edge beats every push edge, so a
# healthy quiet stream still re-arms every tick).
STALL_MARGIN_TICKS = 3.0


class WorkerCore:
    """One worker's slice of the stream space (process-agnostic)."""

    def __init__(
        self,
        index: int,
        ring: Ring,
        *,
        deliver: Callable[[int, object, bytes], None],
        terminal: Callable[[int, object, bytes], None],
        on_stall: Callable[[int, object, str], None],
        tick_interval: float = 1.0,
        stall_margin: float = STALL_MARGIN_TICKS,
        park_limit: int = PARK_LIMIT,
    ):
        self.index = index
        self.reader = RingReader(ring)
        self._deliver = deliver
        self._terminal = terminal
        self._on_stall = on_stall
        self._margin = max(stall_margin * max(tick_interval, 1e-3), 1e-3)
        self._park_limit = park_limit
        # stream_id -> opaque handle (inline: the Subscription; real:
        # the stream's local outbound queue).
        self.streams: Dict[int, object] = {}
        # Parked frames by stream, with the first-parked timestamp per
        # stream (set once, so dict insertion order IS age order).
        self._parked: Dict[int, List[tuple]] = {}
        self._park_ts: Dict[int, float] = {}
        self._parked_total = 0
        # The deadline wheel: bucket -> [stream_id]; per-stream armed
        # deadlines live in _deadline (lazy deletion, like the
        # StreamShard wheel — re-arming just inserts again).
        self._wheel: Dict[int, List[int]] = {}
        self._deadline: Dict[int, float] = {}
        self._wheel_g = max(float(tick_interval), 1e-3)
        self.pushes = 0
        self.terminals = 0
        self.beats = 0
        self.parked_frames = 0
        self.parked_dropped = 0
        self.parked_expired = 0
        self.stalls = 0
        self.desyncs = 0
        self.frames = 0

    def held(self) -> int:
        return len(self.streams)

    # -- stream table --------------------------------------------------

    def register(self, stream_id: int, handle: object, now: float) -> None:
        self.streams[stream_id] = handle
        self._arm(stream_id, now)
        for kind, payload in self._take_parked(stream_id):  # flush
            self._dispatch(stream_id, handle, kind, payload, now)

    def drop(self, stream_id: int) -> None:
        self.streams.pop(stream_id, None)
        self._deadline.pop(stream_id, None)
        self._take_parked(stream_id)

    # -- the deadline wheel --------------------------------------------

    def _arm(self, stream_id: int, now: float) -> None:
        deadline = now + self._margin
        self._deadline[stream_id] = deadline
        self._wheel.setdefault(
            int(deadline // self._wheel_g), []
        ).append(stream_id)

    def check_deadlines(self, now: float) -> int:
        """Pop due wheel buckets; a stream whose armed deadline lapsed
        saw NO frame for a full margin — reset it loudly. Returns
        streams stalled. Also sweeps expired parked frames: the park
        TTL is the same margin."""
        self._sweep_parked(now)
        if not self._wheel:
            return 0
        nb = int(now // self._wheel_g)
        stalled = 0
        for b in sorted(self._wheel):
            if b > nb:
                break
            for stream_id in self._wheel.pop(b):
                deadline = self._deadline.get(stream_id)
                handle = self.streams.get(stream_id)
                if deadline is None or handle is None:
                    continue  # dropped or re-armed into a later bucket
                if deadline > now:
                    # Re-armed since this bucket entry was inserted;
                    # the live entry sits in a later bucket.
                    if int(deadline // self._wheel_g) == b:
                        self._wheel.setdefault(b, []).append(stream_id)
                    continue
                stalled += 1
                self.stalls += 1
                self.drop(stream_id)
                self._on_stall(stream_id, handle, "refresh_deadline")
        return stalled

    # -- the pump ------------------------------------------------------

    def pump(self, now: float) -> dict:
        """Drain the ring and route frames to held streams. A lap or
        corrupt frame means this worker can no longer prove its streams
        complete — every held stream resets (loud, in-band), never a
        silent gap."""
        res = self.reader.poll()
        self.frames += len(res.frames)
        for f in res.frames:
            if f.kind == KIND_BEAT:
                self.beats += 1
                # The tick edge's liveness: every held stream saw the
                # writer alive — re-arm the whole slice (quiet streams
                # must not stall while the ring demonstrably flows).
                for stream_id in self.streams:
                    self._arm(stream_id, now)
                continue
            handle = self.streams.get(f.stream_id)
            if handle is None:
                self._park(f.stream_id, f.kind, f.payload, now)
                continue
            self._dispatch(f.stream_id, handle, f.kind, f.payload, now)
        if res.lapped or res.corrupt:
            self.desyncs += 1
            reason = "ring_lap" if res.lapped else "ring_corrupt"
            for stream_id, handle in list(self.streams.items()):
                self.drop(stream_id)
                self._on_stall(stream_id, handle, reason)
        return {
            "frames": len(res.frames),
            "lapped": res.lapped,
            "corrupt": res.corrupt,
            "gap": res.gap,
        }

    def _dispatch(self, stream_id: int, handle: object, kind: int,
                  payload: bytes, now: float) -> None:
        if kind == KIND_PUSH:
            self.pushes += 1
            self._arm(stream_id, now)
            self._deliver(stream_id, handle, payload)
        elif kind == KIND_TERMINAL:
            self.terminals += 1
            self.drop(stream_id)
            self._terminal(stream_id, handle, payload)

    def _park(self, stream_id: int, kind: int, payload: bytes,
              now: float) -> None:
        if kind == KIND_BEAT:
            return
        if self._park_limit <= 0:
            self.parked_dropped += 1
            return
        while self._parked_total >= self._park_limit and self._parked:
            # Full: evict the oldest parked STREAM wholesale — its
            # registration is the furthest overdue, so it is the most
            # likely orphan; the frame arriving now must still park.
            oldest = next(iter(self._park_ts))
            self.parked_dropped += len(self._take_parked(oldest))
        self.parked_frames += 1
        self._parked_total += 1
        self._park_ts.setdefault(stream_id, now)
        self._parked.setdefault(stream_id, []).append((kind, payload))

    def _take_parked(self, stream_id: int) -> List[tuple]:
        entries = self._parked.pop(stream_id, [])
        self._park_ts.pop(stream_id, None)
        self._parked_total -= len(entries)
        return entries

    def _sweep_parked(self, now: float) -> None:
        """Reclaim parked streams older than one stall margin: the
        establishment reply rides the same backend channel as the
        frames, so a stream that has not registered within a full
        margin of its first parked frame never will (dropped between
        publish and the Drop RPC, or a cancelled establish)."""
        while self._park_ts:
            oldest = next(iter(self._park_ts))
            if self._park_ts[oldest] + self._margin > now:
                break  # age order: everything later is younger
            self.parked_expired += len(self._take_parked(oldest))

    def status(self) -> dict:
        return {
            "worker": self.index,
            "held": self.held(),
            "frames": self.frames,
            "pushes": self.pushes,
            "terminals": self.terminals,
            "beats": self.beats,
            "stalls": self.stalls,
            "desyncs": self.desyncs,
            "parked": self.parked_frames,
            "parked_live": self._parked_total,
            "parked_dropped": self.parked_dropped,
            "parked_expired": self.parked_expired,
            "reader": self.reader.status(),
        }


# ---------------------------------------------------------------------------
# The real worker process.
# ---------------------------------------------------------------------------

CONTROL_SERVICE = "doorman_tpu.FrontendControl"
WORKER_METADATA_KEY = "doorman-frontend-worker"

# Unary Capacity methods forwarded to the tick process as raw bytes.
_FORWARDED_UNARY = (
    "Discovery", "GetCapacity", "GetServerCapacity", "ReleaseCapacity",
)

_CLOSE = object()  # end-of-stream sentinel on a stream's local queue


def _install_uvloop() -> bool:
    try:
        import uvloop  # type: ignore
    except ImportError:
        return False
    uvloop.install()
    return True


def run_worker(
    index: int,
    public_addr: str,
    backend_addr: str,
    ring_name: str,
    ring_capacity: int,
    *,
    tick_interval: float = 1.0,
    poll_interval: float = 0.05,
    heartbeat_interval: float = 1.0,
) -> None:
    """Body of one listener worker PROCESS (a fresh interpreter that
    FrontendPool starts with `main`'s command line: workers never import
    torch, nor a module of this package that does, and never touch the
    card). Serves the public port with SO_REUSEPORT, pumps the shared
    ring, forwards unary RPCs and establishment to `backend_addr`. The
    public port is served in the clear (the reference's worker TLS
    waits with TLS); the backend forward is loopback-plaintext by
    design."""
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s %(levelname).1s frontend-w{index}: "
               "%(message)s",
    )
    uv = _install_uvloop()
    log.info("worker %d: uvloop=%s public=%s backend=%s",
             index, uv, public_addr, backend_addr)
    asyncio.run(_worker_serve(
        index, public_addr, backend_addr, ring_name, ring_capacity,
        tick_interval=tick_interval, poll_interval=poll_interval,
        heartbeat_interval=heartbeat_interval,
    ))


def main(argv=None) -> int:
    """A worker process's command line (FrontendPool._spawn):
    --index --public --backend --ring --ring-bytes [--tick-interval]."""
    p = argparse.ArgumentParser(prog="doorman-frontend-worker")
    p.add_argument("--index", type=int, required=True)
    p.add_argument("--public", required=True)
    p.add_argument("--backend", required=True)
    p.add_argument("--ring", required=True)
    p.add_argument("--ring-bytes", type=int, required=True)
    p.add_argument("--tick-interval", type=float, default=1.0)
    args = p.parse_args(argv)
    run_worker(args.index, args.public, args.backend, args.ring,
               args.ring_bytes, tick_interval=args.tick_interval)
    return 0


async def _worker_serve(
    index: int,
    public_addr: str,
    backend_addr: str,
    ring_name: str,
    ring_capacity: int,
    *,
    tick_interval: float,
    poll_interval: float,
    heartbeat_interval: float,
) -> None:
    import signal
    import time

    import grpc

    from doorman_tpu_torch.obs import flightrec as flightrec_mod
    from doorman_tpu_torch.obs import trace as trace_mod
    from doorman_tpu_torch.proto.grpc_api import SERVICE_NAME as CAPACITY_SERVICE

    # Untracked: this process's resource tracker must not unlink the
    # ring when the worker exits (the respawned worker reads it).
    ring = Ring.shared(ring_name, ring_capacity, track=False)
    recorder = flightrec_mod.FlightRecorder(
        component=f"frontend-w{index}"
    )
    tracer = trace_mod.default_tracer()
    # Workers pace the real event loop; the inline pool is the
    # deterministic twin.
    clock = time.monotonic  # doorman: allow[seeded-determinism]
    loop = asyncio.get_running_loop()
    tallies: Dict[str, Dict[str, int]] = {}

    def deliver(stream_id: int, handle, payload: bytes) -> None:
        # Per-stream queues are unbounded here: the RING is the bounded
        # buffer (a worker this far behind laps and resets loudly), so
        # a second bound would only duplicate the reset contract.
        queue: asyncio.Queue = handle  # type: ignore[assignment]
        queue.put_nowait(payload)

    def terminal(stream_id: int, handle, payload: bytes) -> None:
        queue: asyncio.Queue = handle  # type: ignore[assignment]
        queue.put_nowait(payload)
        queue.put_nowait(_CLOSE)

    def on_stall(stream_id: int, handle, reason: str) -> None:
        queue: asyncio.Queue = handle  # type: ignore[assignment]
        tracer.instant(
            "frontend.stall", cat="frontend",
            args={"worker": index, "stream_id": stream_id,
                  "reason": reason},
        )
        queue.put_nowait(_CLOSE)

    core = WorkerCore(
        index, ring,
        deliver=deliver, terminal=terminal, on_stall=on_stall,
        tick_interval=tick_interval,
    )

    backend = grpc.aio.insecure_channel(backend_addr)
    _worker_md = ((WORKER_METADATA_KEY, str(index)),)

    def _control(method: str):
        return backend.unary_unary(f"/{CONTROL_SERVICE}/{method}")

    establish_rpc = _control("Establish")
    drop_rpc = _control("Drop")
    heartbeat_rpc = _control("Heartbeat")

    def _tally(method: str, band: int, outcome: str) -> None:
        entry = tallies.setdefault(f"{method}/{band}", {})
        entry[outcome] = entry.get(outcome, 0) + 1

    async def _reraise(context, err: "grpc.aio.AioRpcError"):
        trailing = err.trailing_metadata()
        if trailing:
            context.set_trailing_metadata(trailing)
        await context.abort(err.code(), err.details() or "")

    def _forward_unary(method: str):
        rpc = backend.unary_unary(f"/{CAPACITY_SERVICE}/{method}")

        async def handler(request_bytes: bytes, context):
            try:
                return await rpc(
                    request_bytes, metadata=context.invocation_metadata()
                )
            except grpc.aio.AioRpcError as err:
                if method == "GetCapacity" and err.code() == (
                    grpc.StatusCode.RESOURCE_EXHAUSTED
                ):
                    _tally(method, -1, "shed")
                await _reraise(context, err)

        return handler

    async def _watch(request_bytes: bytes, context):
        """WatchCapacity: forward establishment to the tick process
        (it gates, subscribes, and starts publishing to this worker's
        ring), then serve the stream from the local queue the pump
        fills."""
        try:
            reply_bytes = await establish_rpc(
                request_bytes, metadata=_worker_md
            )
        except grpc.aio.AioRpcError as err:
            _tally("WatchCapacity", -1, "shed")
            await _reraise(context, err)
            return
        reply = json.loads(reply_bytes)
        if "error" in reply:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, reply["error"]
            )
        if "shed" in reply:
            _tally("WatchCapacity", int(reply.get("band", 0)), "shed")
            context.set_trailing_metadata((
                ("doorman-retry-after",
                 f"{reply.get('retry_after', 1.0):.3f}"),
            ))
            await context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED, reply["shed"]
            )
        if "terminal" in reply:
            # Not master (or draining): one mastership redirect, end.
            yield bytes.fromhex(reply["terminal"])
            return
        stream_id = int(reply["stream_id"])
        _tally("WatchCapacity", int(reply.get("band", 0)), "admitted")
        queue: asyncio.Queue = asyncio.Queue()
        core.register(stream_id, queue, clock())
        try:
            with tracer.span(
                "frontend.stream", cat="frontend",
                args={"worker": index, "stream_id": stream_id},
            ):
                while True:
                    item = await queue.get()
                    if item is _CLOSE:
                        return
                    yield item
        finally:
            core.drop(stream_id)
            try:
                await drop_rpc(
                    json.dumps({"stream_id": stream_id}).encode(),
                    metadata=_worker_md,
                )
            except grpc.aio.AioRpcError:
                pass  # tick process gone; nothing to clean up against

    handlers = {
        name: grpc.unary_unary_rpc_method_handler(_forward_unary(name))
        for name in _FORWARDED_UNARY
    }
    handlers["WatchCapacity"] = grpc.unary_stream_rpc_method_handler(
        _watch
    )
    server = grpc.aio.server(options=(("grpc.so_reuseport", 1),))
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(
            CAPACITY_SERVICE, handlers
        ),
    ))
    server.add_insecure_port(public_addr)
    await server.start()
    log.info("worker %d serving %s", index, public_addr)

    # Graceful drain: SIGTERM stops accepting, ends held streams (the
    # _CLOSE fan-out below), and lets in-flight unary forwards finish
    # within the grace window (doc/serving.md runbook).
    drain_grace = 5.0

    def _drain():
        log.info("worker %d draining (%d streams)", index, core.held())
        for stream_id, handle in list(core.streams.items()):
            core.drop(stream_id)
            handle.put_nowait(_CLOSE)  # type: ignore[attr-defined]
        asyncio.ensure_future(server.stop(grace=drain_grace))

    loop.add_signal_handler(signal.SIGTERM, _drain)

    async def pump_loop():
        while True:
            now = clock()
            with tracer.span(
                "frontend.pump", cat="frontend", args={"worker": index}
            ):
                core.pump(now)
                core.check_deadlines(now)
            await asyncio.sleep(poll_interval)

    async def heartbeat_loop():
        # Tally deltas move to `pending` before each send and clear
        # only after the RPC succeeds: a heartbeat that fails (tick
        # process briefly unavailable) retries its deltas next beat
        # instead of losing them from the per-worker attribution.
        pending: Dict[str, Dict[str, int]] = {}
        while True:
            await asyncio.sleep(heartbeat_interval)
            for key, outcomes in tallies.items():
                slot = pending.setdefault(key, {})
                for outcome, n in outcomes.items():
                    slot[outcome] = slot.get(outcome, 0) + n
            tallies.clear()
            body = json.dumps({
                "worker": index,
                "held": core.held(),
                "tallies": pending,
            }).encode()
            recorder.record(
                held=core.held(), frames=core.frames,
                pushes=core.pushes, stalls=core.stalls,
            )
            try:
                await heartbeat_rpc(body, metadata=_worker_md)
            except grpc.aio.AioRpcError:
                log.warning(
                    "worker %d: heartbeat failed (tallies held for "
                    "retry)", index,
                )
            else:
                pending.clear()

    tasks = [
        loop.create_task(pump_loop()),
        loop.create_task(heartbeat_loop()),
    ]
    try:
        await server.wait_for_termination()
    finally:
        for t in tasks:
            t.cancel()
        ring.close()
        await backend.close()
