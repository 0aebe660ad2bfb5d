"""Background-refresh capacity client.

Capability parity with reference go/client/doorman/client.go: the client
holds a set of claimed resources, refreshes all their leases in one bulk
GetCapacity on the shortest refresh interval (floored by
minimum_refresh_interval), pushes capacity changes to per-resource queues
(bounded, dropping when full — slow consumers see the latest values on
their next read), zeroes capacity when a lease expires during an outage,
and releases capacity on close.

Port of doorman_tpu/client/client.py: the refresh, its GetCapacity and
the WatchCapacity establishment open obs/trace spans and send their
context as gRPC metadata, as in the reference.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import socket
import time
from typing import Callable, Dict, Optional

import grpc

from doorman_tpu_torch.admission.policy import RETRY_AFTER_KEY
from doorman_tpu_torch.client.connection import Connection
from doorman_tpu_torch.obs import trace as trace_mod
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto import doorman_stream_pb2 as spb
from doorman_tpu_torch.utils.backoff import MAX_BACKOFF, MIN_BACKOFF, VERY_LONG_TIME, backoff

log = logging.getLogger(__name__)

CAPACITY_QUEUE_SIZE = 32

# Upper bound on one bulk-refresh RPC attempt (including the
# connection's internal redirect/retry chasing); see _perform_requests.
REFRESH_RPC_BOUND = 30.0

# Stream mode: after the server answered UNIMPLEMENTED (stream push
# disabled there), poll for this long before probing the stream again —
# a flip may land on a master that does stream.
STREAM_REPROBE = 60.0

_id_counter = 0


def _default_client_id() -> str:
    global _id_counter
    _id_counter += 1
    return f"{socket.gethostname()}:{os.getpid()}:{_id_counter}"


class ErrInvalidWants(ValueError):
    pass


class ErrDuplicateResourceID(ValueError):
    pass


class ClientResource:
    """A resource claimed through a Client. Capacity updates arrive on
    `capacity()`; `ask()` changes the desired capacity; `release()` drops
    the lease."""

    def __init__(self, client: "Client", resource_id: str, wants: float,
                 priority: int):
        self._client = client
        self.id = resource_id
        self.priority = priority
        self.wants = wants
        self.lease: Optional[pb.Lease] = None
        # Server-sent safe capacity (response field, stored like the
        # reference sim client, simulation/client.py:197-200 /
        # :293-296): what the application may consume while it has NO
        # live lease because of an outage. None until the server ever
        # sent one; effective only after an outage expiry.
        self.safe_capacity: Optional[float] = None
        self._fallback_capacity = 0.0
        self._capacity: asyncio.Queue[float] = asyncio.Queue(
            maxsize=CAPACITY_QUEUE_SIZE
        )

    def capacity(self) -> "asyncio.Queue[float]":
        return self._capacity

    def current_capacity(self) -> float:
        if self.lease is not None:
            return self.lease.capacity
        return self._fallback_capacity

    def expires(self) -> float:
        return self.lease.expiry_time if self.lease is not None else 0.0

    async def ask(self, wants: float) -> None:
        if wants <= 0:
            raise ErrInvalidWants(wants)
        self.wants = wants
        # Trigger an immediate refresh, like the reference's Ask which
        # re-enqueues the resource (client.go:132-146,242-268).
        self._client._wake.set()

    async def release(self) -> None:
        await self._client.release_resource(self)

    def _push_capacity(self, value: float) -> None:
        try:
            self._capacity.put_nowait(value)
        except asyncio.QueueFull:
            pass  # consumer lags; it will see newer values later


class Client:
    """A doorman-tpu client. Create with `await Client.connect(addr)`."""

    def __init__(
        self,
        addr: str,
        client_id: Optional[str] = None,
        *,
        minimum_refresh_interval: float = 5.0,
        tls: bool = False,
        tls_ca: Optional[str] = None,
        max_retries: Optional[int] = None,
        clock: Callable[[], float] = time.time,
        retry_rng: Optional[random.Random] = None,
        stream: bool = False,
    ):
        """`max_retries` bounds each RPC's internal retry loop (None =
        the reference's retry-forever). `clock` is the wall-clock used
        for lease-expiry decisions; the chaos harness injects a virtual
        clock here so outage expiry is deterministic. `retry_rng` is the
        matching randomness seam: pass a seeded random.Random to pin the
        retry/shed jitter in replayed runs. `stream=True` holds one
        WatchCapacity stream instead of polling — lease deltas arrive
        as tick-edge pushes, with automatic poll fallback whenever the
        stream is shed, unsupported, redirected, or quiet into the
        lease-expiry margin (doc/streaming.md)."""
        self.id = client_id or _default_client_id()
        self._clock = clock
        self.conn = Connection(
            addr,
            minimum_refresh_interval=minimum_refresh_interval,
            max_retries=max_retries,
            tls=tls,
            tls_ca=tls_ca,
        )
        self.resources: Dict[str, ClientResource] = {}
        self._wake = asyncio.Event()
        self._closed = False
        self._task: Optional[asyncio.Task] = None
        # Private jitter stream for retry pacing (full jitter on the
        # backoff ladder; half-jitter on server retry-after hints) —
        # decorrelates the fleet's retry waves. Private so nothing
        # else's draws interleave with it; unseeded only when the
        # caller injected nothing (production).
        self._retry_rng = retry_rng if retry_rng is not None else random.Random()
        # Stream mode (WatchCapacity push): the last applied push seq
        # (offered back as resume_seq on reconnect), the next time a
        # stream establishment may be attempted, and its backoff rung.
        # The poll path stays fully functional and is the fallback.
        self._stream = bool(stream)
        self._watch_seq = 0
        self._stream_retry_at = 0.0
        self._stream_retry_n = 0
        # Stepped-harness stream state (stream_step; the background
        # task keeps its own call/read locals instead).
        self._watch_call = None
        self._watch_pending: Optional[asyncio.Task] = None
        self._watch_last = 0.0
        # Metrics hook (method, duration_s, error); the obs module's
        # instrument_client replaces this (reference client.go:87-99).
        self.on_request: Callable[[str, float, bool], None] = lambda *a: None

    @classmethod
    async def connect(cls, addr: str, client_id: Optional[str] = None,
                      **kwargs) -> "Client":
        client = cls(addr, client_id, **kwargs)
        client._task = asyncio.create_task(client._run())
        return client

    def master(self) -> str:
        return str(self.conn)

    async def resource(
        self, resource_id: str, wants: float, priority: int = 0
    ) -> ClientResource:
        """Claim a resource; the first refresh happens immediately."""
        if resource_id in self.resources:
            raise ErrDuplicateResourceID(resource_id)
        res = ClientResource(self, resource_id, wants, priority)
        self.resources[resource_id] = res
        self._wake.set()
        return res

    # Releases are best-effort with a bound: leases self-expire (the
    # reference's core design), so a release against a masterless or
    # wedged server must not hang the caller — the connection's
    # default retry-forever loop would otherwise pin close() (and the
    # one-shot CLI) indefinitely.
    RELEASE_TIMEOUT = 10.0

    async def release_resource(self, res: ClientResource) -> None:
        if self.resources.pop(res.id, None) is None:
            return
        try:
            await asyncio.wait_for(
                self.conn.execute(
                    lambda stub: stub.ReleaseCapacity(
                        pb.ReleaseCapacityRequest(
                            client_id=self.id, resource_id=[res.id]
                        )
                    )
                ),
                self.RELEASE_TIMEOUT,
            )
        except Exception as e:
            log.warning(
                "%s: ReleaseCapacity failed (%r); leases will expire "
                "on their own", self.id, e,
            )

    async def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        # Stepped-mode stream state (the background task cleans its own).
        if self._watch_pending is not None:
            self._watch_pending.cancel()
            self._watch_pending = None
        if self._watch_call is not None:
            try:
                self._watch_call.cancel()
            except Exception:
                pass
            self._watch_call = None
        if self.resources:
            try:
                await asyncio.wait_for(
                    self.conn.execute(
                        lambda stub: stub.ReleaseCapacity(
                            pb.ReleaseCapacityRequest(
                                client_id=self.id,
                                resource_id=list(self.resources),
                            )
                        )
                    ),
                    self.RELEASE_TIMEOUT,
                )
            except Exception as e:
                log.warning(
                    "%s: ReleaseCapacity on close failed (%r); leases "
                    "will expire on their own", self.id, e,
                )
        await self.conn.close()

    # ------------------------------------------------------------------

    def _retry_after_hint(self, error) -> float:
        """The server's retry-after hint (seconds) from a shed RPC's
        trailing metadata; falls back to the refresh floor when the
        metadata is missing or unreadable."""
        try:
            for key, value in error.trailing_metadata() or ():
                if key == RETRY_AFTER_KEY:
                    return max(float(value), 0.1)
        except Exception:
            pass
        return max(self.conn.minimum_refresh_interval, MIN_BACKOFF)

    async def _run(self) -> None:
        """Main loop: wake on a new resource or when the shortest refresh
        interval elapses; refresh everything in one bulk RPC
        (client.go:227-294). In stream mode the loop instead holds a
        WatchCapacity stream for as long as one is healthy (no RPCs at
        steady state — deltas are pushed), and each time the stream
        ends it degrades to this same poll loop until the next
        establishment attempt is due (_stream_retry_at)."""
        interval, retry = 0.0, 0
        while not self._closed:
            try:
                await asyncio.wait_for(self._wake.wait(), timeout=interval)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()
            if not self.resources:
                interval = VERY_LONG_TIME
                continue
            if self._stream and self._clock() >= self._stream_retry_at:
                await self._watch_cycle()
                if self._closed:
                    break
                # The stream ended (shed / redirect / unsupported /
                # error): one poll keeps leases fresh and chases any
                # redirect, then the loop retries the stream when due.
            interval, retry = await self._perform_requests(retry)

    async def refresh_once(self) -> bool:
        """Run one bulk-refresh cycle synchronously (no background task
        involved); returns True when the RPC succeeded. Step-driven
        harnesses and tests use this to control the
        refresh cadence deterministically."""
        _, retry = await self._perform_requests(0)
        return retry == 0

    async def _perform_requests(self, retry_number: int):
        # The refresh span is the root of one tick's client-side trace;
        # the RPC child span's context crosses the gRPC hop as metadata,
        # making the server's handler span this refresh's descendant.
        with trace_mod.default_tracer().span(
            "client.refresh", cat="client",
            args={"client": self.id, "resources": len(self.resources)},
        ):
            return await self._refresh_cycle(retry_number)

    async def _refresh_cycle(self, retry_number: int):
        request = pb.GetCapacityRequest(client_id=self.id)
        for resource_id, res in self.resources.items():
            rr = request.resource.add()
            rr.resource_id = resource_id
            rr.priority = res.priority
            rr.wants = res.wants
            if res.lease is not None:
                rr.has.CopyFrom(res.lease)

        # Each refresh attempt is BOUNDED: the connection's default
        # retry-forever loop would otherwise never hand control back
        # during an outage, and a lease could sail past its expiry with
        # the application never told to fall back to safe capacity. The
        # bound tightens to the soonest lease expiry so the fallback is
        # timely, then the next cycle retries (the reference's client
        # likewise runs discrete periodic attempts, client.go:227-294).
        now = self._clock()
        soonest = min(
            (
                res.expires()
                for res in self.resources.values()
                if res.lease is not None
            ),
            default=None,
        )
        bound = (
            REFRESH_RPC_BOUND
            if soonest is None
            else max(1.0, min(REFRESH_RPC_BOUND, soonest - now))
        )
        # RPC-duration telemetry for the metrics hook only — never
        # drives behavior, so it stays on the real clock by design.
        start = time.monotonic()  # doorman: allow[seeded-determinism]
        shed_after: Optional[float] = None
        try:
            # Metadata resolves inside the lambda, per attempt, under
            # the RPC span — retries re-send the current context.
            with trace_mod.default_tracer().span(
                "client.GetCapacity", cat="client"
            ):
                out = await asyncio.wait_for(
                    self.conn.execute(
                        lambda stub: stub.GetCapacity(
                            request, metadata=trace_mod.grpc_metadata()
                        )
                    ),
                    timeout=bound,
                )
            failed = False
        except grpc.aio.AioRpcError as e:
            failed = True
            if e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED:
                # The server's admission control shed this refresh and
                # told us when to come back; leases are retained (they
                # outlive a missed refresh by design) and the hint
                # replaces the backoff ladder.
                shed_after = self._retry_after_hint(e)
                log.warning(
                    "%s: refresh shed by the server; retrying in ~%.1fs",
                    self.id, shed_after,
                )
            else:
                log.exception("%s: GetCapacity failed", self.id)
        except Exception:
            log.exception("%s: GetCapacity failed", self.id)
            failed = True
        # The hook runs outside the RPC try: a raising user callback must
        # not be misclassified as an RPC outage (or kill the loop).
        try:
            # Telemetry duration (see `start` above).
            self.on_request(
                "GetCapacity",
                time.monotonic() - start,  # doorman: allow[seeded-determinism]
                failed,
            )
        except Exception:
            log.exception("%s: on_request hook raised", self.id)
        if failed:
            now = self._clock()
            for res in self.resources.values():
                if res.lease is not None and res.expires() < now:
                    # Lease expired during the outage: fall back to the
                    # server-sent safe capacity (design.md "safe
                    # capacity"; reference simulation/client.py:197-200)
                    # — or to 0 when the server never sent one (the Go
                    # client's conservative choice, client.go:359-366).
                    fallback = (
                        res.safe_capacity
                        if res.safe_capacity is not None
                        else 0.0
                    )
                    res.lease = None
                    res._fallback_capacity = fallback
                    res._push_capacity(fallback)
            if shed_after is not None:
                # Honor the retry-after hint with half jitter: at least
                # half the hint, plus a uniform draw over the other
                # half — the shed wave must not re-synchronize into
                # the next storm (doc/admission.md).
                return (
                    0.5 * shed_after
                    + self._retry_rng.uniform(0.0, 0.5 * shed_after),
                    retry_number + 1,
                )
            return (
                backoff(MIN_BACKOFF, MAX_BACKOFF, retry_number,
                        jitter=self._retry_rng),
                retry_number + 1,
            )

        for pr in out.response:
            res = self.resources.get(pr.resource_id)
            if res is None:
                log.error(
                    "%s: response for unclaimed resource %r",
                    self.id, pr.resource_id,
                )
                continue
            old_capacity = (
                res.lease.capacity if res.lease is not None else -1.0
            )
            # Track the per-resource safe capacity exactly as sent:
            # present -> store, absent -> clear (reference
            # simulation/client.py:293-296).
            if pr.HasField("safe_capacity"):
                res.safe_capacity = pr.safe_capacity
            else:
                res.safe_capacity = None
            res.lease = pb.Lease()
            res.lease.CopyFrom(pr.gets)
            res._fallback_capacity = 0.0  # live lease again
            if res.lease.capacity != old_capacity:
                res._push_capacity(res.lease.capacity)

        interval = VERY_LONG_TIME
        for res in self.resources.values():
            if res.lease is not None:
                interval = min(interval, float(res.lease.refresh_interval))
        interval = max(interval, self.conn.minimum_refresh_interval)
        return interval, 0

    # ------------------------------------------------------------------
    # Stream mode (WatchCapacity push; doc/streaming.md)
    # ------------------------------------------------------------------

    def _watch_request(self) -> spb.WatchCapacityRequest:
        """The subscription request: every claimed resource, with the
        current lease as the resume baseline and the last applied push
        seq as the resume token."""
        request = spb.WatchCapacityRequest(
            client_id=self.id, resume_seq=self._watch_seq
        )
        for resource_id, res in self.resources.items():
            rr = request.resource.add()
            rr.resource_id = resource_id
            rr.priority = res.priority
            rr.wants = res.wants
            if res.lease is not None:
                rr.has.CopyFrom(res.lease)
        return request

    def _watch_poll_deadline(self) -> float:
        """Absolute time of the next safety poll on a quiet stream: one
        refresh interval BEFORE the earliest local lease expiry — the
        staleness margin a polling client lives with at its poll
        instant. Pushes carry a fresh expiry for every row they touch
        and the master's silent-refresh beat keeps renewing the lease
        server-side, so a healthy-but-quiet stream costs ~1 RPC per
        lease length instead of one per refresh interval — the
        steady-state RPC reduction streaming exists for. A stream that
        dies without an error (half-open TCP, wedged master) hits the
        same deadline and degrades to a poll before the lease lapses."""
        now = self._clock()
        deadline = float("inf")
        for res in self.resources.values():
            if res.lease is None:
                # No lease landed yet: nothing protects this line but
                # polling; don't trust stream silence for it.
                return now
            deadline = min(
                deadline,
                float(res.lease.expiry_time)
                - max(float(res.lease.refresh_interval), 1.0),
            )
        if deadline == float("inf"):
            return now
        # Floor: never poll-spin when a served lease is already inside
        # its margin (e.g. very short lease lengths).
        return max(
            deadline,
            self._watch_last
            + max(self.conn.minimum_refresh_interval, 0.1),
        )

    def _watch_apply(self, msg) -> str:
        """Apply one pushed message; returns "redirect" (terminal),
        "stale" (seq replay — dropped), or "applied". Row application
        is field-for-field the poll response path."""
        if msg.HasField("mastership"):
            return "redirect"
        if msg.seq and msg.seq <= self._watch_seq and not msg.snapshot:
            # Exactly-once: a replayed or reordered push is dropped (a
            # stream is a single in-order writer, so this only fires
            # across reconnects).
            return "stale"
        if msg.snapshot:
            # Every stream opens with a snapshot: REBASE onto this
            # master's seq axis (a flip may land on a master whose
            # counter restarted below our high-water mark).
            self._watch_seq = int(msg.seq)
        else:
            self._watch_seq = max(self._watch_seq, int(msg.seq))
        self._watch_last = self._clock()
        for pr in msg.response:
            res = self.resources.get(pr.resource_id)
            if res is None:
                log.error(
                    "%s: push for unclaimed resource %r",
                    self.id, pr.resource_id,
                )
                continue
            old_capacity = (
                res.lease.capacity if res.lease is not None else -1.0
            )
            if pr.HasField("safe_capacity"):
                res.safe_capacity = pr.safe_capacity
            else:
                res.safe_capacity = None
            res.lease = pb.Lease()
            res.lease.CopyFrom(pr.gets)
            res._fallback_capacity = 0.0  # live lease again
            if res.lease.capacity != old_capacity:
                res._push_capacity(res.lease.capacity)
        return "applied"

    def _watch_fail_backoff(self) -> None:
        self._stream_retry_at = self._clock() + backoff(
            MIN_BACKOFF, MAX_BACKOFF, self._stream_retry_n,
            jitter=self._retry_rng,
        )
        self._stream_retry_n += 1

    def _watch_error(self, e: "grpc.aio.AioRpcError") -> str:
        """Classify a stream error into the next retry policy; returns
        an event tag (stepped harnesses log it)."""
        code = e.code()
        if code == grpc.StatusCode.RESOURCE_EXHAUSTED:
            # Admission shed the establishment (AIMD band shed or the
            # per-band stream cap); honor the retry-after hint with
            # half jitter exactly like a shed poll.
            hint = self._retry_after_hint(e)
            self._stream_retry_at = (
                self._clock()
                + 0.5 * hint
                + self._retry_rng.uniform(0.0, 0.5 * hint)
            )
            self._stream_retry_n += 1
            log.warning(
                "%s: capacity stream shed; retrying in ~%.1fs",
                self.id, hint,
            )
            return "shed"
        if code == grpc.StatusCode.UNIMPLEMENTED:
            self._stream_retry_at = self._clock() + STREAM_REPROBE
            log.info(
                "%s: server does not stream; polling (re-probe in %.0fs)",
                self.id, STREAM_REPROBE,
            )
            return "unimplemented"
        log.warning("%s: capacity stream failed (%s)", self.id, code)
        self._watch_fail_backoff()
        return "error"

    async def _watch_redirect(self, msg) -> None:
        """Terminal mastership message: chase the indicated master (the
        caller's fallback poll re-validates it before the stream is
        re-established)."""
        addr = msg.mastership.master_address
        if addr:
            try:
                await self.conn.redirect(addr)
            except Exception:
                log.warning(
                    "%s: redirect to %s failed", self.id, addr,
                )
            self._stream_retry_at = self._clock()
            self._stream_retry_n = 0
        else:
            # Master unknown: back off like a failed poll would.
            self._watch_fail_backoff()

    async def _watch_cycle(self) -> None:
        """One WatchCapacity stream session (background stream mode):
        establish, apply pushes as they arrive, degrade to one poll
        whenever the stream is silent past the refresh interval, and
        return when the stream ends — the caller polls once and retries
        establishment per _stream_retry_at."""
        try:
            await self.conn.ensure()
        except Exception:
            log.warning("%s: dial for capacity stream failed", self.id)
            self._watch_fail_backoff()
            return
        with trace_mod.default_tracer().span(
            "client.WatchCapacity", cat="client",
            args={"client": self.id, "resources": len(self.resources)},
        ):
            call = self.conn.stub.WatchCapacity(
                self._watch_request(), metadata=trace_mod.grpc_metadata()
            )
        pending: Optional[asyncio.Task] = None
        wake_task: Optional[asyncio.Task] = None
        try:
            while not self._closed:
                if pending is None:
                    pending = asyncio.ensure_future(call.read())
                if wake_task is None:
                    wake_task = asyncio.ensure_future(self._wake.wait())
                done, _ = await asyncio.wait(
                    {pending, wake_task},
                    timeout=max(
                        0.1, self._watch_poll_deadline() - self._clock()
                    ),
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if wake_task in done:
                    # ask() / new resource: the subscription lines are
                    # stale — resubscribe immediately (the caller's
                    # poll ships the new wants first).
                    self._stream_retry_at = self._clock()
                    self._stream_retry_n = 0
                    return
                if pending not in done:
                    if self._clock() >= self._watch_poll_deadline():
                        # Quiet into the lease-expiry margin: ONE
                        # safety poll. A healthy stream stays open
                        # through it; a failed poll runs the usual
                        # expiry fallback.
                        self._watch_last = self._clock()
                        await self._perform_requests(0)
                    continue
                msg = pending.result()  # raises on stream errors
                pending = None
                if msg is grpc.aio.EOF:
                    # Server closed without a terminal message (e.g.
                    # shutdown); re-establish after a short backoff.
                    self._watch_fail_backoff()
                    return
                verdict = self._watch_apply(msg)
                if verdict == "redirect":
                    await self._watch_redirect(msg)
                    return
                if verdict == "applied":
                    self._stream_retry_n = 0
        except grpc.aio.AioRpcError as e:
            self._watch_error(e)
        except Exception:
            log.exception("%s: capacity stream failed", self.id)
            self._watch_fail_backoff()
        finally:
            if pending is not None:
                pending.cancel()
            if wake_task is not None:
                wake_task.cancel()
            try:
                call.cancel()
            except Exception:
                pass

    async def stream_step(self, drain_timeout: float = 0.2) -> dict:
        """One deterministic streaming step for stepped harnesses (the
        chaos runner; the background task must NOT be running):
        establish the stream if due, drain the pushes already in
        flight, chase a terminal redirect, and fall back to ONE poll
        whenever the stream is down or has been silent past the
        refresh interval. Returns {"pushes": n, "events": [...]} with
        deterministic event tags (establish/shed/unimplemented/eof/
        redirect/error/poll)."""
        out = {"pushes": 0, "events": []}
        now = self._clock()
        if (
            self._watch_call is None
            and self._stream
            and self.resources
            and now >= self._stream_retry_at
        ):
            if self._watch_pending is not None:
                self._watch_pending.cancel()
                self._watch_pending = None
            try:
                await self.conn.ensure()
                self._watch_call = self.conn.stub.WatchCapacity(
                    self._watch_request(),
                    metadata=trace_mod.grpc_metadata(),
                )
                self._watch_last = now
                out["events"].append("establish")
            except Exception:
                self._watch_call = None
                self._watch_fail_backoff()
        if self._watch_call is not None:
            while True:
                if self._watch_pending is None:
                    self._watch_pending = asyncio.ensure_future(
                        self._watch_call.read()
                    )
                done, _ = await asyncio.wait(
                    {self._watch_pending}, timeout=drain_timeout
                )
                if not done:
                    break  # nothing in flight; the read stays pending
                task, self._watch_pending = self._watch_pending, None
                try:
                    msg = task.result()
                except grpc.aio.AioRpcError as e:
                    self._watch_call = None
                    out["events"].append(self._watch_error(e))
                    break
                except Exception:
                    self._watch_call = None
                    self._watch_fail_backoff()
                    out["events"].append("error")
                    break
                if msg is grpc.aio.EOF:
                    self._watch_call = None
                    self._stream_retry_at = now
                    out["events"].append("eof")
                    break
                verdict = self._watch_apply(msg)
                if verdict == "redirect":
                    self._watch_call = None
                    out["events"].append("redirect")
                    await self._watch_redirect(msg)
                    break
                if verdict == "applied":
                    out["pushes"] += 1
        if self._watch_call is None or now >= self._watch_poll_deadline():
            # Down, or quiet into the lease-expiry margin: one poll
            # (lease-expiry safety; also how a stepped run ships wants
            # changes and chases redirects).
            await self.refresh_once()
            self._watch_last = now
            out["events"].append("poll")
        return out
