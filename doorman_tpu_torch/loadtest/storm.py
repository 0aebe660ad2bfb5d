"""RPC storm driver: closed-loop GetCapacity hammering for overload
testing.

Unlike the recipe-driven workers (doorman_tpu_torch.loadtest.worker — polite
clients that honor refresh intervals), a storm worker fires its next
refresh the moment the previous one returns: the adversarial load shape
the admission front-end (doorman_tpu_torch.admission) exists to survive. Each
worker is pinned to a priority band so per-band goodput under shedding
is observable; shed responses (RESOURCE_EXHAUSTED) are honored by
default with the same jittered retry-after pacing the real client uses
— pass ``honor_retry_after=False`` to model misbehaving clients that
hammer through the hint.

Used by bench.py's ``server_rpc_storm`` against an in-process server,
and standalone against a real deployment:

    python -m doorman_tpu_torch.loadtest.storm --server localhost:15000 \
        --resource storm --workers 64 --duration 10 --bands 0,1,2

``--stream`` swaps the closed-loop polls for held WatchCapacity
streams (doc/streaming.md): workers subscribe, count pushed deltas,
and re-establish after sheds/resets/redirects with the same
retry-after pacing — the storm shape for the per-band stream caps.

``--streams-per-worker M`` multiplexes: each worker task holds M
streams over ONE shared channel, drained by a single read loop
(asyncio.wait over the streams' pending reads) — so the driver can
hold 100k live streams with a few dozen tasks and channels instead of
one task + channel per stream, which is what lets a single storm
process exercise the sharded fan-out at its design scale.

``--record out.jsonl`` captures every poll request's start as an
arrival event (tick, relative time, band, wants) — the workload
harness's ``trace`` generator replays the captured log as a
deterministic arrival schedule on the virtual clock (doc/workload.md).

``--procs P`` splits the worker population over P OS processes (spawn
context), each with its own event loop, gRPC channels, and seeded RNG
stream. One asyncio loop tops out near ~570 establishments/s on a
laptop core — against a multi-worker serving plane (doc/serving.md)
that driver-side ceiling would masquerade as server capacity. Workers
split evenly (client ids stay globally unique via per-proc index
bases); the parent merges counters and the raw latency populations, so
the merged percentiles are exact, not averaged.

Port of doorman_tpu/loadtest/storm.py: a copy apart from import paths
and `run_storm_procs`'s wait, which reads the children's liveness and
raises as soon as every child has exited with a result missing (the
reference waits out `duration + 60` s on the queue).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import random
import sys
import time
from typing import Dict, List, Optional

import grpc

from doorman_tpu_torch.admission.policy import RETRY_AFTER_KEY
from doorman_tpu_torch.loadtest.ratecurve import ArrivalSampler, RateCurve
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto.grpc_api import CapacityStub
from doorman_tpu_torch.utils import flagenv

log = logging.getLogger("doorman.loadtest.storm")

__all__ = [
    "merge_storm_results", "percentile", "run_storm",
    "run_storm_procs",
]


class _Pacer:
    """Open-loop offered-rate pacing (``--rate-curve``): a background
    task releases request permits per the curve's trapezoid integral
    over small real-time steps; each worker blocks on a permit before
    every RPC. The offered rate then follows the schedule instead of
    the server's response latency — the storm turns from closed-loop
    (back-to-back) into a rate-driven load shape."""

    def __init__(self, sampler: ArrivalSampler, step: float = 0.05):
        self._sampler = sampler
        self._step = step
        self._sem = asyncio.Semaphore(0)
        self._task: Optional[asyncio.Task] = None

    def start(self, deadline: float) -> None:
        self._task = asyncio.ensure_future(self._run(deadline))

    async def _run(self, deadline: float) -> None:
        start = time.monotonic()
        while True:
            now = time.monotonic()
            if now >= deadline:
                return
            t0 = now - start
            await asyncio.sleep(min(self._step, deadline - now))
            t1 = time.monotonic() - start
            for _ in range(self._sampler.take(t0, t1)):
                self._sem.release()

    async def acquire(self, deadline: float) -> bool:
        """Block until a permit or the deadline; False means go home."""
        try:
            await asyncio.wait_for(
                self._sem.acquire(),
                timeout=max(deadline - time.monotonic(), 0.0),
            )
            return True
        except asyncio.TimeoutError:
            return False

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()


def percentile(sorted_values: List[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list (0 when empty)."""
    if not sorted_values:
        return 0.0
    idx = min(
        len(sorted_values) - 1,
        max(0, int(round(q * (len(sorted_values) - 1)))),
    )
    return sorted_values[idx]


def _retry_after(error: grpc.aio.AioRpcError) -> Optional[float]:
    try:
        for key, value in error.trailing_metadata() or ():
            if key == RETRY_AFTER_KEY:
                return float(value)
    except Exception:
        pass
    return None


async def _worker(
    index: int,
    addr: str,
    resource: str,
    band: int,
    wants: float,
    deadline: float,
    stats: Dict,
    rng: random.Random,
    honor_retry_after: bool,
    rpc_timeout: Optional[float],
    pacer: Optional[_Pacer] = None,
    recorder: Optional[callable] = None,
) -> None:
    async with grpc.aio.insecure_channel(addr) as channel:
        stub = CapacityStub(channel)
        request = pb.GetCapacityRequest(client_id=f"storm-{index}")
        rr = request.resource.add()
        rr.resource_id = resource
        rr.wants = wants
        rr.priority = band
        while time.monotonic() < deadline:
            if pacer is not None and not await pacer.acquire(deadline):
                return
            if recorder is not None:
                recorder(band, wants)
            t0 = time.monotonic()
            try:
                out = await stub.GetCapacity(request, timeout=rpc_timeout)
                if out.HasField("mastership"):
                    stats["redirects"] += 1
                    continue
                stats["ok"] += 1
                stats["ok_by_band"][band] = (
                    stats["ok_by_band"].get(band, 0) + 1
                )
                latency = time.monotonic() - t0
                stats["latencies"].append(latency)
                stats["latencies_by_band"].setdefault(band, []).append(
                    latency
                )
                # Carry the grant forward like a refreshing client.
                rr.has.CopyFrom(out.response[0].gets)
            except grpc.aio.AioRpcError as e:
                if e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED:
                    stats["shed"] += 1
                    stats["shed_by_band"][band] = (
                        stats["shed_by_band"].get(band, 0) + 1
                    )
                    if honor_retry_after:
                        hint = _retry_after(e) or 1.0
                        # Half jitter, like the real client: at least
                        # hint/2, spread over the other half.
                        await asyncio.sleep(
                            min(
                                0.5 * hint + rng.uniform(0, 0.5 * hint),
                                max(deadline - time.monotonic(), 0.0),
                            )
                        )
                else:
                    stats["errors"] += 1
            except Exception:
                stats["errors"] += 1


async def _stream_worker(
    index: int,
    addr: str,
    resource: str,
    band: int,
    wants: float,
    deadline: float,
    stats: Dict,
    rng: random.Random,
    honor_retry_after: bool,
) -> None:
    """One WatchCapacity subscriber: hold a stream, count pushes, and
    re-establish — honoring the shed retry-after hint with the real
    client's half jitter — whenever the stream is shed, reset, or
    redirected. In stream mode ``ok``/``latencies`` count successful
    establishments (the admitted RPCs), ``pushes`` the lease deltas."""
    from doorman_tpu_torch.proto import doorman_stream_pb2 as spb

    async with grpc.aio.insecure_channel(addr) as channel:
        stub = CapacityStub(channel)
        request = spb.WatchCapacityRequest(client_id=f"storm-{index}")
        rr = request.resource.add()
        rr.resource_id = resource
        rr.wants = wants
        rr.priority = band
        while time.monotonic() < deadline:
            t0 = time.monotonic()
            call = stub.WatchCapacity(request)
            try:
                established = False
                while True:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return
                    msg = await asyncio.wait_for(
                        call.read(), timeout=remaining
                    )
                    if msg is grpc.aio.EOF:
                        stats["resets"] += 1
                        break
                    if msg.HasField("mastership"):
                        stats["redirects"] += 1
                        break
                    if not established:
                        established = True
                        stats["ok"] += 1
                        stats["ok_by_band"][band] = (
                            stats["ok_by_band"].get(band, 0) + 1
                        )
                        latency = time.monotonic() - t0
                        stats["latencies"].append(latency)
                        stats["latencies_by_band"].setdefault(
                            band, []
                        ).append(latency)
                    stats["pushes"] += 1
                    # Carry the resume contract like the real client:
                    # seq token + has baseline ride re-establishment.
                    request.resume_seq = max(
                        request.resume_seq, int(msg.seq)
                    )
                    for row in msg.response:
                        if row.resource_id == resource:
                            rr.has.CopyFrom(row.gets)
            except asyncio.TimeoutError:
                return  # duration over; cancelling the read ends the RPC
            except grpc.aio.AioRpcError as e:
                if e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED:
                    stats["shed"] += 1
                    stats["shed_by_band"][band] = (
                        stats["shed_by_band"].get(band, 0) + 1
                    )
                    if honor_retry_after:
                        hint = _retry_after(e) or 1.0
                        await asyncio.sleep(
                            min(
                                0.5 * hint + rng.uniform(0, 0.5 * hint),
                                max(deadline - time.monotonic(), 0.0),
                            )
                        )
                else:
                    stats["errors"] += 1
            except Exception:
                stats["errors"] += 1
            finally:
                call.cancel()


class _MuxStream:
    """One multiplexed stream's state inside a mux worker."""

    __slots__ = (
        "request", "band", "call", "pending", "established", "wake",
        "t0",
    )

    def __init__(self, request, band: int):
        self.request = request
        self.band = band
        self.call = None
        self.pending = None
        self.established = False
        self.wake = 0.0  # earliest (re)establishment time
        self.t0 = 0.0


async def _mux_worker(
    index: int,
    addr: str,
    resource: str,
    bands: tuple,
    wants: float,
    deadline: float,
    stats: Dict,
    rng: random.Random,
    honor_retry_after: bool,
    n_streams: int,
    resource_spread: int,
) -> None:
    """One multiplexed worker: `n_streams` WatchCapacity subscriptions
    over one shared channel, drained by a single asyncio.wait loop.
    Stats semantics match _stream_worker (ok = establishments, pushes =
    received deltas); shed establishments honor retry-after per stream
    before that stream reconnects."""
    from doorman_tpu_torch.proto import doorman_stream_pb2 as spb

    def _close(st: "_MuxStream", wake_in: float) -> None:
        if st.pending is not None:
            st.pending.cancel()
            st.pending = None
        if st.call is not None:
            st.call.cancel()
            st.call = None
        st.established = False
        st.wake = time.monotonic() + wake_in

    # Establishment ramp: at most this many streams per worker may be
    # opened-but-not-yet-established at once. Opening every stream in
    # one burst floods the (often shared, in benches even same-loop)
    # server with N concurrent establishment decides and nothing
    # completes; a bounded ramp establishes the population at the rate
    # the server actually serves.
    ramp = 64

    async with grpc.aio.insecure_channel(
        addr, options=(("grpc.use_local_subchannel_pool", 1),)
    ) as channel:
        stub = CapacityStub(channel)
        streams: List[_MuxStream] = []
        for j in range(n_streams):
            gi = index * n_streams + j
            band = bands[gi % len(bands)]
            request = spb.WatchCapacityRequest(
                client_id=f"storm-{index}-{j}"
            )
            rr = request.resource.add()
            # resource_spread > 1 fans subscriptions over a resource
            # family: with everyone on ONE row, every establishment
            # re-grants every prior subscriber (O(n^2) push traffic),
            # which measures the resource's popularity, not the
            # driver's capacity to hold streams.
            rr.resource_id = (
                resource if resource_spread <= 1
                else f"{resource}-{gi % resource_spread}"
            )
            rr.wants = wants
            rr.priority = band
            streams.append(_MuxStream(request, band))
        # Completion-queue read loop: every stream's pending read pushes
        # itself onto done_q when it resolves, so handling a completion
        # is O(1) in held streams. (asyncio.wait over the pending set
        # would re-register O(held) callbacks per wake — quadratic at
        # 100k streams; this is the whole trick that lets one task
        # drain thousands of streams.)
        done_q: "asyncio.Queue" = asyncio.Queue()

        def start_read(st: "_MuxStream") -> None:
            st.pending = asyncio.ensure_future(st.call.read())
            st.pending.add_done_callback(
                lambda fut, st=st: done_q.put_nowait((fut, st))
            )

        from collections import deque

        unopened = deque(streams)
        waking: List[_MuxStream] = []  # closed, waiting out retry-after
        opening = 0  # opened but not yet established
        try:
            while True:
                now = time.monotonic()
                if now >= deadline:
                    return
                if waking:
                    still = []
                    for st in waking:
                        if st.wake <= now:
                            unopened.append(st)
                        else:
                            still.append(st)
                    waking[:] = still
                while unopened and opening < ramp:
                    st = unopened.popleft()
                    st.t0 = time.monotonic()
                    st.call = stub.WatchCapacity(st.request)
                    start_read(st)
                    opening += 1
                timeout = deadline - now
                if waking:
                    timeout = min(
                        timeout,
                        max(min(s.wake for s in waking) - now, 0.0),
                    )
                try:
                    fut, st = await asyncio.wait_for(
                        done_q.get(), timeout=max(timeout, 0.01)
                    )
                except asyncio.TimeoutError:
                    continue
                if st.pending is not fut:
                    continue  # stale: the stream was closed since
                st.pending = None
                if not st.established:
                    # Whatever this read produced — first message,
                    # shed, error — the stream leaves the
                    # establishment ramp window.
                    opening -= 1
                try:
                    msg = fut.result()
                except asyncio.CancelledError:
                    continue
                except grpc.aio.AioRpcError as e:
                    if (
                        e.code()
                        == grpc.StatusCode.RESOURCE_EXHAUSTED
                    ):
                        stats["shed"] += 1
                        stats["shed_by_band"][st.band] = (
                            stats["shed_by_band"].get(st.band, 0) + 1
                        )
                        hint = (
                            (_retry_after(e) or 1.0)
                            if honor_retry_after else 0.0
                        )
                        _close(
                            st,
                            0.5 * hint + rng.uniform(0, 0.5 * hint),
                        )
                    else:
                        stats["errors"] += 1
                        _close(st, 0.2)
                    waking.append(st)
                    continue
                except Exception:
                    stats["errors"] += 1
                    _close(st, 0.2)
                    waking.append(st)
                    continue
                if msg is grpc.aio.EOF:
                    stats["resets"] += 1
                    _close(st, 0.0)
                    waking.append(st)
                    continue
                if msg.HasField("mastership"):
                    stats["redirects"] += 1
                    _close(st, 0.0)
                    waking.append(st)
                    continue
                if not st.established:
                    st.established = True
                    stats["ok"] += 1
                    stats["ok_by_band"][st.band] = (
                        stats["ok_by_band"].get(st.band, 0) + 1
                    )
                    latency = time.monotonic() - st.t0
                    stats["latencies"].append(latency)
                    stats["latencies_by_band"].setdefault(
                        st.band, []
                    ).append(latency)
                stats["pushes"] += 1
                st.request.resume_seq = max(
                    st.request.resume_seq, int(msg.seq)
                )
                mine = st.request.resource[0]
                for row in msg.response:
                    if row.resource_id == mine.resource_id:
                        mine.has.CopyFrom(row.gets)
                start_read(st)
        finally:
            for st in streams:
                _close(st, 0.0)


async def run_storm(
    addr: str,
    resource: str = "storm",
    *,
    workers: int = 32,
    duration: float = 5.0,
    bands: tuple = (0,),
    wants: float = 10.0,
    honor_retry_after: bool = True,
    rpc_timeout: Optional[float] = None,
    seed: int = 0,
    stream: bool = False,
    streams_per_worker: int = 1,
    resource_spread: int = 1,
    rate_curve: "Optional[RateCurve | str]" = None,
    rate_jitter: float = 0.0,
    index_base: int = 0,
    record: bool = False,
    _raw: bool = False,
) -> Dict:
    """Drive `workers` closed-loop GetCapacity clients (round-robin
    over `bands`) for `duration` seconds; returns aggregate stats with
    per-band goodput and latency percentiles (seconds). With
    ``stream=True`` the workers hold WatchCapacity streams instead:
    ``ok``/``latencies`` become establishment counts/latencies,
    ``pushes`` counts received deltas, and shed establishments honor
    the retry-after hint before reconnecting. ``rate_curve`` (a
    RateCurve or its ``"t:rate,..."`` text form) switches the poll
    storm to open-loop pacing: offered rate follows the piecewise-
    linear schedule (with optional seeded multiplicative
    ``rate_jitter``) instead of the server's response latency.
    ``record=True`` captures every poll request's start as an arrival
    event — ``out["arrivals"]`` rows of ``[t_rel_s, band, wants]`` —
    the stream the workload harness's ``trace`` generator replays."""
    stats: Dict = {
        "ok": 0, "shed": 0, "errors": 0, "redirects": 0,
        "ok_by_band": {}, "shed_by_band": {}, "latencies": [],
        "latencies_by_band": {},
    }
    if stream:
        stats["pushes"] = 0
        stats["resets"] = 0
    rng = random.Random(seed)
    if record and stream:
        raise ValueError(
            "--record captures the poll storm's arrival log; stream "
            "mode holds long-lived subscriptions and has no per-"
            "request arrivals to record"
        )
    pacer: Optional[_Pacer] = None
    if rate_curve is not None:
        if stream:
            raise ValueError(
                "--rate-curve paces the closed-loop poll storm; "
                "stream mode holds long-lived subscriptions and has "
                "no per-request rate to pace"
            )
        if isinstance(rate_curve, str):
            rate_curve = RateCurve.parse(rate_curve)
        pacer = _Pacer(ArrivalSampler(
            rate_curve, jitter=rate_jitter,
            rng=random.Random(rng.random()),
        ))
    deadline = time.monotonic() + duration
    start = time.monotonic()
    events: List[tuple] = []
    recorder = (
        (lambda band, wants:
         events.append((time.monotonic() - start, band, wants)))
        if record else None
    )
    if pacer is not None:
        pacer.start(deadline)
    if stream and streams_per_worker > 1:
        await asyncio.gather(*(
            _mux_worker(
                index_base + i, addr, resource, bands, wants,
                deadline, stats,
                random.Random(rng.random()), honor_retry_after,
                streams_per_worker, resource_spread,
            )
            for i in range(workers)
        ))
    elif stream:
        await asyncio.gather(*(
            _stream_worker(
                index_base + i, addr, resource,
                bands[(index_base + i) % len(bands)], wants,
                deadline, stats, random.Random(rng.random()),
                honor_retry_after,
            )
            for i in range(workers)
        ))
    else:
        await asyncio.gather(*(
            _worker(
                index_base + i, addr, resource,
                bands[(index_base + i) % len(bands)], wants,
                deadline, stats, random.Random(rng.random()),
                honor_retry_after, rpc_timeout, pacer, recorder,
            )
            for i in range(workers)
        ))
    if pacer is not None:
        pacer.stop()
    elapsed = max(time.monotonic() - start, 1e-9)
    lat = sorted(stats.pop("latencies"))
    lat_by_band = {
        band: sorted(values)
        for band, values in stats.pop("latencies_by_band").items()
    }
    out = {
        **stats,
        "workers": workers,
        "duration_s": round(elapsed, 3),
        "goodput_qps": round(stats["ok"] / elapsed, 1),
        "offered_qps": round(
            (stats["ok"] + stats["shed"] + stats["errors"]) / elapsed, 1
        ),
        "p50_s": round(percentile(lat, 0.50), 6),
        "p99_s": round(percentile(lat, 0.99), 6),
        # Per-band tails: the admission SLOs (obs.slo.storm_slo_verdicts)
        # hold each band's admission-on p99 against the admission-off
        # tail for the same band.
        "p50_s_by_band": {
            band: round(percentile(v, 0.50), 6)
            for band, v in sorted(lat_by_band.items())
        },
        "p99_s_by_band": {
            band: round(percentile(v, 0.99), 6)
            for band, v in sorted(lat_by_band.items())
        },
    }
    if record:
        out["arrivals"] = [
            [round(t, 6), band, w] for t, band, w in sorted(events)
        ]
    if _raw:
        # Multi-process merge path: the parent re-derives exact merged
        # percentiles from the children's raw populations.
        out["latencies_sorted"] = lat
        out["latencies_sorted_by_band"] = lat_by_band
    return out


def merge_storm_results(parts: List[Dict]) -> Dict:
    """Merge per-process run_storm(_raw=True) results into one report
    with the single-process shape (plus ``procs``). Counters sum,
    per-band tallies sum, and the raw latency populations concatenate
    before the percentile pass — the merged tails are exact. The procs
    ran concurrently, so rates divide by the slowest child's elapsed
    wall, not the sum."""
    if not parts:
        raise ValueError("no storm results to merge")
    counters = ("ok", "shed", "errors", "redirects", "pushes", "resets")
    merged: Dict = {
        key: sum(p[key] for p in parts)
        for key in counters if key in parts[0]
    }
    for key in ("ok_by_band", "shed_by_band"):
        tally: Dict = {}
        for p in parts:
            for band, n in p[key].items():
                tally[band] = tally.get(band, 0) + n
        merged[key] = tally
    lat = sorted(
        v for p in parts for v in p.get("latencies_sorted", ())
    )
    lat_by_band: Dict[int, List[float]] = {}
    for p in parts:
        for band, values in p.get(
            "latencies_sorted_by_band", {}
        ).items():
            lat_by_band.setdefault(band, []).extend(values)
    if "arrivals" in parts[0]:
        merged["arrivals"] = sorted(
            row for p in parts for row in p.get("arrivals", ())
        )
    elapsed = max(p["duration_s"] for p in parts)
    merged.update({
        "procs": len(parts),
        "workers": sum(p["workers"] for p in parts),
        "duration_s": elapsed,
        "goodput_qps": round(merged["ok"] / elapsed, 1),
        "offered_qps": round(
            (merged["ok"] + merged["shed"] + merged["errors"])
            / elapsed, 1
        ),
        "p50_s": round(percentile(lat, 0.50), 6),
        "p99_s": round(percentile(lat, 0.99), 6),
        "p50_s_by_band": {
            band: round(percentile(sorted(v), 0.50), 6)
            for band, v in sorted(lat_by_band.items())
        },
        "p99_s_by_band": {
            band: round(percentile(sorted(v), 0.99), 6)
            for band, v in sorted(lat_by_band.items())
        },
    })
    return merged


def _storm_proc(out_q, addr: str, resource: str, kwargs: Dict) -> None:
    """Spawn-picklable child entry: one event loop's slice of the
    storm, raw latencies included for the parent's exact merge."""
    try:
        out_q.put(asyncio.run(
            run_storm(addr, resource, _raw=True, **kwargs)
        ))
    except Exception as exc:  # surface, don't hang the parent's join
        out_q.put({"error": f"{type(exc).__name__}: {exc}"})


def run_storm_procs(
    addr: str,
    resource: str = "storm",
    *,
    procs: int,
    workers: int = 32,
    seed: int = 0,
    **kwargs,
) -> Dict:
    """Multi-process storm: split `workers` over `procs` OS processes
    (spawn context — each child gets a fresh event loop and its own
    gRPC channels), then merge the children's reports. Client ids stay
    globally unique (per-proc index_base) and each child draws from a
    distinct seeded RNG stream. Synchronous by design: the parent has
    no loop to starve while it joins the children."""
    import multiprocessing as mp
    import queue

    if procs <= 1:
        out = asyncio.run(run_storm(
            addr, resource, workers=workers, seed=seed, **kwargs
        ))
        out["procs"] = 1
        return out
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    base, extra = divmod(workers, procs)
    children = []
    index_base = 0
    for p in range(procs):
        share = base + (1 if p < extra else 0)
        if share == 0:
            continue
        child_kwargs = dict(
            kwargs, workers=share, seed=seed * 1000 + p,
            index_base=index_base,
        )
        index_base += share
        proc = ctx.Process(
            target=_storm_proc, args=(out_q, addr, resource,
                                      child_kwargs),
        )
        proc.start()
        children.append(proc)
    duration = float(kwargs.get("duration", 5.0))
    parts, errors = [], []
    # Generous floor: spawn + grpc import dominate short storms.
    deadline = time.monotonic() + duration + 60.0
    try:
        while len(parts) + len(errors) < len(children):
            # Liveness is read before the wait: a child that puts its
            # result and exits during the wait is still alive here, and
            # its result is read on the next turn. A child that died
            # without one ends the storm at once, not at the deadline.
            alive = any(proc.is_alive() for proc in children)
            try:
                part = out_q.get(timeout=1.0)
            except queue.Empty:
                if not alive or time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"{len(children) - len(parts) - len(errors)} of "
                        f"{len(children)} storm procs gave no result "
                        f"(exit codes "
                        f"{[proc.exitcode for proc in children]})"
                    ) from None
                continue
            (errors if "error" in part else parts).append(part)
    finally:
        for proc in children:
            proc.join(timeout=10.0)
            if proc.is_alive():
                proc.terminate()
    if errors:
        raise RuntimeError(f"storm proc failed: {errors[0]['error']}")
    return merge_storm_results(parts)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="loadtest-storm")
    p.add_argument("--server", default="localhost:15000",
                   help="doorman server address")
    p.add_argument("--resource", default="storm")
    p.add_argument("--workers", type=int, default=64)
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--bands", default="0",
                   help="comma-separated priority bands, workers "
                        "round-robin over them (e.g. '0,1,2')")
    p.add_argument("--wants", type=float, default=10.0)
    p.add_argument("--ignore-retry-after", action="store_true",
                   help="hammer through shed responses (misbehaving-"
                        "client mode)")
    p.add_argument("--rpc-timeout", type=float, default=0.0,
                   help="per-RPC gRPC deadline in seconds (0: none); "
                        "short deadlines exercise the admission "
                        "fast-fail path")
    p.add_argument("--stream", action="store_true",
                   help="hold WatchCapacity streams instead of "
                        "closed-loop polls; shed establishments honor "
                        "retry-after before reconnecting "
                        "(doc/streaming.md)")
    p.add_argument("--streams-per-worker", type=int, default=1,
                   help="stream mode: multiplex this many streams per "
                        "worker over one shared channel (100k streams "
                        "without 100k tasks/channels)")
    p.add_argument("--rate-curve", default="",
                   help="open-loop offered-rate schedule "
                        "'t:rate,t:rate,...' (piecewise-linear, e.g. "
                        "'0:5,30:50,60:5'); empty keeps the closed-"
                        "loop back-to-back storm")
    p.add_argument("--rate-jitter", type=float, default=0.0,
                   help="seeded multiplicative jitter on each pacing "
                        "step's expected arrivals, in [0, 1)")
    p.add_argument("--seed", type=int, default=0,
                   help="RNG seed for retry jitter and rate-curve "
                        "jitter")
    p.add_argument("--resource-spread", type=int, default=1,
                   help="multiplexed stream mode: fan subscriptions "
                        "over this many resources (<resource>-<k>) so "
                        "held-stream capacity is measured instead of "
                        "one row's O(n^2) re-grant traffic")
    p.add_argument("--record", default="",
                   help="write the storm's arrival log (one JSONL "
                        "object per poll request: tick, t, band, "
                        "wants) to this path; the workload harness's "
                        "'trace' generator replays it "
                        "(doc/workload.md)")
    p.add_argument("--record-tick", type=float, default=1.0,
                   help="tick interval in seconds used to map "
                        "recorded arrival times onto replayable tick "
                        "numbers (default 1.0)")
    p.add_argument("--procs", type=int, default=1,
                   help="split the workers over this many OS "
                        "processes (spawn), one event loop each — "
                        "drives a multi-worker serving plane past a "
                        "single loop's establishment ceiling; the "
                        "merged percentiles are exact")
    return p


def main(argv=None) -> None:
    parser = make_parser()
    flagenv.populate(parser)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    kwargs = dict(
        workers=args.workers,
        duration=args.duration,
        bands=tuple(int(b) for b in args.bands.split(",") if b.strip()),
        wants=args.wants,
        honor_retry_after=not args.ignore_retry_after,
        rpc_timeout=args.rpc_timeout or None,
        seed=args.seed,
        stream=args.stream,
        streams_per_worker=args.streams_per_worker,
        resource_spread=args.resource_spread,
        rate_curve=args.rate_curve or None,
        rate_jitter=args.rate_jitter,
        record=bool(args.record),
    )
    if args.procs > 1:
        out = run_storm_procs(
            args.server, args.resource, procs=args.procs, **kwargs
        )
    else:
        out = asyncio.run(run_storm(args.server, args.resource,
                                    **kwargs))
    import json

    if args.record:
        arrivals = out.pop("arrivals", [])
        tick = max(args.record_tick, 1e-9)
        with open(args.record, "w") as f:
            for t, band, wants in arrivals:
                f.write(json.dumps(
                    {"tick": int(t // tick), "t": t,
                     "band": band, "wants": wants},
                    sort_keys=True,
                ) + "\n")
        print(f"recorded {len(arrivals)} arrivals to {args.record}",
              file=sys.stderr)
    print(json.dumps(out, indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
