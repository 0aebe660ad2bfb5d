"""Smoke of the REAL serving plane (port of
doorman_tpu/cmd/frontend_smoke.py): spawn listener workers, hold a
stream through a worker kill, resume with no replay and no gap.

    python -m doorman_tpu_torch.cmd.frontend_smoke [--workers N] \\
        [--device cuda|cpu]

The CPU tests pin the frontend's byte contracts on the inline pool
(deterministic, virtual clock); this binary is the complementing
end-to-end arc over everything the inline pool cannot fake — spawned
worker processes, SO_REUSEPORT accept spreading, the shared-memory
rings, the Establish/Drop/Heartbeat control surface, and the reaper's
crash-respawn path:

  1. start a CapacityServer (stream push, sharded) on an ephemeral
     loopback backend and a FrontendPool of N workers on the public
     port;
  2. establish a WatchCapacity stream through the pool and read the
     establishment snapshot;
  3. churn the lease via forwarded unary GetCapacity RPCs until a push
     arrives on the held stream;
  4. hard-kill the worker that owns the stream; the stream must END
     (reset-to-redirect, never a silent lapse);
  5. re-establish with the resume contract (resume_seq + has baseline)
     against the respawned pool and see the stream live again, with
     every message's seq strictly beyond the pre-kill sequence (no
     replay).

The server is the immediate-mode one (no device work); `--device` is
the device it is built for ("cuda" unless the caller asks for "cpu").
The listener workers never import torch.

Exit 0 on success. On failure: diagnostics to stderr, the server's
flight-recorder dump to --flightrec-dir (or $DOORMAN_FLIGHTREC_DIR),
exit 1. chip_smoke.py runs it on the card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import socket
import sys
import time

log = logging.getLogger("doorman.frontend_smoke")
# The interpreter's start, as near as this module sees it: the first lap
# (imports) runs from here, before torch is imported.
_T0 = time.monotonic()

CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1}
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="frontend-smoke")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--ring-bytes", type=int, default=1 << 20)
    p.add_argument("--tick-interval", type=float, default=0.2)
    p.add_argument("--device", default="cuda",
                   help="the server's device (cuda, or cpu when asked)")
    p.add_argument("--timeout", type=float, default=90.0,
                   help="overall wall-clock budget in seconds")
    p.add_argument("--flightrec-dir",
                   default=os.environ.get("DOORMAN_FLIGHTREC_DIR", ""),
                   help="directory for the flight-recorder dump on "
                        "failure")
    return p


async def _watch_until(call, predicate, deadline: float):
    """Read stream messages until `predicate(msg)` is true; returns
    (matching message, all messages read). Raises on EOF/timeout."""
    import grpc

    seen = []
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(
                f"stream produced no matching message; saw {len(seen)}"
            )
        msg = await asyncio.wait_for(call.read(), timeout=remaining)
        if msg is grpc.aio.EOF:
            raise ConnectionResetError("stream ended")
        seen.append(msg)
        if predicate(msg):
            return msg, seen


class _Laps:
    """Seconds per step of the arc, logged as each step ends and
    returned in the result line, so a run that is slow says where."""

    def __init__(self, start: float):
        self.steps = {}
        self._last = start

    def __call__(self, step: str) -> None:
        now = time.monotonic()
        self.steps[step] = round(now - self._last, 3)
        self._last = now
        log.info("step %s: %.3f s", step, self.steps[step])


async def smoke(args: argparse.Namespace) -> int:
    import grpc

    from doorman_tpu_torch.proto import doorman_pb2 as pb
    from doorman_tpu_torch.proto import doorman_stream_pb2 as spb
    from doorman_tpu_torch.proto.grpc_api import CapacityStub
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer

    lap = _Laps(_T0)
    lap("imports")
    deadline = time.monotonic() + args.timeout
    server = CapacityServer(
        "smoke-root", TrivialElection(),
        mode="immediate",
        tick_interval=args.tick_interval,
        minimum_refresh_interval=0.0,
        stream_push=True,
        stream_shards=4,
        device=args.device,
    )
    pool = server.attach_frontend(
        args.workers, ring_bytes=args.ring_bytes, inline=False,
    )
    public_port = _free_port()
    public_addr = f"127.0.0.1:{public_port}"
    try:
        backend_port = await server.start(0, host="127.0.0.1")
        await server.load_config(parse_yaml_config(CONFIG))
        await pool.start(public_addr, f"127.0.0.1:{backend_port}")
        lap("server_start")

        # Spawned workers take seconds to import grpc and bind; ready
        # means every worker has heartbeat the control surface.
        while time.monotonic() < deadline:
            held = pool.control.status()["worker_held"]
            if len(held) == args.workers:
                break
            await asyncio.sleep(0.2)
        else:
            raise TimeoutError("workers never became ready")
        log.info("pool ready: %d workers heartbeating", args.workers)
        lap("workers_ready")

        async with grpc.aio.insecure_channel(public_addr) as channel:
            stub = CapacityStub(channel)

            # 1) establish through the pool.
            watch_req = spb.WatchCapacityRequest(client_id="smoke-w")
            rr = watch_req.resource.add()
            rr.resource_id = "r0"
            rr.wants = 10.0
            rr.priority = 1
            call = stub.WatchCapacity(watch_req)
            snap, _ = await _watch_until(
                call, lambda m: bool(m.response), deadline
            )
            last_seq = int(snap.seq)
            lease = pb.Lease()
            lease.CopyFrom(snap.response[0].gets)
            log.info("established: seq=%d has=%.1f", last_seq,
                     lease.capacity)
            lap("establish")

            # The registry knows which worker the kernel handed the
            # stream to — that's the one the kill must target.
            subs = server._streams.iter_subs()
            assert len(subs) == 1, subs
            victim = subs[0].worker
            log.info("stream held by worker %s", victim)

            # 2) churn the lease with forwarded unary RPCs until a
            # push rides the ring to our held stream.
            async def churn():
                i = 0
                while True:
                    i += 1
                    req = pb.GetCapacityRequest(client_id=f"churn-{i}")
                    cr = req.resource.add()
                    cr.resource_id = "r0"
                    cr.wants = 10.0 + i
                    cr.priority = 1
                    await stub.GetCapacity(req)
                    await asyncio.sleep(args.tick_interval / 2)

            churn_task = asyncio.ensure_future(churn())
            try:
                push, msgs = await _watch_until(
                    call,
                    lambda m: bool(m.response) and int(m.seq) > last_seq,
                    deadline,
                )
            finally:
                churn_task.cancel()
            last_seq = max(
                last_seq, max(int(m.seq) for m in msgs)
            )
            for m in msgs:
                for row in m.response:
                    if row.resource_id == "r0":
                        lease.CopyFrom(row.gets)
            log.info("push received: seq=%d", last_seq)
            lap("push")

            # 3) kill the owning worker: the stream must END loudly.
            pool.kill_worker(victim)
            log.info("killed worker %s", victim)
            try:
                while True:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            "stream survived its worker's death"
                        )
                    msg = await asyncio.wait_for(
                        call.read(), timeout=remaining
                    )
                    if msg is grpc.aio.EOF:
                        break
            except grpc.aio.AioRpcError:
                pass  # UNAVAILABLE from the TCP teardown: also a reset
            log.info("stream reset after worker kill")
            lap("kill_reset")

            # 4) wait for the reaper to sweep + respawn, then resume.
            while time.monotonic() < deadline:
                if len(pool.status()["live"]) == args.workers:
                    break
                await asyncio.sleep(0.2)
            else:
                raise TimeoutError("reaper never respawned the worker")
            log.info("worker respawned; re-establishing with resume")
            lap("respawn")

            watch_req.resume_seq = last_seq
            rr.has.CopyFrom(lease)
            call2 = stub.WatchCapacity(watch_req)
            churn_task = asyncio.ensure_future(churn())
            try:
                msg, msgs2 = await _watch_until(
                    call2, lambda m: bool(m.response), deadline
                )
            finally:
                churn_task.cancel()
            # No replay: everything after resume is strictly beyond
            # the pre-kill sequence.
            stale = [int(m.seq) for m in msgs2
                     if m.response and int(m.seq) <= last_seq]
            assert not stale, f"replayed seqs {stale} (<= {last_seq})"
            log.info("resumed: seq=%d > %d, no replay", int(msg.seq),
                     last_seq)
            call2.cancel()
            lap("resume")

        status = pool.status()
        print(json.dumps({
            "ok": True,
            "workers": args.workers,
            "victim": victim,
            "resumed_seq": int(msg.seq),
            "steps_s": dict(lap.steps),
            "control": status["control"],
            "publisher": {
                k: status["publisher"][k]
                for k in ("published_frames", "published_bytes")
                if k in status["publisher"]
            },
        }, sort_keys=True))
        return 0
    except Exception as exc:
        log.error("frontend smoke FAILED: %s: %s",
                  type(exc).__name__, exc)
        dump = (
            server.flightrec.dump(
                f"frontend_smoke:{type(exc).__name__}"
            )
            if server.flightrec is not None else {"records": []}
        )
        if args.flightrec_dir:
            os.makedirs(args.flightrec_dir, exist_ok=True)
            path = os.path.join(
                args.flightrec_dir, "frontend_smoke_dump.json"
            )
            with open(path, "w") as f:
                json.dump(dump, f, indent=2, sort_keys=True)
            log.error("flight-recorder dump written to %s", path)
        return 1
    finally:
        await server.stop()
        lap("teardown")


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    args = make_parser().parse_args(argv)
    return asyncio.run(smoke(args))


if __name__ == "__main__":
    sys.exit(main())
