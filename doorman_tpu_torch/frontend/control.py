"""FrontendControl: the tick process's control surface for listener
workers.

Real workers forward three things here over the backend channel, all
as raw bytes (the worker never re-encodes what the client sent):

  * Establish — the client's WatchCapacityRequest bytes, stamped with
    the worker's index in metadata. The tick process runs EXACTLY the
    in-process WatchCapacity establishment gate — mastership,
    validation, AIMD admission (check_watch), the per-band stream cap
    — through the establishment ramp (admission/ramp.py), then
    subscribes the stream into the registry (which pins it to the
    calling worker's shards and starts publishing its frames to that
    worker's ring). The JSON reply tells the worker how the stream
    begins: {"stream_id": n} (serve from the ring), {"shed": reason,
    "retry_after": s, "band": b} (abort RESOURCE_EXHAUSTED with the
    retry-after trailer), {"terminal": hex} (send one mastership
    redirect and end — not master), or {"error": msg} (invalid
    argument).
  * Drop — {"stream_id": n}: the stream's handler ended (client went
    away, drain); unsubscribe + matcher removal, same as the
    in-process handler's finally block.
  * Heartbeat — {"worker": i, "held": n, "tallies": {...}}: per-worker
    shed/admit tally deltas absorbed into Admission.worker_tallies and
    liveness the pool's reaper watches.

JSON (not proto) because this surface is pool-internal — both ends
ship in this package, the payloads are control-plane small, and the
data plane (the ring and the forwarded client bytes) never touches it.
"""

from __future__ import annotations

import json
import logging
from typing import Callable, Dict, Optional

import grpc

from doorman_tpu_torch.proto import doorman_stream_pb2 as spb

log = logging.getLogger(__name__)

__all__ = [
    "CONTROL_SERVICE",
    "FrontendControl",
    "WORKER_METADATA_KEY",
    "add_frontend_control",
]

# The wire name is the reference's, so both packages' pools speak it.
CONTROL_SERVICE = "doorman_tpu.FrontendControl"
WORKER_METADATA_KEY = "doorman-frontend-worker"


def _worker_index(context) -> int:
    for key, value in context.invocation_metadata() or ():
        if key == WORKER_METADATA_KEY:
            return int(value)
    return -1


class FrontendControl:
    """Bound to one CapacityServer; registered on its backend gRPC
    server by add_frontend_control. `on_heartbeat(worker, held)` is the
    pool's liveness hook."""

    def __init__(self, server,
                 on_heartbeat: Optional[Callable[[int, int], None]] = None):
        self._server = server
        self._on_heartbeat = on_heartbeat
        self.establishments = 0
        self.drops = 0
        self.heartbeats = 0
        self.worker_held: Dict[int, int] = {}

    # -- handlers (raw bytes in, JSON bytes out) -----------------------

    async def Establish(self, request_bytes: bytes, context) -> bytes:
        worker = _worker_index(context)
        server = self._server
        request = spb.WatchCapacityRequest.FromString(request_bytes)
        if server._streams is None:
            return json.dumps(
                {"error": "stream push is disabled on this server"}
            ).encode()
        if not server.is_master:
            out = spb.WatchCapacityResponse()
            out.mastership.CopyFrom(server._mastership())
            return json.dumps(
                {"terminal": out.SerializeToString().hex()}
            ).encode()
        from doorman_tpu_torch.server import config as config_mod

        msg = config_mod.validate_get_capacity_request(request)
        if msg is not None:
            return json.dumps({"error": msg}).encode()
        band = max((rr.priority for rr in request.resource), default=0)

        def establish():
            """The gated subscribe, in arrival order inside the ramp's
            window — the same sequence as the in-process handler."""
            shed = None
            if server._admission is not None:
                shed = server._admission.check_watch(request)
            if shed is None:
                shed = server._streams.check_cap(band)
            if shed is not None:
                return {
                    "shed": shed.reason,
                    "retry_after": shed.retry_after,
                    "band": band,
                }
            # Pin to the CALLING worker: it holds the gRPC stream the
            # kernel's SO_REUSEPORT accept handed it, so its ring is
            # where this stream's frames must land.
            sub = server._streams.subscribe(
                request, worker=worker if worker >= 0 else None
            )
            server._stream_match_add(sub)
            # ramp.submit runs this thunk ON the event loop (call_later
            # flush), never an executor thread — no lock needed.
            self.establishments += 1  # doorman: allow[lock-discipline]
            return {"stream_id": sub.stream_id, "band": band,
                    "shard": sub.shard, "worker": sub.worker}

        ramp = getattr(server, "_frontend_ramp", None)
        if ramp is not None:
            reply = await ramp.submit(establish)
        else:
            reply = establish()
        # Shed attribution rides the WORKER's heartbeat delta (it
        # tallies the shed reply in _watch) — absorbing it here too
        # would double-count it in Admission.worker_tallies.
        return json.dumps(reply).encode()

    async def Drop(self, request_bytes: bytes, context) -> bytes:
        body = json.loads(request_bytes)
        server = self._server
        streams = server._streams
        if streams is not None:
            sub = streams.stream_by_id(int(body.get("stream_id", 0)))
            if sub is not None:
                streams.unsubscribe(sub)
                server._stream_match_remove(sub)
                self.drops += 1
        return b"{}"

    async def Heartbeat(self, request_bytes: bytes, context) -> bytes:
        body = json.loads(request_bytes)
        worker = int(body.get("worker", _worker_index(context)))
        self.heartbeats += 1
        self.worker_held[worker] = int(body.get("held", 0))
        tallies = body.get("tallies") or {}
        if tallies and self._server._admission is not None:
            self._server._admission.absorb_worker_tallies(worker, tallies)
        if self._on_heartbeat is not None:
            self._on_heartbeat(worker, self.worker_held[worker])
        return b"{}"

    def status(self) -> dict:
        return {
            "establishments": self.establishments,
            "drops": self.drops,
            "heartbeats": self.heartbeats,
            "worker_held": {
                str(w): n for w, n in sorted(self.worker_held.items())
            },
        }


def add_frontend_control(grpc_server, control: FrontendControl) -> None:
    """Register the control surface on a grpc.aio server with raw-bytes
    method handlers (no serializers: the Establish request IS the
    client's WatchCapacityRequest bytes, replies are JSON)."""
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(getattr(control, name))
        for name in ("Establish", "Drop", "Heartbeat")
    }
    grpc_server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(CONTROL_SERVICE, handlers),
    ))
