"""The reconcile beat over real gRPC: head service + shard reporter.

Deployment shape (doc/federation.md, "Deploying the beat over RPC"):
the fleet head runs a small gRPC service speaking the EXISTING
Capacity surface; each shard process runs a ShardReporter task that
periodically sweeps its straddling stores, sends the compact summaries
as one GetServerCapacity (server_id "fleet-shard-<k>"), and installs
the response leases as its straddle shares. No new proto, no
per-client rows on the wire, and the failure story is inherited: a
shard that stops reporting freezes at its last share and drains; a
head that dies stops renewing every share and the whole straddle
decays to per-shard zero — capacity is never invented by an outage.

Port of doorman_tpu/fleet/rpc.py: a copy apart from import paths.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Dict, Optional

import grpc

from doorman_tpu_torch.federation.reconcile import summarize_resource
from doorman_tpu_torch.fleet.beat import (
    BeatCore,
    decode_summary,
    encode_summary,
    parse_shard_server_id,
    shard_server_id,
)
from doorman_tpu_torch.obs import trace as trace_mod
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto.grpc_api import (
    CapacityServicer,
    CapacityStub,
    add_capacity_servicer,
)

log = logging.getLogger(__name__)

__all__ = ["FleetBeatServicer", "ShardReporter", "serve_beat"]


class FleetBeatServicer(CapacityServicer):
    """The head's service: GetServerCapacity carrying a fleet-shard
    server_id is a beat report — decode the summaries, fold them into
    BeatCore, answer with the reporting shard's shares as response
    leases. Anything else is politely refused (the head allocates
    nothing itself)."""

    def __init__(self, core: BeatCore):
        self.core = core

    async def Discovery(self, request, context):
        # The head holds no election: it is always "master" of the
        # beat, which lets supervisor readiness checks reuse the
        # ordinary Discovery probe.
        return pb.DiscoveryResponse(is_master=True)

    async def GetServerCapacity(self, request, context):
        shard = parse_shard_server_id(request.server_id)
        if shard is None:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "the fleet head only serves beat reports "
                "(server_id 'fleet-shard-<k>')",
            )
        out = pb.GetServerCapacityResponse()
        with trace_mod.default_tracer().span(
            "fleet.beat", cat="fleet",
            args={"shard": shard, "resources": len(request.resource)},
        ):
            for req in request.resource:
                summary = decode_summary(req, shard)
                share = self.core.offer(shard, req.resource_id, summary)
                if share is None:
                    continue
                value, expiry = share
                resp = out.response.add()
                resp.resource_id = req.resource_id
                resp.gets.capacity = float(value)
                resp.gets.expiry_time = int(expiry)
                resp.gets.refresh_interval = max(
                    1, int(self.core.share_ttl / 2)
                )
        return out

    async def GetCapacity(self, request, context):
        await context.abort(
            grpc.StatusCode.UNIMPLEMENTED,
            "the fleet head is not a capacity server; dial a shard",
        )

    async def ReleaseCapacity(self, request, context):
        await context.abort(
            grpc.StatusCode.UNIMPLEMENTED,
            "the fleet head is not a capacity server; dial a shard",
        )

    async def WatchCapacity(self, request, context):
        await context.abort(
            grpc.StatusCode.UNIMPLEMENTED,
            "the fleet head is not a capacity server; dial a shard",
        )


async def serve_beat(
    core: BeatCore, *, host: str = "127.0.0.1", port: int = 0
):
    """Bind the beat service. Returns (grpc.aio server, bound port)."""
    server = grpc.aio.server()
    add_capacity_servicer(server, FleetBeatServicer(core))
    bound = server.add_insecure_port(f"{host}:{port}")
    await server.start()
    return server, bound


class ShardReporter:
    """The shard-side half of the beat: sweep + summarize the
    straddling resources, report, install the returned shares.

    Runs inside the shard's server process (cmd/server.py --fleet-beat)
    with direct access to the CapacityServer — summaries never leave
    the process as anything bigger than the per-band aggregates. A
    failed report is a missed beat, not an error: the share installed
    last time keeps serving until its expiry, which is the same
    partition-drain story the in-process reconciler pins."""

    def __init__(
        self,
        server,
        shard: int,
        beat_addr: str,
        straddle,
        *,
        interval: float = 2.0,
        clock: Callable[[], float] = time.time,
    ):
        self.server = server
        self.shard = int(shard)
        self.beat_addr = beat_addr
        self.straddle = tuple(straddle)
        self.interval = float(interval)
        self._clock = clock
        self._channel = None
        self._stub = None
        self.reports = 0
        self.failures = 0
        self.installed: Dict[str, float] = {}

    def _ensure_stub(self):
        if self._stub is None:
            self._channel = grpc.aio.insecure_channel(self.beat_addr)
            self._stub = CapacityStub(self._channel)
        return self._stub

    def _build_request(self) -> Optional[pb.GetServerCapacityRequest]:
        from doorman_tpu_torch.core.resource import algo_kind_for

        req = pb.GetServerCapacityRequest(
            server_id=shard_server_id(self.shard)
        )
        for rid in self.straddle:
            res = self.server.resources.get(rid)
            if res is None:
                # Not claimed yet on this shard: report the empty
                # summary so the head still counts us live (and the
                # zero-demand slack split reaches us).
                req.resource.add(resource_id=rid)
                continue
            res.store.clean()
            summary = summarize_resource(
                res, self.shard, kind=algo_kind_for(res.template)
            )
            req.resource.append(encode_summary(summary, rid))
        return req if len(req.resource) else None

    async def step(self) -> bool:
        """One report round. Returns True when the report landed and
        the shares were installed."""
        if not self.server.is_master:
            # A non-master candidate holds no store worth reporting;
            # its silence freezes the share, exactly as intended.
            return False
        request = self._build_request()
        if request is None:
            return False
        try:
            resp = await self._ensure_stub().GetServerCapacity(
                request, timeout=max(self.interval, 1.0)
            )
        except Exception as e:
            self.failures += 1
            log.warning(
                "shard %d beat report to %s failed: %r",
                self.shard, self.beat_addr, e,
            )
            return False
        self.reports += 1
        for r in resp.response:
            self.server.set_straddle_share(
                r.resource_id, r.gets.capacity, float(r.gets.expiry_time)
            )
            self.installed[r.resource_id] = float(r.gets.capacity)
        trace_mod.default_tracer().instant(
            "fleet.report", cat="fleet",
            args={"shard": self.shard,
                  "resources": len(resp.response)},
        )
        return True

    async def run(self) -> None:
        """The beat loop; cancel the task to stop. First report fires
        immediately — bring-up wants the bootstrap split installed
        BEFORE the front door opens (doc/federation.md corollary)."""
        while True:
            try:
                await self.step()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception(
                    "shard %d beat step blew up; next beat retries",
                    self.shard,
                )
            await asyncio.sleep(self.interval)

    async def close(self) -> None:
        if self._channel is not None:
            await self._channel.close()
            self._channel = None
            self._stub = None

    def status(self) -> dict:
        return {
            "shard": self.shard,
            "beat_addr": self.beat_addr,
            "straddle": list(self.straddle),
            "interval": self.interval,
            "reports": self.reports,
            "failures": self.failures,
            "installed": {
                rid: round(v, 6)
                for rid, v in sorted(self.installed.items())
            },
        }
