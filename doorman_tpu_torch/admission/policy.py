"""The shed matrix and the retry-after contract.

What may be shed, and what a shed looks like on the wire:

  method               sheddable  why
  -------------------  ---------  ------------------------------------
  GetCapacity          by band    refreshes are RETRYABLE BY DESIGN —
                                  leases outlive a missed refresh, so a
                                  shed client keeps serving on its last
                                  grant and simply comes back later
  WatchCapacity        by band    stream ESTABLISHMENT only (an open
                                  stream is never shed mid-flight — it
                                  costs the server nothing until a row
                                  moves): a refused subscriber simply
                                  keeps polling, which is the exact
                                  contract it would have without the
                                  stream; per-band stream caps shed
                                  here too (kind="stream_cap")
  GetServerCapacity    never      one RPC aggregates a whole downstream
                                  subtree; shedding it degrades every
                                  client under that server at once
  ReleaseCapacity      never      releases SHRINK load — shedding one
                                  pins capacity on a dead client and
                                  makes the overload worse
  Discovery            never      mastership discovery is how clients
                                  drain AWAY from this server

A shed GetCapacity is `RESOURCE_EXHAUSTED` with the pacing hint in
trailing metadata under ``doorman-retry-after`` (seconds, decimal). The
hint is the admission-path's analog of the lease's `refresh_interval`
field — "come back in N seconds" — carried in metadata because a
non-OK gRPC status cannot carry a response message. Clients honor it
with jitter (half the hint plus a uniform draw over the other half) so
a shed wave does not re-synchronize into the next storm.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["RETRY_AFTER_KEY", "SHED_MATRIX", "Shed", "sheddable"]

# gRPC trailing-metadata key carrying the retry-after hint (seconds).
RETRY_AFTER_KEY = "doorman-retry-after"

# method -> may the admission controller shed it?
SHED_MATRIX = {
    "GetCapacity": True,
    "WatchCapacity": True,  # establishment only; see the table above
    "GetServerCapacity": False,
    "ReleaseCapacity": False,
    "Discovery": False,
}


def sheddable(method: str) -> bool:
    return SHED_MATRIX.get(method, False)


@dataclass(frozen=True)
class Shed:
    """A decision to refuse one request."""

    reason: str
    retry_after: float
    band: int
    kind: str  # "overload" | "deadline" | "stream_cap"
