"""Lease value type.

Capability parity with the reference's lease record
(reference go/server/doorman/store.go:20-36): expiry, refresh interval,
granted capacity (has), requested capacity (wants), subclient count.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Lease:
    """A capacity lease granted to one client for one resource.

    Times are absolute seconds since the epoch (matching the wire format);
    durations are in seconds.
    """

    expiry: float = 0.0
    refresh_interval: float = 0.0
    has: float = 0.0
    wants: float = 0.0
    subclients: int = 0
    # Wire priority of the client for this resource (doorman.proto
    # ResourceRequest.priority); interpreted only by priority-aware
    # algorithms, recorded for all.
    priority: int = 0

    @property
    def is_zero(self) -> bool:
        return self.expiry == 0.0


ZERO_LEASE = Lease()
