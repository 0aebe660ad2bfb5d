"""Per-resource lease store with O(1) running aggregates.

Capability parity with the reference store
(reference go/server/doorman/store.go:68-213): client -> lease map with
running sum_has / sum_wants / subclient count, expiry sweep, and a read-only
status view. Differences by design:

  - the clock is injected (defaults to time.time) so the simulation harness
    and tests can run on virtual time;
  - iteration order over clients is insertion order (Python dict), which is
    deterministic — the Go map iteration is randomized. The batch solver
    relies on this determinism for reproducible packing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Tuple

from doorman_tpu_torch.core.lease import Lease, ZERO_LEASE


@dataclass
class ClientLeaseStatus:
    client_id: str
    lease: Lease


@dataclass
class ResourceLeaseStatus:
    id: str
    sum_has: float
    sum_wants: float
    leases: List[ClientLeaseStatus] = field(default_factory=list)


class LeaseStore:
    """The set of outstanding leases for one resource."""

    def __init__(self, id: str, clock: Callable[[], float] = time.time):
        self.id = id
        self._clock = clock
        self._leases: Dict[str, Lease] = {}
        self._sum_wants = 0.0
        self._sum_has = 0.0
        self._count = 0  # total subclients

    def __len__(self) -> int:
        return len(self._leases)

    @property
    def count(self) -> int:
        """Total number of subclients across all leases."""
        return self._count

    @property
    def sum_has(self) -> float:
        return self._sum_has

    @property
    def sum_wants(self) -> float:
        return self._sum_wants

    def get(self, client: str) -> Lease:
        return self._leases.get(client, ZERO_LEASE)

    def has_client(self, client: str) -> bool:
        return client in self._leases

    def subclients(self, client: str) -> int:
        return self._leases.get(client, ZERO_LEASE).subclients

    def assign(
        self,
        client: str,
        lease_length: float,
        refresh_interval: float,
        has: float,
        wants: float,
        subclients: int,
        priority: int = 0,
    ) -> Lease:
        """Record capacity `has` given to `client`; updates running sums by
        delta and stamps a fresh expiry of now + lease_length."""
        old = self._leases.get(client, ZERO_LEASE)
        self._sum_has += has - old.has
        self._sum_wants += wants - old.wants
        self._count += subclients - old.subclients
        lease = Lease(
            expiry=self._clock() + lease_length,
            refresh_interval=refresh_interval,
            has=has,
            wants=wants,
            subclients=subclients,
            priority=priority,
        )
        self._leases[client] = lease
        return lease

    def bulk_assign(
        self,
        clients,
        lease_length: float,
        refresh_interval: float,
        has,
        wants,
        subclients=None,
        priority=None,
    ) -> None:
        """assign() per row, in input order (the vector population's
        grouped-commit path). Same running-sum accumulation order and
        same clock stamp per row as the equivalent assign loop — the
        native store implements this contract as one C call."""
        n = len(clients)
        subs = subclients if subclients is not None else [1] * n
        prio = priority if priority is not None else [0] * n
        for i in range(n):
            self.assign(
                clients[i], lease_length, refresh_interval,
                float(has[i]), float(wants[i]), int(subs[i]),
                int(prio[i]),
            )

    def regrant(self, client: str, has: float) -> None:
        """Update only the granted capacity of an existing lease — the
        batched tick's write-back. Expiry and refresh are NOT touched:
        they advance only when the client itself refreshes (reference
        semantics, store.go:153-181 + Decide stamping the requester
        only), so a client that stops refreshing expires after one
        lease length even while the server stays busy."""
        old = self._leases.get(client)
        if old is None:
            return  # released mid-solve
        self._sum_has += has - old.has
        self._leases[client] = Lease(
            expiry=old.expiry,
            refresh_interval=old.refresh_interval,
            has=has,
            wants=old.wants,
            subclients=old.subclients,
            priority=old.priority,
        )

    def release(self, client: str) -> None:
        lease = self._leases.pop(client, None)
        if lease is None:
            return
        self._sum_wants -= lease.wants
        self._sum_has -= lease.has
        self._count -= lease.subclients

    def clean(self) -> int:
        """Remove expired leases; returns how many were removed."""
        now = self._clock()
        expired = [c for c, l in self._leases.items() if now > l.expiry]
        for client in expired:
            self.release(client)
        return len(expired)

    def restore(self, client: str, lease: Lease) -> None:
        """Insert a lease verbatim — absolute expiry preserved — for the
        persistence restore path (doorman_tpu/persist). assign() would
        re-stamp expiry from the clock, silently extending every
        restored lease by a full lease length."""
        old = self._leases.get(client, ZERO_LEASE)
        self._sum_has += lease.has - old.has
        self._sum_wants += lease.wants - old.wants
        self._count += lease.subclients - old.subclients
        self._leases[client] = lease

    def dump_rows(self) -> List[Tuple[str, float, float, float, float, int, int]]:
        """Drain API for snapshotting: every lease as one
        (client, expiry, refresh_interval, has, wants, subclients,
        priority) row. The native store implements the same contract as
        a single bulk C call (dm_dump), so snapshot serialization never
        walks a million-lease store lease-by-lease through Python
        attribute access."""
        return [
            (c, l.expiry, l.refresh_interval, l.has, l.wants,
             l.subclients, l.priority)
            for c, l in self._leases.items()
        ]

    def items(self) -> Iterator[Tuple[str, Lease]]:
        return iter(self._leases.items())

    def map(self, fn: Callable[[str, Lease], None]) -> None:
        for client, lease in self._leases.items():
            fn(client, lease)

    def band_aggregates(self) -> List[Tuple[int, float, int]]:
        """(priority, wants-sum, subclient-count) per distinct priority,
        ascending (same contract as the native store's C fast path)."""
        bands: Dict[int, List[float]] = {}
        for lease in self._leases.values():
            acc = bands.setdefault(lease.priority, [0.0, 0])
            acc[0] += lease.wants
            acc[1] += lease.subclients
        return [
            (p, bands[p][0], int(bands[p][1])) for p in sorted(bands)
        ]

    def lease_status(self) -> ResourceLeaseStatus:
        return ResourceLeaseStatus(
            id=self.id,
            sum_has=self._sum_has,
            sum_wants=self._sum_wants,
            leases=[
                ClientLeaseStatus(client_id=c, lease=l)
                for c, l in self._leases.items()
            ],
        )
