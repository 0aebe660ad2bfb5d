"""Resource: one rate-limited entity — config template + lease store +
algorithm binding + learning-mode clock.

Capability parity with reference go/server/doorman/resource.go:37-210.
Python server handlers run on a single asyncio loop, so the reference's
RWMutex discipline collapses away; the injected clock serves the simulation
harness and tests.
"""

from __future__ import annotations

import fnmatch
import time
from typing import Callable, Optional

from doorman_tpu_torch.algorithms import scalar
from doorman_tpu_torch.core.lease import Lease
from doorman_tpu_torch.core.store import LeaseStore
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.algorithms.kinds import AlgoKind


# variant -> internal lane, per wire kind (the config-epoch seam: a
# variant flip re-maps the kind vector, which the solver's config
# mirror detects exactly like a wire-kind change).
_VARIANT_LANES = {
    (int(pb.Algorithm.PROPORTIONAL_SHARE), "topup"):
        int(AlgoKind.PROPORTIONAL_TOPUP),
    (int(pb.Algorithm.PROPORTIONAL_SHARE), "logutil"):
        int(AlgoKind.PROPORTIONAL_FAIRNESS),
    (int(pb.Algorithm.FAIR_SHARE), "maxmin"):
        int(AlgoKind.MAX_MIN_FAIR),
    (int(pb.Algorithm.FAIR_SHARE), "balanced"):
        int(AlgoKind.BALANCED_FAIRNESS),
}


def algo_kind_for(template: pb.ResourceTemplate) -> int:
    """Map a config template to the solver lane. The `variant`
    parameter refines PROPORTIONAL_SHARE (topup = Go-style top-up,
    logutil = Kelly proportional fairness) and FAIR_SHARE (maxmin =
    unweighted max-min, balanced = balanced fairness) into their
    portfolio lanes; the wire PRIORITY_BANDS kind maps to its internal
    lane id (the wire value collides with the internal top-up lane
    number)."""
    kind = int(template.algorithm.kind)
    variant = scalar.get_parameter(template.algorithm, "variant")
    if variant is not None:
        lane = _VARIANT_LANES.get((kind, variant))
        if lane is not None:
            return lane
    if kind == int(pb.Algorithm.PRIORITY_BANDS):
        return int(AlgoKind.PRIORITY_BANDS)
    return kind


def static_param(template: pb.ResourceTemplate) -> float:
    """STATIC's per-client capacity is the template capacity (the reference
    reuses the capacity field with per-client meaning, algorithm.go:75-85)."""
    return float(template.capacity)


class Resource:
    """A resource as the master sees it."""

    def __init__(
        self,
        resource_id: str,
        template: pb.ResourceTemplate,
        *,
        learning_mode_end: float = 0.0,
        clock: Callable[[], float] = time.time,
        store_factory: Optional[Callable[[str], LeaseStore]] = None,
    ):
        self.id = resource_id
        self._clock = clock
        # store_factory lets the server back all resources with the native
        # C++ engine (doorman_tpu_torch.native); default is the Python store.
        self.store = (
            store_factory(resource_id)
            if store_factory is not None
            else LeaseStore(resource_id, clock=clock)
        )
        # Bound once: the store never changes for a Resource's lifetime,
        # and the request paths should not pay a getattr per request.
        self._decide_fast = getattr(self.store, "decide_fast", None)
        self._refresh_grant = getattr(self.store, "refresh_grant", None)
        self.learning_mode_end = learning_mode_end
        # Expiry of the capacity lease this (intermediate) server holds from
        # its parent; None on the root. Expired parent lease => capacity 0.
        self.parent_expiry: Optional[float] = None
        self.template: pb.ResourceTemplate = None  # set by load_config
        self._algorithm: scalar.Algorithm = None
        self._learner: scalar.Algorithm = None
        self.load_config(template, None)

    def load_config(
        self, template: pb.ResourceTemplate, parent_expiry: Optional[float]
    ) -> None:
        self.template = template
        self.parent_expiry = parent_expiry
        self._algorithm = scalar.get_algorithm(template.algorithm)
        self._learner = scalar.learn(template.algorithm)
        # Per-request decide parameters, read once per config load:
        # protobuf field access (and the variant-parameter scan in
        # algo_kind_for) costs microseconds — too slow to repeat on
        # every request of the native fast path.
        self._decide_kind = algo_kind_for(template)
        self._lease_length = float(template.algorithm.lease_length)
        self._refresh_interval = float(template.algorithm.refresh_interval)

    @property
    def capacity(self) -> float:
        """Current capacity; zero when the parent lease has expired
        (resource.go:62-72)."""
        if self.parent_expiry is not None and self.parent_expiry < self._clock():
            return 0.0
        return self.template.capacity

    @property
    def in_learning_mode(self) -> bool:
        return self.learning_mode_end > self._clock()

    def decide(self, request: scalar.Request) -> Lease:
        """Per-request (immediate-mode) decision: sweep expired leases then
        run the configured algorithm — or the learner during learning mode
        (resource.go:100-113). Native stores run the whole decide as one
        locked C call (sweep + algorithm + upsert, bit-identical grants —
        native/store.cc::dm_decide); PRIORITY_BANDS and Python stores
        take the scalar path."""
        fast = self._decide_fast
        if fast is not None:
            kind = (
                self.store.DECIDE_LEARN
                if self.in_learning_mode
                else self._decide_kind
            )
            result = fast(
                kind, self.capacity, self._lease_length,
                self._refresh_interval, request.has, request.wants,
                request.subclients, request.priority, request.client,
            )
            if result is not None:
                lease, confused, old_has = result
                if confused:
                    scalar.log.error(
                        "client %s is confused: says it has %s, was "
                        "assigned %s", request.client, request.has, old_has,
                    )
                return lease
        self.store.clean()
        if self.in_learning_mode:
            return self._learner(self.store, self.capacity, request)
        return self._algorithm(self.store, self.capacity, request)

    def release(self, client: str) -> None:
        self.store.release(client)

    def matches(self, template: pb.ResourceTemplate) -> bool:
        glob = template.identifier_glob
        return glob == self.id or fnmatch.fnmatchcase(self.id, glob)

    def safe_capacity(self) -> float:
        """Configured safe capacity, or the dynamic fallback
        capacity / known clients (resource.go:81-96)."""
        if self.template.HasField("safe_capacity"):
            return self.template.safe_capacity
        count = max(self.store.count, 1)
        return self.template.capacity / count

    def status(self) -> dict:
        return {
            "id": self.id,
            "sum_has": self.store.sum_has,
            "sum_wants": self.store.sum_wants,
            "count": self.store.count,
            "capacity": self.capacity,
            "in_learning_mode": self.in_learning_mode,
            "algorithm": pb.Algorithm.Kind.Name(self.template.algorithm.kind),
        }
