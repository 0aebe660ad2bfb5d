"""Per-request (incremental) allocation algorithms.

Semantics parity with the reference algorithm suite
(reference go/server/doorman/algorithm.go:66-313): each algorithm maps
(lease store state, available capacity, one client's request) to a lease, and
assigns it into the store — so the outcome for a client depends on the store
state left behind by previously-processed requests. The batched solver
(doorman_tpu_torch.solver) recasts this as a per-tick snapshot solve; these scalar
forms are the oracle for it and the fallback execution path for single
requests arriving between ticks.

An algorithm here is `fn(store, capacity, request) -> Lease`, produced by a
factory taking the proto Algorithm config (lease_length / refresh_interval),
mirroring the reference's closure design.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict

from doorman_tpu_torch.core.lease import Lease
from doorman_tpu_torch.core.store import LeaseStore
from doorman_tpu_torch.proto import doorman_pb2 as pb

log = logging.getLogger(__name__)

Algorithm = Callable[[LeaseStore, float, "Request"], Lease]


@dataclass(frozen=True)
class Request:
    """One client's capacity request for one resource."""

    client: str
    has: float
    wants: float
    subclients: int = 1
    priority: int = 0


def _params(config: pb.Algorithm) -> tuple[float, float]:
    return float(config.lease_length), float(config.refresh_interval)


def _peek(store: LeaseStore, client: str):
    """(found, lease, sum_has, sum_wants, count) — in ONE store call
    when the store provides the combined read (the native store's
    request path pays a ctypes crossing per primitive read; see
    NativeLeaseStore.peek), else composed from the primitives. A pure
    read combination: semantics identical either way."""
    peek = getattr(store, "peek", None)
    if peek is not None:
        return peek(client)
    return (
        store.has_client(client),
        store.get(client),
        store.sum_has,
        store.sum_wants,
        store.count,
    )


def no_algorithm(config: pb.Algorithm) -> Algorithm:
    """Every client gets exactly what it wants."""
    length, interval = _params(config)

    def algo(store: LeaseStore, capacity: float, r: Request) -> Lease:
        return store.assign(r.client, length, interval, r.wants, r.wants, r.subclients,
                            priority=r.priority)

    return algo


def static(config: pb.Algorithm) -> Algorithm:
    """Every client gets min(configured capacity, wants); the configured
    capacity is per client, not a shared total."""
    length, interval = _params(config)

    def algo(store: LeaseStore, capacity: float, r: Request) -> Lease:
        return store.assign(
            r.client, length, interval, min(capacity, r.wants), r.wants,
            r.subclients, priority=r.priority,
        )

    return algo


def learn(config: pb.Algorithm) -> Algorithm:
    """Learning mode: grant whatever the client reports it already has, so a
    freshly-elected master reconstructs state without overcommitting."""
    length, interval = _params(config)

    def algo(store: LeaseStore, capacity: float, r: Request) -> Lease:
        return store.assign(r.client, length, interval, r.has, r.wants, r.subclients,
                            priority=r.priority)

    return algo


def proportional_share(config: pb.Algorithm) -> Algorithm:
    """Proportional share, simulation semantics (the framework's canonical
    PROPORTIONAL_SHARE; parity target algo_proportional.py:31-65): grant
    wants when total wants fit within capacity, otherwise scale every
    client by capacity / all_wants; always clamped by the free capacity
    (capacity minus leases outstanding to others)."""
    length, interval = _params(config)

    def algo(store: LeaseStore, capacity: float, r: Request) -> Lease:
        _, old, sum_has, sum_wants, _count = _peek(store, r.client)
        # The requester's own outstanding lease does not count against it.
        all_wants = sum_wants - old.wants + r.wants
        sum_leases = sum_has - old.has
        free = max(capacity - sum_leases, 0.0)
        if all_wants < capacity:
            gets = min(r.wants, free)
        else:
            gets = min(r.wants * (capacity / all_wants), free)
        return store.assign(r.client, length, interval, gets, r.wants, r.subclients,
                            priority=r.priority)

    return algo


def proportional_topup(config: pb.Algorithm) -> Algorithm:
    """Proportional share, Go reference semantics (algorithm.go:213-292;
    select with algorithm parameter variant=topup): grant wants when there
    is room; in overload, grant the equal share plus a top-up proportional
    to the client's excess demand, funded by clients requesting under their
    equal share."""
    length, interval = _params(config)

    def algo(store: LeaseStore, capacity: float, r: Request) -> Lease:
        found, old, sum_has, sum_wants, count = _peek(store, r.client)
        if not found:
            count += r.subclients

        equal_share = capacity / count
        equal_share_client = equal_share * r.subclients
        # Capacity not currently promised to anyone else; the hard cap on
        # what this run may grant.
        unused = capacity - sum_has + old.has

        if sum_wants <= capacity or r.wants <= equal_share_client:
            return store.assign(
                r.client, length, interval,
                min(r.wants, unused), r.wants, r.subclients,
                priority=r.priority,
            )

        # Overload: pool the capacity left by clients under their equal
        # share, and the excess demand of those over it, then top up
        # proportionally.
        extra_capacity = 0.0
        extra_need = 0.0
        for client_id, lease in store.items():
            if client_id == r.client:
                wants, subclients = r.wants, r.subclients
            else:
                wants, subclients = lease.wants, lease.subclients
            share = equal_share * subclients
            if wants < share:
                extra_capacity += share - wants
            else:
                extra_need += wants - share

        gets = equal_share_client + (r.wants - equal_share_client) * (
            extra_capacity / extra_need
        )
        return store.assign(
            r.client, length, interval, min(gets, unused), r.wants,
            r.subclients, priority=r.priority,
        )

    return algo


def fair_share(config: pb.Algorithm) -> Algorithm:
    """Weighted fair share with two rounds of redistributing capacity left
    unclaimed by clients under their equal share (the reference's bounded
    approximation of max-min water-filling; the solver also offers the full
    iterative water-fill — see doorman_tpu_torch.solver.lanes)."""
    length, interval = _params(config)

    def algo(store: LeaseStore, capacity: float, r: Request) -> Lease:
        _, old, sum_has, _sum_wants, count0 = _peek(store, r.client)
        if r.has != old.has:
            log.error(
                "client %s is confused: says it has %s, was assigned %s",
                r.client, r.has, old.has,
            )

        count = count0 - old.subclients + r.subclients
        available = capacity - sum_has + old.has
        equal_share = capacity / count
        deserved = equal_share * r.subclients

        if r.wants <= deserved:
            return store.assign(
                r.client, length, interval,
                min(r.wants, available), r.wants, r.subclients,
                priority=r.priority,
            )

        # Round 1: capacity left by clients under their equal share is
        # contested by the subclients of everyone over it.
        extra = 0.0
        want_extra = r.subclients
        want_extra_clients: Dict[str, Lease] = {}
        for client_id, lease in store.items():
            if client_id == r.client:
                continue
            their_deserved = lease.subclients * equal_share
            if lease.wants < their_deserved:
                extra += their_deserved - lease.wants
            elif lease.wants > their_deserved:
                want_extra += lease.subclients
                want_extra_clients[client_id] = lease

        deserved_extra = (extra / want_extra) * r.subclients
        if r.wants < deserved + deserved_extra:
            return store.assign(
                r.client, length, interval,
                min(r.wants, available), r.wants, r.subclients,
                priority=r.priority,
            )

        # Round 2: clients over their equal share but under share+extra
        # leave part of the extra pool unclaimed; redistribute it once more.
        want_extra_extra = r.subclients
        extra_extra = 0.0
        for client_id, lease in want_extra_clients.items():
            if client_id == r.client:
                continue
            entitled = deserved_extra + deserved
            if lease.wants < entitled:
                extra_extra += entitled - lease.wants
            elif lease.wants > entitled:
                want_extra_extra += lease.subclients

        deserved_extra_extra = (extra_extra / want_extra_extra) * r.subclients
        return store.assign(
            r.client, length, interval,
            min(deserved + deserved_extra + deserved_extra_extra, available),
            r.wants, r.subclients, priority=r.priority,
        )

    return algo


def _portfolio_algorithm(config: pb.Algorithm, solve) -> Algorithm:
    """Per-request form shared by the fairness-portfolio lanes
    (MAX_MIN_FAIR / BALANCED_FAIRNESS / PROPORTIONAL_FAIRNESS): like
    priority_bands, recompute the whole resource's allocation — every
    stored lease plus this request — with the lane's numpy tick oracle,
    and grant the requester its share clamped to the capacity not
    promised to others (the incremental convergence discipline of the
    other scalar forms; the batched tick reassigns everyone at once and
    needs no clamp). `solve` is fn(capacity, wants[], subclients[]) ->
    gets[]."""
    import numpy as np

    length, interval = _params(config)

    def algo(store: LeaseStore, capacity: float, r: Request) -> Lease:
        entries = {
            c: (l.wants, float(l.subclients)) for c, l in store.items()
        }
        entries[r.client] = (r.wants, float(r.subclients))
        clients = list(entries)
        wants = np.array([entries[c][0] for c in clients], np.float64)
        sub = np.array([entries[c][1] for c in clients], np.float64)
        gets = solve(capacity, wants, sub)
        available = max(
            capacity - store.sum_has + store.get(r.client).has, 0.0
        )
        grant = min(float(gets[clients.index(r.client)]), available)
        return store.assign(
            r.client, length, interval, grant, r.wants, r.subclients,
            priority=r.priority,
        )

    return algo


def max_min_fair(config: pb.Algorithm) -> Algorithm:
    """Client-granular (unweighted) max-min water-filling by the
    fast-converging fill iteration (arxiv 2310.09699); wire form
    FAIR_SHARE + parameter variant=maxmin. Oracle:
    algorithms.tick.max_min_fair_tick."""
    from doorman_tpu_torch.algorithms import tick

    return _portfolio_algorithm(
        config, lambda cap, wants, sub: tick.max_min_fair_tick(cap, wants)
    )


def balanced_fairness(config: pb.Algorithm) -> Algorithm:
    """Balanced fairness by the bounded recursive cap-peeling formula
    (arxiv 1711.02880); wire form FAIR_SHARE + parameter
    variant=balanced. Oracle: algorithms.tick.balanced_fairness_tick."""
    from doorman_tpu_torch.algorithms import tick

    return _portfolio_algorithm(config, tick.balanced_fairness_tick)


def proportional_fairness(config: pb.Algorithm) -> Algorithm:
    """Weighted proportional fairness (Kelly log-utility dual fixpoint,
    arxiv 1404.2266); wire form PROPORTIONAL_SHARE + parameter
    variant=logutil. Oracle:
    algorithms.tick.proportional_fairness_tick."""
    from doorman_tpu_torch.algorithms import tick

    return _portfolio_algorithm(config, tick.proportional_fairness_tick)


def get_parameter(config: pb.Algorithm, name: str, default: str | None = None):
    """Fetch a named algorithm parameter (analog of the simulation's
    get_named_parameter, algorithm.py:66-71)."""
    for p in config.parameters:
        if p.name == name:
            return p.value
    return default


_FACTORIES = {
    pb.Algorithm.NO_ALGORITHM: no_algorithm,
    pb.Algorithm.STATIC: static,
    pb.Algorithm.PROPORTIONAL_SHARE: proportional_share,
    pb.Algorithm.FAIR_SHARE: fair_share,
}


# The `variant` parameter refines a wire kind into a portfolio lane;
# server.config validates against this table so a typo'd variant fails
# the config load instead of silently selecting the base lane.
VARIANT_FACTORIES = {
    (pb.Algorithm.PROPORTIONAL_SHARE, "topup"): proportional_topup,
    (pb.Algorithm.PROPORTIONAL_SHARE, "logutil"): proportional_fairness,
    (pb.Algorithm.FAIR_SHARE, "maxmin"): max_min_fair,
    (pb.Algorithm.FAIR_SHARE, "balanced"): balanced_fairness,
}


def get_algorithm(config: pb.Algorithm) -> Algorithm:
    """Build the algorithm the config names (registry analog of
    reference algorithm.go:304-313). The `variant` parameter selects
    the portfolio lanes sharing a wire kind: PROPORTIONAL_SHARE
    variant=topup (Go-style equal-share-plus-top-up) or
    variant=logutil (Kelly proportional fairness); FAIR_SHARE
    variant=maxmin (unweighted max-min) or variant=balanced (balanced
    fairness)."""
    variant = get_parameter(config, "variant")
    if variant is not None:
        factory = VARIANT_FACTORIES.get((config.kind, variant))
        if factory is not None:
            return factory(config)
    return _FACTORIES[config.kind](config)
