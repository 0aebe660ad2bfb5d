"""Simulation model: servers, clients, server jobs.

Capability parity with reference simulation/server.py, client.py,
server_job.py and server_state_wrapper.py, rebuilt on the framework core:
each simulated server tracks leases in the framework's LeaseStore (clients
and downstream servers share one store, exactly like the real
CapacityServer) and runs the framework's scalar algorithms; sim-specific
behaviors layered on top are the refresh-interval decay per tree level
(decay^level * refresh), lease expiry clamped to the server's own lease
from below, the 2-second per-client request throttle, learning mode after
an election win, and unmanaged resources granted verbatim.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from doorman_tpu_torch.algorithms import Request, get_algorithm, get_parameter
from doorman_tpu_torch.core.lease import Lease
from doorman_tpu_torch.core.store import LeaseStore
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.server.config import find_template
from doorman_tpu_torch.sim.core import Sim

log = logging.getLogger("doorman_tpu_torch.sim")

# Reference sim constants (simulation/server.py:27-41).
DEFAULT_LEASE_UNKNOWN_RESOURCE = 300.0
MINIMUM_REQUEST_INTERVAL = 2.0
DEFAULT_REFRESH_INTERVAL = 5.0
DEFAULT_DISCOVERY_INTERVAL = 5.0
END_OF_TIME = 86400.0
DEFAULT_DECAY_FACTOR = 0.5


@dataclass
class SimConfig:
    """Simulation-wide resource configuration: a repository of templates
    (glob-matched, like the server config) whose algorithm parameters may
    carry a decay_factor; ids matching no template are unmanaged."""

    repository: pb.ResourceRepository

    @classmethod
    def default(cls) -> "SimConfig":
        """The reference sim's global config
        (simulation/global_config.py:19-45): resource0 with capacity 500,
        safe capacity 10, ProportionalShare at refresh 8s / lease 60s."""
        repo = pb.ResourceRepository()
        t = repo.resources.add()
        t.identifier_glob = "resource0"
        t.capacity = 500.0
        t.safe_capacity = 10.0
        t.algorithm.kind = pb.Algorithm.PROPORTIONAL_SHARE
        t.algorithm.lease_length = 60
        t.algorithm.refresh_interval = 8
        return cls(repo)

    @classmethod
    def portfolio(cls, wire_kind: int, variant: "str | None") -> "SimConfig":
        """The default config re-pointed at a fairness-portfolio lane
        (doc/algorithms.md "The fairness portfolio"): same capacity /
        lease shape, the algorithm selected by wire kind + `variant`
        parameter — the sim-side half of the per-algorithm scenario
        diversity (chaos parametrizes master_flap_warm the same way)."""
        cfg = cls.default()
        algo = cfg.repository.resources[0].algorithm
        algo.kind = int(wire_kind)
        if variant is not None:
            algo.parameters.add(name="variant", value=variant)
        return cfg

    def find(self, resource_id: str) -> Optional[pb.ResourceTemplate]:
        return find_template(self.repository, resource_id)


def decay_factor(algo: pb.Algorithm) -> float:
    raw = get_parameter(algo, "decay_factor")
    return float(raw) if raw is not None else DEFAULT_DECAY_FACTOR


@dataclass
class ResponseLease:
    capacity: float
    expiry_time: float
    refresh_interval: float


@dataclass
class SimResource:
    """One resource on one simulated server."""

    template: pb.ResourceTemplate
    store: LeaseStore
    learning_expiry: float
    # The server's own capacity lease (from config at the root, from the
    # downstream master otherwise).
    has: Optional[ResponseLease] = None
    last_request: Dict[str, float] = field(default_factory=dict)


class SimServer:
    """One simulated server task (reference simulation/server.py)."""

    def __init__(self, sim: Sim, job, job_name: str, level: int,
                 downstream_job=None, config: Optional[SimConfig] = None):
        assert (level == 0) == (downstream_job is None)
        self.sim = sim
        self.job = job
        self.level = level
        self.downstream_job = downstream_job
        self.config = config or SimConfig.default()
        self.server_id = sim.next_name("server", job_name)
        self.master = None  # downstream master (for level > 0)
        self.election_victory_time: Optional[float] = None
        self.resources: Dict[str, SimResource] = {}
        sim.scheduler.add_thread(self, 0.0)

    # -- mastership ----------------------------------------------------

    def is_master(self) -> bool:
        return self.election_victory_time is not None

    def become_master(self) -> None:
        assert not self.is_master()
        log.info("%s becoming master", self.server_id)
        assert not self.resources
        self.election_victory_time = self.sim.clock.get_time()
        self.sim.scheduler.update_thread(self, 0.0)

    def lose_mastership(self) -> None:
        assert self.is_master()
        log.info("%s losing mastership", self.server_id)
        self.election_victory_time = None
        self.resources = {}
        self.master = None

    # -- resource state ------------------------------------------------

    def _max_lease_duration(self, algo: pb.Algorithm) -> float:
        return float(algo.lease_length)

    def _refresh_interval(self, algo: pb.Algorithm) -> float:
        """Per-level refresh decay (reference algorithm.py:96-99)."""
        return int(
            (decay_factor(algo) ** self.level) * float(algo.refresh_interval)
        )

    def find_resource(self, resource_id: str) -> Optional[SimResource]:
        res = self.resources.get(resource_id)
        if res is not None:
            return res
        template = self.config.find(resource_id)
        if template is None:
            return None
        # Learning mode ends one max lease duration after the election win
        # (reference server_state_wrapper.py:216-217).
        res = SimResource(
            template=template,
            store=LeaseStore(resource_id, clock=self.sim.clock),
            learning_expiry=(
                self.election_victory_time
                + self._max_lease_duration(template.algorithm)
            ),
        )
        self.resources[resource_id] = res
        return res

    def _cleanup(self) -> None:
        now = self.sim.clock.get_time()
        for res in self.resources.values():
            res.store.clean()
            if res.has is not None and res.has.expiry_time <= now:
                res.has = None

    def _create_lease(self, res: SimResource, capacity: float) -> ResponseLease:
        """Lease stamping with the sim's clamping rules
        (reference algorithm.py:108-133)."""
        now = self.sim.clock.get_time()
        algo = res.template.algorithm
        refresh = self._refresh_interval(algo)
        expiry = now + float(algo.lease_length)
        if res.has is not None:
            expiry = min(expiry, res.has.expiry_time)
        if now + refresh >= expiry:
            refresh = max(expiry - now - 1, 1.0)
        return ResponseLease(capacity, expiry, refresh)

    def _decide(self, res: SimResource, client_id: str, wants: float,
                has_capacity: float, subclients: int) -> ResponseLease:
        """Insert the demand and run the resource's algorithm (or the
        learning-mode replay), stamping sim lease rules."""
        now = self.sim.clock.get_time()
        available = res.has.capacity if res.has is not None else 0.0

        if res.learning_expiry >= now:
            gets = has_capacity
            self.sim.varz.counter("server.learning_mode_response").inc()
        else:
            algo = get_algorithm(res.template.algorithm)
            # The framework's scalar algorithms run against the shared
            # store with the server's own lease as the capacity baseline.
            lease = algo(
                res.store, available,
                Request(client_id, has_capacity, wants, subclients),
            )
            gets = lease.has
            self.sim.varz.counter("server.algorithm_runs").inc()

        out = self._create_lease(res, gets)
        # (Re)assign with the clamped expiry so store cleanup follows the
        # sim's lease rules; keep whatever priority the algorithm recorded.
        res.store.assign(
            client_id,
            out.expiry_time - now,
            out.refresh_interval,
            gets,
            wants,
            subclients,
            priority=res.store.get(client_id).priority,
        )
        return out

    # -- RPCs ----------------------------------------------------------

    def Discovery_RPC(self, client_id: str, resource_ids: List[str]):
        """Returns (master_id or None, {resource_id: safe_capacity})."""
        master = self.job.get_master()
        safe = {}
        for rid in resource_ids:
            t = self.config.find(rid)
            if t is not None and t.HasField("safe_capacity"):
                safe[rid] = t.safe_capacity
        if master is None:
            self.sim.varz.counter("server.incomplete_discovery_response").inc()
        return (master.server_id if master else None), safe

    def _handle_capacity(self, caller_id: str, requests, subclients_of) -> (
        Optional[Dict[str, ResponseLease]]
    ):
        """Common GetCapacity/GetServerCapacity path: throttle, update
        state, decide. requests: [(resource_id, wants, has_capacity)]."""
        if not self.is_master():
            self.sim.varz.counter("server.not_master_response").inc()
            return None
        now = self.sim.clock.get_time()
        self._cleanup()
        out: Dict[str, ResponseLease] = {}
        for resource_id, wants, has_capacity in requests:
            res = self.find_resource(resource_id)
            if res is None:
                # Unmanaged resource: grant verbatim.
                log.warning(
                    "%s request for unmanaged resource %s",
                    self.server_id, resource_id,
                )
                out[resource_id] = ResponseLease(
                    wants, now + DEFAULT_LEASE_UNKNOWN_RESOURCE,
                    DEFAULT_REFRESH_INTERVAL,
                )
                continue
            last = res.last_request.get(caller_id)
            if last is not None and now - last < MINIMUM_REQUEST_INTERVAL:
                self.sim.varz.counter("server.throttled_request").inc()
                continue
            res.last_request[caller_id] = now
            out[resource_id] = self._decide(
                res, caller_id, wants, has_capacity, subclients_of(resource_id)
            )
        return out

    def GetCapacity_RPC(self, client_id: str, requests):
        """requests: [(resource_id, wants, has_capacity)]. Returns
        {resource_id: (ResponseLease, safe_capacity or None)} or None when
        not master."""
        grants = self._handle_capacity(client_id, requests, lambda rid: 1)
        if grants is None:
            return None
        out = {}
        for rid, lease in grants.items():
            template = self.config.find(rid)
            safe = (
                template.safe_capacity
                if template is not None and template.HasField("safe_capacity")
                else None
            )
            out[rid] = (lease, safe)
        return out

    def GetServerCapacity_RPC(self, server_id: str, requests):
        """requests: [(resource_id, bands, has_capacity)] where bands is
        [(priority, num_clients, wants)]. Returns {resource_id:
        ResponseLease} or None when not master."""
        flat = []
        subclients = {}
        for resource_id, bands, has_capacity in requests:
            wants_total = sum(w for _, _, w in bands)
            subclients[resource_id] = max(
                sum(n for _, n, _ in bands), 1
            )
            flat.append((resource_id, wants_total, has_capacity))
        return self._handle_capacity(
            server_id, flat, lambda rid: subclients[rid]
        )

    # -- own capacity refresh (the server tree edge) ---------------------

    def _discover_downstream(self) -> bool:
        master_id, _ = self.downstream_job.get_random_task().Discovery_RPC(
            self.server_id, []
        )
        if master_id is None:
            self.master = None
            self.sim.varz.counter("server.discovery_failure").inc()
            return False
        self.master = self.downstream_job.get_task_by_name(master_id)
        return True

    def _get_capacity(self) -> bool:
        now = self.sim.clock.get_time()
        if self.level == 0:
            # Root: capacity comes from the configuration; the old lease is
            # discarded first (no clamping against it) and the refresh
            # interval doubled (reference server.py:221-234).
            for res in self.resources.values():
                res.has = None
                lease = self._create_lease(res, res.template.capacity)
                lease.refresh_interval *= 2
                res.has = lease
            return True
        # Non-root: lease capacity from the downstream master.
        requests = []
        for rid, res in self.resources.items():
            status = res.store
            bands = [(1, max(status.count, 1), status.sum_wants)]
            has_cap = res.has.capacity if res.has is not None else 0.0
            requests.append((rid, bands, has_cap))
        if not requests:
            return True
        grants = self.master.GetServerCapacity_RPC(self.server_id, requests)
        if grants is None:
            return False
        for rid, lease in grants.items():
            self.resources[rid].has = lease
        return True

    def thread_continue(self) -> float:
        if not self.is_master():
            return END_OF_TIME
        if self.level > 0 and self.master is None:
            if not self._discover_downstream():
                return DEFAULT_DISCOVERY_INTERVAL
        if not self._get_capacity():
            self.master = None
            self.sim.varz.counter("server.reschedule_discovery").inc()
            return 0.0
        delay = min(
            (
                res.has.refresh_interval
                for res in self.resources.values()
                if res.has is not None
            ),
            default=DEFAULT_REFRESH_INTERVAL,
        )
        if delay <= 0:
            delay = DEFAULT_REFRESH_INTERVAL
        return delay


class ServerJob:
    """A job of N server tasks with a (randomly elected) master
    (reference simulation/server_job.py)."""

    def __init__(self, sim: Sim, job_name: str, level: int, size: int,
                 downstream_job=None, config: Optional[SimConfig] = None):
        self.sim = sim
        self.job_name = job_name
        self.tasks: Dict[str, SimServer] = {}
        self.master: Optional[SimServer] = None
        for _ in range(size):
            s = SimServer(sim, self, job_name, level, downstream_job, config)
            self.tasks[s.server_id] = s
        self.trigger_master_election()
        sim.server_jobs.append(self)

    def get_master(self) -> Optional[SimServer]:
        return self.master

    def get_task_by_name(self, name: str) -> SimServer:
        return self.tasks[name]

    def get_random_task(self) -> SimServer:
        return self.sim.random.choice(list(self.tasks.values()))

    def lose_master(self) -> None:
        """Fault injection: the master goes away; no successor elected."""
        if self.master is not None:
            self.master.lose_mastership()
            self.master = None

    def trigger_master_election(self) -> None:
        old = self.master
        self.master = self.get_random_task()
        if old is self.master:
            return
        if old is not None:
            old.lose_mastership()
        self.master.become_master()


class SimClient:
    """A simulated client (reference simulation/client.py): discovers the
    master, refreshes all its resources, randomly fluctuates wants."""

    def __init__(self, sim: Sim, name: str, downstream_job: ServerJob):
        self.sim = sim
        self.downstream_job = downstream_job
        self.client_id = sim.next_name("client", name)
        self.master: Optional[SimServer] = None
        # resource_id -> state dict(wants, priority, has: ResponseLease|None,
        #                           safe_capacity)
        self.resources: Dict[str, dict] = {}
        sim.clients.append(self)
        sim.scheduler.add_thread(self, 0.0)

    def add_resource(self, resource_id: str, priority: int, wants: float,
                     fraction: float = 0.0, interval: float = 1.0) -> None:
        assert resource_id not in self.resources
        self.resources[resource_id] = {
            "wants": wants, "priority": priority, "has": None,
            "safe_capacity": None,
        }
        if fraction > 0:
            self._change_wants(resource_id, fraction, interval)
        self.sim.scheduler.update_thread(self, 0.0)

    def _change_wants(self, resource_id: str, fraction: float,
                      interval: float) -> None:
        state = self.resources[resource_id]
        w = state["wants"]
        w += fraction * (1 - 2 * self.sim.random.random()) * w
        state["wants"] = max(w, 0.0)
        self.sim.varz.gauge(f"client.{self.client_id}.wants").set(
            state["wants"]
        )
        self.sim.scheduler.add_relative(
            interval, lambda: self._change_wants(resource_id, fraction, interval)
        )

    def set_wants(self, resource_id: str, wants: float) -> None:
        self.resources[resource_id]["wants"] = wants

    def get_wants(self, resource_id: str) -> float:
        return self.resources[resource_id]["wants"]

    def current_capacity(self, resource_id: str) -> float:
        has = self.resources[resource_id]["has"]
        return has.capacity if has is not None else 0.0

    def _discover(self) -> bool:
        task = self.downstream_job.get_random_task()
        master_id, safe = task.Discovery_RPC(
            self.client_id, list(self.resources)
        )
        for rid, cap in safe.items():
            self.resources[rid]["safe_capacity"] = cap
        if master_id is None:
            self.master = None
            self.sim.varz.counter("client.discovery_failure").inc()
            return False
        self.master = self.downstream_job.get_task_by_name(master_id)
        return True

    def _maybe_lease_expired(self, resource_id: str) -> None:
        state = self.resources.get(resource_id)
        if state is None or state["has"] is None:
            return
        if state["has"].expiry_time <= self.sim.clock.get_time():
            state["has"] = None
            self.sim.varz.counter("client.lease_expired").inc()

    def _get_capacity(self) -> bool:
        if not self.resources:
            return True
        requests = [
            (
                rid,
                state["wants"],
                state["has"].capacity if state["has"] is not None else 0.0,
            )
            for rid, state in self.resources.items()
        ]
        out = self.master.GetCapacity_RPC(self.client_id, requests)
        if out is None:
            self.sim.varz.counter("client.GetCapacity_RPC.failure").inc()
            return False
        for rid, (lease, safe) in out.items():
            state = self.resources[rid]
            state["has"] = lease
            state["safe_capacity"] = safe
            self.sim.scheduler.add_absolute(
                lease.expiry_time, lambda rid=rid: self._maybe_lease_expired(rid)
            )
        return True

    def thread_continue(self) -> float:
        if self.master is None:
            if not self._discover():
                return DEFAULT_DISCOVERY_INTERVAL
        if not self._get_capacity():
            self.master = None
            return 0.0
        delay = min(
            (
                s["has"].refresh_interval
                for s in self.resources.values()
                if s["has"] is not None
            ),
            default=DEFAULT_REFRESH_INTERVAL,
        )
        if delay <= 0:
            self.sim.varz.counter("client.improbable.delay").inc()
            delay = DEFAULT_REFRESH_INTERVAL
        return delay
