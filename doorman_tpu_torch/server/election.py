"""Master election.

Capability parity with reference go/server/election/election.go:29-172:
an Election is something a server runs; it reports mastership changes and
the identity of the current master. Two implementations:

  * TrivialElection — the participant wins immediately (single-server
    deployments, tests).
  * KVElection — the reference's etcd flow (TTL'd lock key: acquire with
    set-if-absent, renew every ttl/3, watch broadcasts the holder)
    generalized over an abstract LeaseKV so the failover state machine is
    testable without an etcd cluster. EtcdKV speaks the etcd v3 gateway
    (shared client server/etcd.py — the same API generation the config
    source uses) when an etcd endpoint is actually available; InMemoryKV
    backs tests and multi-server single-process setups.

Host-only (standard library and server/etcd.py): a copy of the JAX
package's module, import paths aside.
"""

from __future__ import annotations

import abc
import asyncio
import logging
import time
from typing import Awaitable, Callable, Dict, Optional, Tuple

from doorman_tpu_torch.server.etcd import EtcdGateway

log = logging.getLogger(__name__)

IsMasterCallback = Callable[[bool], Awaitable[None]]
CurrentMasterCallback = Callable[[str], Awaitable[None]]


def shard_lock_key(lock: str, shard: int) -> str:
    """The per-shard election lease key of a federated deployment:
    shard k's candidates campaign for `<lock>/shard<k>` instead of the
    single root lock, so each shard runs its OWN mastership (N
    concurrent masters, one per shard, off one etcd namespace) and a
    shard's failover never disturbs the others. Shard -1 (or any
    negative) means "not federated" and returns the lock unchanged."""
    if shard < 0:
        return lock
    return f"{lock.rstrip('/')}/shard{int(shard)}"


class Election(abc.ABC):
    """A master election. `run` starts campaigning and returns immediately;
    outcomes are delivered through the callbacks (mirrors the reference's
    IsMaster()/Current() channels)."""

    @abc.abstractmethod
    async def run(
        self,
        id: str,
        on_is_master: IsMasterCallback,
        on_current: CurrentMasterCallback,
    ) -> None:
        ...

    async def stop(self) -> None:
        pass


class TrivialElection(Election):
    """The participant immediately wins (reference election.go:51-73)."""

    def __str__(self) -> str:
        return "no election, acting as the master"

    async def run(self, id, on_is_master, on_current) -> None:
        await on_is_master(True)
        await on_current(id)


class LeaseKV(abc.ABC):
    """A tiny TTL'd-key store: just enough of etcd for the election."""

    @abc.abstractmethod
    async def acquire(self, key: str, value: str, ttl: float) -> bool:
        """Set key=value with ttl iff the key does not exist (or has
        expired). Returns True on success."""

    @abc.abstractmethod
    async def refresh(self, key: str, value: str, ttl: float) -> bool:
        """Extend the ttl iff the key still holds `value`."""

    @abc.abstractmethod
    async def get(self, key: str) -> Optional[str]:
        """Current live value of the key, or None."""

    async def wait_for_change(self, key: str, timeout: float) -> None:
        """Block until the key (probably) changed, or `timeout`. The
        default is a plain sleep (polling); KVs with a real watch (etcd)
        override it so the election's current-master broadcast follows
        changes instantly, like the reference's watcher goroutine
        (election.go:141-170)."""
        await asyncio.sleep(timeout)


class InMemoryKV(LeaseKV):
    """Process-local LeaseKV for tests and single-process multi-server
    topologies. Supports fault injection via `expire`."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._data: Dict[str, Tuple[str, float]] = {}

    def _live(self, key: str) -> Optional[str]:
        entry = self._data.get(key)
        if entry is None:
            return None
        value, expiry = entry
        if expiry <= self._clock():
            del self._data[key]
            return None
        return value

    async def acquire(self, key, value, ttl) -> bool:
        if self._live(key) is not None:
            return False
        self._data[key] = (value, self._clock() + ttl)
        return True

    async def refresh(self, key, value, ttl) -> bool:
        if self._live(key) != value:
            return False
        self._data[key] = (value, self._clock() + ttl)
        return True

    async def get(self, key) -> Optional[str]:
        return self._live(key)

    def expire(self, key: str) -> None:
        """Fault injection: drop the lock as if its TTL lapsed."""
        self._data.pop(key, None)


class EtcdKV(LeaseKV):
    """etcd v3 LeaseKV over the shared gateway client (server/etcd.py).

    The reference election used its era's v2 client with a TTL'd key
    (election.go:112-171); the v3 idiom for the same lock is a lease:
    acquire = lease grant + transactional create (put iff the key does
    not exist), refresh = lease keepalive (the key dies with the lease),
    get = range read. Blocking HTTP runs in the default executor with a
    short per-request timeout: renewal failure must be observed well
    inside the lock TTL, or a partitioned master keeps acting as master
    after a standby wins (the v2 client's 5s timeout had the same
    role)."""

    # Cap for any single gateway HTTP request (the gateway splits it
    # across endpoints on failover). Mastership-loss detection must fit
    # inside KVElection's renewal cadence (ttl/3 with ttl defaulting to
    # 10s), not the gateway's lenient config-watch default — so each
    # OPERATION also gets an overall budget, sized to the number of
    # sequential RPCs it issues (refresh: a 0.5*ttl window covering a
    # 0.32*ttl first attempt plus one transient-failure retry, see
    # refresh(); acquire, which is not on the loss-detection path, gets
    # 3x REQUEST_TIMEOUT for its get + lease-grant + transactional-put
    # sequence). Budgeting each request off the operation's shared
    # deadline keeps the sum inside the budget instead of stacking
    # per-request timeouts past the lock TTL and re-opening the
    # split-brain window.
    REQUEST_TIMEOUT = 5.0

    def __init__(self, endpoints: list[str],
                 gateway: Optional[EtcdGateway] = None):
        """`gateway` substitutes a pre-built gateway client (the chaos
        harness injects a fault-wrapping one); default builds the
        shared EtcdGateway over `endpoints`."""
        self._gw = gateway or EtcdGateway(endpoints)
        self._leases: Dict[str, int] = {}  # lock key -> held lease id
        self._fast_watches = 0  # consecutive instant watch returns

    def _per_request(self, budget: float) -> Callable[[], float]:
        """Per-HTTP-request timeouts drawn from one operation deadline:
        each call gets the remaining budget (capped at REQUEST_TIMEOUT,
        floored so a nearly-exhausted deadline still issues ONE fast
        request rather than one that cannot succeed at all — the floor
        is sized per endpoint because the gateway splits it across its
        failover list). After that one floored request the closure
        RAISES: the caller's wait_for has already abandoned the
        executor thread by then, and an unbounded floor would let that
        orphan keep hammering etcd endpoints with doomed requests for
        the rest of its sequence during a partition."""
        # Wall clock by design (here and below): these budgets pace real
        # etcd sockets. Chaos virtualizes time ABOVE this seam, at the
        # election-KV / gateway injectors, so replays never reach these.
        end = time.monotonic() + budget  # doorman: allow[seeded-determinism]
        floor = 0.1 * len(self._gw.endpoints)
        floored = [False]

        def t() -> float:
            remaining = end - time.monotonic()  # doorman: allow[seeded-determinism]
            if remaining <= 0:
                if floored[0]:
                    raise TimeoutError(
                        "etcd operation budget exhausted "
                        f"({budget:.1f}s); abandoning the sequence"
                    )
                floored[0] = True
                return floor
            return max(min(self.REQUEST_TIMEOUT, remaining), floor)

        return t

    async def _call(self, fn, budget: float):
        try:
            # Slack over the inner budget: requests that hit the
            # deadline floor should resolve (or fail) on their own and
            # surface their real outcome, not be abandoned mid-flight.
            return await asyncio.wait_for(
                asyncio.get_running_loop().run_in_executor(None, fn),
                budget + min(1.0, budget / 4),
            )
        except Exception as e:
            # Failures are expected during partitions, but silence here
            # would make a misconfigured endpoint list undiagnosable —
            # the campaign loop would just never win, quietly.
            log.warning("etcd election request failed: %r", e)
            return None

    def _revoke_quietly(self, lease_id: int) -> bool:
        """Best-effort lease revoke at the full REQUEST_TIMEOUT — OFF
        any operation budget, because cleanup matters most precisely
        when the budget is already spent. Returns True when etcd
        confirmed the revoke (callers use this to decide whether their
        backstop must stay armed); on False the TTL is the backstop."""
        try:
            self._gw.lease_revoke(lease_id, timeout=self.REQUEST_TIMEOUT)
            return True
        except Exception:
            return False

    def _spawn_revoke(self, lease_id: "int | None") -> None:
        """Best-effort background revoke of a lease whose operation we
        abandoned (asyncio.wait_for cannot cancel the executor thread,
        and the thread's etcd side effects — a granted lease, a
        just-extended TTL, even a lock acquired after we gave up on it
        — would otherwise pin a stale key for a full TTL with nobody
        renewing it)."""
        if not lease_id:
            return
        try:
            asyncio.get_running_loop().run_in_executor(
                None, lambda: self._revoke_quietly(lease_id)
            )
        except RuntimeError:
            pass  # loop shutting down

    async def acquire(self, key, value, ttl) -> bool:
        budget = 3.0 * self.REQUEST_TIMEOUT
        t = self._per_request(budget)
        # Shared with the executor thread: `lease` is the granted lease
        # (if any), `abandoned` is set when the caller stops waiting.
        # Every interleaving must end with an unrenewed lock revoked:
        #   - timeout before the grant: caller sees lease=None (no-op),
        #     the thread later finds abandoned=True after its put and
        #     self-revokes;
        #   - timeout after the grant: the caller revokes the recorded
        #     lease AND the thread self-revokes on its abandoned check
        #     (double revoke of a dead lease is harmless);
        #   - clean race loss: the thread revokes inline and clears
        #     `lease`, so the caller does not issue a redundant revoke.
        state: Dict[str, object] = {"lease": None, "abandoned": False}

        def attempt() -> Optional[int]:
            # Cheap existence probe first: the standby's campaign loop
            # runs for the deployment's lifetime and the lock is almost
            # always held — don't churn lease grants on every cycle.
            if self._gw.get(key, timeout=t()) is not None:
                return None
            lease_id = self._gw.lease_grant(ttl, timeout=t())
            state["lease"] = lease_id
            try:
                won = self._gw.put_if_absent(
                    key, value, lease_id, timeout=t()
                )
            except Exception:
                # The put may have COMMITTED in etcd even though the
                # response was lost: revoke so a lock nobody will renew
                # cannot survive, then surface the failure. `lease`
                # stays recorded when the revoke fails so the caller's
                # _spawn_revoke backstop still fires.
                if self._revoke_quietly(lease_id):
                    state["lease"] = None
                raise
            if state["abandoned"] or not won:
                if self._revoke_quietly(lease_id):
                    state["lease"] = None
                return None
            return lease_id

        try:
            lease_id = await self._call(attempt, budget)
        except asyncio.CancelledError:
            # stop() during an in-flight campaign: the executor thread
            # may still win the lock after we are gone. Mark it
            # abandoned (the thread self-revokes on its check) and
            # backstop any already-granted lease ourselves.
            state["abandoned"] = True
            self._spawn_revoke(state["lease"])
            raise
        if lease_id is None:
            # We are about to report "not master": no lock created by
            # the (possibly still-running) thread may survive unrenewed.
            state["abandoned"] = True
            self._spawn_revoke(state["lease"])
            return False
        self._leases[key] = lease_id
        return True

    async def refresh(self, key, value, ttl) -> bool:
        lease_id = self._leases.get(key)
        if lease_id is None:
            return False
        # The loss-detection path: sleep(ttl/3) + this operation must
        # conclude well before the lock TTL lapses and a standby wins;
        # the WHOLE operation (slack included) fits a 0.5*ttl window so
        # the worst case stays ~0.83*ttl. Within that window a single
        # TRANSIENT failure — an executor thread starved by a
        # concurrent XLA compile, one dropped etcd round-trip — retries
        # instead of reading as mastership loss (small-TTL elections
        # flapped under load without this). The FIRST attempt gets the
        # lion's share (0.32*ttl, +_call's budget/4 slack = 0.4*ttl —
        # the previous single-attempt tolerance, so a slow-but-healthy
        # etcd still succeeds first try); the retry runs in whatever
        # window remains, which is nearly everything when the first
        # attempt failed fast. DEFINITE losses (lease TTL 0, key not
        # ours) never retry.
        deadline = time.monotonic() + 0.5 * ttl  # doorman: allow[seeded-determinism]
        budget = min(self.REQUEST_TIMEOUT, 0.32 * ttl)

        outcome: "bool | None" = None
        for attempt in range(2):
            t = self._per_request(budget)

            def renew() -> "bool | None":
                if self._gw.lease_keepalive(lease_id, timeout=t()) <= 0:
                    return False  # lease gone: definite loss
                # The LeaseKV contract: extend iff the key still holds
                # OUR value. A lease can outlive the key (operator
                # `etcdctl del` to force a new election, or an
                # overwrite): renewing on the lease alone would leave
                # two masters.
                try:
                    held = self._gw.get(key, timeout=t())
                except Exception:
                    return None  # can't verify ownership: transient
                ours = held is not None and held.decode() == value
                if not ours:
                    # The keepalive above just re-extended the lease to
                    # a full TTL; abandoning it now would pin a stale
                    # lock key for that long with nobody renewing — a
                    # full-TTL leaderless window. Release it so
                    # re-election is immediate.
                    self._revoke_quietly(lease_id)
                return ours

            try:
                outcome = await self._call(renew, budget)
            except asyncio.CancelledError:
                # stop() mid-renewal: the thread's keepalive may have
                # just extended the lease to a full TTL; do not leave
                # it pinned by a master that no longer exists.
                self._spawn_revoke(lease_id)
                self._leases.pop(key, None)
                raise
            if outcome is not None:
                break
            remaining = deadline - time.monotonic()  # doorman: allow[seeded-determinism]
            if remaining <= 0.05 * ttl:
                break  # no meaningful retry window left
            budget = min(self.REQUEST_TIMEOUT, remaining / 1.25)
        ok = bool(outcome)
        if not ok:
            # Mastership is lost; a fresh acquire grants a fresh lease.
            # The thread may still be mid-renewal (timeout), or its own
            # step-down revoke may have failed: backstop-revoke on every
            # failure (revoking a dead lease is harmless) so the lock is
            # not pinned by a master that has already stepped down.
            self._spawn_revoke(lease_id)
            self._leases.pop(key, None)
            return False
        return True

    async def get(self, key) -> Optional[str]:
        value = await self._call(
            lambda: self._gw.get(key, timeout=self.REQUEST_TIMEOUT),
            self.REQUEST_TIMEOUT,
        )
        return value.decode() if value is not None else None

    async def wait_for_change(self, key, timeout) -> None:
        """Real etcd watch: returns as soon as the lock key changes, so
        mastership broadcasts propagate in RPC time rather than a poll
        interval. Falls back to a sleep when the watch cannot be
        established (partition), and rate-limits consecutive instant
        returns — an endpoint whose /v3/watch answers immediately with
        an error body or a closed stream reports "success" per the
        gateway's lenient contract, and without a floor the watch loop
        would hammer etcd back-to-back (the polling default this
        replaced was bounded to one get per interval)."""
        start = time.monotonic()  # doorman: allow[seeded-determinism]
        ok = False
        try:
            ok = await asyncio.get_running_loop().run_in_executor(
                None,
                lambda: self._gw.wait_for_change(key, timeout=timeout),
            )
        except Exception:
            ok = False
        if not ok:
            self._fast_watches = 0
            await asyncio.sleep(min(timeout, 1.0))
            return
        if time.monotonic() - start < 0.05:  # doorman: allow[seeded-determinism]
            # A genuine change can return this fast once or twice in a
            # row (re-election storm); only a degenerate watch does so
            # indefinitely. Escalate to the full poll interval then.
            self._fast_watches += 1
            await asyncio.sleep(
                min(timeout, 1.0)
                if self._fast_watches >= 5
                else 0.05
            )
        else:
            self._fast_watches = 0


class KVElection(Election):
    """TTL-lock election over a LeaseKV (reference election.go:89-172):
    campaign with acquire, renew every ttl/3, report loss when a renewal
    fails; a watcher polls the key and broadcasts the current master."""

    def __init__(self, kv: LeaseKV, lock: str, ttl: float = 10.0):
        self._kv = kv
        self._lock = lock
        self._ttl = ttl
        self._tasks: list[asyncio.Task] = []

    def __str__(self) -> str:
        return f"kv lock: {self._lock} (ttl {self._ttl}s)"

    async def run(self, id, on_is_master, on_current) -> None:
        self._tasks.append(
            asyncio.create_task(self._campaign(id, on_is_master))
        )
        self._tasks.append(asyncio.create_task(self._watch(on_current)))

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()

    async def _campaign(self, id: str, on_is_master: IsMasterCallback) -> None:
        while True:
            if not await self._kv.acquire(self._lock, id, self._ttl):
                await asyncio.sleep(self._ttl)
                continue
            await on_is_master(True)
            while True:
                await asyncio.sleep(self._ttl / 3)
                if not await self._kv.refresh(self._lock, id, self._ttl):
                    await on_is_master(False)
                    break

    async def _watch(self, on_current: CurrentMasterCallback) -> None:
        last: Optional[str] = None
        while True:
            current = await self._kv.get(self._lock)
            value = current or ""
            if value != last:
                last = value
                await on_current(value)
            # A real watch (etcd) returns the moment the lock changes;
            # the plain-KV default sleeps the poll interval (reference
            # watcher goroutine, election.go:141-170).
            await self._kv.wait_for_change(
                self._lock, min(1.0, self._ttl / 3)
            )
