"""Invariants evaluated every chaos tick.

Four families, each with its documented slack:

  * capacity: per resource on each master, Σ live grants <= the largest
    capacity the resource carried within the last lease_length of
    virtual time. The window IS the contract: a grant issued under the
    old capacity legitimately lives until its lease lapses, so a
    capacity cut (or a parent-lease expiry zeroing an intermediate)
    tightens the bound only as old leases drain. Learning-mode
    resources are exempt while learning (the server deliberately grants
    whatever clients claim — server.go:438-455's relearning window).
  * single-master: at most one member of an election group believes it
    is master at any tick. No slack: two masters is the split-brain
    this whole subsystem exists to catch.
  * lease lag-never-lead: a client's believed capacity must be a value
    the serving master actually granted that client within the last
    lease_length (client state may LAG the server by a refresh
    interval, but a capacity the server never issued means forged or
    corrupted grants); held leases' expiry never moves backwards.
  * reconvergence (checked by the runner): after the plan heals, client
    allocations return to the fault-free baseline within the plan's
    reconverge budget.
  * admission (admission-enabled plans): the shed matrix is law —
    ReleaseCapacity and GetServerCapacity are NEVER shed (a shed
    release pins a dead client's capacity; a shed server aggregate
    starves a whole subtree), and the top priority band's GetCapacity
    shed count stays zero whenever lower bands exist (the goodput
    floor: overload shedding walks UP from the bottom band and never
    reaches the top while there is anything below it to shed).
    Deadline fast-fails are excluded — a request that brought too
    short a deadline was refused on its own terms, not the band's.
  * warm restore (persistence-enabled plans): every master takeover that
    restored state must land capacity-safe — per restored resource,
    sum(restored grants) <= the live capacity at restore (no learning
    slack here: the clamp in persist/restore.py is unconditional) — and
    a resource the restore reported as learning-skipped must actually be
    OUT of learning mode (a skip that silently fell back to learning
    would pass the capacity checks while eating the whole cold-path
    window the plan's reconverge budget excludes).

Port of doorman_tpu/chaos/invariants.py: a copy apart from import paths.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

EPS = 1e-6


@dataclass(frozen=True)
class Violation:
    tick: int
    invariant: str
    subject: str
    detail: str

    def as_log(self) -> list:
        return ["violation", self.invariant, self.subject, self.detail]


class _Window:
    """Max over observations within a trailing virtual-time window."""

    def __init__(self, span: float):
        self.span = span
        self._obs: List[Tuple[float, float]] = []  # (time, value)

    def observe(self, now: float, value: float) -> float:
        self._obs.append((now, value))
        cutoff = now - self.span
        self._obs = [(t, v) for t, v in self._obs if t >= cutoff]
        return max(v for _, v in self._obs)


class InvariantChecker:
    def __init__(self, clock, *, lease_length: float):
        self._clock = clock
        self._lease_length = lease_length
        self._cap_windows: Dict[str, _Window] = {}
        # (resource, client) -> recent server-granted values
        self._grant_windows: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
        # (server, resource, client) -> last seen expiry (monotonicity)
        self._expiries: Dict[Tuple[str, str, str], float] = {}
        self._expiry_regressions: List = []
        # Restore summaries already validated (by object identity: a
        # server keeps one summary per takeover).
        self._checked_restores: set = set()
        # Admission tallies only grow; report each offending key once,
        # not once per subsequent tick.
        self._reported_admission: set = set()

    # -- per-tick entry point ------------------------------------------

    def check_tick(
        self,
        tick: int,
        servers: Dict[str, object],       # logical name -> CapacityServer
        election_groups: List[List[str]], # names sharing one lock
        clients: List[object],            # chaos-driven Client objects
    ) -> List[Violation]:
        out: List[Violation] = []
        out += self._check_single_master(tick, servers, election_groups)
        out += self._check_capacity(tick, servers)
        out += self._check_restores(tick, servers)
        out += self._check_admission(tick, servers)
        self._record_grants(servers)
        out += self._check_lag_never_lead(tick, clients)
        return out

    # -- federation -----------------------------------------------------

    def check_federation(
        self,
        tick: int,
        shard_servers: Dict[str, object],
        straddle: Dict[str, float],
    ) -> List[Violation]:
        """The capacity-sum invariant of the federated tree: for every
        straddling resource, the grants outstanding across ALL shards
        sum to at most the configured capacity — on every tick,
        partition or not. No lease-window slack here: the reconciler's
        contract is that shares sum under capacity and a lost shard's
        share stays charged through its drain window, so the bound
        holds pointwise (doc/federation.md, "The invariant")."""
        out: List[Violation] = []
        for rid, capacity in straddle.items():
            total = 0.0
            holders = []
            for name, server in sorted(shard_servers.items()):
                res = server.resources.get(rid)
                if res is None:
                    continue
                res.store.clean()
                if res.store.sum_has:
                    holders.append(f"{name}={res.store.sum_has:.6f}")
                total += res.store.sum_has
            if total > capacity + EPS:
                out.append(Violation(
                    tick, "fed_capacity_sum", rid,
                    f"Σ shard grants {total:.6f} > configured "
                    f"capacity {capacity:.6f} ({', '.join(holders)})",
                ))
        return out

    # -- admission ------------------------------------------------------

    def _check_admission(self, tick, servers) -> List[Violation]:
        out = []
        for name, server in servers.items():
            adm = getattr(server, "_admission", None)
            if adm is None:
                continue
            gc_bands = [
                band for (method, band) in adm.tallies
                if method == "GetCapacity"
            ]
            top = max(gc_bands) if gc_bands else None
            for (method, band), counts in adm.tallies.items():
                if counts["shed"] == 0:
                    continue
                key = (name, method, band)
                if key in self._reported_admission:
                    continue
                if method in ("ReleaseCapacity", "GetServerCapacity"):
                    self._reported_admission.add(key)
                    out.append(Violation(
                        tick, "releases_never_shed",
                        f"{name}/{method}",
                        f"{counts['shed']} {method} RPC(s) shed — the "
                        "shed matrix forbids shedding this method",
                    ))
                elif (
                    method == "GetCapacity"
                    and band == top
                    and len(set(gc_bands)) > 1
                ):
                    self._reported_admission.add(key)
                    out.append(Violation(
                        tick, "top_band_floor", f"{name}/band{band}",
                        f"top band {band} shed {counts['shed']} "
                        "request(s) while lower bands existed to shed "
                        "first",
                    ))
        return out

    # -- warm restore ---------------------------------------------------

    def _check_restores(self, tick, servers) -> List[Violation]:
        out = []
        for name, server in servers.items():
            summary = getattr(server, "last_restore", None)
            if summary is None or id(summary) in self._checked_restores:
                continue
            self._checked_restores.add(id(summary))
            for rid, info in summary.get("resources", {}).items():
                if (
                    info["capacity"] > 0
                    and info["sum_has"] > info["capacity"] + EPS
                ):
                    out.append(Violation(
                        tick, "restore_capacity", f"{name}/{rid}",
                        f"restored sum(grants)={info['sum_has']:.6f} > "
                        f"capacity={info['capacity']:.6f}",
                    ))
                res = server.resources.get(rid)
                if (
                    info["learning"] == "skip"
                    and res is not None
                    and res.in_learning_mode
                ):
                    out.append(Violation(
                        tick, "warm_learning", f"{name}/{rid}",
                        "restore reported learning skipped but the "
                        "resource is in learning mode",
                    ))
        return out

    # -- single master --------------------------------------------------

    def _check_single_master(self, tick, servers, groups) -> List[Violation]:
        out = []
        for group in groups:
            masters = [n for n in group if servers[n].is_master]
            if len(masters) > 1:
                out.append(Violation(
                    tick, "single_master", ",".join(sorted(masters)),
                    f"{len(masters)} concurrent masters",
                ))
        return out

    # -- capacity -------------------------------------------------------

    def _check_capacity(self, tick, servers) -> List[Violation]:
        now = self._clock()
        out = []
        for name, server in servers.items():
            if not server.is_master:
                continue
            for rid, res in server.resources.items():
                res.store.clean()
                window = self._cap_windows.setdefault(
                    f"{name}/{rid}", _Window(self._lease_length)
                )
                allowed = window.observe(now, res.capacity)
                if res.in_learning_mode:
                    continue  # documented learning-mode slack
                total = res.store.sum_has
                if total > allowed + EPS:
                    out.append(Violation(
                        tick, "capacity", f"{name}/{rid}",
                        f"sum(grants)={total:.6f} > allowed={allowed:.6f}",
                    ))
        return out

    # -- lag but never lead ---------------------------------------------

    def _record_grants(self, servers) -> None:
        """Record every grant each master currently holds, so client
        beliefs can be validated against what was actually issued."""
        now = self._clock()
        cutoff = now - self._lease_length
        live_keys = set()
        for name, server in servers.items():
            for rid, res in server.resources.items():
                length = res._lease_length
                for client, lease in res.store.items():
                    key = (rid, client)
                    win = self._grant_windows.setdefault(key, [])
                    win.append((now, lease.has))
                    self._grant_windows[key] = [
                        (t, v) for t, v in win if t >= cutoff
                    ]
                    ekey = (name, rid, client)
                    live_keys.add(ekey)
                    prev = self._expiries.get(ekey)
                    # Monotonicity holds only under constant config: a
                    # re-templated lease_length (an intermediate's first
                    # parent exchange shortens the self-config default)
                    # legitimately re-anchors expiries.
                    last = None
                    if prev is not None and prev[1] == length:
                        last = prev[0]
                    if last is not None and lease.expiry < last - EPS:
                        # Flagged through check via the stored marker:
                        # expiry regressions are recorded here and
                        # surfaced by _check_lag_never_lead's sweep.
                        self._expiry_regressions.append(
                            (self._clock(), ekey, last, lease.expiry)
                        )
                    self._expiries[ekey] = (lease.expiry, length)
        # Leases released or lapsed may legitimately restart lower.
        for key in list(self._expiries):
            if key not in live_keys:
                del self._expiries[key]

    def _check_lag_never_lead(self, tick, clients) -> List[Violation]:
        out = []
        regressions, self._expiry_regressions = self._expiry_regressions, []
        for _, (name, rid, client), last, new in regressions:
            out.append(Violation(
                tick, "lease_monotonicity", f"{name}/{rid}/{client}",
                f"expiry moved backwards {last:.3f} -> {new:.3f}",
            ))
        for cl in clients:
            for rid, res in cl.resources.items():
                if res.lease is None:
                    # Outage fallback: the client serves safe capacity
                    # (or 0) by construction; nothing to lead with.
                    continue
                believed = res.lease.capacity
                issued = [
                    v for _, v in self._grant_windows.get((rid, cl.id), [])
                ]
                if not issued:
                    # The master's state was wiped (failover) and the
                    # client still holds a pre-wipe lease: allowed to
                    # lag until refresh or expiry.
                    continue
                if not any(abs(believed - v) <= EPS for v in issued):
                    out.append(Violation(
                        tick, "lag_never_lead", f"{rid}/{cl.id}",
                        f"client believes {believed:.6f}, never issued "
                        f"within the window (issued={sorted(set(round(v, 6) for v in issued))})",
                    ))
        return out
