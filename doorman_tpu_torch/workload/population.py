"""Array-backed macro-client population for the workload harness.

The per-client engine steps one real `Client` per macro client per
tick (`harness._refresh_clients`): a million-client tick is a million
awaited RPCs, which ROADMAP.md names as the driver ceiling now that
the serving plane can hold the streams. This module replaces the
coroutines with a table: every per-client fact the refresh loop reads
— band, wants, client-side lease (has / expiry / fallback / safe
capacity), server-side lease mirror, region RTT, shard pin — lives in
one numpy column, and a tick refreshes the due set with a handful of
batched calls into the server's bulk decide seam
(`CapacityServer.decide_bulk` -> `coalesce.decide_grouped_arrays`,
falling back to the sequential `decide_grouped`).

Parity contract (the vector-vs-clients `log_sha256` pin in
tests/test_torch_workload_population.py): with ``refresh_spread == 1`` this
engine is byte-identical to the per-client path, because every
observable effect is replayed in the same order —

  * rows are append-only and stepped in row (= insertion) order, the
    order `dict` iteration gives the per-client loop; a departed id
    that re-arrives gets a NEW row, exactly like a dict pop+reinsert;
  * admission draws come from the same shared controller RNG in due
    order (`Admission.check_get_capacity_many`; per-row
    `check_get_capacity_band` when federation makes several
    controllers share the stream), before any decide — decides draw no
    randomness, so batching the draws preserves the sequence;
  * store mutations replay through `decide_bulk`, whose array pass is
    grant-exact with the sequential path (see
    coalesce.decide_grouped_arrays' exactness argument) and whose
    fallback IS the sequential path;
  * client-side lease semantics mirror client.py exactly: expiry is
    the response's ``int()``-truncated ``expiry_time`` (np.floor for
    positive floats), a FAILED refresh keeps leases and only an
    expired one (strict ``expiry < now``) falls back to the last
    server-sent safe capacity (or 0.0), and a successful refresh
    clears the fallback;
  * the RTT jitter draws (`meas_rng`) happen per due rtt-carrying row
    in row order — the same subsequence the per-client loop draws.

Routing replays the connection layer's redirect chase without the
RPCs, including its stickiness: each row carries the server its
virtual `Connection` is parked on (`conn`, -1 = no channel yet, which
dials the shard seed like `Connection.addr`), and a refresh follows
``current_master`` address pointers from there — parking on every hop
exactly as `Connection._connect` does, failing with the row parked in
place when a pointer is empty (`MasterUnknown`) or the 5-hop sleepless
budget runs out. The distinction matters at a mastership flip: a row
parked on the old master fails that tick if the old master's pointer
is still empty, even though the new master already holds the lock —
the same one-tick blindness the per-client path exhibits (harness
clients run with ``max_retries=0``, so one chase per refresh).
Departures replay `Client.close()`: one ReleaseCapacity against the
current master (never shed, `note_pass_through` + store release), or
nothing when there is no master — leases then self-expire.

Scale discipline (the `workload_population_scaling` bench row): a tick
must cost O(due set), never O(population). Due selection is a
deadline wheel (`refresh_spread` buckets of row indices, compacted as
rows die); the expired-lease precondition is a lazy scalar lower
bound over the mirrored server expiries (recomputed only when the
clock passes it); native client handles are interned once per row per
engine generation and passed as arrays, so the fast path never
materializes a million id strings.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from doorman_tpu_torch.proto import doorman_pb2 as pb

__all__ = ["VectorPopulation"]

_NAN = float("nan")
_INF = float("inf")


class VectorPopulation:
    """The array population behind ``population_engine: "vector"``.

    Owns no servers and no sockets: the runner passes itself in, and
    the engine drives `runner.servers` in-process through the same
    handler-adjacent seams the loopback clients reach by RPC.
    """

    def __init__(self, runner):
        self.runner = runner
        spec = runner.spec
        self.rid = str(spec.resource)
        self.spread = max(1, int(spec.refresh_spread))
        self.fed = spec.federated_config() is not None
        self._n = 0
        self._cap = 0
        self._active_count = 0
        self._ids: List[str] = []
        self._row: Dict[str, int] = {}
        self._alloc(1024)
        # Deadline wheel: per-phase chunks of row indices (arrays from
        # bulk arrivals, one-element arrays from singles), compacted to
        # the live rows each time the bucket comes due.
        self._buckets: List[List[np.ndarray]] = [
            [] for _ in range(self.spread)
        ]
        # Rows awaiting their FIRST refresh ahead of their wheel slot
        # (spread > 1 only; at spread 1 every row is due every tick).
        self._pending_first: List[int] = []
        # Server-side mirror binding, one entry per shard group (the
        # non-federated topology is one group): which server+store the
        # srv_* mirrors describe. A mastership flip wipes the server's
        # resources, so a changed binding invalidates the mirrors.
        self._bound: Dict[int, tuple] = {}
        self._live: Dict[int, int] = {}
        self._srv_min: Dict[int, float] = {}
        # Native client-handle cache: (engine, row-aligned int64 array,
        # -1 = not interned against this engine generation).
        self._hcache: Optional[Tuple[object, np.ndarray]] = None
        # Proxy address -> server index, built on first chase (the
        # proxies do not exist yet when the runner constructs us).
        self._addr2idx: Optional[Dict[str, int]] = None
        # Introspection for tests and the scaling bench.
        self.step_walls: List[float] = []
        self.fast_rows_total = 0
        self.seq_rows_total = 0
        self.seq_ticks = 0

    # -- storage ---------------------------------------------------------

    def _alloc(self, cap: int) -> None:
        self.band = np.zeros(cap, np.int32)
        self.wants = np.zeros(cap, np.float64)
        self.rtt = np.full(cap, _NAN, np.float64)
        self.active = np.zeros(cap, bool)
        self.shard = np.zeros(cap, np.int32)
        # Client-side lease state (client.py's ClientResource).
        self.cli_has = np.zeros(cap, np.float64)
        self.cli_expiry = np.zeros(cap, np.float64)  # int()-cast values
        self.cli_lease = np.zeros(cap, bool)
        self.fallback = np.zeros(cap, np.float64)
        self.safe = np.zeros(cap, np.float64)
        self.has_safe = np.zeros(cap, bool)
        # Server-side lease mirror (exact floats out of decide_bulk).
        self.srv_has = np.zeros(cap, np.float64)
        self.srv_wants = np.zeros(cap, np.float64)
        self.srv_expiry = np.zeros(cap, np.float64)
        self.srv_live = np.zeros(cap, bool)
        # The server index this row's virtual Connection is parked on
        # (-1: no channel; the next chase dials the shard seed).
        self.conn = np.full(cap, -1, np.int32)
        self._cap = cap

    _COLUMNS = (
        "band", "wants", "rtt", "active", "shard", "cli_has",
        "cli_expiry", "cli_lease", "fallback", "safe", "has_safe",
        "srv_has", "srv_wants", "srv_expiry", "srv_live", "conn",
    )

    def _ensure(self, extra: int) -> None:
        need = self._n + extra
        if need <= self._cap:
            return
        cap = self._cap
        while cap < need:
            cap *= 2
        old = {name: getattr(self, name) for name in self._COLUMNS}
        self._alloc(cap)
        for name, arr in old.items():
            getattr(self, name)[: self._n] = arr[: self._n]
        if self._hcache is not None:
            engine, handles = self._hcache
            grown = np.full(cap, -1, np.int64)
            grown[: self._n] = handles[: self._n]
            self._hcache = (engine, grown)

    # -- the mutator surface (harness.arrive/depart/grant_of) ------------

    def arrive(
        self, cid: str, band: int, wants: float,
        shard: Optional[int] = None,
    ) -> None:
        if cid in self._row:
            raise ValueError(f"client id {cid!r} already present")
        self._ensure(1)
        i = self._n
        self.band[i] = int(band)
        self.wants[i] = float(wants)
        self.rtt[i] = _NAN
        self.active[i] = True
        self.shard[i] = 0 if shard is None else int(shard)
        self.cli_lease[i] = False
        self.cli_has[i] = 0.0
        self.fallback[i] = 0.0
        self.has_safe[i] = False
        self.srv_live[i] = False
        self.conn[i] = -1
        self._ids.append(cid)
        self._row[cid] = i
        self._n = i + 1
        self._active_count += 1
        self._buckets[i % self.spread].append(
            np.array([i], np.int64)
        )
        if self.spread > 1:
            self._pending_first.append(i)

    def bulk_arrive(
        self, ids: List[str], band: int, wants: float,
        shard: Optional[int] = None, first_refresh: str = "wheel",
    ) -> None:
        """Append a block of identical-shape rows in one shot (the
        base_population expansion). ``first_refresh="wheel"`` lets the
        deadline wheel stage lease establishment over one revolution —
        the parked-million setup; ``"now"`` queues every row for the
        next tick like `arrive` does."""
        n = len(ids)
        if not n:
            return
        self._ensure(n)
        start, end = self._n, self._n + n
        rows = np.arange(start, end, dtype=np.int64)
        self.band[start:end] = int(band)
        self.wants[start:end] = float(wants)
        self.rtt[start:end] = _NAN
        self.active[start:end] = True
        self.shard[start:end] = 0 if shard is None else int(shard)
        self.cli_lease[start:end] = False
        self.cli_has[start:end] = 0.0
        self.fallback[start:end] = 0.0
        self.has_safe[start:end] = False
        self.srv_live[start:end] = False
        self.conn[start:end] = -1
        self._ids.extend(ids)
        self._row.update(zip(ids, range(start, end)))
        self._n = end
        self._active_count += n
        for p in range(self.spread):
            first = start + ((p - start) % self.spread)
            if first < end:
                self._buckets[p].append(
                    np.arange(first, end, self.spread, dtype=np.int64)
                )
        if self.spread > 1 and first_refresh == "now":
            self._pending_first.extend(rows.tolist())

    def set_rtt(self, cid: str, rtt_ms: float) -> None:
        self.rtt[self._row[cid]] = float(rtt_ms)

    async def depart(self, cid: str) -> None:
        """Replay `Client.close()`'s release leg: one ReleaseCapacity
        against the current master (the redirect chase's terminus), or
        nothing when there is none — the lease then self-expires."""
        i = self._row.pop(cid, None)
        if i is None:
            return
        self.active[i] = False
        self._active_count -= 1
        key = int(self.shard[i]) if self.fed else 0
        land, parked = self._chase(int(self.conn[i]), int(self.shard[i]))
        self.conn[i] = parked
        if land < 0:
            return  # close() swallows the error; leases self-expire
        server = self.runner.servers.get(f"s{land}")
        if server is None:
            return
        req = pb.ReleaseCapacityRequest(
            client_id=cid, resource_id=[self.rid]
        )
        out = pb.ReleaseCapacityResponse()
        await server._release_capacity(
            req, None, out, server._clock(), False
        )
        # The release only touched the store our mirrors describe if
        # the binding is still current (a stale binding is reset on the
        # next refresh pass either way).
        store = self._store_of(server)
        if (
            self.srv_live[i]
            and self._bound.get(key) == self._token(server, store)
        ):
            self.srv_live[i] = False
            self._live[key] = self._live.get(key, 0) - 1

    def grant_of(self, cid: str) -> float:
        i = self._row.get(cid)
        if i is None:
            return 0.0
        if self.cli_lease[i]:
            return float(self.cli_has[i])
        return float(self.fallback[i])

    def client_ids(self) -> List[str]:
        return [
            self._ids[i] for i in range(self._n) if self.active[i]
        ]

    def population(self) -> int:
        return self._active_count

    # -- routing / server-mirror bookkeeping -----------------------------

    def _addr_index(self) -> Dict[str, int]:
        """Proxy address -> server index (addresses are stable for the
        life of a run; server OBJECTS behind them may be redeployed, so
        lookups resolve `runner.servers[f"s{i}"]` live)."""
        if self._addr2idx is None:
            self._addr2idx = {
                proxy.address: int(name[1:])
                for name, proxy in self.runner.proxies.items()
            }
        return self._addr2idx

    def _chase(self, conn: int, seed: int) -> Tuple[int, int]:
        """Replay one `Connection.execute` mastership chase (the
        harness clients run with ``max_retries=0``: exactly one chase
        per refresh, no backoff re-dial). Returns ``(landing, parked)``
        server indices — landing is -1 when the chase fails
        (`MasterUnknown` / hop budget), with the connection parked
        wherever `_connect` last left it; a dead dial closes the
        channel (parked -1) like the transport-error path does."""
        servers = self.runner.servers
        addr2idx = self._addr_index()
        if conn < 0:
            conn = seed
        hops = 0
        while True:
            server = servers.get(f"s{conn}")
            if server is None:
                return -1, -1
            if server.is_master:
                return conn, conn
            ptr = server.current_master
            if not ptr:
                return -1, conn
            hops += 1
            if hops > 5:
                return -1, conn
            nxt = addr2idx.get(ptr)
            if nxt is None:
                return -1, -1
            conn = nxt

    def _route_rows(self, rows: np.ndarray) -> np.ndarray:
        """Chase every row's connection (grouped by identical parked
        state, so the cost is O(distinct states), not O(rows)), park
        the connections where the chases leave them, and return each
        row's landing server index (-1: the refresh fails this tick)."""
        conn = self.conn[rows]
        seeds = self.shard[rows]
        landed = np.full(rows.size, -1, np.int32)
        parked = conn.copy()
        pairs = np.unique(
            np.stack((conn.astype(np.int64), seeds.astype(np.int64))),
            axis=1,
        )
        for c, s in pairs.T.tolist():
            land, park = self._chase(int(c), int(s))
            m = (conn == c) & (seeds == s)
            landed[m] = land
            parked[m] = park
        self.conn[rows] = parked
        return landed

    def _store_of(self, server):
        res = server.resources.get(self.rid)
        return None if res is None else res.store

    @staticmethod
    def _token(server, store) -> tuple:
        # Strong references on purpose: an id()-based token could
        # collide when a wiped store's address is reused by its
        # replacement. Neither class defines __eq__, so the tuple
        # comparison is identity.
        return (server, store)

    def _group_mask(self, key: int) -> np.ndarray:
        mask = self.srv_live[: self._n]
        if self.fed:
            mask = mask & (self.shard[: self._n] == key)
        return mask

    def _sync_binding(self, key: int, server) -> None:
        """Reset the srv_* mirrors when they describe a previous store
        generation — a mastership flip wipes the server's resources, so
        every lease the mirrors remember is gone."""
        token = self._token(server, self._store_of(server))
        if self._bound.get(key) == token:
            return
        if self._live.get(key, 0):
            mask = self._group_mask(key)
            self.srv_live[: self._n][mask] = False
        self._live[key] = 0
        self._srv_min[key] = _INF
        self._bound[key] = token

    def _recompute_min(self, key: int) -> None:
        mask = self._group_mask(key)
        if mask.any():
            self._srv_min[key] = float(
                self.srv_expiry[: self._n][mask].min()
            )
        else:
            self._srv_min[key] = _INF

    def _sweep_expired(self, key: int, now: float) -> None:
        """After a sequential decide ran with expired mirrors: the
        store's clean() removed every lease with ``now > expiry`` —
        drop the same rows from the mirror."""
        mask = self._group_mask(key) & (
            now > self.srv_expiry[: self._n]
        )
        dead = int(np.count_nonzero(mask))
        if dead:
            self.srv_live[: self._n][mask] = False
            self._live[key] = self._live.get(key, 0) - dead
        self._recompute_min(key)

    def _handles_for(self, engine, rows: np.ndarray) -> np.ndarray:
        if self._hcache is None or self._hcache[0] is not engine:
            self._hcache = (engine, np.full(self._cap, -1, np.int64))
        handles = self._hcache[1]
        missing = rows[handles[rows] < 0]
        if missing.size:
            intern = engine.client_handle
            ids = self._ids
            for i in missing.tolist():
                handles[i] = intern(ids[i])
        return handles[rows]

    # -- the per-tick refresh pass ---------------------------------------

    def _due_rows(self, tick: int) -> np.ndarray:
        phase = tick % self.spread
        chunks = self._buckets[phase]
        if chunks:
            cat = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
            due = cat[self.active[cat]]
            # Compact: dead rows never come back, so the bucket keeps
            # only its live rows (O(live) forever, not O(ever-lived)).
            self._buckets[phase] = [due] if due.size else []
        else:
            due = np.empty(0, np.int64)
        if self._pending_first:
            pending = np.asarray(self._pending_first, np.int64)
            self._pending_first = []
            pending = pending[self.active[pending]]
            if pending.size:
                due = np.unique(np.concatenate((due, pending)))
        return due

    def step_refresh(self, tick: int) -> None:
        """One tick's refresh pass over the due set — the vector twin
        of `harness._refresh_clients`. Synchronous by design: every
        decide runs inline on the loop, the same discipline as the
        coalescer's window-0 submit."""
        r = self.runner
        t0 = time.perf_counter()
        due = self._due_rows(tick)
        if due.size == 0:
            r._offered_by_band = {}
            self.step_walls.append(time.perf_counter() - t0)
            return
        bands_due = self.band[due]
        offered: Dict[int, int] = {}
        for b, c in zip(*np.unique(bands_due, return_counts=True)):
            offered[int(b)] = int(c)
        r._refresh_attempts += int(due.size)
        now = r.clock()
        ok = np.zeros(due.size, bool)

        # Route first: one chase per distinct parked-connection state
        # gives every due row its landing server (-1: that row's chase
        # failed — no admission draw, no decide, lease-retention path).
        landed = self._route_rows(due)

        if self.fed:
            shards = self.shard[due]
            groups = [
                (int(s), np.flatnonzero(shards == s))
                for s in np.unique(shards)
            ]
        else:
            groups = [(0, np.arange(due.size, dtype=np.int64))]

        # Admission draws consume the SHARED seeded RNG: when several
        # controllers (federated shards) interleave on one due stream,
        # the draws must happen per row in due order — grouping first
        # would reorder the stream against the per-client path. A
        # single controller's subsequence stays contiguous, so the
        # batched `check_get_capacity_many` replays it exactly.
        fed_admission = self.fed and any(
            getattr(s, "_admission", None) is not None
            for s in r.servers.values()
        )
        admitted_by_pos: Optional[np.ndarray] = None
        if fed_admission:
            admitted_by_pos = np.zeros(due.size, bool)
            servers = r.servers
            for pos in range(due.size):
                land = int(landed[pos])
                if land < 0:
                    continue
                server = servers.get(f"s{land}")
                if server is None:
                    continue
                adm = getattr(server, "_admission", None)
                admitted_by_pos[pos] = (
                    True if adm is None
                    else adm.check_get_capacity_band(
                        int(bands_due[pos])
                    )
                )

        for key, gpos in groups:
            gl = gpos[landed[gpos] >= 0]
            if not gl.size:
                continue  # masterless / every chase failed this tick
            # Every successful chase in a group lands on the same
            # server: an election lock has one holder at a time, and
            # federated master pointers never cross shards.
            server = r.servers.get(f"s{int(landed[gl[0]])}")
            if server is None:
                continue
            if admitted_by_pos is not None:
                admitted = admitted_by_pos[gl]
            else:
                adm = getattr(server, "_admission", None)
                admitted = (
                    np.ones(gl.size, bool) if adm is None
                    else np.asarray(
                        adm.check_get_capacity_many(bands_due[gl]),
                        bool,
                    )
                )
            gpos_ok = gl[admitted]
            if not gpos_ok.size:
                continue
            sel = due[gpos_ok]

            self._sync_binding(key, server)
            live = self._live.get(key, 0)
            fast_ok = True
            if live > 0 and now > self._srv_min.get(key, _INF):
                # The lower bound tripped: find the true minimum; if
                # the clock really passed it, a sequential decide must
                # sweep the expired leases this tick.
                self._recompute_min(key)
                if now > self._srv_min[key]:
                    fast_ok = False

            w = self.wants[sel]
            prio = self.band[sel].astype(np.int64)
            has = np.where(self.cli_lease[sel], self.cli_has[sel], 0.0)
            srv_live_sel = self.srv_live[sel]
            old_h = np.where(srv_live_sel, self.srv_has[sel], 0.0)
            old_w = np.where(srv_live_sel, self.srv_wants[sel], 0.0)
            new = ~srv_live_sel
            engine = getattr(server, "_store_engine", None)
            cids = handles = None
            if engine is not None:
                handles = self._handles_for(engine, sel)
            else:
                cids = [self._ids[i] for i in sel.tolist()]
            grants, expiry, _refresh, safe, fast_rows = server.decide_bulk(
                self.rid, cids, has, w, prio,
                old_has=old_h, old_wants=old_w, new_mask=new,
                cid_handles=handles,
                # -1 forces the count precondition to fail, which
                # routes the whole batch down the sequential path (the
                # one that sweeps expired leases).
                expected_count=(live if fast_ok else -1),
            )

            # Client side, exactly as client.py applies a response:
            # truncated expiry, stored safe capacity, cleared fallback.
            self.cli_has[sel] = grants
            self.cli_expiry[sel] = np.floor(expiry)
            self.cli_lease[sel] = True
            self.fallback[sel] = 0.0
            self.safe[sel] = safe
            self.has_safe[sel] = True
            # Server mirror: exact floats for the next tick's deltas.
            self.srv_has[sel] = grants
            self.srv_wants[sel] = w
            self.srv_expiry[sel] = expiry
            self.srv_live[sel] = True
            self._live[key] = live + int(np.count_nonzero(new))
            if not fast_ok:
                self._sweep_expired(key, now)
            self._srv_min[key] = min(
                self._srv_min.get(key, _INF), float(expiry.min())
            )
            self._bound[key] = self._token(
                server, self._store_of(server)
            )
            ok[gpos_ok] = True
            r._refresh_ok += int(sel.size)
            self.fast_rows_total += int(fast_rows)
            self.seq_rows_total += int(sel.size) - int(fast_rows)
            if fast_rows < sel.size:
                self.seq_ticks += 1

        failed = due[~ok]
        if failed.size:
            # A failed refresh keeps leases; only an expired one
            # (strict, against the int-cast client expiry) falls back
            # to the last server-sent safe capacity, else 0.0.
            exp = failed[
                self.cli_lease[failed] & (self.cli_expiry[failed] < now)
            ]
            if exp.size:
                self.fallback[exp] = np.where(
                    self.has_safe[exp], self.safe[exp], 0.0
                )
                self.cli_lease[exp] = False

        # Measurement streams (outside the log digest): the bulk wall
        # amortized per due client, and the modeled-WAN virtual latency
        # with its seeded jitter drawn per rtt-carrying row in order.
        wall_ms = (time.perf_counter() - t0) * 1000.0
        r.samples["get_capacity_wall_ms"].extend(
            [wall_ms / due.size] * int(due.size)
        )
        rtt_due = self.rtt[due]
        with_rtt = np.flatnonzero(~np.isnan(rtt_due))
        if with_rtt.size:
            meas = r.meas_rng
            out = r.samples["refresh_virtual_ms"]
            for pos in with_rtt.tolist():
                out.append(
                    1.0 + rtt_due[pos] * (0.9 + 0.2 * meas.random())
                )
        r._offered_by_band = offered
        self.step_walls.append(time.perf_counter() - t0)

    # -- measurement -----------------------------------------------------

    def measure_bands(self) -> Tuple[Dict[int, float], Dict[int, float]]:
        """Per-band (wants, gets) sums over the live population.
        np.bincount accumulates its input strictly in order, so each
        band's float additions replay in row (= insertion) order —
        the same accumulation sequence as the per-client loop."""
        act = np.flatnonzero(self.active[: self._n])
        if not act.size:
            return {}, {}
        bands = self.band[act]
        w = self.wants[act]
        cur = np.where(
            self.cli_lease[act], self.cli_has[act], self.fallback[act]
        )
        g = np.minimum(cur, w)
        minlength = int(bands.max()) + 1
        wants_sum = np.bincount(bands, weights=w, minlength=minlength)
        gets_sum = np.bincount(bands, weights=g, minlength=minlength)
        wants_by: Dict[int, float] = {}
        gets_by: Dict[int, float] = {}
        for b in np.unique(bands).tolist():
            wants_by[int(b)] = float(wants_sum[b])
            gets_by[int(b)] = float(gets_sum[b])
        return wants_by, gets_by

    def snapshot(self, base_ids: List[str]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for cid in base_ids:
            i = self._row.get(cid)
            if i is None:
                continue
            out[f"{cid}/{self.rid}"] = (
                float(self.cli_has[i]) if self.cli_lease[i]
                else float(self.fallback[i])
            )
        return out
