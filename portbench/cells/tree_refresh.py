"""The `tree_refresh` mixes (harness kind): a closed loop over a server tree
(layout `tree`) in one process, its levels talking over loopback gRPC.

Every server is the configuration's CapacityServer with its own native
store; the intermediates' parent is set and their updater left off
(`start(updater_loop=False)`): the loop runs their exchanges itself,
through `_perform_parent_requests`, the updater's own step. Each
iteration stands for one tick interval and runs, in this order:

  1. each datacenter takes the plan's refreshes of its own clients
     (gen/traffic.py `RefreshPlan`, every lease once per refresh
     interval) through its store's `bulk_refresh`, then `tick_once`;
  2. the intermediates whose exchange falls due exchange with their
     parent: intermediate j (datacenters first, then regions) on the
     iterations i with i = j mod E, E the refresh interval in ticks;
  3. the regions tick, then the root.

The window ends with `flush_ticks` on every server. After it the demand
is held still (the clients go on refreshing with the wants they last
sent) and exchanges and ticks go on for the configuration's
`settle_ticks` iterations, until the tree is at the fixed point the
reference states; then every server's grants are read back and judged.
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
import time

import numpy as np

from portbench.cells import common

# The program's spans the per-layer readers take from the window, with
# the args each carries (a traced run's diag counts the spans that lack
# any); the RPC's own span besides.
NEEDS = {"server.tick": ("server", "solve"),
         "server.parent_exchange": ("server", "outcome"),
         "server.band_aggregate": ("resources", "bands"),
         "server.parent_install": ("templates",),
         "server.GetServerCapacity": ("lines", "bands")}
SPANS = (*NEEDS, "server.parent_refresh")
ARGS = sorted({a for args in NEEDS.values() for a in args})
# How far back an intermediate's mastership starts, so that the learning
# window of the default template it starts from has passed
# (`learning_mode_duration` 0 for every server, as at the root).
LEARNED = 3600.0


def run(cell) -> dict:
    return asyncio.run(_run(cell))


def _server(cfg: dict, device: str, server_id: str, parent: str = ""):
    sub = dict(cfg, server_id=server_id,
               server=dict(cfg["server"], parent_addr=parent))
    return common.make_server(sub, device)


class Tree:
    """The root, the regions and the datacenters, started on loopback."""

    def __init__(self):
        self.root = None
        self.regions, self.dcs = [], []

    @property
    def servers(self):
        return [self.root, *self.regions, *self.dcs]

    @property
    def intermediates(self):
        """In exchange order: the datacenters, then the regions."""
        return [*self.dcs, *self.regions]

    async def start(self, cfg: dict, device: str, place, document: str):
        from doorman_tpu_torch.server.config import parse_yaml_config

        self.root = _server(cfg, device, place.root)
        port = await self._start(self.root)
        await self.root.load_config(parse_yaml_config(document))
        addrs = []
        for name in place.regions:
            s = _server(cfg, device, name, f"127.0.0.1:{port}")
            addrs.append(f"127.0.0.1:{await self._start(s)}")
            self.regions.append(s)
        for d, name in enumerate(place.dcs):
            s = _server(cfg, device, name, addrs[place.region_of_dc[d]])
            await self._start(s)
            self.dcs.append(s)
        for s in self.intermediates:
            s.became_master_at -= LEARNED

    @staticmethod
    async def _start(server) -> int:
        return await server.start(0, host="127.0.0.1", tick_loop=False,
                                  updater_loop=False)

    async def stop(self):
        for s in self.servers:
            if s is not None:
                await s.stop()


def _refusal():
    """Why the program cannot run this loop, or None."""
    from doorman_tpu_torch.server.server import CapacityServer

    if "updater_loop" not in inspect.signature(
            CapacityServer.start).parameters:
        return "CapacityServer.start has no updater_loop switch"
    return None


class Ingest:
    """Each datacenter's share of every iteration's refreshes: its
    positions in each of the plan's phases (in the plan's order), with
    the handles of its own store."""

    def __init__(self, plan, dc_of_lease, rid_h, cid_h, D, interval):
        self.plan = plan
        self.pos, self.rids, self.cids = [], [], []
        for f in range(plan.F):
            m = plan.members[f]
            pos = [np.flatnonzero(dc_of_lease[m] == d) for d in range(D)]
            self.pos.append(pos)
            self.rids.append([rid_h[m[p]] for p in pos])
            self.cids.append([cid_h[m[p]] for p in pos])
        self.expiry = [[np.empty(len(c)) for c in cs] for cs in self.cids]
        self.refresh = [[np.full(len(c), interval) for c in cs]
                        for cs in self.cids]

    def part(self, i: int, d: int, lease_length: float, wants=None):
        """bulk_refresh's arguments of datacenter d at iteration i (the
        plan's wants, or the given [N] wants of every lease)."""
        f = i % self.plan.F
        p = self.pos[f][d]
        w = (self.plan.pool[i % self.plan.P][p] if wants is None
             else wants[self.plan.members[f][p]])
        e = self.expiry[f][d]
        e.fill(time.time() + lease_length)
        return self.rids[f][d], self.cids[f][d], e, self.refresh[f][d], w


async def _run(cell) -> dict:
    from portbench import harness
    from portbench.gen import deploy, traffic

    why = _refusal()
    if why is not None:
        raise harness.Refused(why)
    cfg, mix = cell.config, cell.mix
    common.host_threads(cfg)
    build_s = common.build_port(cell.device)
    layout = deploy.layout(cfg)
    dep = layout.build(cfg, mix, cell.seed)
    place = dep.place
    R, C, D = dep.n, dep.clients, len(place.dcs)
    tick_interval = cfg["server"]["tick_interval"]
    plan = traffic.RefreshPlan(dep.wants, mix, cell.seed,
                               dep.refresh_interval, tick_interval)
    every = plan.F  # an exchange each refresh interval
    warm = int(mix["warm_iterations"])
    tree = Tree()
    counts = Counts(tree)
    prof = common.Profiler(cell.trace, "host between the harness's calls")
    span = common.span
    stats = {k: [] for k in ("ingest", "dc_tick", "exchange", "upper_tick")}
    done = attempted = 0
    try:
        await tree.start(cfg, cell.device, place, dep.document)
        rid_h = np.empty(R * C, np.int32)
        cid_h = np.empty(R * C, np.int64)
        dc_of_lease = np.tile(place.dc_of_client, R)
        handle_to_lease = []
        for d, s in enumerate(tree.dcs):
            cols = place.clients_of(d)
            part = dataclasses.replace(
                dep, clients=len(cols), wants=dep.wants[:, cols],
                subclients=dep.subclients[:, cols],
                priority=dep.priority[:, cols])
            _res, rid, cids = deploy.populate(s, part)
            lease = (np.arange(R)[:, None] * C + cols[None, :]).ravel()
            rid_h[lease] = np.repeat(rid, len(cols))
            cid_h[lease] = cids.ravel()
            inv = np.full(int(cids.max()) + 1, -1, np.int64)
            inv[cids.ravel()] = lease
            handle_to_lease.append(inv)
        ingest = Ingest(plan, dc_of_lease, rid_h, cid_h, D,
                        dep.refresh_interval)
        order = tree.intermediates

        async def iteration(i: int, wants=None, timed=False) -> int:
            n, ingest_s = 0, 0.0
            counts.key = plan.key(i)
            for d, s in enumerate(tree.dcs):
                args = ingest.part(i, d, dep.lease_length, wants)
                a = common.now()
                with span("ingest", cell.trace):
                    n += s._store_engine.bulk_refresh(*args)
                b = common.now()
                ingest_s += b - a
                with span("dc_tick", cell.trace):
                    await counts.tick(s, "dc")
                if timed:
                    stats["dc_tick"].append(common.now() - b)
            for j in range(i % every, len(order), every):
                a = common.now()
                with span("exchange", cell.trace):
                    await order[j]._perform_parent_requests(0)
                if timed:
                    stats["exchange"].append(common.now() - a)
            for s in (*tree.regions, tree.root):
                a = common.now()
                with span("upper_tick", cell.trace):
                    await counts.tick(s, "upper")
                if timed:
                    stats["upper_tick"].append(common.now() - a)
            if timed:
                stats["ingest"].append(ingest_s)
            return n

        for i in range(warm):
            await iteration(i)
        for s in tree.servers:
            await s.flush_ticks()
        counts.start()
        phases0 = _phase_totals(tree)
        setup_s = common.now() - cell.t0
        i = warm
        prof.start()
        load = common.HostLoad()
        with span("window", cell.trace):
            t_start = prof.window_start = common.now()
            deadline = t_start + cell.seconds
            while True:
                done += await iteration(i, timed=True)
                attempted += plan.size(i)
                i += 1
                if common.now() >= deadline:
                    break
            c = common.now()
            with span("flush_ticks", cell.trace):
                for s in tree.servers:
                    await s.flush_ticks()
            t_end = common.now()
        host = load.done()
        window_counts = counts.done()
        spans = _window_spans(t_start) if cell.trace else None
        prof.stop()
        flush_s = t_end - c
        phases = common.phase_delta(phases0, _phase_totals(tree))
        # The demand held still until the tree settles: the clients go
        # on refreshing, with the wants they last sent.
        sent = plan.state(i - 1)
        settle = int(cfg["settle_ticks"])
        for j in range(i, i + settle):
            await iteration(j, wants=sent)
        for s in tree.servers:
            await s.flush_ticks()
        settle_s = common.now() - t_end
        device = common.device_block(cell.device)
        held, stored_wants, found = _read_back(tree, dep, handle_to_lease)
    finally:
        await tree.stop()
    del tree
    iterations = i - warm
    run = {
        "setup_s": setup_s, "window_s": t_end - t_start,
        "refreshes": done, "attempted": attempted,
        "failed": attempted - done, "ticks": iterations,
        "ingest_s": stats["ingest"],
        "tick_walls": stats["dc_tick"] + stats["upper_tick"],
        "flush_s": flush_s, "phases": phases,
        "trace": prof.summary, "device": device,
        "program_spans": spans, "dc_servers": list(place.dcs),
        "diag": dict(
            host, build_s=build_s, settle_s=settle_s, iterations=iterations,
            settle_iterations=settle, flush_ms=1e3 * flush_s,
            **{k: v for k, v in window_counts.items() if k != "rows"},
            **{f"{k}_ms": common.wall_quantiles_ms(v)
               for k, v in stats.items()},
            **{f"{k}_ms_per_iteration": 1e3 * sum(v) / iterations
               for k, v in stats.items()}),
    }
    shape = (R, C)
    if cell.trace:
        run["k1_work"] = _work(layout, dep, plan, range(warm, i),
                               window_counts["rows"])
        run["diag"]["span_ms_per_iteration"] = _span_sums(spans, iterations)
        run["diag"]["spans_lacking_args"] = sum(
            not all(k in sp["args"] for k in NEEDS.get(sp["name"], ()))
            for sp in spans)
    from portbench.reference import judge

    numbers, control = layout.check(cell, dep, sent.reshape(shape), held)
    limits = cfg["limits"]
    check = {"leases_off": {"value": judge.leases_off(found, stored_wants,
                                                      sent),
                            "limit": 0}}
    check.update({k: {"value": v, "limit": limits[k]}
                  for k, v in numbers.items()})
    run["check"], run["control"] = check, control
    return run


class Counts:
    """What the window did besides the refreshes, from the program's own
    counts: the exchanges by outcome and the bands the root and the
    regions decided (the registry's counters), each tick's solve by role
    (datacenter or upper: the regions and the root; the flight record's
    solve_mode), the rows each server's solves took under each key of
    the plan (the engine's last_scope, for the roofline's work), and K1's
    and K2's launches by role and by the layout of the server's lane
    width."""

    OUTCOMES = ("ok", "rpc_error", "config_error")

    def __init__(self, tree):
        self.tree = tree
        self.on = False
        self.key = None  # the plan's key of the running iteration
        self.solves = {"dc": {}, "upper": {}}
        self.layouts = {"dc": {}, "upper": {}}
        self.rows = {}  # (plan key, server id) -> rows solved
        self._counters0 = {}

    def _counters(self) -> dict:
        from doorman_tpu_torch.obs import metrics as metrics_mod

        reg = metrics_mod.default_registry()
        ex = reg.counter("doorman_server_parent_exchanges",
                         labels=("server", "outcome"))
        bands = reg.counter("doorman_server_capacity_bands",
                            labels=("server",))
        out = {o: sum(ex.value(s.id, o) for s in self.tree.intermediates)
               for o in self.OUTCOMES}
        out["bands"] = sum(bands.value(s.id) for s in self.tree.servers)
        return out

    def start(self):
        self.on = True
        self._counters0 = self._counters()

    async def tick(self, server, role: str):
        if not self.on:
            await server.tick_once()
            return
        from doorman_tpu_torch.solver import dense_cuda

        engine = server._resident  # None until the server holds rows
        solves0 = _solves(engine)
        launches0 = dense_cuda.LAUNCHES["k1"] + dense_cuda.LAUNCHES["k2"]
        await server.tick_once()
        mode = server._solve_mode() or "none"
        self.solves[role][mode] = self.solves[role].get(mode, 0) + 1
        if engine is None:
            return
        if _solves(engine) != solves0:
            k = (self.key, server.id)
            self.rows[k] = self.rows.get(k, 0) + int(engine.last_scope["rows"])
        launched = (dense_cuda.LAUNCHES["k1"] + dense_cuda.LAUNCHES["k2"]
                    - launches0)
        if launched:
            by = self.layouts[role]
            layout = dense_cuda.k1_layout(engine._K)
            by[layout] = by.get(layout, 0) + launched

    def done(self) -> dict:
        self.on = False
        now, then = self._counters(), self._counters0
        moved = {k: now[k] - then.get(k, 0) for k in now}
        return {
            "exchanges": sum(moved[o] for o in self.OUTCOMES),
            "exchange_failures": sum(moved[o] for o in self.OUTCOMES
                                     if o != "ok"),
            "bands_served": moved["bands"],
            "solves": self.solves,
            "k1_launches_by_layout": self.layouts,
            "rows": self.rows,
        }


def _solves(engine) -> int:
    """Solves the resident engine has dispatched (none without one)."""
    return 0 if engine is None else sum(engine.solve_modes.values())


def _phase_totals(tree) -> dict:
    """Every server's solver laps (`phase_s`), summed over the tree."""
    out = {}
    for s in tree.servers:
        for k, v in common.phase_totals(s).items():
            out[k] = out.get(k, 0.0) + v
    return out


def _window_spans(t_start: float):
    """The window's program spans the readers take (name, seconds, the
    args they read), from the tracer itself: the profiler keeps none."""
    from doorman_tpu_torch.obs import trace as program_trace

    zero = program_trace.perf_to_us(t_start)
    out = []
    for sp in program_trace.default_tracer().snapshot():
        if sp.ph != "X" or sp.name not in SPANS or sp.ts < zero:
            continue
        args = sp.args or {}
        out.append({"name": sp.name, "t_s": (sp.ts - zero) / 1e6,
                    "dur_s": sp.dur / 1e6,
                    "args": {k: args[k] for k in ARGS if k in args}})
    return out


def _span_sums(spans, iterations: int) -> dict:
    """Per span name: [spans, ms] over the window, per iteration."""
    out = {}
    for sp in spans:
        n, ms = out.get(sp["name"], (0, 0.0))
        out[sp["name"]] = (n + 1, ms + sp["dur_s"] * 1e3)
    return {k: [n / iterations, ms / iterations]
            for k, (n, ms) in sorted(out.items())}


def _band_grants(server, ids, downstream):
    """[R, len(downstream)] of `server`'s grants to each downstream
    server's bands of each resource (every band summed)."""
    from doorman_tpu_torch.server.server import _band_key

    out = np.zeros((len(ids), len(downstream)))
    for r, rid in enumerate(ids):
        res = server.resources.get(rid)
        if res is None:
            continue
        for k, sid in enumerate(downstream):
            for p in server._server_bands.get((rid, sid), ()):
                out[r, k] += res.store.get(_band_key(sid, p)).has
    return out


def _capacities(servers, ids):
    """[R, len(servers)] of each intermediate's installed capacity."""
    out = np.zeros((len(ids), len(servers)))
    for k, s in enumerate(servers):
        for r, rid in enumerate(ids):
            res = s.resources.get(rid)
            out[r, k] = 0.0 if res is None else res.capacity
    return out


def _read_back(tree, dep, handle_to_lease):
    """What every server holds: (HeldGrants, each lease's stored wants,
    how often each lease was found), the leases from each datacenter's
    store in one pack call."""
    from portbench.reference import judge
    from portbench.reference.tree import HeldGrants

    R, C = dep.n, dep.clients
    n = R * C
    grants = np.full(n, np.nan)
    wants = np.full(n, np.nan)
    found = np.zeros(n, np.int64)
    for s, inv in zip(tree.dcs, handle_to_lease):
        stores = [s.resources[r].store for r in dep.ids]
        w, h, f = judge.read_store(s._store_engine, stores, inv, n)
        mine = f > 0
        wants[mine], grants[mine] = w[mine], h[mine]
        found += f
    place = dep.place
    regions = [s.id for s in tree.regions]
    region = np.zeros((R, len(tree.dcs)))
    for g, s in enumerate(tree.regions):
        dcs = np.flatnonzero(place.region_of_dc == g)
        region[:, dcs] = _band_grants(s, dep.ids, [place.dcs[d] for d in dcs])
    held = HeldGrants(
        dc_wants=None, region_wants=None,
        root=_band_grants(tree.root, dep.ids, regions), region=region,
        clients=grants.reshape(R, C),
        dc_capacity=_capacities(tree.dcs, dep.ids),
        region_capacity=_capacities(tree.regions, dep.ids))
    return held, wants, found


def _work(layout, dep, plan, window, rows):
    """The window's K1 and K2 work: each server's rows solved under each
    key of the plan (`Counts.rows`), at the work of that server's rows
    at the demand the key's iterations left in the table."""
    first = {}
    for j in window:
        first.setdefault(plan.key(j), j)
    nbytes = ops = 0.0
    for key, j in first.items():
        per_server = layout.work(dep, plan.state(j).reshape(dep.n, -1))
        for sid, (b, o) in per_server.items():
            share = rows.get((key, sid), 0) / dep.n
            nbytes += b * share
            ops += o * share
    return nbytes, ops
