"""Driver of the `refresh` mixes: a closed loop of master ticks.

Each iteration hands the port one iteration's refreshes of the plan
(gen/traffic.py `RefreshPlan`) through the native store's
`bulk_refresh`, then calls `CapacityServer.tick_once`; the next
iteration starts when the tick returns (its depth-N pipeline dispatches
ahead). The window ends with `flush_ticks`, so every refresh it counts
has been re-apportioned and landed in the store. After the window the
demand is held still for the configuration's `settle_ticks` iterations
(the clients go on refreshing, with the wants they last sent), so that
chained grants reach the fixed point the reference states, and every
lease is read back and judged.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from portbench.cells import common


def run(cell) -> dict:
    return asyncio.run(_run(cell))


async def _run(cell) -> dict:
    from doorman_tpu_torch.server.config import parse_yaml_config

    from portbench.gen import deploy, traffic

    cfg, mix = cell.config, cell.mix
    common.host_threads(cfg)
    build_s = common.build_port(cell.device)
    layout = deploy.layout(cfg)
    dep = layout.build(cfg, mix, cell.seed)
    plan = traffic.RefreshPlan(dep.wants, mix, cell.seed,
                               dep.refresh_interval,
                               cfg["server"]["tick_interval"])
    warm = int(mix["warm_iterations"])
    server = common.make_server(cfg, cell.device)
    await server.start(0, host="127.0.0.1", tick_loop=False)
    prof = common.Profiler(cell.trace, "host between the harness's calls")
    span = common.span
    walls, ingest_s, done, attempted = [], [], 0, 0
    try:
        await server.load_config(parse_yaml_config(dep.document))
        _res, rid, cids = deploy.populate(server, dep)
        plan.bind(rid, cids)
        engine = server._store_engine
        expiry = [np.empty(len(m)) for m in plan.members]
        refresh = [np.full(len(m), dep.refresh_interval) for m in plan.members]

        def ingest(i: int) -> int:
            rids, cids_i, wants = plan.batch(i)
            e = expiry[i % plan.F]
            e.fill(time.time() + dep.lease_length)
            return engine.bulk_refresh(rids, cids_i, e, refresh[i % plan.F],
                                       wants)

        for i in range(warm):
            ingest(i)
            await server.tick_once()
        await server.flush_ticks()
        phases0 = common.phase_totals(server)
        setup_s = common.now() - cell.t0
        i = warm
        prof.start()
        load = common.HostLoad()
        with span("window", cell.trace):
            t_start = prof.window_start = common.now()
            deadline = t_start + cell.seconds
            while True:
                a = common.now()
                with span("ingest", cell.trace):
                    done += ingest(i)
                b = common.now()
                with span("tick_once", cell.trace):
                    await server.tick_once()
                c = common.now()
                attempted += plan.size(i)
                ingest_s.append(b - a)
                walls.append(c - b)
                i += 1
                if c >= deadline:
                    break
            with span("flush_ticks", cell.trace):
                await server.flush_ticks()
            t_end = common.now()
        host = load.done()
        prof.stop()
        flush_s = t_end - c
        phases = common.phase_delta(phases0, common.phase_totals(server))
        # The demand held still until chained grants settle: the
        # clients go on refreshing, with the wants they last sent.
        sent = plan.state(i - 1)
        for j in range(i, i + int(cfg["settle_ticks"])):
            f = j % plan.F
            expiry[f].fill(time.time() + dep.lease_length)
            engine.bulk_refresh(plan.rids[f], plan.cids[f], expiry[f],
                                refresh[f], sent[plan.members[f]])
            await server.tick_once()
        await server.flush_ticks()
        settle_s = common.now() - t_end
        device = common.device_block(cell.device)
        stores = [server.resources[r].store for r in dep.ids]
        from portbench.reference import judge

        stored_wants, grants, found = judge.read_store(
            engine, stores, common.lease_index(cids), dep.n * dep.clients)
    finally:
        await server.stop()
    del server, engine, stores
    iterations = i - warm
    run = {
        "setup_s": setup_s, "window_s": t_end - t_start,
        "refreshes": done, "attempted": attempted,
        "failed": attempted - done,
        "ticks": iterations, "tick_walls": walls, "ingest_s": ingest_s,
        "flush_s": flush_s, "phases": phases, "trace": prof.summary,
        "device": device,
        "diag": dict(host, build_s=build_s, settle_s=settle_s,
                     tick_ms=common.wall_quantiles_ms(walls),
                     iterations=iterations,
                     ingest_ms=1e3 * float(np.mean(ingest_s)),
                     flush_ms=1e3 * flush_s,
                     phase_ms_per_tick={k: 1e3 * v / iterations
                                        for k, v in sorted(phases.items())}),
    }
    shape = (dep.n, dep.clients)
    if cell.trace:
        run["k1_work"] = _work(layout, dep, plan, range(warm, i), shape)
    numbers, control = layout.check(cell, dep, sent.reshape(shape),
                                    grants.reshape(shape))
    limits = cfg["limits"]
    check = {"leases_off": {"value": judge.leases_off(found, stored_wants,
                                                      sent),
                            "limit": 0}}
    check.update({k: {"value": v, "limit": limits[k]}
                  for k, v in numbers.items()})
    run["check"], run["control"] = check, control
    return run


def _work(layout, dep, plan, window, shape):
    """The window's K1 work for the roofline: every row solved once a
    tick, at the demand the tick's refreshes left in the table."""
    per_key, nbytes, ops = {}, 0.0, 0.0
    for j in window:
        key = plan.key(j)
        if key not in per_key:
            per_key[key] = layout.work(dep, plan.state(j).reshape(shape))
        nbytes += per_key[key][0]
        ops += per_key[key][1]
    return nbytes, ops
