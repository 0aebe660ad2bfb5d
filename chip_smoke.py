#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (doorman_tpu_torch) on one H100.

    python3 chip_smoke.py

Builds the port's kernels and native store from the sources in this
checkout, holds every kernel against its plain PyTorch version on the
card, drives the main path — the batch-mode CapacityServer on the native
store, ticking the resident fused + scoped solve at the bench's full
size (10,000 resources x 100 clients = 1M leases, bucket K = 128, 5%
demand churn and 20% delivery per tick) at f32 and briefly at f64,
answering GetCapacity / ReleaseCapacity / Discovery over loopback gRPC —
and the delta-tracked full tick, and checks what comes out. Kernel launch
counters are zeroed just before each path is driven and read just after.

Prints one line per phase, the card's name and power limit, one JSON line
of per-kernel measurements, and last the JSON result line. Exits non-zero
(and prints no result) without a CUDA device, outside a checkout of the
repo, or when any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The main path's shape (bench.py's 1M-lease cell).
N_RES = 10_000
N_CLIENTS = 100
CHURN = N_RES // 20  # 5% of resources get new demand per tick
TICKS = 40
F64_TICKS = 6
QUIET_TICKS = 14  # >= 2 delivery rotations with no churn: the fixpoint
F64_RTOL = 1e-12  # f64 kernel vs plain: reduction order only
DEVICE = "cuda"
H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores

# (glob prefix, wire kind, variant, share of resources)
LANES = (
    ("none", 0, None, 0.05),
    ("static", 1, None, 0.05),
    ("prop", 2, None, 0.40),
    ("fair", 3, None, 0.25),
    ("topup", 2, "topup", 0.05),
    ("maxmin", 3, "maxmin", 0.07),
    ("bal", 3, "balanced", 0.07),
    ("pf", 2, "logutil", 0.06),
)
CAP_TIERS = (1_500.0, 3_500.0, 5_000.0, 20_000.0)


def say(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


# -- phase 1: the device ----------------------------------------------------

def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi unavailable"
    say(f"phase device: {name} capability {cap} count "
        f"{torch.cuda.device_count()} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    check(tuple(cap) == (9, 0), f"capability {cap} is not Hopper (9, 0)")
    return name, card


# -- phase 2: the build -----------------------------------------------------

def phase_build():
    from doorman_tpu_torch import native
    from doorman_tpu_torch.solver import dense_cuda

    t0 = time.perf_counter()
    errors = []
    secs = {}

    def run(name, fn):
        t = time.perf_counter()
        try:
            fn()
        except Exception as e:  # reported below
            errors.append(f"{name}: {e}")
        secs[name] = time.perf_counter() - t

    # One compiler process per source, started together.
    jobs = [
        threading.Thread(target=run, args=("dense_solve.cu", dense_cuda.build)),
        threading.Thread(target=run, args=("store.cc", native.native_available)),
    ]
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    check(not errors, f"build failed: {errors}")
    check(native.native_available(), "native store did not build")
    say("phase build: " + ", ".join(
        f"{k} {v:.1f}s" for k, v in sorted(secs.items())
    ) + f" (wall {time.perf_counter() - t0:.1f}s)")


# -- phase 3: kernel parity -------------------------------------------------

def _parity_batch(torch, rng, R, K, dtype):
    import numpy as np

    from doorman_tpu_torch.solver.carry import tables_from_numpy

    n = rng.integers(1, K + 1, R)  # every row padded past its clients
    act = np.arange(K)[None, :] < n[:, None]
    wants = rng.random((R, K)) * 100
    has = rng.random((R, K)) * 50
    sub = rng.integers(1, 4, (R, K)).astype(np.float64)
    cap = rng.random(R) * 80 * n + 5  # under- and overloaded rows
    kinds = np.array([0, 1, 2, 3, 4, 5, 7, 8, 9], np.int32)
    kind = kinds[np.arange(R) % len(kinds)]  # every lane (and a laneless kind)
    learn = rng.random(R) < 0.1
    statc = rng.random(R) * 60
    return tables_from_numpy(
        wants * act, has * act, sub * act, act, cap, kind, learn, statc,
        has * act, device="cuda", dtype=dtype,
    )


def _rel_err(torch, got, want, batch):
    scale = torch.maximum(
        batch.capacity, torch.where(batch.active, batch.wants, 0).amax(1)
    )[:, None].double().clamp_min(1e-30)  # padding rows: 0 / tiny
    return ((got.double() - want.double()).abs() / scale).max().item()


def _check_k2(torch, batch, prev, delivered, where):
    """K2 on a path's own tables (a comparison launch, not counted):
    its grants within the parity bound of the plain solve, equal to K1's
    bit for bit, and changed / prev_new exactly the epilogue's
    definition on its own grants. Returns (K2 result, max abs err vs
    plain, max relative err vs plain)."""
    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.dense import fused_tick_plain

    saved = dict(dense_cuda.LAUNCHES)
    res = dense_cuda.fused_tick_k2(batch, prev, delivered)
    k1 = dense_cuda.solve_dense_k1(batch)
    dense_cuda.LAUNCHES.update(saved)
    gets, prev_new, changed = res
    plain = fused_tick_plain(batch, prev, delivered)[0]
    bound = (F64_RTOL if batch.wants.dtype == torch.float64
             else F32_PARITY_REL_BOUND)
    rel = _rel_err(torch, gets, plain, batch)
    check(bool(torch.isfinite(gets).all()), f"K2 non-finite ({where})")
    check(rel <= bound, f"K2 vs plain {rel:.3g} > {bound:g} ({where})")
    check(torch.equal(gets, k1), f"K2 gets != K1 ({where})")
    out = gets.to(prev.dtype)
    check(torch.equal(changed, delivered & (out != prev).any(dim=1)),
          f"K2 changed mask wrong ({where})")
    check(torch.equal(prev_new, torch.where(delivered[:, None], out, prev)),
          f"K2 prev_new wrong ({where})")
    return res, (gets.double() - plain.double()).abs().max().item(), rel


def phase_kernels(torch):
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.dense import solve_dense

    rng = np.random.default_rng(2024)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for K in (8, 128, 4096):
        R = 96 if K == 4096 else 1024
        for dtype in (torch.float32, torch.float64):
            batch, prev = _parity_batch(torch, rng, R, K, dtype)
            g1 = dense_cuda.solve_dense_k1(batch)
            g2 = dense_cuda.solve_dense_k1(batch)
            plain = solve_dense(batch)
            torch.cuda.synchronize()
            check(torch.equal(g1, g2), f"K1 not deterministic (K={K} {dtype})")
            check(bool(torch.isfinite(g1).all()), f"K1 non-finite (K={K})")
            err = _rel_err(torch, g1, plain, batch)
            bound = F32_PARITY_REL_BOUND if dtype == torch.float32 else F64_RTOL
            check(err <= bound,
                  f"K1 vs plain {err:.3g} > {bound:g} (K={K} {dtype})")
            worst[dtype] = max(worst[dtype], err)
            rows = torch.from_numpy(
                rng.permutation(R)[: R // 3].astype(np.int32)
            ).cuda()
            check(torch.equal(dense_cuda.solve_dense_k1(batch, rows=rows),
                              g1[rows.long()]),
                  f"K1 row-gather form disagrees (K={K})")
            delivered = torch.from_numpy(rng.random(R) < 0.5).cuda()
            for pdt in (dtype, torch.bfloat16):
                p = prev.to(pdt)
                p[::3] = g1[::3].to(pdt)  # some delivered rows unchanged
                gets, prev_new, changed = dense_cuda.fused_tick_k2(
                    batch, p, delivered
                )
                out = g1.to(pdt)
                check(torch.equal(gets, g1), f"K2 gets != K1 (K={K} {pdt})")
                check(torch.equal(
                    changed, delivered & (out != p).any(dim=1)
                ), f"K2 changed mask wrong (K={K} {pdt})")
                check(torch.equal(
                    prev_new, torch.where(delivered[:, None], out, p)
                ), f"K2 prev_new wrong (K={K} {pdt})")
                check(bool(changed.any()) and not bool(changed.all()),
                      f"K2 parity input degenerate (K={K})")
            say(f"phase kernels: K={K} {str(dtype)[6:]} R={R}: K1 vs plain "
                f"max rel err {err:.3g} (bound {bound:g}), repeat "
                f"bit-identical, K2 gets==K1 and changed/prev_new exact "
                f"for {str(dtype)[6:]} and bfloat16 prev")
    return worst


# -- phase 4: the server slice ----------------------------------------------

def _config_yaml(lease_length=3600, refresh=5):
    lines = ["resources:"]
    for prefix, kind, variant, _share in LANES:
        for t, cap in enumerate(CAP_TIERS):
            params = (
                f", parameters: [{{name: variant, value: {variant}}}]"
                if variant else ""
            )
            lines.append(
                f"  - identifier_glob: '{prefix}.t{t}.*'\n"
                f"    capacity: {cap}\n"
                f"    algorithm: {{kind: {kind}, lease_length: {lease_length},"
                f" refresh_interval: {refresh}, learning_mode_duration: 0"
                f"{params}}}"
            )
    lines.append(
        "  - identifier_glob: '*'\n    capacity: 1000\n"
        f"    algorithm: {{kind: 0, lease_length: {lease_length},"
        f" refresh_interval: {refresh}, learning_mode_duration: 0}}"
    )
    return "\n".join(lines) + "\n"


def _resource_ids(rng):
    import numpy as np

    shares = np.array([lane[3] for lane in LANES])
    lane = rng.choice(len(LANES), N_RES, p=shares / shares.sum())
    tier = rng.integers(0, len(CAP_TIERS), N_RES)
    return [f"{LANES[l][0]}.t{t}.r{i}" for i, (l, t) in enumerate(zip(lane, tier))]


def _populate(server, rng):
    """1M leases through the engine's bulk upsert (the snapshot-load
    path): 100 clients on each of 10,000 resources."""
    import numpy as np

    ids = _resource_ids(rng)
    res = [server.get_or_create_resource(r) for r in ids]
    engine = server._store_engine
    rids = np.repeat([r.store._rid for r in res], N_CLIENTS).astype(np.int32)
    cids = np.fromiter(
        (engine.client_handle(f"c{i}.{c}")
         for i in range(N_RES) for c in range(N_CLIENTS)),
        np.int64, count=N_RES * N_CLIENTS,
    )
    n = len(rids)
    now = time.time()
    engine.bulk_assign(
        rids, cids, np.full(n, now + 3600.0), np.full(n, 5.0),
        np.zeros(n), rng.integers(0, 100, n).astype(np.float64),
        np.ones(n, np.int32),
    )
    return res, rids.reshape(N_RES, N_CLIENTS), cids.reshape(N_RES, N_CLIENTS)


def _churn(engine, rng, rids, cids):
    """5% of resources refresh with new demand (bench.py's churn)."""
    import numpy as np

    pick = rng.choice(N_RES, CHURN, replace=False)
    n = CHURN * N_CLIENTS
    engine.bulk_refresh(
        rids[pick].ravel(), cids[pick].ravel(),
        np.full(n, time.time() + 3600.0), np.full(n, 5.0),
        rng.integers(0, 100, n).astype(np.float64),
    )


def _pcts(xs):
    import numpy as np

    a = np.asarray(xs) * 1000.0
    return float(np.percentile(a, 50)), float(np.percentile(a, 95))


async def _requests(torch, server, port, resources):
    """Discovery, GetCapacity for clients holding leases (served from the
    last solved grant) and for a new client (first-response decide), a
    ReleaseCapacity, over loopback gRPC."""
    import grpc

    from doorman_tpu_torch.proto import doorman_pb2 as pb
    from doorman_tpu_torch.proto.grpc_api import CapacityStub

    async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
        stub = CapacityStub(ch)
        d = await stub.Discovery(pb.DiscoveryRequest())
        check(d.is_master, "Discovery: not master")
        served = 0
        for i in (0, 17, N_RES // 2, N_RES - 1):
            res = resources[i]
            client = f"c{i}.3"
            lease = res.store.get(client)
            req = pb.GetCapacityRequest(client_id=client)
            r = req.resource.add()
            r.resource_id, r.wants, r.priority = res.id, lease.wants, 1
            r.has.capacity = lease.has
            out = await stub.GetCapacity(req)
            got = out.response[0]
            check(got.resource_id == res.id, "GetCapacity: wrong resource")
            check(got.gets.capacity == lease.has,
                  f"GetCapacity {res.id}: served {got.gets.capacity}, "
                  f"store holds {lease.has}")
            check(got.gets.expiry_time > time.time(), "expired lease served")
            served += 1
        # A brand-new client: the scalar first-response path.
        res = resources[1]
        req = pb.GetCapacityRequest(client_id="newcomer")
        r = req.resource.add()
        r.resource_id, r.wants, r.priority = res.id, 7.0, 1
        out = await stub.GetCapacity(req)
        cap = out.response[0].gets.capacity
        check(0.0 <= cap <= 7.0, f"first response {cap} outside [0, wants]")
        await stub.ReleaseCapacity(pb.ReleaseCapacityRequest(
            client_id="newcomer", resource_id=[res.id]))
        check(not res.store.has_client("newcomer"), "release did not drop")
        return served + 1


async def _drive_server(torch, dtype_name, ticks, quiet, seed):
    import numpy as np

    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    rng = np.random.default_rng(seed)
    server = CapacityServer(
        "smoke", TrivialElection(), mode="batch", native_store=True,
        solver_dtype=dtype_name, fused_tick=True, scoped_solve=True,
        tick_pipeline_depth=3, tick_interval=1.0, device=DEVICE,
    )
    port = await server.start(0, host="127.0.0.1", tick_loop=False)
    try:
        await server.load_config(parse_yaml_config(_config_yaml()))
        t = time.perf_counter()
        resources, rids, cids = _populate(server, rng)
        say(f"phase server[{dtype_name}]: {len(resources)} resources, "
            f"{server._store_engine.total_leases} leases populated in "
            f"{time.perf_counter() - t:.1f}s")
        dense_cuda.reset_launches()  # the main path starts here
        walls, modes = [], []
        for i in range(ticks + quiet):
            if i < ticks:
                _churn(server._store_engine, rng, rids, cids)
            t = time.perf_counter()
            await server.tick_once()
            walls.append(time.perf_counter() - t)
            modes.append(server._resident.last_solve_mode)
        await server.flush_ticks()
        torch.cuda.synchronize()
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        served = await _requests(torch, server, port, resources)
        return server, resources, walls, modes, launches, served
    finally:
        await server.stop()


def _check_server_grants(torch, server, resources):
    """The store of record against the device, the device grants against
    the kernel's plain version, and sampled rows against the f64 numpy
    oracles, all on the main path's own tables."""
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import (
        F32_PARITY_REL_BOUND,
        oracle_row,
    )
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.dense import DenseBatch, solve_dense

    solver = server._resident
    cfg = solver._config
    batch = DenseBatch(
        wants=solver._wants, has=solver._has, subclients=solver._sub,
        active=solver._act, capacity=cfg.cap_d, algo_kind=cfg.kind_d,
        learning=cfg.learn_d, static_capacity=cfg.statc_d,
    )
    f64 = solver._tdtype == torch.float64
    bound = F64_RTOL if f64 else F32_PARITY_REL_BOUND
    saved = dict(dense_cuda.LAUNCHES)
    kern = dense_cuda.solve_dense_k1(batch)
    dense_cuda.LAUNCHES.update(saved)  # a comparison launch: not counted
    plain = solve_dense(batch)
    err = _rel_err(torch, kern, plain, batch)
    check(bool(torch.isfinite(kern).all()), "non-finite grants")
    check(err <= bound, f"K1 vs plain on the server tables: {err:.3g}")
    # After the quiet ticks every row was delivered after the last
    # churn: rows the solve reports at their fixpoint (outside the
    # frontier) hold exactly the device grants in the store; rows still
    # in scope (overloaded proportional rows, whose grant sits on the
    # free-capacity clamp and moves by an ulp a tick, as in the
    # reference: tests/test_torch_scope.py) are within the parity bound.
    has = solver._has.double().cpu().numpy()
    cap_h = cfg.cap_h.astype(np.float64)
    frontier = set(solver._scope.ids().tolist())
    rng = np.random.default_rng(9)
    mism, settling, worst_store = 0, 0, 0.0
    for i in rng.choice(len(resources), min(400, len(resources)), replace=False):
        res = resources[i]
        row = solver._row_lut[res.store._rid]
        store = np.array([l.has for _c, l in res.store.items()])
        dev = has[row, : len(store)]
        if row in frontier:
            settling += 1
            scale = max(cap_h[row], 1e-30)
            worst_store = max(worst_store, float(np.abs(store - dev).max()) / scale)
        elif not np.array_equal(store, dev):
            mism += 1
    check(mism == 0, f"{mism} converged store rows differ from the device")
    check(worst_store <= bound if f64 else worst_store <= F32_PARITY_REL_BOUND,
          f"settling rows: store vs device {worst_store:.3g}")
    # The kernel's grants against the f64 oracles on the same inputs.
    tabs = {k: v.double().cpu().numpy() if v.is_floating_point() else
            v.cpu().numpy() for k, v in (
                ("w", batch.wants), ("h", batch.has), ("s", batch.subclients),
                ("a", batch.active), ("c", batch.capacity),
                ("k", batch.algo_kind), ("st", batch.static_capacity))}
    kern_np = kern.double().cpu().numpy()
    worst = 0.0
    for r in rng.choice(len(resources), 300, replace=False):
        m = tabs["a"][r]
        w = tabs["w"][r, m]
        want = oracle_row(int(tabs["k"][r]), float(tabs["c"][r]),
                          float(tabs["st"][r]), w, tabs["h"][r, m],
                          tabs["s"][r, m])
        scale = max(float(tabs["c"][r]), float(w.max()) if len(w) else 0.0)
        worst = max(worst, float(np.abs(kern_np[r, m] - want).max()) / scale)
    # The bounded portfolio fills are exact to the oracles' own bounded
    # iteration; the f32 bound covers f32 arithmetic (f64 rows likewise).
    check(worst <= F32_PARITY_REL_BOUND,
          f"kernel vs f64 oracle {worst:.3g} > {F32_PARITY_REL_BOUND:g}")
    return err, worst, settling


async def _servers(torch, card):
    out = {}
    for dtype_name, ticks, quiet, seed in (
        ("f32", TICKS, QUIET_TICKS, 1), ("f64", F64_TICKS, QUIET_TICKS, 2),
    ):
        server, resources, walls, modes, launches, served = (
            await _drive_server(torch, dtype_name, ticks, quiet, seed)
        )
        check(launches["k1"] > 0, f"{dtype_name}: K1 never launched")
        check(modes.count("scoped") >= ticks // 2,
              f"{dtype_name}: scoped ticks {modes.count('scoped')}")
        err, oracle_err, settling = _check_server_grants(
            torch, server, resources
        )
        p50, p95 = _pcts(walls[2:ticks])
        say(f"phase server[{dtype_name}]: {len(walls)} ticks "
            f"({ticks} with 5% churn, {quiet} quiet), modes "
            f"scoped={modes.count('scoped')} full={modes.count('full')}, "
            f"tick wall p50 {p50:.2f} ms p95 {p95:.2f} ms, launches "
            f"{launches}, K1 vs plain {err:.3g}, vs f64 oracle "
            f"{oracle_err:.3g}, {served} requests answered, store == "
            f"device grants on converged rows ({settling} of 400 sampled "
            f"still in scope); card {card}")
        phases = server._resident.phase_s
        say(f"phase server[{dtype_name}]: host phase ms per tick: " + ", ".join(
            f"{k} {v * 1000.0 / len(walls):.3f}"
            for k, v in phases.items() if v > 0
        ))
        out[dtype_name] = dict(
            p50=p50, p95=p95, launches=launches, ticks=len(walls),
            server=server,
        )
    return out


def phase_server(torch, card):
    # One event loop for both servers (gRPC's asyncio binding is per loop).
    return asyncio.run(_servers(torch, card))


# -- phase 5: the tracked path ----------------------------------------------

def phase_tracked(torch, server):
    import numpy as np

    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.dense import DenseBatch
    from doorman_tpu_torch.solver.resident import ResidentDenseSolver

    resources = list(server.resources.values())
    engine = server._store_engine
    solver = ResidentDenseSolver(
        engine, dtype=np.float32, device=DEVICE, rotate_ticks=5,
        scoped=False,
    )
    check(solver.enable_delta_tracking(), "delta tracking unsupported")
    rng = np.random.default_rng(3)
    dense_cuda.reset_launches()  # the tracked path starts here
    changed = 0
    for _ in range(6):
        pick = rng.choice(len(resources), CHURN, replace=False)
        for i in pick[:50]:
            res = resources[i]
            for c, lease in list(res.store.items())[:5]:
                res.store.assign(c, 3600.0, 5.0, lease.has,
                                 float(rng.integers(0, 100)), 1)
        solver.step(resources)
        changed += len(solver.take_changed_rids())
    torch.cuda.synchronize()
    launches = dict(dense_cuda.LAUNCHES)
    check(launches["k2"] > 0, "K2 never launched on the tracked path")
    check(changed > 0, "tracked path reported no changed rows")
    check(bool(torch.isfinite(solver._has).all()), "non-finite grants")
    # K2 once more on the tracked solver's own full tables and resident
    # previous-grants table, with the tick's 20% delivery.
    cfg = solver._config
    batch = DenseBatch(
        wants=solver._wants, has=solver._has, subclients=solver._sub,
        active=solver._act, capacity=cfg.cap_d, algo_kind=cfg.kind_d,
        learning=cfg.learn_d, static_capacity=cfg.statc_d,
    )
    g = torch.Generator(device="cpu").manual_seed(5)
    delivered = (torch.rand(batch.wants.shape[0], generator=g) < 0.2).cuda()
    (_g, _p, chg), _abs, rel = _check_k2(
        torch, batch, solver._prev, delivered, "tracked tables"
    )
    say(f"phase tracked: 6 full ticks with delta tracking on, launches "
        f"{launches}, {changed} changed rids delivered; K2 on the tracked "
        f"tables {list(batch.wants.shape)} {str(solver._prev.dtype)[6:]} "
        f"prev: vs plain {rel:.3g} relative, == K1, changed/prev_new exact "
        f"({int(chg.sum())} changed rows)")
    return launches


# -- the kernels' JSON line --------------------------------------------------

def _time_ms(torch, fn, reps=20):
    fn()
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _ops(torch, batch):
    """Floating-point operations the lane solve needs on these inputs,
    counted per lane element by the row's lane and load (overloaded
    iterative rows run their bounded loops; fitting rows do not)."""
    K = batch.wants.shape[1]
    n = batch.active.sum(dim=1).double()
    kind = batch.algo_kind
    over = (torch.where(batch.active, batch.wants, 0).sum(1) > batch.capacity)
    per = torch.full_like(n, 4.0)  # mask + sum of wants + final mask
    per += torch.where(kind == 1, 1.0, 0.0)
    per += torch.where(kind == 2, 6.0, 0.0)
    per += torch.where(kind == 4, 14.0, 0.0)
    fair_it = 30 if batch.wants.dtype == torch.float32 else 48
    per += torch.where((kind == 3) & over, 4.0 + 3.0 * fair_it + 8.0 + 2.0, 0.0)
    per += torch.where(((kind == 7) | (kind == 9)) & over, 1.0 + 16 * 4.0 + 2.0, 0.0)
    per += torch.where((kind == 8) & over, 9 * 6.0 + 8 * 3.0 + 3.0, 0.0)
    per = torch.where(batch.learning, 1.0, per)
    # Every lane of the row is visited (padding lanes too).
    return float((per * K).sum().item())


def kernel_line(torch, server, tracked_launches, main_launches, worst):
    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.dense import (
        DenseBatch,
        fused_tick_plain,
        solve_dense,
    )

    solver = server._resident
    cfg = solver._config
    batch = DenseBatch(
        wants=solver._wants, has=solver._has, subclients=solver._sub,
        active=solver._act, capacity=cfg.cap_d, algo_kind=cfg.kind_d,
        learning=cfg.learn_d, static_capacity=cfg.statc_d,
    )
    R, K = batch.wants.shape
    g = torch.Generator(device="cpu").manual_seed(4)
    delivered = (torch.rand(R, generator=g) < 0.2).cuda()
    # The server table's K1 grants, against the plain version.
    saved = dict(dense_cuda.LAUNCHES)
    k1 = dense_cuda.solve_dense_k1(batch)
    dense_cuda.LAUNCHES.update(saved)
    p1 = solve_dense(batch)
    rel1 = _rel_err(torch, k1, p1, batch)
    check(rel1 <= F32_PARITY_REL_BOUND, f"K1 vs plain {rel1:.3g} (server)")
    err1 = (k1 - p1).abs().max().item()
    # K2 at the same shape, with prev = the resident has where a third
    # of the rows moved since their last delivery; f32 and bf16 prev.
    prev = solver._has.clone()
    prev[::3] += 1.0
    err2 = 0.0
    for pdt in (torch.float32, torch.bfloat16):
        p = prev.to(pdt)
        (_g, _p, chg), e, _rel = _check_k2(
            torch, batch, p, delivered, f"server tables, {pdt} prev"
        )
        check(bool(chg.any()) and not bool(chg.all()),
              f"K2 changed mask degenerate ({pdt} prev)")
        err2 = max(err2, e)
    saved = dict(dense_cuda.LAUNCHES)
    k1_ms = _time_ms(torch, lambda: dense_cuda.solve_dense_k1(batch))
    k2_ms = _time_ms(torch, lambda: dense_cuda.fused_tick_k2(batch, prev, delivered))
    plain1_ms = _time_ms(torch, lambda: solve_dense(batch), reps=3)
    plain2_ms = _time_ms(
        torch, lambda: fused_tick_plain(batch, prev, delivered), reps=3
    )
    # The scoped tick's shape: K1 over a scope of ~1,000 gathered rows.
    scope = torch.randperm(R, generator=g)[:1024].to(torch.int32).cuda()
    k1_scope_ms = _time_ms(
        torch, lambda: dense_cuda.solve_dense_k1(batch, rows=scope)
    )
    dense_cuda.LAUNCHES.update(saved)  # timing launches: not counted
    it =batch.wants.element_size()
    ops = _ops(torch, batch)
    cols = R * (4 + 4 + 1 + 4)  # cap, kind, learning, static per row
    bytes1 = R * K * (3 * it + 1) + cols + R * K * it
    bytes2 = bytes1 + R * K * 2 * prev.element_size() + R + R
    flops = H100_F32_FLOPS
    entries = []
    for name, ms, pms, launches, nbytes, err, src, repl in (
        ("K1 dense lane solve", k1_ms, plain1_ms, main_launches["k1"],
         bytes1, err1, "doorman_tpu_torch/csrc/dense_solve.cu",
         "doorman_tpu/solver/pallas_dense.py:40"),
        ("K2 fused solve + delivered delta", k2_ms, plain2_ms,
         tracked_launches["k2"], bytes2, err2,
         "doorman_tpu_torch/csrc/dense_solve.cu",
         "doorman_tpu/solver/pallas_dense.py:57"),
    ):
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / flops * 1e3
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": int(launches), "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": [R, K], "dtype": str(batch.wants.dtype),
        })
    entries[0]["scoped_ms"] = k1_scope_ms
    entries[0]["scoped_rows"] = int(scope.numel())
    entries[0]["parity_rel_err"] = {str(k)[6:]: v for k, v in worst.items()}
    return {"kernels": entries}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (ROOT / "doorman_tpu_torch" / "csrc" / "dense_solve.cu").exists():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        name, card = phase_device(torch)
        phase_build()
        worst = phase_kernels(torch)
        servers = phase_server(torch, card)
        tracked = phase_tracked(torch, servers["f32"]["server"])
        line = kernel_line(
            torch, servers["f32"]["server"], tracked,
            servers["f32"]["launches"], worst,
        )
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say(f"summary: f32 tick wall p50 {servers['f32']['p50']:.2f} ms p95 "
        f"{servers['f32']['p95']:.2f} ms, f64 p50 {servers['f64']['p50']:.2f}"
        f" ms p95 {servers['f64']['p95']:.2f} ms at {N_RES * N_CLIENTS} "
        f"leases; total {time.perf_counter() - t0:.1f}s")
    say(card)
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
