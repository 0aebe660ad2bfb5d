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
then the same server with PRIORITY_BANDS resources in capacity groups
beside lane resources (the BatchSolver's grouped solve, kernel K3, in
the same tick as the resident K1 solve), and the delta-tracked full
tick, and checks what comes out. Every kernel has two layouts (a warp
per row up to 256 lanes, a block per row above); each layout of K1, K2
and K3 is held against the plain version at widths on both sides of
that line, and the two against each other. Kernel launch counters are
zeroed just before each path is driven and read just after. Last, the
f32 lane server runs again on two churn seeds with K1/K2 in each
layout, and the rows left in the scoped tick's frontier are reported.

Then resources of any width: K3's cluster layout, which spreads a row
wider than shared memory over a thread-block cluster, against its plain
version and against the one-block global layout up to 1,048,576 lanes,
staged in shared memory and streamed from global memory; the lane
server with one resource of 1,000,000 clients
and with ten of 100,000 (bench.py's wide shapes, on the chunked wide
resident solver), and one 20,000-client resource per lane kind; a narrow
resource overflowing between two ticks on the 1M-lease lane server (that
tick runs the BatchSolver's edge-list lane part, the next the wide
solver); and 8 PRIORITY_BANDS resources of 100,000 clients in two
binding capacity groups, whose every K3 launch is in the cluster layout.

Then the reference server's other settings: the round-trip tick
(`fused_tick=False`) beside the fused one on two lane servers from one
seed, whose stores must hold the same bytes, with one K1 launch a tick
and no K2 (and one wide pair); a batch server on the Python lease store
(1,000 PRIORITY_BANDS resources in two binding groups beside 1,000 lane
resources, 100 clients each), whose K3 grants must equal the native
store's BatchSolver's bit for bit; and an immediate-mode server, the
reference's default, answering GetCapacity over loopback with no kernel
launch, every grant equal to an in-process replay.

Last, streaming lease push (WatchCapacity): the reference's push-vs-poll
parity pin over loopback gRPC (a flip and a resume included; every
pushed row equal to the poll row of its tick); the lane cell with
100,000 subscriptions on a stream server whose fanout starts from K2's
changed rows and the device matcher, beside a twin that re-decides every
subscription every tick (equal pushes, byte for byte, and equal stores);
and bench.py's fanout tiers of 1,000 to 100,000 subscriptions (quiet
ticks walk no subscription, every churned row's subscribers are pushed).

Then the capacity tree: tools/drives/drive_tree3.py's root <- region <-
leaf, three servers in this process over loopback gRPC with the client
library's Clients on the leaf, converging to the banded and proportional
allocation with capacity conserved at every hop, and losing it once the
root stops and the parent leases lapse; and a root holding 100
downstream servers' band sub-leases over 1,000 resources, whose every
GetServerCapacity answer equals its store's band grants and whose
grants hold to the f64 oracles (K1/K2 over the lane rows, K3 over the
PRIORITY_BANDS rows, each against its plain version on those tables).

Last, observability (obs/): the f64 lane cell with the reference's obs
defaults and every other obs part on (tracer, history, audit, detector, a
torch.profiler capture of its first ticks) beside its twin with all of
them off; the audit's flags by class and a corrupted grant it must catch;
the priority cell under a capture; the device's busy share and each
kernel's profiler time beside its CUDA-event time; and the server
binary's /metrics and /debug/status on --debug-port.

Last, persistence and warm master takeover (persist/, server/etcd.py,
server/election.py, server/sources.py): the lane cell at f32 with
snapshots and a journal beside its persist-off twin, a clean step-down
and a new master restoring every store row for row and skipping
learning, its first tick full through K2, then a crash and a takeover
whose learning window shrinks to the state's age; the priority cell's
takeover, its first tick 38 K3 launches; and two server binaries under
an etcd election (tests/fake_etcd.py) with config and state in etcd:
the master killed, the standby restoring warm and the client's grant
back, then a config put reaching the master as a full tick.

Last, federation (federation/): the reference's sharded-vs-single-root
parity schedule at f64 (two shard roots and the straddle reconciliation
beat against one root, every grant equal, FAIR_SHARE within 1 ulp, the
shares never past capacity); two root shards of bench.py's federated
workload (1M leases each, 2M on the card) with one straddling resource
per reconcilable lane, ticking in lockstep rounds with a reconciliation
beat after each (every tick after a beat is a config-epoch full tick
through K2), their straddling grants merged over both shards against
the f64 oracle over the union of their clients; the aggregation adapter
at 10,000 x 100 at f32 and f64 against numpy per-band sums and the
native store's band_aggregates; and a federated intermediate over the
two roots on loopback gRPC (one GetServerCapacity per root per
exchange, the roots' band sub-leases equal to its aggregates, K3 on the
roots' band rows, one root blocked).

Last, admission and the frontend (admission/, workload/forecast.py,
frontend/): admission-fused, the lane cell at f32 with every churn tick's
50,000 refreshes sent through the admission coalescer's windows on two
twins from one seed, one whose windows stage the rows they wrote for the
resident tick (K1/K2 served from the staging cache) and one whose do not
(answers, stores and device grants equal after every tick, launches
equal, staged rows served on every churn tick); admission-storm,
bench.py's RPC storm against the immediate-mode server with admission
off and on, its workers in other processes (the top band, a release or
a shed without the retry-after trailer fails it); forecast, the seasonal
forecaster's step on the card against its numpy oracle, bit for bit;
frontend-parity, run inside the streams phase: its unscoped pair's
filtered server (the lane cell with 100,000 subscriptions) pooled over
four push rings, every frame byte-equal to the check-all twin's pushes,
no ring lap; and frontend-pool, four real listener workers under an
establishment storm and a held population, the sentinel's push latency,
then cmd/frontend_smoke's kill-and-resume arc.

Last, the fleet (fleet/, cmd/fleet.py) and TLS on every hop: fleet-reshard,
three shard roots of bench.py's build_shard shape (1M leases each) under
the FleetController, two active, then a live reshard to three: the moved
resources' rows carried to the new owner with their has and solved there
within the f32 bound of the f64 oracle, 1,000 stale-router refreshes
redirected to the new owner and counted, the stayed resources at rest
byte-identical across the install, Σ straddling shares within capacity
every beat; fleet-procs, cmd.fleet --smoke with its three shard processes
ticking on the card; tls, the server binary over TLS beside a plaintext
twin (equal grants), request latency over TLS beside plaintext, two
listener workers terminating TLS (frames byte-equal to a plaintext
pool's), and an intermediate dialing a TLS root.

Last, chaos and the load tester (chaos/, loadtest/, cmd/chaos.py): chaos,
every shipped fault plan through ChaosRunner(plan, device="cuda"), each
replayed on the card (the same log_sha256) and held to its device="cpu"
twin (the master timeline, the event kinds less pure push entries, the
store grants within 1e-12 relative), the audit catching the corrupted
grant, K1 launched by device_tunnel_outage's resident ticks, then
`cmd.chaos --plan device_tunnel_outage --device cuda` as a process; and
loadtest-lane, the lane cell's server on its real 1 s tick loop with 5%
churn a tick under loadtest.storm.run_storm_procs (48 poll workers in 4
spawned processes, bands 0/1/2, ~10 s on prop.t0.storm): request p50 /
p99 by band, the tick wall under the storm beside storm-free ticks, the
host phase laps and the K1/K2 the storm's ticks launch, then the grants
against the f64 oracles after quiet ticks.

Beside them, the workload harness (workload/, cmd/workload.py): the ten small
scenarios through run_scenario(name, device="cuda") at scale 1.0, each
replayed on the card and run again on the CPU (log_sha256 equal), every
server and the forecaster on the card; diurnal_million with 1,000,000
resident clients on the vector engine (peak population, refresh ratio,
driver tick mean and max); flash_crowd_million at scales 0.001 / 0.003 /
0.01 (its PRIORITY_BANDS decide is quadratic in the parked population,
in both packages: the fitted exponent of seconds against clients stands
in for scale 1.0), each million scenario beside its CPU twin at 0.01;
and `cmd.workload --scenario flash_crowd_predictive --device cuda` as a
process. The servers run in immediate mode: no K1/K2/K3 launch.

The streams phase (in two halves), the takeover phase and the workload
phase run in processes of their own beside the main sequence (BESIDE),
from the end of the
kernels' timings until the admission phase; each one's lines are printed
when it is joined.

Prints one line per phase, the card's name and power limit, one JSON line
of per-kernel measurements, and last the JSON result line. Exits non-zero
(and prints no result) without a CUDA device, outside a checkout of the
repo, or when any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
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

# The priority slice: 10,000 PRIORITY_BANDS resources x 100 clients, 80%
# of them in 16 capacity groups of 500 whose caps are 25% of their
# members' summed capacity (every group binds), beside 1,000 lane
# resources x 100 clients.
N_PRIO = 10_000
N_PRIO_LANE = 1_000
N_GROUPS = 16
GROUP_SIZE = 500
GROUP_SHARE = 0.25
PRIORITIES = (0, 1, 5, 10)  # wire priorities: 4 bands
PRIO_TICKS = 10
PRIO_F64_TICKS = 4
# Grouped solve, K3 vs the plain solve: the reference's own
# kernel-vs-XLA bound (tests/test_pallas_priority.py), relative to the
# row's capacity (the theta bisection turns an ulp of usage into a
# different feasible theta).
K3_SOLVE_RTOL = 1e-5


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
    # Every kernel entry's registers and spills as ptxas reported them;
    # the warp layouts hold their rows in registers and must not spill.
    usage, unknown = {}, []
    for entry, use in dense_cuda.ptxas_usage().items():
        label = dense_cuda.entry_label(entry)
        if label is None:
            unknown.append(entry)
        else:
            usage[label] = use
    for kern in ("K1", "K2", "K3"):
        say(f"phase build: {kern} ptxas " + ", ".join(
            f"{n[3:]} {u['registers']} registers, {u['spill_stores']}/"
            f"{u['spill_loads']} B spilled"
            for n, u in sorted(usage.items()) if n.startswith(kern)))
    # K1: 2 block + 8 warp (f32/f64, V = 1/2/4/8); K2: twice K1's, one
    # per prev type; K3: 2 block + 8 warp + 2 global + 4 cluster (f32/f64,
    # staged and streamed).
    counts = {k: sum(n.startswith(k) for n in usage) for k in ("K1", "K2", "K3")}
    check(counts == {"K1": 10, "K2": 20, "K3": 16},
          f"ptxas reported {counts} kernel entries; unlabelled: {unknown}")
    spills = [n for n, u in usage.items()
              if (" warp " in n or " cluster " in n)
              and (u["spill_stores"] or u["spill_loads"])]
    check(not spills, f"warp or cluster layout spills: {spills}")
    check(sum(" global " in n for n in usage) == 2,
          "K3's global layout entries missing from ptxas's report")
    cluster = {n: u for n, u in usage.items() if " cluster " in n}
    check(len(cluster) == 4,
          "K3's cluster layout entries missing from ptxas's report")
    say("phase build: K3 cluster layout ptxas " + ", ".join(
        f"{n[11:]} {u['registers']} registers, {u['spill_stores']}/"
        f"{u['spill_loads']} B spilled" for n, u in sorted(cluster.items())))
    return usage


# -- phase 3: kernel parity -------------------------------------------------

def _parity_batch(torch, rng, R, K, dtype):
    import numpy as np

    from doorman_tpu_torch.solver.carry import tables_from_numpy

    n = rng.integers(1, K + 1, R)  # every row padded past its clients
    act = np.arange(K)[None, :] < n[:, None]
    act[0] = False  # a wholly inactive row
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
        has * act, device=DEVICE, dtype=dtype,
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
    """K1 and K2 against their plain versions on the same CUDA tensors —
    the warp layout at K = 8, 100, 128, 256, the block layout at K = 257
    and 4096, f32 and f64, every lane kind with fitting and overflowing
    rows — with repeat launches bit-identical, the gather form equal to
    the full form's rows, K2's grants equal to K1's and its changed /
    prev_new exact for prev in the solve dtype and bfloat16; then the two
    layouts against each other on one K = 128 table. Comparison
    launches: not counted."""
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.dense import solve_dense

    saved = dict(dense_cuda.LAUNCHES)
    rng = np.random.default_rng(2024)
    worst = {}
    for K in (8, 100, 128, 256, 257, 4096):
        R = 96 if K == 4096 else 1024
        layout = dense_cuda.k1_layout(K)
        for dtype in (torch.float32, torch.float64):
            tag = f"K={K} {str(dtype)[6:]} {layout} layout"
            batch, prev = _parity_batch(torch, rng, R, K, dtype)
            g1 = dense_cuda.solve_dense_k1(batch)
            g2 = dense_cuda.solve_dense_k1(batch)
            plain = solve_dense(batch)
            torch.cuda.synchronize()
            check(torch.equal(g1, g2), f"K1 not deterministic ({tag})")
            check(bool(torch.isfinite(g1).all()), f"K1 non-finite ({tag})")
            check(not bool(g1[0].any()), f"K1 grants on an inactive row ({tag})")
            err = _rel_err(torch, g1, plain, batch)
            bound = F32_PARITY_REL_BOUND if dtype == torch.float32 else F64_RTOL
            check(err <= bound, f"K1 vs plain {err:.3g} > {bound:g} ({tag})")
            key = (str(dtype)[6:], layout)
            worst[key] = max(worst.get(key, 0.0), err)
            over = (torch.where(batch.active, batch.wants, 0).sum(1)
                    > batch.capacity)
            check(bool(over.any()) and not bool(over.all()),
                  f"K1 parity input degenerate ({tag})")
            rows = torch.from_numpy(
                rng.permutation(R)[: R // 3].astype(np.int32)
            ).cuda()
            check(torch.equal(dense_cuda.solve_dense_k1(batch, rows=rows),
                              g1[rows.long()]),
                  f"K1 row-gather form disagrees ({tag})")
            delivered = torch.from_numpy(rng.random(R) < 0.5).cuda()
            for pdt in (dtype, torch.bfloat16):
                p = prev.to(pdt)
                p[::3] = g1[::3].to(pdt)  # some delivered rows unchanged
                gets, prev_new, changed = dense_cuda.fused_tick_k2(
                    batch, p, delivered
                )
                out = g1.to(pdt)
                check(torch.equal(gets, g1), f"K2 gets != K1 ({tag} {pdt})")
                check(torch.equal(
                    changed, delivered & (out != p).any(dim=1)
                ), f"K2 changed mask wrong ({tag} {pdt})")
                check(torch.equal(
                    prev_new, torch.where(delivered[:, None], out, p)
                ), f"K2 prev_new wrong ({tag} {pdt})")
                check(bool(changed.any()) and not bool(changed.all()),
                      f"K2 parity input degenerate ({tag})")
            say(f"phase kernels: {tag} R={R}: K1 vs plain max rel err "
                f"{err:.3g} (bound {bound:g}), {over.float().mean().item():.0%}"
                f" rows overloaded, repeat bit-identical, gather form == full"
                f" rows, K2 gets==K1 and changed/prev_new exact for "
                f"{str(dtype)[6:]} and bfloat16 prev")
    # The two layouts on one K = 128 table: within the same bounds (not
    # bit-equal: their sums run in other orders); each layout's K2 gets
    # equal to its own K1.
    for dtype in (torch.float32, torch.float64):
        bound = F32_PARITY_REL_BOUND if dtype == torch.float32 else F64_RTOL
        batch, prev = _parity_batch(torch, rng, 1024, 128, dtype)
        delivered = torch.from_numpy(rng.random(1024) < 0.5).cuda()
        gw = dense_cuda._launch_k1("warp", batch)
        gb = dense_cuda._launch_k1("block", batch)
        kw = dense_cuda._launch_k2("warp", batch, prev, delivered)[0]
        kb = dense_cuda._launch_k2("block", batch, prev, delivered)[0]
        plain = solve_dense(batch)
        torch.cuda.synchronize()
        tag = f"K=128 {str(dtype)[6:]}"
        lerr = _rel_err(torch, gw, gb, batch)
        berr = _rel_err(torch, gb, plain, batch)
        check(berr <= bound, f"K1 block layout vs plain {berr:.3g} ({tag})")
        check(lerr <= bound, f"K1 warp vs block layout {lerr:.3g} ({tag})")
        check(torch.equal(kw, gw) and torch.equal(kb, gb),
              f"K2 gets != K1 of the same layout ({tag})")
        key = (str(dtype)[6:], "block")
        worst[key] = max(worst.get(key, 0.0), berr)
        say(f"phase kernels: {tag}: K1 warp vs block layout {lerr:.3g}, "
            f"block vs plain {berr:.3g} (bound {bound:g}), each layout's K2 "
            f"gets == its K1")
    dense_cuda.LAUNCHES.update(saved)
    return worst


# -- phase 3b: K3 parity ----------------------------------------------------

def _put(torch, arr, dtype=None):
    t = torch.from_numpy(arr).to(DEVICE)
    return t.to(dtype) if dtype is not None else t


def _k3_tables(torch, rng, R, K, dtype):
    """Banded-fill inputs: every row padded past its clients, 4 bands,
    capacities leaving rows both fitting and overloaded; row 0 wholly
    inactive, row 1 of capacity 0, rows 2-3 with no member in bands 1
    and 3, rows 4-5 full and below any one client's wants (every band
    overflows)."""
    import numpy as np

    n = rng.integers(1, K + 1, R)
    n[4:6] = K
    act = np.arange(K)[None, :] < n[:, None]
    wants = rng.random((R, K)) * 100 * act
    weights = rng.integers(1, 4, (R, K)).astype(np.float64) * act
    band = (rng.integers(0, 4, (R, K)) * act).astype(np.int32)
    cap = rng.random(R) * 80 * n + 5
    act[0] = False
    wants[0] = weights[0] = band[0] = 0
    cap[1] = 0.0
    band[2:4] = (band[2:4] // 2) * 2
    cap[4:6] = wants[4:6].min(1) / 2
    return (_put(torch, wants, dtype), _put(torch, weights, dtype),
            _put(torch, band), _put(torch, act), _put(torch, cap, dtype))


def _k3_rel(torch, got, want, wants, active, cap):
    scale = torch.maximum(
        cap, torch.where(active, wants, 0).amax(1)
    )[:, None].double().clamp_min(1e-30)
    return ((got.double() - want.double()).abs() / scale).max().item()


def _widest_k3_row(torch, dtype):
    """The widest row K3's block layout stages in shared memory
    (priority_cuda.k3_layout)."""
    from doorman_tpu_torch.solver.priority_cuda import SMEM_LIMIT, k3_smem_bytes

    it = torch.empty((), dtype=dtype).element_size()
    K = (SMEM_LIMIT - 64 * it) // (5 * it + 6)
    check(k3_smem_bytes(K, it) <= SMEM_LIMIT < k3_smem_bytes(K + 1, it),
          f"widest K3 row miscounted ({K} at {dtype})")
    return K


def phase_kernels_k3(torch):
    """K3 against its plain version on the same CUDA tensors — the warp
    layout at K = 8, 100, 128, 256, the block layout at K = 257, 4096 and
    the widest row it admits; f32 and f64; 1 and 4 bands — with repeat
    launches bit-identical and the row totals checked; the two layouts
    against each other on one K = 128 table (the cluster and global
    layouts, for rows wider than the block layout stages, have their own
    phase); the grouped solve_priority
    through K3 against the plain solve, two calls bit-identical.
    Comparison launches: not counted."""
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.priority import (
        PriorityBatch,
        _alloc_banded,
        solve_priority,
    )
    from doorman_tpu_torch.solver.priority_cuda import (
        _launch_layout,
        alloc_banded_k3,
        k3_layout,
    )

    saved = dict(dense_cuda.LAUNCHES)
    rng = np.random.default_rng(2025)
    worst = {}
    for dtype in (torch.float32, torch.float64):
        bound = F32_PARITY_REL_BOUND if dtype == torch.float32 else F64_RTOL
        # The row totals feed the group usage: a tree sum of up to K
        # grants, held to the grouped solve's bound at f32.
        tbound = K3_SOLVE_RTOL if dtype == torch.float32 else F64_RTOL
        it = torch.empty((), dtype=dtype).element_size()
        for K in (8, 100, 128, 256, 257, 4096, _widest_k3_row(torch, dtype)):
            R = 1024 if K <= 257 else (96 if K == 4096 else 32)
            layout = k3_layout(K, it)
            w, wt, band, act, cap = _k3_tables(torch, rng, R, K, dtype)
            over = (torch.where(act, w, 0).sum(1) > cap).float().mean().item()
            for nb in (1, 4):
                g1, t1 = alloc_banded_k3(w, wt, band, act, cap, nb, totals=True)
                g2, t2 = alloc_banded_k3(w, wt, band, act, cap, nb, totals=True)
                g3 = alloc_banded_k3(w, wt, band, act, cap, nb)
                plain = _alloc_banded(w, wt, band, act, cap, nb)
                torch.cuda.synchronize()
                tag = f"K={K} {str(dtype)[6:]} {nb} band(s) {layout} layout"
                check(torch.equal(g1, g2) and torch.equal(g1, g3)
                      and torch.equal(t1, t2), f"K3 not deterministic ({tag})")
                check(bool(torch.isfinite(g1).all()), f"K3 non-finite ({tag})")
                err = _k3_rel(torch, g1, plain, w, act, cap)
                check(err <= bound, f"K3 vs plain {err:.3g} > {bound:g} ({tag})")
                check(not bool(g1[:2].any()),
                      f"K3 grants on an inactive or zero-capacity row ({tag})")
                terr = _k3_rel(torch, t1[:, None], g1.double().sum(1)[:, None],
                               w, act, cap)
                check(terr <= tbound, f"K3 row totals off by {terr:.3g} ({tag})")
                check(0.05 < over < 0.95, f"K3 parity input degenerate ({tag})")
                worst[(str(dtype)[6:], layout)] = max(
                    worst.get((str(dtype)[6:], layout), 0.0), err)
                say(f"phase kernels-K3: {tag} R={R}: vs plain max rel err "
                    f"{err:.3g} (bound {bound:g}), repeat bit-identical, row "
                    f"totals within {terr:.3g}, {over:.0%} rows overloaded")
        # The two layouts on one K = 128 table: within the same bounds
        # (not bit-equal: their sums run in other orders).
        w, wt, band, act, cap = _k3_tables(torch, rng, 1024, 128, dtype)
        for nb in (1, 4):
            gw, tw = _launch_layout("warp", w, wt, band, act, cap, nb, True)
            gb, tb = _launch_layout("block", w, wt, band, act, cap, nb, True)
            gb2, _tb2 = _launch_layout("block", w, wt, band, act, cap, nb, True)
            plain = _alloc_banded(w, wt, band, act, cap, nb)
            torch.cuda.synchronize()
            tag = f"K=128 {str(dtype)[6:]} {nb} band(s)"
            check(torch.equal(gb, gb2), f"K3 block layout not deterministic ({tag})")
            lerr = _k3_rel(torch, gw, gb, w, act, cap)
            berr = _k3_rel(torch, gb, plain, w, act, cap)
            terr = _k3_rel(torch, tw[:, None], tb[:, None], w, act, cap)
            check(berr <= bound, f"K3 block layout vs plain {berr:.3g} ({tag})")
            check(lerr <= bound, f"K3 warp vs block layout {lerr:.3g} ({tag})")
            check(terr <= tbound, f"K3 warp vs block row totals {terr:.3g} ({tag})")
            worst[(str(dtype)[6:], "block")] = max(
                worst.get((str(dtype)[6:], "block"), 0.0), berr)
            say(f"phase kernels-K3: {tag}: warp vs block layout {lerr:.3g}, "
                f"block vs plain {berr:.3g} (bound {bound:g}), row totals "
                f"{terr:.3g}")
    # The grouped solve: two groups, caps 50% and 25% of their members'
    # capacity (bench.py's TPU gate), K = 128.
    solve_err = {}
    for dtype in (torch.float32, torch.float64):
        R, K = 1024, 128
        w, wt, band, act, cap = _k3_tables(torch, rng, R, K, dtype)
        group = rng.choice(np.array([-1, 0, 1], np.int32), R)
        cap_h = cap.double().cpu().numpy()
        gcap = np.asarray([cap_h[group == 0].sum() * 0.5,
                           cap_h[group == 1].sum() * 0.25])
        batch = PriorityBatch(
            wants=w, weights=wt, band=band, active=act, capacity=cap,
            group=_put(torch, group), group_cap=_put(torch, gcap, dtype),
        )
        k1 = solve_priority(batch, 4, use_kernel=True)
        k2 = solve_priority(batch, 4, use_kernel=True)
        plain = solve_priority(batch, 4, use_kernel=False)
        torch.cuda.synchronize()
        tag = str(dtype)[6:]
        check(torch.equal(k1, k2), f"grouped solve not deterministic ({tag})")
        scale = cap.double().clamp_min(1e-30)[:, None]
        err = ((k1.double() - plain.double()).abs() / scale).max().item()
        check(err <= K3_SOLVE_RTOL,
              f"grouped solve K3 vs plain {err:.3g} > {K3_SOLVE_RTOL:g} ({tag})")
        usage = [k1.double().sum(1)[_put(torch, group == g)].sum().item()
                 for g in (0, 1)]
        check(all(u <= c * (1 + 1e-6) for u, c in zip(usage, gcap)),
              f"grouped solve exceeds a group cap ({tag}): {usage} {gcap}")
        solve_err[tag] = err
        say(f"phase kernels-K3: grouped solve_priority {tag} R={R} K={K} "
            f"2 groups: K3 vs plain {err:.3g} of capacity (bound "
            f"{K3_SOLVE_RTOL:g}), two calls bit-identical, group usage "
            f"{usage[0]:.6g}/{gcap[0]:.6g} {usage[1]:.6g}/{gcap[1]:.6g}")
    dense_cuda.LAUNCHES.update(saved)
    return worst, solve_err


# -- phase 4: the server slice ----------------------------------------------

def _lane_templates(lease_length=3600, refresh=5, learning=0):
    lines = []
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
                f" refresh_interval: {refresh}, learning_mode_duration:"
                f" {learning}{params}}}"
            )
    return lines


def _config_yaml(lease_length=3600, refresh=5, learning=0):
    lines = ["resources:"] + _lane_templates(lease_length, refresh, learning)
    lines.append(
        "  - identifier_glob: '*'\n    capacity: 1000\n"
        f"    algorithm: {{kind: 0, lease_length: {lease_length},"
        f" refresh_interval: {refresh}, learning_mode_duration: {learning}}}"
    )
    return "\n".join(lines) + "\n"


def _resource_ids(rng, n=N_RES):
    import numpy as np

    shares = np.array([lane[3] for lane in LANES])
    lane = rng.choice(len(LANES), n, p=shares / shares.sum())
    tier = rng.integers(0, len(CAP_TIERS), n)
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
    """5% of resources refresh with new demand (bench.py's churn);
    returns the indices of the resources picked."""
    import numpy as np

    pick = rng.choice(N_RES, CHURN, replace=False)
    n = CHURN * N_CLIENTS
    engine.bulk_refresh(
        rids[pick].ravel(), cids[pick].ravel(),
        np.full(n, time.time() + 3600.0), np.full(n, 5.0),
        rng.integers(0, 100, n).astype(np.float64),
    )
    return pick


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


async def _drive_server(torch, dtype_name, ticks, quiet, seed, fused=True,
                        tracked=None, label="server"):
    """The lane cell's server from `seed`: churn and quiet ticks, launches
    read around them, then requests over loopback. With a `tracked` dict,
    the store's has after those ticks, then RT_TRACKED_TICKS delta-
    tracked churn ticks and their changed rows and launches, land in it."""
    import numpy as np

    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    rng = np.random.default_rng(seed)
    server = CapacityServer(
        "smoke", TrivialElection(), mode="batch", native_store=True,
        solver_dtype=dtype_name, fused_tick=fused, scoped_solve=True,
        tick_pipeline_depth=3, tick_interval=1.0, flightrec_capacity=0,
        device=DEVICE,
    )
    port = await server.start(0, host="127.0.0.1", tick_loop=False)
    try:
        await server.load_config(parse_yaml_config(_config_yaml()))
        t = time.perf_counter()
        resources, rids, cids = _populate(server, rng)
        say(f"phase {label}[{dtype_name}]: {len(resources)} resources, "
            f"{server._store_engine.total_leases} leases populated in "
            f"{time.perf_counter() - t:.1f}s")
        dense_cuda.reset_launches()  # the main path starts here
        walls, modes, scopes = [], [], []
        for i in range(ticks + quiet):
            if i < ticks:
                _churn(server._store_engine, rng, rids, cids)
            t = time.perf_counter()
            await server.tick_once()
            walls.append(time.perf_counter() - t)
            modes.append(server._resident.last_solve_mode)
            scopes.append(server._resident.last_scope["rows"])
        await server.flush_ticks()
        torch.cuda.synchronize()
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        if tracked is not None:
            solver = server._resident
            tracked["has"] = _packed_has(server)
            tracked["phases"] = {k: v * 1e3 / len(walls)
                                 for k, v in solver.phase_s.items() if v > 0}
            # The next tick rebuilds with the previous-grants table; the
            # changed rows are read after every tick and after the flush.
            solver.enable_delta_tracking()
            name = {r.store._rid: r.id for r in resources}
            dense_cuda.reset_launches()
            changed = []
            for i in range(RT_TRACKED_TICKS + 1):
                if i < RT_TRACKED_TICKS:
                    _churn(server._store_engine, rng, rids, cids)
                    await server.tick_once()
                else:
                    await server.flush_ticks()
                changed.append(
                    sorted(name[r] for r in solver.take_changed_rids()))
            torch.cuda.synchronize()
            tracked.update(changed=changed, has_after=_packed_has(server),
                           launches=dict(dense_cuda.LAUNCHES))
        served = await _requests(torch, server, port, resources)
        return server, resources, walls, modes, scopes, launches, served
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
    from doorman_tpu_torch.solver.dense import solve_dense

    solver = server._resident
    cfg = solver._config
    batch = solver.table()
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
    has = batch.has.double().cpu().numpy()
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


def _frontier(server):
    """(rows in the scope frontier, lane rows, {kind name: frontier
    rows}) of a server's resident solver."""
    import numpy as np

    from doorman_tpu_torch.algorithms.kinds import AlgoKind

    solver = server._resident
    ids = solver._scope.ids()
    kinds, counts = np.unique(solver._config.kind_h[ids], return_counts=True)
    by_kind = {AlgoKind(int(k)).name: int(n) for k, n in zip(kinds, counts)}
    return len(ids), solver._R, by_kind


async def _servers(torch, card):
    out = {}
    for dtype_name, ticks, quiet, seed in (
        ("f32", TICKS, QUIET_TICKS, 1), ("f64", F64_TICKS, QUIET_TICKS, 2),
    ):
        server, resources, walls, modes, scopes, launches, served = (
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
        # The rows the scoped ticks solve: the churned rows' closure plus
        # the frontier of rows not yet at their fixpoint (which the sum
        # order of K1's layout may move: reported, not checked).
        frontier, n_rows, by_kind = _frontier(server)
        scoped = [n for n, m in zip(scopes, modes) if m == "scoped"]
        say(f"phase server[{dtype_name}]: lane rows in scope: frontier "
            f"after the quiet ticks {frontier} of {n_rows} "
            f"({frontier / max(n_rows, 1):.1%}; {by_kind}); scoped ticks "
            f"solved {sum(scoped) / max(len(scoped), 1):.0f} rows on "
            f"average (last quiet tick {scopes[-1]}); {settling} of 400 "
            f"sampled rows in scope")
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


# -- phase 4b: PRIORITY_BANDS with capacity groups beside lane resources ------

def _prio_layout(rng):
    """(resource ids, capacities, group ids, group caps) of the
    PRIORITY_BANDS resources: 16 groups of 500, the rest uncoupled; each
    group's cap is GROUP_SHARE of its members' summed capacity."""
    import numpy as np

    tier = rng.integers(0, len(CAP_TIERS), N_PRIO)
    group = np.full(N_PRIO, -1, np.int64)
    group[: N_GROUPS * GROUP_SIZE] = np.repeat(np.arange(N_GROUPS), GROUP_SIZE)
    rng.shuffle(group)
    cap = np.asarray(CAP_TIERS)[tier]
    gcap = np.asarray([GROUP_SHARE * cap[group == g].sum()
                       for g in range(N_GROUPS)])
    ids = [f"p.g{g}.t{t}.r{i}" if g >= 0 else f"p.u.t{t}.r{i}"
           for i, (g, t) in enumerate(zip(group, tier))]
    return ids, cap, group, gcap


def _prio_yaml(gcap, lease_length=3600, refresh=5):
    algo = (f"{{kind: PRIORITY_BANDS, lease_length: {lease_length}, "
            f"refresh_interval: {refresh}, learning_mode_duration: 0}}")
    lines = ["groups:"]
    for g, c in enumerate(gcap):
        lines.append(f"  - name: g{g}\n    capacity: {float(c)!r}")
    lines.append("resources:")
    for t, cap in enumerate(CAP_TIERS):
        for g in range(len(gcap)):
            lines.append(
                f"  - identifier_glob: 'p.g{g}.t{t}.*'\n    capacity: {cap}\n"
                f"    capacity_group: g{g}\n    algorithm: {algo}"
            )
        lines.append(f"  - identifier_glob: 'p.u.t{t}.*'\n    capacity: {cap}\n"
                     f"    algorithm: {algo}")
    lines += _lane_templates(lease_length, refresh)
    lines.append(
        "  - identifier_glob: '*'\n    capacity: 1000\n"
        f"    algorithm: {{kind: 0, lease_length: {lease_length},"
        f" refresh_interval: {refresh}, learning_mode_duration: 0}}"
    )
    return "\n".join(lines) + "\n"


def _populate_prio(server, rng, ids):
    """100 clients on each resource through the engine's bulk upsert:
    the PRIORITY_BANDS leases (the first N_PRIO resources) with 1-3
    subclients and wire priorities from PRIORITIES, the lane leases as
    in the lane phase."""
    import numpy as np

    res = [server.get_or_create_resource(r) for r in ids]
    engine = server._store_engine
    rids = np.repeat([r.store._rid for r in res], N_CLIENTS).astype(np.int32)
    cids = np.fromiter(
        (engine.client_handle(f"c{i}.{c}")
         for i in range(len(ids)) for c in range(N_CLIENTS)),
        np.int64, count=len(ids) * N_CLIENTS,
    )
    n, n_prio = len(rids), N_PRIO * N_CLIENTS
    sub = np.ones(n, np.int32)
    sub[:n_prio] = rng.integers(1, 4, n_prio)
    prio = np.zeros(n, np.int64)
    prio[:n_prio] = rng.choice(np.asarray(PRIORITIES), n_prio)
    now = time.time()
    engine.bulk_assign(
        rids, cids, np.full(n, now + 3600.0), np.full(n, 5.0), np.zeros(n),
        rng.integers(0, 100, n).astype(np.float64), sub, prio,
    )
    return (res, rids.reshape(len(ids), N_CLIENTS),
            cids.reshape(len(ids), N_CLIENTS))


def _churn_prio(engine, rng, rids, cids):
    """5% of the priority and 5% of the lane resources refresh with new
    demand (priorities and subclients kept)."""
    import numpy as np

    pick = np.concatenate([
        rng.choice(N_PRIO, N_PRIO // 20, replace=False),
        N_PRIO + rng.choice(N_PRIO_LANE, N_PRIO_LANE // 20, replace=False),
    ])
    n = len(pick) * N_CLIENTS
    engine.bulk_refresh(
        rids[pick].ravel(), cids[pick].ravel(),
        np.full(n, time.time() + 3600.0), np.full(n, 5.0),
        rng.integers(0, 100, n).astype(np.float64),
    )


async def _prio_requests(torch, server, port, resources):
    """GetCapacity over loopback for clients of priority resources
    (served from the store), a newcomer's first response on a priority
    resource (the scalar priority_bands), and its release."""
    import grpc

    from doorman_tpu_torch.proto import doorman_pb2 as pb
    from doorman_tpu_torch.proto.grpc_api import CapacityStub

    async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
        stub = CapacityStub(ch)
        served = 0
        for i in (0, 17, N_PRIO // 2, N_PRIO - 1):
            res = resources[i]
            client = f"c{i}.3"
            lease = res.store.get(client)
            req = pb.GetCapacityRequest(client_id=client)
            r = req.resource.add()
            r.resource_id, r.wants, r.priority = res.id, lease.wants, lease.priority
            r.has.capacity = lease.has
            out = await stub.GetCapacity(req)
            got = out.response[0]
            check(got.resource_id == res.id, "GetCapacity: wrong resource")
            check(got.gets.capacity == lease.has,
                  f"GetCapacity {res.id}: served {got.gets.capacity}, "
                  f"store holds {lease.has}")
            served += 1
        res = resources[1]
        req = pb.GetCapacityRequest(client_id="newcomer")
        r = req.resource.add()
        r.resource_id, r.wants, r.priority = res.id, 7.0, 10
        out = await stub.GetCapacity(req)
        cap = out.response[0].gets.capacity
        check(0.0 <= cap <= 7.0, f"priority first response {cap} outside "
              "[0, wants]")
        await stub.ReleaseCapacity(pb.ReleaseCapacityRequest(
            client_id="newcomer", resource_id=[res.id]))
        check(not res.store.has_client("newcomer"), "release did not drop")
        return served + 1


async def _drive_prio(torch, dtype_name, ticks, seed, **server_kw):
    import numpy as np

    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    rng = np.random.default_rng(seed)
    prio_ids, cap, group, gcap = _prio_layout(rng)
    ids = prio_ids + _resource_ids(rng, N_PRIO_LANE)
    server = CapacityServer(
        "smoke-prio", TrivialElection(), mode="batch", native_store=True,
        solver_dtype=dtype_name, fused_tick=True, scoped_solve=True,
        tick_pipeline_depth=3, tick_interval=1.0, device=DEVICE,
        **{"flightrec_capacity": 0, **server_kw},
    )
    port = await server.start(0, host="127.0.0.1", tick_loop=False)
    try:
        await server.load_config(parse_yaml_config(_prio_yaml(gcap)))
        t = time.perf_counter()
        resources, rids, cids = _populate_prio(server, rng, ids)
        say(f"phase server[prio {dtype_name}]: {N_PRIO} PRIORITY_BANDS "
            f"resources in {N_GROUPS} groups of {GROUP_SIZE} (+"
            f"{N_PRIO - N_GROUPS * GROUP_SIZE} uncoupled) and {N_PRIO_LANE} "
            f"lane resources, {server._store_engine.total_leases} leases "
            f"populated in {time.perf_counter() - t:.1f}s")
        dense_cuda.reset_launches()  # the main path starts here
        walls = []
        for _ in range(ticks):
            _churn_prio(server._store_engine, rng, rids, cids)
            t = time.perf_counter()
            await server.tick_once()
            walls.append(time.perf_counter() - t)
        await server.flush_ticks()
        torch.cuda.synchronize()
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        served = await _prio_requests(torch, server, port, resources)
        return dict(server=server, resources=resources, walls=walls,
                    launches=launches, served=served, cap=cap, group=group,
                    gcap=gcap, ticks=ticks)
    finally:
        await server.stop()


def _check_prio(torch, run):
    """The store of record against the solve's grants, the group caps
    and resource capacities in the store, and sampled uncoupled rows
    against the f64 numpy oracle."""
    import numpy as np

    from doorman_tpu_torch.algorithms.priority import priority_alloc
    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver.priority import alloc_evaluations

    server, resources = run["server"], run["resources"]
    solver = server._solver
    snap = solver.last_snapshot.priority_part
    launches = run["launches"]
    per_tick = alloc_evaluations(solver._tdtype, True)
    check(solver.ticks == run["ticks"],
          f"BatchSolver ticks {solver.ticks} != {run['ticks']}")
    check(launches["k3"] == per_tick * run["ticks"],
          f"K3 launches {launches['k3']} != {per_tick} x {run['ticks']}")
    check(launches["k1"] > 0, "K1 never launched beside the priority part")
    prio_res = resources[:N_PRIO]
    check(snap.resource_ids == [r.id for r in prio_res],
          "the priority snapshot's rows are not the priority resources")
    engine = server._store_engine
    name = engine.client_name
    gets = snap.gets
    starts = np.searchsorted(snap.ridx, np.arange(N_PRIO + 1))
    rng = np.random.default_rng(11)
    mism = 0
    for i in rng.choice(N_PRIO, min(200, N_PRIO), replace=False):
        store = prio_res[i].store
        for e in range(starts[i], starts[i + 1]):
            if store.get(name(int(snap.cids[e]))).has != float(
                gets[i, snap.pos[e]]
            ):
                mism += 1
    check(mism == 0, f"{mism} sampled store grants differ from the solve")
    ridx, _c, _w, has, _s, _p = engine.pack([r.store for r in prio_res])
    per_res = np.bincount(ridx, weights=has, minlength=N_PRIO)
    over = per_res - run["cap"] * (1 + 1e-6)
    check((over <= 0).all(), f"resource capacity exceeded by {over.max():.6g}")
    ratios = []
    for g in range(N_GROUPS):
        usage = per_res[run["group"] == g].sum()
        check(usage <= run["gcap"][g] * (1 + 1e-6),
              f"group g{g}: usage {usage:.9g} > cap {run['gcap'][g]:.9g}")
        ratios.append(usage / run["gcap"][g])
    # Each cap is a quarter of its members' capacity: every group binds.
    check(min(ratios) > 0.999, f"a group's cap does not bind: {min(ratios)}")
    b = snap.batch
    w = b.wants.double().cpu().numpy()
    wt = b.weights.double().cpu().numpy()
    bd = b.band.cpu().numpy()
    a = b.active.cpu().numpy()
    c = b.capacity.double().cpu().numpy()
    uncoupled = np.nonzero(b.group.cpu().numpy() < 0)[0]
    worst = 0.0
    for r in rng.choice(uncoupled, min(200, len(uncoupled)), replace=False):
        m = a[r]
        want = priority_alloc(c[r], w[r, m], wt[r, m], bd[r, m])
        scale = max(c[r], float(w[r, m].max()))
        worst = max(worst, float(np.abs(gets[r, m] - want).max()) / scale)
    check(worst <= F32_PARITY_REL_BOUND,
          f"uncoupled rows vs f64 oracle {worst:.3g}")
    return min(ratios), max(ratios), worst, snap.num_bands


async def _prio_servers(torch, card):
    out = {}
    for dtype_name, ticks, seed in (
        ("f32", PRIO_TICKS, 5), ("f64", PRIO_F64_TICKS, 6),
    ):
        run = await _drive_prio(torch, dtype_name, ticks, seed)
        lo, hi, oracle_err, nb = _check_prio(torch, run)
        p50, p95 = _pcts(run["walls"][1:])
        solver = run["server"]._solver
        say(f"phase server[prio {dtype_name}]: {ticks} ticks with 5% churn, "
            f"tick wall p50 {p50:.2f} ms p95 {p95:.2f} ms, launches "
            f"{run['launches']} ({run['launches']['k3'] // ticks} K3 per "
            f"tick), {nb} bands, store == solve grants on 200 sampled rows, "
            f"group usage / cap in [{lo:.9f}, {hi:.9f}], resource caps "
            f"held, uncoupled rows vs f64 oracle {oracle_err:.3g}, "
            f"{run['served']} requests answered; card {card}")
        say(f"phase server[prio {dtype_name}]: BatchSolver ms per tick: " +
            ", ".join(f"{k} {v * 1000.0 / ticks:.3f}"
                      for k, v in solver.phase_s.items()) +
            "; resident host phase ms per tick: " + ", ".join(
                f"{k} {v * 1000.0 / ticks:.3f}"
                for k, v in run["server"]._resident.phase_s.items() if v > 0))
        out[dtype_name] = dict(p50=p50, p95=p95, **run)
    return out


def phase_server(torch, card):
    # One event loop for every server (gRPC's asyncio binding is per loop).
    async def both():
        return await _servers(torch, card), await _prio_servers(torch, card)

    return asyncio.run(both())


# -- phase 5: the tracked path ----------------------------------------------

def phase_tracked(torch, server):
    import numpy as np

    from doorman_tpu_torch.solver import dense_cuda
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
    check(bool(torch.isfinite(solver.table().has).all()),
          "non-finite grants")
    # K2 once more on the tracked solver's own full tables and resident
    # previous-grants table, with the tick's 20% delivery.
    cfg = solver._config
    batch = solver.table()
    g = torch.Generator(device="cpu").manual_seed(5)
    delivered = (torch.rand(batch.wants.shape[0], generator=g) < 0.2).cuda()
    prev = solver.prev_table()
    (_g, _p, chg), _abs, rel = _check_k2(
        torch, batch, prev, delivered, "tracked tables"
    )
    say(f"phase tracked: 6 full ticks with delta tracking on, launches "
        f"{launches}, {changed} changed rids delivered; K2 on the tracked "
        f"tables {list(batch.wants.shape)} {str(prev.dtype)[6:]} "
        f"prev: vs plain {rel:.3g} relative, == K1, changed/prev_new exact "
        f"({int(chg.sum())} changed rows)")
    return launches


# -- phase 6: the scope frontier under each K1 layout -------------------------

# One seed (cut from four, then from two, for the run's time), the block
# layout first.
FRONTIER_SEEDS = (1,)


def phase_frontier(torch):
    """The f32 lane server again on churn seeds FRONTIER_SEEDS, once with
    K1/K2 in the warp layout and once forced to the block layout, in
    turns (block first on odd seeds). The two layouts add a row in
    different orders, and the rows still in scope after the quiet ticks
    — overloaded proportional rows whose grant moves by an ulp a tick —
    depend on the last bits of those sums. Reported, not checked:
    {layout: [(frontier rows, rows per scoped tick, churn tick p50 ms)
    per seed]}."""
    from doorman_tpu_torch.solver import dense_cuda

    chosen = dense_cuda.k1_layout
    out = {"warp": [], "block": []}

    async def drive():
        for seed in FRONTIER_SEEDS:
            order = ("block", "warp") if seed % 2 else ("warp", "block")
            for layout in order:
                dense_cuda.k1_layout = lambda K, layout=layout: layout
                try:
                    server, _r, walls, modes, scopes, launches, _s = (
                        await _drive_server(torch, "f32", TICKS, QUIET_TICKS,
                                            seed))
                finally:
                    dense_cuda.k1_layout = chosen
                check(launches["k1"] > 0, f"{layout}: K1 never launched")
                frontier, n_rows, by_kind = _frontier(server)
                scoped = [n for n, m in zip(scopes, modes) if m == "scoped"]
                per_tick = sum(scoped) / max(len(scoped), 1)
                p50, _p95 = _pcts(walls[2:TICKS])
                out[layout].append((frontier, per_tick, p50))
                say(f"phase frontier: seed {seed} K1 {layout} layout: "
                    f"frontier {frontier} of {n_rows} ({by_kind}), scoped "
                    f"ticks solved {per_tick:.0f} rows on average, churn "
                    f"tick p50 {p50:.2f} ms")

    asyncio.run(drive())
    w = [f for f, _n, _t in out["warp"]]
    b = [f for f, _n, _t in out["block"]]
    faster = sum(tb < tw for (_f, _n, tw), (_g, _m, tb)
                 in zip(out["warp"], out["block"]))
    say(f"phase frontier: frontier rows warp {w} block {b} (warp larger on "
        f"{sum(x > y for x, y in zip(w, b))} of {len(w)} seeds); churn tick "
        f"p50 lower with the block layout on {faster} of {len(w)} seeds")
    return out


# -- phase 7: K3 past shared memory: the cluster and global layouts ---------

# Widths the block layout cannot stage (priority_cuda.k3_layout), with
# the rows each table holds.
K3_GLOBAL_WIDTHS = {"f32": ((16_384, 32), (131_072, 8), (1_048_576, 6)),
                    "f64": ((8_192, 32), (131_072, 8), (1_048_576, 2))}


def _cluster_alternatives(K, it, plan):
    """Other (C, staged) plans of the cluster layout at width K, beside
    the plan the wrapper picks: 8 and 16 blocks streamed, and staged
    with 8 and 16 blocks and with the fewest blocks that can stage the
    row, where that fits."""
    from doorman_tpu_torch.solver.priority_cuda import (
        CLUSTER_MAX,
        SMEM_LIMIT,
        k3_cluster_plan,
        k3_cluster_smem_bytes,
    )

    alts = [(8, False), (CLUSTER_MAX, False)]
    for C in (8, CLUSTER_MAX):
        if k3_cluster_smem_bytes(K, C, True, it) <= SMEM_LIMIT:
            alts.append((C, True))
    if alts[-1][1]:
        fewest = k3_cluster_plan(K, it, rows=1, sms=1)[:2]
        if fewest not in alts:
            alts.append(fewest)
    return [a for a in alts if a != tuple(plan)]


def phase_k3_global(torch):
    """K3 past shared memory. The cluster layout (which the wrapper
    launches there) against its plain version on the same CUDA tensors
    at the widths above, f32 and f64, 1 and 4 bands (the K3 phase's
    special rows included): repeat launches bit-identical, the row
    totals checked, the other cluster plans and the global layout held
    against the plain version and the cluster layout on the same
    tables; the global layout against the block layout on one K = 4,096
    table. Comparison launches: not counted."""
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.priority import _alloc_banded
    from doorman_tpu_torch.solver.priority_cuda import (
        _launch_layout,
        alloc_banded_k3,
        k3_cluster_plan_for,
        k3_layout,
    )

    saved = dict(dense_cuda.LAUNCHES)
    saved_layouts = dict(dense_cuda.K3_LAYOUT_LAUNCHES)
    rng = np.random.default_rng(2026)
    worst = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        tag_dt = "f32" if dtype == torch.float32 else "f64"
        bound = F32_PARITY_REL_BOUND if dtype == torch.float32 else F64_RTOL
        tbound = K3_SOLVE_RTOL if dtype == torch.float32 else F64_RTOL
        it = torch.empty((), dtype=dtype).element_size()
        for K, R in K3_GLOBAL_WIDTHS[tag_dt]:
            check(k3_layout(K, it) == "cluster",
                  f"K={K} at {name} is not a cluster-layout row")
            w, wt, band, act, cap = _k3_tables(torch, rng, R, K, dtype)
            for nb in (1, 4):
                plan = k3_cluster_plan_for(w, nb)
                before = dense_cuda.K3_LAYOUT_LAUNCHES["cluster"]
                g1, t1 = alloc_banded_k3(w, wt, band, act, cap, nb, totals=True)
                g2, t2 = alloc_banded_k3(w, wt, band, act, cap, nb, totals=True)
                plain = _alloc_banded(w, wt, band, act, cap, nb)
                torch.cuda.synchronize()
                tag = f"K={K} {name} {nb} band(s) R={R}"
                check(dense_cuda.K3_LAYOUT_LAUNCHES["cluster"] == before + 2,
                      f"K3 did not launch its cluster layout ({tag})")
                check(torch.equal(g1, g2) and torch.equal(t1, t2),
                      f"K3 cluster layout not deterministic ({tag})")
                check(bool(torch.isfinite(g1).all()), f"K3 non-finite ({tag})")
                err = _k3_rel(torch, g1, plain, w, act, cap)
                check(err <= bound,
                      f"K3 cluster vs plain {err:.3g} > {bound:g} ({tag})")
                check(not bool(g1[:2].any()),
                      f"K3 grants on an inactive or zero-capacity row ({tag})")
                terr = _k3_rel(torch, t1[:, None], g1.double().sum(1)[:, None],
                               w, act, cap)
                check(terr <= tbound, f"K3 cluster row totals {terr:.3g} ({tag})")
                worst[f"{name} cluster"] = max(
                    worst.get(f"{name} cluster", 0.0), err)
                syncs = torch.zeros(R, dtype=torch.int32, device=DEVICE)
                _launch_layout("cluster", w, wt, band, act, cap, nb, False,
                               syncs=syncs)
                # The same tables through the other plans and the global
                # layout: each against the plain version, and against the
                # cluster layout's grants.
                others = []
                for alt in _cluster_alternatives(K, it, plan[:2]):
                    ga, ta = _launch_layout("cluster", w, wt, band, act, cap,
                                            nb, True, plan=alt)
                    others.append((f"C={alt[0]} "
                                   f"{'staged' if alt[1] else 'streamed'}",
                                   ga, ta))
                gg, tg = _launch_layout("global", w, wt, band, act, cap, nb,
                                        True)
                others.append(("global", gg, tg))
                torch.cuda.synchronize()
                errs = []
                for label, ga, ta in others:
                    e_plain = _k3_rel(torch, ga, plain, w, act, cap)
                    e_cl = _k3_rel(torch, ga, g1, w, act, cap)
                    e_tot = _k3_rel(torch, ta[:, None], t1[:, None], w, act,
                                    cap)
                    check(e_plain <= bound and e_cl <= bound
                          and e_tot <= tbound,
                          f"K3 {label} vs plain {e_plain:.3g}, vs the "
                          f"cluster plan {e_cl:.3g}, row totals {e_tot:.3g} "
                          f"({tag})")
                    key = f"{name} {'global' if label == 'global' else 'cluster'}"
                    worst[key] = max(worst.get(key, 0.0), e_plain)
                    errs.append(f"{label} {e_cl:.3g}")
                say(f"phase k3-global: {tag}: cluster C={plan[0]} "
                    f"{'staged' if plan[1] else 'streamed'} "
                    f"({plan[2]} B shared a block), "
                    f"{int(syncs.max().item())} cluster barriers a launch "
                    f"(rows {int(syncs.min().item())}-"
                    f"{int(syncs.max().item())}), vs plain max rel err "
                    f"{err:.3g} (bound {bound:g}), repeat bit-identical, row "
                    f"totals within {terr:.3g}; vs the cluster layout: "
                    + ", ".join(errs))
                del g1, g2, t1, t2, plain, others, gg, tg
            if K == K3_GLOBAL_WIDTHS[tag_dt][0][0]:
                # NaN and inf wants and weights: the bisection's
                # NaN-propagating sums. NaN and inf where the plain
                # version has them, within the bound elsewhere.
                w2, wt2 = w.clone(), wt.clone()
                w2[6, 5], wt2[7, 9] = float("nan"), float("inf")
                w2[3, 1] = float("inf")
                g1 = alloc_banded_k3(w2, wt2, band, act, cap, 4)
                g2 = alloc_banded_k3(w2, wt2, band, act, cap, 4)
                plain = _alloc_banded(w2, wt2, band, act, cap, 4)
                odd = ~torch.isfinite(plain)
                inf = torch.isinf(plain)
                err = _k3_rel(torch, torch.where(odd, 0, g1),
                              torch.where(odd, 0, plain), w, act, cap)
                ints = torch.int32 if dtype == torch.float32 else torch.int64
                tag = f"K={K} {name} 4 bands R={R}, NaN and inf inputs"
                check(torch.equal(torch.isnan(g1), torch.isnan(plain))
                      and torch.equal(g1[inf], plain[inf])
                      and torch.equal(g1.view(ints), g2.view(ints))
                      and err <= bound,
                      f"K3 cluster vs plain {err:.3g} ({tag})")
                say(f"phase k3-global: {tag}: NaN on "
                    f"{int(torch.isnan(plain).sum())} and inf on "
                    f"{int(inf.sum())} lanes as in the plain version, "
                    f"elsewhere {err:.3g}, repeat bit-identical")
                del w2, wt2, g1, g2, plain, odd, inf
                # Band ranks past a byte: the row is read from global
                # memory whatever its width.
                nb = 300
                plan = k3_cluster_plan_for(w, nb)
                g1 = alloc_banded_k3(w, wt, band, act, cap, nb)
                g2 = alloc_banded_k3(w, wt, band, act, cap, nb)
                plain = _alloc_banded(w, wt, band, act, cap, nb)
                err = _k3_rel(torch, g1, plain, w, act, cap)
                tag = f"K={K} {name} {nb} bands R={R}"
                check(not plan[1], f"K3 cluster plan {plan} stages ({tag})")
                check(torch.equal(g1, g2) and err <= bound,
                      f"K3 cluster vs plain {err:.3g} ({tag})")
                say(f"phase k3-global: {tag}: cluster C={plan[0]} streamed, "
                    f"vs plain {err:.3g}, repeat bit-identical")
                del g1, g2, plain
            del w, wt, band, act, cap
        # The global and block layouts on one table both take.
        w, wt, band, act, cap = _k3_tables(torch, rng, 96, 4096, dtype)
        for nb in (1, 4):
            gg, tg = _launch_layout("global", w, wt, band, act, cap, nb, True)
            gb, tb = _launch_layout("block", w, wt, band, act, cap, nb, True)
            torch.cuda.synchronize()
            lerr = _k3_rel(torch, gg, gb, w, act, cap)
            terr = _k3_rel(torch, tg[:, None], tb[:, None], w, act, cap)
            tag = f"K=4096 {name} {nb} band(s)"
            check(lerr <= bound, f"K3 global vs block layout {lerr:.3g} ({tag})")
            check(terr <= tbound, f"K3 global vs block row totals {terr:.3g}")
            say(f"phase k3-global: {tag} R=96: global vs block layout "
                f"{lerr:.3g} (bound {bound:g}), row totals {terr:.3g}")
    dense_cuda.LAUNCHES.update(saved)
    dense_cuda.K3_LAYOUT_LAUNCHES.update(saved_layouts)
    return worst


def _wide_prio_tables(torch, wide_prio):
    """The wide priority server's own 8 x 131,072 tables at each dtype,
    at a representative theta evaluation (grouped rows at theta = 0.5)."""
    out = {}
    for dt, run in (("f32", wide_prio["f32"]["run"]),
                    ("f64", wide_prio["f64"]["run"])):
        part = run["server"]._solver.last_snapshot.priority_part
        b, nb = part.batch, part.num_bands
        wants = torch.where(b.active, b.wants, 0)
        weights = torch.where(b.active, b.weights, 0)
        half = torch.where(b.group >= 0, 0.5, 1.0).to(b.capacity.dtype)
        R, K = wants.shape
        out[f"{R}x{K} {dt}"] = (wants, weights, b.band, b.active,
                                b.capacity * half, nb)
    return out


def _k3_1m_tables(torch):
    """One 1,048,576-lane row at each dtype: 95% active, wants 0-99, 1-3
    subclients, 4 bands, capacity a tenth of the wants (every band
    overflows what the ones above left)."""
    import numpy as np

    rng = np.random.default_rng(31)
    K = 1 << 20
    act = _put(torch, rng.random((1, K)) < 0.95)
    w = rng.integers(0, 100, (1, K)).astype(np.float64)
    s = rng.integers(1, 4, (1, K)).astype(np.float64)
    b1 = _put(torch, rng.integers(0, 4, (1, K)).astype(np.int32))
    out = {}
    for dt, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        w1 = _put(torch, w, dtype) * act
        s1 = _put(torch, s, dtype) * act
        out[f"1x{K} {dt}"] = (w1, s1, b1, act, w1.sum(1) * 0.1, 4)
    return out


def _k3_global_timing(torch, tables):
    """K3 past shared memory, timed with the launches queued: the
    cluster layout (the plan the wrapper picks), the global layout and
    the plain version on the same tables, in turns (plain, global,
    cluster, cluster, global, plain), beside the bound; then the other
    cluster plans on the same tables (8 and 16 blocks streamed, 16
    staged where that fits), each with the clusters the card holds at
    once. Fails unless the cluster layout is faster than the global
    layout on every table."""
    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.priority import _alloc_banded
    from doorman_tpu_torch.solver.priority_cuda import (
        _launch_layout,
        alloc_banded_k3,
        k3_cluster_max_active,
        k3_cluster_plan_for,
    )

    saved = dict(dense_cuda.LAUNCHES)
    saved_layouts = dict(dense_cuda.K3_LAYOUT_LAUNCHES)
    out = {}
    for key, args in tables.items():
        R, K = args[0].shape
        dtype = args[0].dtype
        it = args[0].element_size()
        nb = args[5]
        bound_rel = F32_PARITY_REL_BOUND if dtype == torch.float32 else F64_RTOL
        got = alloc_banded_k3(*args)
        plain = _alloc_banded(*args)
        rel = _k3_rel(torch, got, plain, args[0], args[3], args[4])
        check(rel <= bound_rel, f"K3 cluster {key} vs plain {rel:.3g}")
        C, staged, smem = k3_cluster_plan_for(args[0], nb)
        syncs = torch.zeros(R, dtype=torch.int32, device=DEVICE)
        _launch_layout("cluster", *args, False, syncs=syncs)

        def run_cluster():
            return alloc_banded_k3(*args)

        def run_global():
            return _launch_layout("global", *args, False)

        def run_plain():
            return _alloc_banded(*args)

        turns = [
            _time_ms(torch, run_plain, reps=2),
            _time_ms(torch, run_global, reps=3, queued=True),
            _time_ms(torch, run_cluster, reps=20, queued=True),
            _time_ms(torch, run_cluster, reps=20, queued=True),
            _time_ms(torch, run_global, reps=3, queued=True),
            _time_ms(torch, run_plain, reps=2),
        ]
        ms = (turns[2] + turns[3]) / 2
        gms = (turns[1] + turns[4]) / 2
        pms = (turns[0] + turns[5]) / 2
        nbytes = R * K * (2 * it + 4 + 1) + R * K * it + R * it
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = _k3_ops(torch, *args, plain) / H100_F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        plans = [{
            "C": C, "staged": staged, "smem": smem, "chosen": True, "ms": ms,
            "max_active_clusters": k3_cluster_max_active(dtype, K, C, staged),
        }]
        for alt in _cluster_alternatives(K, it, (C, staged)):
            a_ms = _time_ms(
                torch, lambda: _launch_layout("cluster", *args, False,
                                              plan=alt),
                reps=20, queued=True)
            plans.append({
                "C": alt[0], "staged": alt[1], "chosen": False, "ms": a_ms,
                "max_active_clusters": k3_cluster_max_active(dtype, K, *alt),
            })
        out[key] = {
            "ms": ms, "global_ms": gms, "plain_ms": pms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share_of_bound": bound / ms,
            "global_share_of_bound": bound / gms, "turns_ms": turns,
            "rel_err": rel, "shape": [R, K], "dtype": str(dtype),
            "max_abs_err": (got.double() - plain.double()).abs().max().item(),
            "cluster": C, "staged": staged, "smem_bytes": smem,
            "cluster_syncs": int(syncs.max().item()), "plans": plans,
        }
        say(f"phase k3-global: timed {key}: cluster C={C} "
            f"{'staged' if staged else 'streamed'} {ms:.4f} ms queued "
            f"({bound / ms:.2%} of bound, {int(syncs.max().item())} cluster "
            f"barriers a launch, {plans[0]['max_active_clusters']} clusters "
            f"resident at once), global {gms:.4f} ms "
            f"({bound / gms:.3%} of bound), plain {pms:.3f} ms, bound "
            f"{bound:.5f} ms ({out[key]['bound_by']}); other plans: "
            + ", ".join(
                f"C={p['C']} {'staged' if p['staged'] else 'streamed'} "
                f"{p['ms']:.4f} ms ({p['max_active_clusters']} resident)"
                for p in plans[1:]))
        check(ms < gms, f"K3 cluster layout {ms:.4f} ms not below the global "
              f"layout's {gms:.4f} ms on {key}")
        del got, plain
    dense_cuda.LAUNCHES.update(saved)
    dense_cuda.K3_LAYOUT_LAUNCHES.update(saved_layouts)
    return out


# -- phase 8: lane resources of any width ----------------------------------

# bench.py's bench_server_tick_wide shapes (label, wide resources,
# clients each), each beside tools/drives/drive_wide.py's narrow filler.
WIDE_SHAPES = (("wide-1m", 1, 1_000_000), ("wide-10x100k", 10, 100_000))
WIDE_NARROW = 5
WIDE_NARROW_CLIENTS = 50
WIDE_TICKS = 12
WIDE_F64_TICKS = 3
WIDE_QUIET = 8  # > one delivery rotation (5) plus the pipeline's depth
WIDE_FLIGHTREC = 64  # the wide servers' flight recorder holds every tick
LANE_MIX_CLIENTS = 20_000


def _wide_yaml(wide_ids, capacity, lanes=False):
    algo = ("lease_length: 3600, refresh_interval: 5, "
            "learning_mode_duration: 0")
    lines = ["resources:"]
    for rid in wide_ids:
        if lanes:
            prefix = rid.split(".")[1]
            _p, kind, variant, _s = next(l for l in LANES if l[0] == prefix)
            params = (f", parameters: [{{name: variant, value: {variant}}}]"
                      if variant else "")
            cap = 40.0 if kind == 1 else capacity  # STATIC: per client
            lines.append(f"  - identifier_glob: '{rid}'\n    capacity: {cap}\n"
                         f"    algorithm: {{kind: {kind}, {algo}{params}}}")
        else:
            lines.append(f"  - identifier_glob: '{rid}'\n"
                         f"    capacity: {capacity}\n    algorithm: "
                         f"{{kind: PROPORTIONAL_SHARE, {algo}}}")
    lines.append("  - identifier_glob: '*'\n    capacity: 500\n"
                 f"    algorithm: {{kind: FAIR_SHARE, {algo}}}")
    return "\n".join(lines) + "\n"


def _wide_inputs(engine, res):
    """(wants, has, subclients) of each resource, in slot order."""
    import numpy as np

    ridx, _c, w, h, s, _p = engine.pack([r.store for r in res])
    starts = np.searchsorted(ridx, np.arange(len(res) + 1))
    return [(w[a:b], h[a:b], s[a:b]) for a, b in zip(starts[:-1], starts[1:])]


async def _drive_wide(torch, label, n_wide, clients, dtype_name, ticks,
                      quiet, seed, lanes=False, fused=True):
    import numpy as np

    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    rng = np.random.default_rng(seed)
    capacity = 40.0 * clients  # oversubscribed: mean wants ~50
    if lanes:
        wide_ids = [f"mix.{l[0]}" for l in LANES]
    else:
        wide_ids = [f"wide{r}" for r in range(n_wide)]
    server = CapacityServer(
        f"smoke-{label}", TrivialElection(), mode="batch", native_store=True,
        solver_dtype=dtype_name, fused_tick=fused, scoped_solve=True,
        tick_pipeline_depth=3, tick_interval=1.0,
        flightrec_capacity=WIDE_FLIGHTREC, device=DEVICE,
    )
    await server.start(0, host="127.0.0.1", tick_loop=False)
    try:
        await server.load_config(parse_yaml_config(
            _wide_yaml(wide_ids, capacity, lanes)))
        t = time.perf_counter()
        res = [server.get_or_create_resource(r) for r in wide_ids]
        narrow = [server.get_or_create_resource(f"narrow{i}")
                  for i in range(WIDE_NARROW)]
        engine = server._store_engine
        n_wide_leases = len(res) * clients
        rids = np.concatenate([
            np.repeat([r.store._rid for r in res], clients),
            np.repeat([r.store._rid for r in narrow], WIDE_NARROW_CLIENTS),
        ]).astype(np.int32)
        cids = np.fromiter(
            (engine.client_handle(f"w{i}") for i in range(len(rids))),
            np.int64, count=len(rids),
        )
        n = len(rids)
        sub = np.ones(n, np.int32)
        if lanes:
            sub[:n_wide_leases] = rng.integers(1, 4, n_wide_leases)
        engine.bulk_assign(
            rids, cids, np.full(n, time.time() + 3600.0), np.full(n, 5.0),
            np.zeros(n), rng.integers(1, 100, n).astype(np.float64), sub,
        )
        say(f"phase {label}[{dtype_name}]: {len(res)} wide resource(s) x "
            f"{clients} clients + {WIDE_NARROW} x {WIDE_NARROW_CLIENTS}, "
            f"{engine.total_leases} leases populated in "
            f"{time.perf_counter() - t:.1f}s")
        inputs = _wide_inputs(engine, res)
        dense_cuda.reset_launches()  # the wide path starts here
        walls, modes, scopes, first = [], [], [], None
        n_churn = n_wide_leases // 20  # 5% of the wide clients a tick
        for i in range(ticks + quiet):
            if 0 < i < ticks:
                pick = rng.choice(n_wide_leases, n_churn, replace=False)
                engine.bulk_refresh(
                    rids[pick], cids[pick],
                    np.full(n_churn, time.time() + 3600.0),
                    np.full(n_churn, 5.0),
                    rng.integers(1, 100, n_churn).astype(np.float64),
                )
            if i == ticks + quiet - 1:
                # The last tick re-reads the config (as a reload does):
                # a full solve that delivers every chunk row, after
                # which the store of record must equal the device grants.
                server._config_epoch += 1
            t = time.perf_counter()
            await server.tick_once()
            walls.append(time.perf_counter() - t)
            wide = server._resident_wide
            if i == 0:
                # The first (full) solve's grants.
                first = wide.table().has.clone()
            modes.append(wide.last_solve_mode)
            scopes.append(wide.last_scope["rows"])
        await server.flush_ticks()
        torch.cuda.synchronize()
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        return dict(server=server, res=res, inputs=inputs, first=first,
                    walls=walls, modes=modes, scopes=scopes,
                    launches=launches, capacity=capacity, clients=clients,
                    ticks=ticks)
    finally:
        await server.stop()


def _check_wide(torch, run, label, lanes=False):
    """The first tick's grants against the f64 oracles, conservation in
    the store, the store of record equal to the device grants after the
    quiet ticks (the last of which delivered every row), the partition,
    and the chunked solve's determinism."""
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import (
        F32_PARITY_REL_BOUND,
        oracle_row,
    )
    from doorman_tpu_torch.core.resource import algo_kind_for, static_param
    from doorman_tpu_torch.solver.dense import solve_chunked

    server, res = run["server"], run["res"]
    wide = server._resident_wide
    check(server._wide_ids == {r.id for r in res},
          f"{label}: wide partition {sorted(server._wide_ids)}")
    check(server._solver is None or server._solver.ticks == 0,
          f"{label}: the BatchSolver ticked (an overflow)")
    check(run["launches"]["k1"] > 0, f"{label}: K1 never launched for the "
          "narrow resources")
    W = wide._W
    first = run["first"].double().cpu().numpy().reshape(-1)
    final = wide.table().has.double().cpu().numpy().reshape(-1)
    rng = np.random.default_rng(17)
    frontier = set(wide._scope.ids().tolist())
    worst_oracle = 0.0
    for i, r in enumerate(res):
        w, h, s = run["inputs"][i]
        kind = algo_kind_for(r.template)
        cap = float(r.template.capacity)
        want = oracle_row(kind, cap, static_param(r.template), w, h, s)
        base = int(wide._base_row[wide._rid_to_seg[r.store._rid]]) * W
        got = first[base: base + len(w)]
        if lanes:
            scale = max(cap, float(w.max()))
            err = float(np.abs(got - want).max()) / scale
            check(err <= F32_PARITY_REL_BOUND,
                  f"{label} {r.id}: first tick vs f64 oracle {err:.3g}")
            worst_oracle = max(worst_oracle, err)
        else:
            # bench.py's check of this shape: rtol 2e-6, atol 1e-4.
            sample = rng.integers(0, len(w), 4000)
            diff = np.abs(got[sample] - want[sample])
            check((diff <= 1e-4 + 2e-6 * np.abs(want[sample])).all(),
                  f"{label} {r.id}: first tick vs f64 oracle off by "
                  f"{diff.max():.3g}")
            rel = diff / np.maximum(np.abs(want[sample]), 1e-30)
            worst_oracle = max(worst_oracle, float(rel.max()))
        _r, _c, _w, store, _s, _p = server._store_engine.pack([r.store])
        # Conservation, but on NO_ALGORITHM (grants = wants) and STATIC
        # (a per-client cap).
        check(kind in (0, 1) or store.sum() <= cap * (1 + 1e-6),
              f"{label} {r.id}: store holds {store.sum():.9g} > {cap:.9g}")
        check(np.array_equal(store, final[base: base + len(store)]),
              f"{label} {r.id}: store differs from the device grants")
    # The chunked solve twice on the server's tables: the same bits.
    cfg = wide._config
    batch = wide.table()
    lanes_present = cfg.lanes()
    a = solve_chunked(batch, lanes=lanes_present)
    b = solve_chunked(batch, lanes=lanes_present)
    torch.cuda.synchronize()
    check(torch.equal(a, b), f"{label}: chunked re-solve not bit-identical")
    # Segments still in the scope frontier: an overloaded proportional
    # resource's grants sit on the free-capacity clamp and move by an
    # ulp a tick, as the narrow rows do (PERF.md).
    return dict(worst_oracle=worst_oracle, settling=len(frontier),
                batch=batch, lanes=lanes_present)


def _flight_ticks(label, dtype_name, run, ticks):
    """Each tick's flight record (its wall and its host phase laps, the
    `wide.*` ones included), and the churn tick with the largest wall of
    those the p95 covers, named with its largest phases."""
    recs = run["server"].flightrec.snapshot()
    check(len(recs) == len(run["walls"]),
          f"{len(recs)} flight records for {len(run['walls'])} ticks")
    for i, r in enumerate(recs):
        top = sorted(r.get("phases", {}).items(), key=lambda kv: -kv[1])
        say(f"phase {label}[{dtype_name}]: flight record {i} (tick "
            f"{r['tick']}, {r.get('solve_mode')}): wall {r['wall_ms']:.2f}"
            f" ms; phases ms " + ", ".join(f"{k} {v:.2f}" for k, v in top))
    lo = 2 if ticks > 3 else 1
    i = max(range(lo, ticks), key=lambda k: recs[k]["wall_ms"])
    top = sorted(recs[i].get("phases", {}).items(), key=lambda kv: -kv[1])
    spike = {"index": i, "tick": recs[i]["tick"],
             "wall_ms": recs[i]["wall_ms"],
             "solve_mode": recs[i].get("solve_mode"),
             "phases_ms": dict(top[:4])}
    say(f"phase {label}[{dtype_name}]: largest churn tick: {spike}")
    return spike


def phase_wide(torch, card):
    """bench.py's wide shapes and the lane mix through
    CapacityServer.tick_once: f32, and a few ticks at f64."""
    out = {}

    async def drive():
        for label, n_wide, clients in WIDE_SHAPES + (
                ("lane-mix", len(LANES), LANE_MIX_CLIENTS),):
            lanes = label == "lane-mix"
            for dtype_name, ticks, seed in (("f32", WIDE_TICKS, 7),
                                            ("f64", WIDE_F64_TICKS, 8)):
                if lanes and dtype_name == "f64":
                    continue
                run = await _drive_wide(torch, label, n_wide, clients,
                                        dtype_name, ticks, WIDE_QUIET, seed,
                                        lanes)
                chk = _check_wide(torch, run, label, lanes)
                walls = run["walls"]
                p50, p95 = _pcts(walls[2:ticks]) if ticks > 3 else _pcts(
                    walls[1:ticks])
                wide = run["server"]._resident_wide
                scoped = [n for n, m in zip(run["scopes"], run["modes"])
                          if m == "scoped"]
                phases = run["server"].status()["phase_s"]
                say(f"phase {label}[{dtype_name}]: {len(walls)} ticks ({ticks}"
                    f" with 5% churn, {WIDE_QUIET} quiet), tick wall p50 "
                    f"{p50:.2f} ms p95 {p95:.2f} ms, modes scoped="
                    f"{run['modes'].count('scoped')} full="
                    f"{run['modes'].count('full')}, launches "
                    f"{run['launches']}, first tick vs f64 oracle "
                    f"{chk['worst_oracle']:.3g}, store == device grants "
                    f"after a full delivery ({chk['settling']} of "
                    f"{len(run['res'])} resources still in the scope "
                    f"frontier), chunked re-solve bit-identical; card {card}")
                say(f"phase {label}[{dtype_name}]: rows in scope: {wide._R} "
                    f"chunk rows of {wide._W} lanes, scoped ticks solved "
                    f"{sum(scoped) / max(len(scoped), 1):.0f} rows on average,"
                    f" frontier {len(wide._scope)} of {len(run['res'])} "
                    f"resources; host phase ms per tick: " + ", ".join(
                        f"{k} {v * 1000.0 / len(walls):.3f}"
                        for k, v in phases.items() if v > 0))
                spike = _flight_ticks(label, dtype_name, run, ticks)
                out[f"{label} {dtype_name}"] = dict(
                    p50=p50, p95=p95, run=run, check=chk, spike=spike)

    asyncio.run(drive())
    return out


def _wide_entry(torch, wide):
    """The chunked lane solve (plain PyTorch: the JAX package computes
    it outside any Pallas kernel) timed on the wide-1m f32 server's own
    tables, beside its bytes bound."""
    chk = wide["wide-1m f32"]["check"]
    batch, lanes = chk["batch"], chk["lanes"]
    from doorman_tpu_torch.solver.dense import solve_chunked

    ms = _time_ms(torch, lambda: solve_chunked(batch, lanes=lanes), reps=10)
    R, W = batch.wants.shape
    it = batch.wants.element_size()
    nbytes = R * W * (3 * it + 1) + R * W * it + R * 8
    return {
        "name": "chunked lane solve (plain PyTorch, no kernel)",
        "shape": [R, W], "dtype": str(batch.wants.dtype), "ms": ms,
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "tick_p50_ms": wide["wide-1m f32"]["p50"],
        "tick_p95_ms": wide["wide-1m f32"]["p95"],
        "tick_p50_ms_10x100k": wide["wide-10x100k f32"]["p50"],
        "tick_p95_ms_10x100k": wide["wide-10x100k f32"]["p95"],
    }


# -- phase 9: the BatchSolver's lane parts ---------------------------------

def phase_batch_lanes(torch, server):
    """The BatchSolver's dense lane part (kernel K1) on the f32 lane
    server's 10,000 resources: one snapshot, one solve, the flat grants
    against the plain solve of the same dense table. Not applied."""
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.batch import BatchSolver
    from doorman_tpu_torch.solver.dense import solve_dense

    solver = BatchSolver(dtype=np.float32, device=DEVICE)
    resources = list(server.resources.values())
    t = time.perf_counter()
    solver.prepare(resources)  # a first pack, timed apart
    first_ms = (time.perf_counter() - t) * 1e3
    solver.phase_s = dict.fromkeys(solver.phase_s, 0.0)
    dense_cuda.reset_launches()  # the dense lane part starts here
    snap = solver.prepare(resources)
    gets = solver.solve(snap)
    torch.cuda.synchronize()
    launches = dict(dense_cuda.LAUNCHES)  # read just after
    check(snap.dense is not None, "the lane part did not pack dense")
    check(launches["k1"] == 1, f"dense lane part launches {launches}")
    n_rows, kfill = snap.dense_fill
    plain = solve_dense(snap.dense)[:n_rows, :kfill].cpu().numpy()
    want = plain[snap.ridx, snap.pos]
    cap = snap.dense.capacity.cpu().numpy()[snap.ridx]
    w = snap.dense.wants.cpu().numpy()[snap.ridx, snap.pos]
    err = float((np.abs(gets - want) / np.maximum(cap, w)).max())
    check(err <= F32_PARITY_REL_BOUND, f"dense lane part vs plain {err:.3g}")
    say(f"phase batch-lanes: dense lane part over {len(resources)} resources "
        f"({snap.num_edges} edges, table {list(snap.dense.wants.shape)}): "
        f"launches {launches}, vs plain {err:.3g}; BatchSolver ms: " +
        ", ".join(f"{k} {v * 1e3:.3f}" for k, v in solver.phase_s.items())
        + f" (the first pack: {first_ms:.1f} ms)")
    return dict(launches=launches["k1"], rel_err=err,
                pack_ms=solver.phase_s["pack"] * 1e3, first_pack_ms=first_ms,
                solve_ms=solver.phase_s["solve"] * 1e3)


# -- phase 10: a narrow resource overflows ----------------------------------

OVERFLOW_CLIENTS = 5_000


def _oracle_err(res, grants, inputs):
    """Max |grant - f64 oracle| / max(capacity, max wants) of one lane
    resource, on the solve's inputs (wants, has, subclients)."""
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import oracle_row
    from doorman_tpu_torch.core.resource import algo_kind_for, static_param

    w, h, s = inputs
    cap = float(res.template.capacity)
    want = oracle_row(algo_kind_for(res.template), cap,
                      static_param(res.template), w, h, s)
    return float(np.abs(grants - want).max()) / max(cap, float(w.max()))


def phase_overflow(torch, server):
    """On the f32 lane server: 5,000 clients bulk-assigned onto one
    100-client PROPORTIONAL_SHARE resource between two ticks. That tick
    must run the BatchSolver's edge-list lane part over every resource;
    the next must run the resource on the wide solver; grants within the
    oracle bound on both."""
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda

    engine = server._store_engine
    res = next(r for r in server.resources.values()
               if r.id.startswith("prop."))
    rng = np.random.default_rng(12)
    n = OVERFLOW_CLIENTS
    cids = np.fromiter((engine.client_handle(f"ovf{i}") for i in range(n)),
                       np.int64, count=n)
    engine.bulk_assign(
        np.full(n, res.store._rid, np.int32), cids,
        np.full(n, time.time() + 3600.0), np.full(n, 5.0), np.zeros(n),
        rng.integers(1, 100, n).astype(np.float64), np.ones(n, np.int32),
    )
    batch_ticks = server._solver.ticks if server._solver is not None else 0
    dense_cuda.reset_launches()  # the overflow path starts here
    before = _wide_inputs(engine, [res])[0]
    t = time.perf_counter()
    asyncio.run(server.tick_once())
    t_overflow = time.perf_counter() - t
    solver = server._solver
    check(solver is not None and solver.ticks == batch_ticks + 1,
          "the overflow tick did not run through the BatchSolver")
    snap = solver.last_snapshot
    check(snap.edges is not None and snap.dense is None,
          "the overflow tick did not take the edge-list lane part")
    check(len(snap.resource_ids) == len(server.resources),
          "the overflow tick did not solve every resource")
    _r, _c, _w, store, _s, _p = engine.pack([res.store])
    err1 = _oracle_err(res, store, before)
    check(err1 <= F32_PARITY_REL_BOUND, f"overflow tick vs oracle {err1:.3g}")
    check(store.sum() <= res.template.capacity * (1 + 1e-6),
          "overflow tick exceeds the resource's capacity")
    before = _wide_inputs(engine, [res])[0]
    t = time.perf_counter()
    asyncio.run(server.tick_once())
    asyncio.run(server.flush_ticks())
    t_next = time.perf_counter() - t
    torch.cuda.synchronize()
    launches = dict(dense_cuda.LAUNCHES)
    wide = server._resident_wide
    check(res.id in server._wide_ids and wide is not None and wide.ticks >= 1,
          "the next tick did not run the grown resource on the wide solver")
    check(solver.ticks == batch_ticks + 1, "a second overflow tick ran")
    check(launches["k1"] > 0, "K1 never launched on the tick after")
    _r, _c, _w, store, _s, _p = engine.pack([res.store])
    err2 = _oracle_err(res, store, before)
    check(err2 <= F32_PARITY_REL_BOUND, f"wide tick vs oracle {err2:.3g}")
    say(f"phase overflow: {res.id} grew from 100 to {len(store)} clients: "
        f"the tick ran the BatchSolver's edge-list part over "
        f"{len(snap.resource_ids)} resources ({snap.num_edges} edges) in "
        f"{t_overflow * 1e3:.1f} ms, vs f64 oracle {err1:.3g}; the next tick "
        f"ran it on the wide solver ({wide._R} chunk rows) in "
        f"{t_next * 1e3:.1f} ms, vs f64 oracle {err2:.3g}; launches "
        f"{launches}")
    return dict(err=max(err1, err2), overflow_ms=t_overflow * 1e3,
                next_ms=t_next * 1e3)


# -- phase 11: wide PRIORITY_BANDS resources -------------------------------

WIDE_PRIO_RES = 8
WIDE_PRIO_CLIENTS = 100_000
WIDE_PRIO_GROUP = 4  # resources a capacity group
WIDE_PRIO_TICKS = {"f32": 3, "f64": 2}


def _wide_prio_yaml(capacity, gcap):
    algo = ("{kind: PRIORITY_BANDS, lease_length: 3600, refresh_interval: 5, "
            "learning_mode_duration: 0}")
    lines = ["groups:"]
    for g, c in enumerate(gcap):
        lines.append(f"  - name: wg{g}\n    capacity: {float(c)!r}")
    lines.append("resources:")
    for g in range(len(gcap)):
        lines.append(f"  - identifier_glob: 'wp.g{g}.*'\n    capacity: "
                     f"{capacity}\n    capacity_group: wg{g}\n"
                     f"    algorithm: {algo}")
    lines.append("  - identifier_glob: '*'\n    capacity: 500\n    algorithm: "
                 "{kind: FAIR_SHARE, lease_length: 3600, refresh_interval: 5, "
                 "learning_mode_duration: 0}")
    return "\n".join(lines) + "\n"


async def _drive_wide_prio(torch, dtype_name, seed):
    import numpy as np

    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    rng = np.random.default_rng(seed)
    C, n_res = WIDE_PRIO_CLIENTS, WIDE_PRIO_RES
    capacity = 40.0 * C
    n_groups = n_res // WIDE_PRIO_GROUP
    gcap = [GROUP_SHARE * capacity * WIDE_PRIO_GROUP] * n_groups
    ids = [f"wp.g{i // WIDE_PRIO_GROUP}.r{i}" for i in range(n_res)]
    server = CapacityServer(
        "smoke-wide-prio", TrivialElection(), mode="batch", native_store=True,
        solver_dtype=dtype_name, fused_tick=True, scoped_solve=True,
        tick_pipeline_depth=3, tick_interval=1.0, flightrec_capacity=0,
        device=DEVICE,
    )
    await server.start(0, host="127.0.0.1", tick_loop=False)
    try:
        await server.load_config(parse_yaml_config(
            _wide_prio_yaml(capacity, gcap)))
        res = [server.get_or_create_resource(r) for r in ids]
        engine = server._store_engine
        rids = np.repeat([r.store._rid for r in res], C).astype(np.int32)
        n = len(rids)
        cids = np.fromiter((engine.client_handle(f"p{i}") for i in range(n)),
                           np.int64, count=n)
        engine.bulk_assign(
            rids, cids, np.full(n, time.time() + 3600.0), np.full(n, 5.0),
            np.zeros(n), rng.integers(0, 100, n).astype(np.float64),
            rng.integers(1, 4, n).astype(np.int32),
            rng.choice(np.asarray(PRIORITIES), n),
        )
        ticks = WIDE_PRIO_TICKS[dtype_name]
        dense_cuda.reset_launches()  # the wide priority path starts here
        walls = []
        for i in range(ticks):
            if i:
                pick = rng.choice(n, n // 20, replace=False)
                engine.bulk_refresh(
                    rids[pick], cids[pick],
                    np.full(len(pick), time.time() + 3600.0),
                    np.full(len(pick), 5.0),
                    rng.integers(0, 100, len(pick)).astype(np.float64),
                )
            t = time.perf_counter()
            await server.tick_once()
            walls.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        layouts = dict(dense_cuda.K3_LAYOUT_LAUNCHES)
        return dict(server=server, resources=res, walls=walls, ticks=ticks,
                    launches=launches, layouts=layouts,
                    cap=np.full(n_res, capacity),
                    group=np.arange(n_res) // WIDE_PRIO_GROUP,
                    gcap=np.asarray(gcap))
    finally:
        await server.stop()


def _check_wide_prio(torch, run):
    """_check_prio's checks on the wide priority server: the K3 launches
    (every one in the cluster layout), the store of record against the
    solve's grants, each resource within its capacity, every group
    within its cap and binding, and the grouped solve through K3 against
    the plain solve."""
    import numpy as np

    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.priority import (
        alloc_evaluations,
        solve_priority,
    )

    server, res = run["server"], run["resources"]
    solver = server._solver
    part = solver.last_snapshot.priority_part
    per_tick = alloc_evaluations(solver._tdtype, True)
    n_launch = per_tick * run["ticks"]
    check(solver.ticks == run["ticks"], f"BatchSolver ticks {solver.ticks}")
    check(run["launches"]["k3"] == n_launch,
          f"K3 launches {run['launches']['k3']} != {n_launch}")
    check(run["layouts"] == {"warp": 0, "block": 0, "cluster": n_launch},
          f"K3 layouts {run['layouts']}: not all cluster")
    check(part.batch.wants.shape[1] == 131_072,
          f"bucket K = {part.batch.wants.shape[1]}")
    engine = server._store_engine
    name = engine.client_name
    rng = np.random.default_rng(13)
    mism = 0
    starts = np.searchsorted(part.ridx, np.arange(len(res) + 1))
    for i in range(len(res)):
        store = res[i].store
        for e in rng.integers(starts[i], starts[i + 1], 500):
            if store.get(name(int(part.cids[e]))).has != float(
                    part.gets[i, part.pos[e]]):
                mism += 1
    check(mism == 0, f"{mism} sampled store grants differ from the solve")
    ridx, _c, _w, has, _s, _p = engine.pack([r.store for r in res])
    per_res = np.bincount(ridx, weights=has, minlength=len(res))
    check((per_res <= run["cap"] * (1 + 1e-6)).all(),
          "a resource exceeds its capacity")
    ratios = []
    for g, gcap in enumerate(run["gcap"]):
        usage = per_res[run["group"] == g].sum()
        check(usage <= gcap * (1 + 1e-6),
              f"group wg{g}: usage {usage:.9g} > cap {gcap:.9g}")
        ratios.append(usage / gcap)
    check(min(ratios) > 0.999, f"a group's cap does not bind: {ratios}")
    b, nb = part.batch, part.num_bands
    saved = dict(dense_cuda.LAUNCHES)
    saved_layouts = dict(dense_cuda.K3_LAYOUT_LAUNCHES)
    ks = solve_priority(b, nb, use_kernel=True)
    ps = solve_priority(b, nb, use_kernel=False)
    dense_cuda.LAUNCHES.update(saved)  # comparison launches: not counted
    dense_cuda.K3_LAYOUT_LAUNCHES.update(saved_layouts)
    srel = ((ks.double() - ps.double()).abs()
            / b.capacity.double().clamp_min(1e-30)[:, None]).max().item()
    check(srel <= K3_SOLVE_RTOL, f"grouped solve vs plain {srel:.3g}")
    split = _solve_split(torch, b, nb)
    dense_cuda.LAUNCHES.update(saved)  # timing launches: not counted
    dense_cuda.K3_LAYOUT_LAUNCHES.update(saved_layouts)
    check(split["k3_launches"] == per_tick,
          f"{split['k3_launches']} K3 launches in one grouped solve")
    return min(ratios), max(ratios), srel, nb, split


def _solve_split(torch, batch, num_bands):
    """One grouped solve through K3 on the host clock (after a warm-up),
    split into its K3 launches (a pair of CUDA events around each
    wrapper call: the kernel, and any wait of the card for the launch's
    host enqueue) and the rest (the theta bisection's torch ops and
    the host between them)."""
    from doorman_tpu_torch.solver import priority_cuda
    from doorman_tpu_torch.solver.priority import solve_priority

    real = priority_cuda.alloc_banded_k3
    events = []

    def timed(*a, **k):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = real(*a, **k)
        e.record()
        events.append((s, e))
        return out

    solve_priority(batch, num_bands, use_kernel=True)
    torch.cuda.synchronize()
    priority_cuda.alloc_banded_k3 = timed
    try:
        t = time.perf_counter()
        solve_priority(batch, num_bands, use_kernel=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    finally:
        priority_cuda.alloc_banded_k3 = real
    k3 = sum(s.elapsed_time(e) for s, e in events)
    return {"solve_ms": wall, "k3_ms": k3, "rest_ms": wall - k3,
            "k3_launches": len(events)}


def phase_wide_prio(torch, card):
    out = {}

    async def drive():
        for dtype_name, seed in (("f32", 21), ("f64", 22)):
            run = await _drive_wide_prio(torch, dtype_name, seed)
            lo, hi, srel, nb, split = _check_wide_prio(torch, run)
            walls = run["walls"]
            solver = run["server"]._solver
            ticks = run["ticks"]
            say(f"phase wide-prio[{dtype_name}]: {WIDE_PRIO_RES} "
                f"PRIORITY_BANDS resources x {WIDE_PRIO_CLIENTS} clients in "
                f"{WIDE_PRIO_RES // WIDE_PRIO_GROUP} groups, {ticks} ticks "
                f"(walls ms {[round(w * 1e3, 2) for w in walls]}), launches "
                f"{run['launches']} by K3 layout {run['layouts']}, {nb} bands, "
                f"group usage / cap in [{lo:.9f}, {hi:.9f}], resource caps "
                f"held, grouped solve K3 vs plain {srel:.3g}; BatchSolver ms "
                f"per tick: " + ", ".join(
                    f"{k} {v * 1000.0 / ticks:.3f}"
                    for k, v in solver.phase_s.items())
                + f"; one grouped solve {split['solve_ms']:.3f} ms: "
                f"{split['k3_launches']} K3 launches {split['k3_ms']:.3f} ms "
                f"(events around each), the rest {split['rest_ms']:.3f} ms; "
                f"card {card}")
            out[dtype_name] = dict(run=run, solve_rel_err=srel, split=split)

    asyncio.run(drive())
    return out


# -- phase 12: the round-trip tick --------------------------------------------

RT_TICKS = {"f32": (12, 6), "f64": (3, 3)}  # (churn, quiet) ticks
RT_TRACKED_TICKS = 3
RT_WIDE = ("wide-10x100k", 10, 100_000)
RT_WIDE_TICKS = (3, 2)  # (ticks, quiet) of _drive_wide


def _packed_has(server):
    """Every lease's has, resource by resource in registry order (one
    bulk pack of the native engine)."""
    _r, _c, _w, has, _s, _p = server._store_engine.pack(
        [r.store for r in server.resources.values()])
    return has


def _byte_diff(a, b):
    """Leases whose has differs in any bit (a length mismatch counts
    every lease)."""
    import numpy as np

    if a.shape != b.shape:
        return max(len(a), len(b))
    return int((a.view(np.uint64) != b.view(np.uint64)).sum())


def phase_round_trip(torch, card):
    """The round-trip tick (`--no-fused-tick`) beside the fused one: two
    lane-cell servers from one seed with identical churn, whose stores
    must hold the same bytes; the round-trip server runs one K1 launch a
    tick and no K2, tracked or not; then one wide pair."""
    out = {}

    async def drive():
        for dtype_name, seed in (("f32", 31), ("f64", 32)):
            ticks, quiet = RT_TICKS[dtype_name]
            n = ticks + quiet
            runs = {}
            for fused in (True, False):
                tr = {}
                _s, _r, walls, modes, _sc, launches, _sv = await _drive_server(
                    torch, dtype_name, ticks, quiet, seed, fused=fused,
                    tracked=tr, label="round-trip " + (
                        "fused" if fused else "unfused"))
                runs[fused] = dict(tr, walls=walls, modes=modes,
                                   main_launches=launches)
            fu, rt = runs[True], runs[False]
            diff = _byte_diff(fu["has"], rt["has"])
            check(diff == 0, f"round-trip[{dtype_name}]: {diff} leases differ "
                  "from the fused server's")
            check(rt["main_launches"]["k1"] == n
                  and rt["main_launches"]["k2"] == 0,
                  f"round-trip[{dtype_name}]: launches {rt['main_launches']} "
                  f"in {n} ticks")
            check(rt["modes"] == ["full"] * n,
                  f"round-trip[{dtype_name}]: modes {rt['modes']}")
            check("scoped" in fu["modes"], "fused server: no scoped tick")
            tl = rt["launches"]
            check(tl["k1"] == RT_TRACKED_TICKS and tl["k2"] == 0,
                  f"round-trip[{dtype_name}] tracked: launches {tl}")
            check(fu["launches"]["k2"] >= 1,
                  "fused tracked run: K2 never launched")
            check(fu["changed"] == rt["changed"],
                  f"round-trip[{dtype_name}] tracked: changed rows differ")
            check(sum(map(len, rt["changed"])) > 0,
                  f"round-trip[{dtype_name}] tracked: no changed row")
            diff = _byte_diff(fu["has_after"], rt["has_after"])
            check(diff == 0, f"round-trip[{dtype_name}] tracked: {diff} leases "
                  "differ")
            churn = slice(2, ticks) if ticks > 3 else slice(1, ticks)
            p50, p95 = _pcts(rt["walls"][churn])
            fp50, fp95 = _pcts(fu["walls"][churn])
            say(f"phase round-trip[{dtype_name}]: {len(fu['has'])} leases, "
                f"{ticks} churn + {quiet} quiet ticks on each of two servers "
                f"from seed {seed}: stores byte-identical; round-trip launches "
                f"{rt['main_launches']} (one K1 a tick, every tick full), "
                f"fused {fu['main_launches']} ({fu['modes'].count('scoped')} "
                f"scoped ticks); tick wall p50 / p95 round-trip {p50:.2f} / "
                f"{p95:.2f} ms, fused {fp50:.2f} / {fp95:.2f} ms; tracked "
                f"{RT_TRACKED_TICKS} ticks: changed rows "
                f"{[len(c) for c in rt['changed']]} equal, launches round-trip "
                f"{tl}, fused {fu['launches']}; card {card}")
            say(f"phase round-trip[{dtype_name}]: host phase ms per tick, "
                "round-trip: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in rt["phases"].items())
                + "; fused: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in fu["phases"].items()))
            out[dtype_name] = dict(
                p50=p50, p95=p95, fused_p50=fp50, fused_p95=fp95,
                launches=rt["main_launches"], tracked_launches=tl,
                fused_launches=fu["main_launches"], changed=[
                    len(c) for c in rt["changed"]],
                walls_ms=[w * 1e3 for w in rt["walls"]],
                fused_walls_ms=[w * 1e3 for w in fu["walls"]],
            )
        label, n_wide, clients = RT_WIDE
        runs = {}
        for fused in (True, False):
            runs[fused] = await _drive_wide(
                torch, f"round-trip {label} {'fused' if fused else 'unfused'}",
                n_wide, clients, "f32", *RT_WIDE_TICKS, 41, fused=fused)
        fu, rt = runs[True], runs[False]
        diff = _byte_diff(_packed_has(fu["server"]), _packed_has(rt["server"]))
        check(diff == 0, f"round-trip {label}: {diff} leases differ")
        check(set(rt["modes"]) == {"full"} and "scoped" in fu["modes"],
              f"round-trip {label}: modes {rt['modes']} / {fu['modes']}")
        say(f"phase round-trip[{label} f32]: {n_wide} x {clients} clients, "
            f"{len(rt['walls'])} ticks each: stores byte-identical; tick walls "
            f"ms round-trip {[round(w * 1e3, 2) for w in rt['walls']]}, fused "
            f"{[round(w * 1e3, 2) for w in fu['walls']]}; launches (the "
            f"narrow resources) {rt['launches']}; card {card}")
        out[label] = dict(walls_ms=[w * 1e3 for w in rt["walls"]],
                          fused_walls_ms=[w * 1e3 for w in fu["walls"]])

    asyncio.run(drive())
    return out


# -- phase 13: a batch server on the Python lease store ------------------------

PY_PRIO = 1_000
PY_LANE = 1_000
PY_GROUP_SIZE = 500
# f32 cut from 6 ticks for the run's time.
PY_TICKS = {"f32": 4, "f64": 3}
PY_SAMPLE = 200  # lane resources held to the f64 oracles


def _py_layout(rng):
    """(resource ids, capacities, group ids, group caps) of the Python
    store's PRIORITY_BANDS resources: groups of PY_GROUP_SIZE, each
    capped at GROUP_SHARE of its members' summed capacity."""
    import numpy as np

    n_groups = PY_PRIO // PY_GROUP_SIZE
    tier = rng.integers(0, len(CAP_TIERS), PY_PRIO)
    group = np.repeat(np.arange(n_groups), PY_GROUP_SIZE)
    rng.shuffle(group)
    cap = np.asarray(CAP_TIERS)[tier]
    gcap = np.asarray([GROUP_SHARE * cap[group == g].sum()
                       for g in range(n_groups)])
    ids = [f"p.g{g}.t{t}.r{i}" for i, (g, t) in enumerate(zip(group, tier))]
    return ids, cap, group, gcap


def _populate_py(server, rng, ids):
    """N_CLIENTS leases on each resource, lease by lease into its Python
    store: the PRIORITY_BANDS leases (the first PY_PRIO resources) with
    1-3 subclients and wire priorities from PRIORITIES, wants 0-99."""
    import numpy as np

    res = [server.get_or_create_resource(r) for r in ids]
    n, n_prio = len(ids) * N_CLIENTS, PY_PRIO * N_CLIENTS
    wants = rng.integers(0, 100, n).astype(np.float64)
    sub = np.ones(n, np.int64)
    sub[:n_prio] = rng.integers(1, 4, n_prio)
    prio = np.zeros(n, np.int64)
    prio[:n_prio] = rng.choice(np.asarray(PRIORITIES), n_prio)
    k = 0
    for i, r in enumerate(res):
        for c in range(N_CLIENTS):
            r.store.assign(f"c{i}.{c}", 3600.0, 5.0, 0.0, float(wants[k]),
                           int(sub[k]), int(prio[k]))
            k += 1
    return res


def _churn_py(rng, res):
    """5% of the priority and 5% of the lane resources refresh with new
    demand (has, subclients and priorities kept), as GetCapacity on a
    batch server records it."""
    import numpy as np

    n_lane = len(res) - PY_PRIO
    pick = np.concatenate([
        rng.choice(PY_PRIO, PY_PRIO // 20, replace=False),
        PY_PRIO + rng.choice(n_lane, n_lane // 20, replace=False),
    ])
    wants = rng.integers(0, 100, len(pick) * N_CLIENTS)
    k = 0
    for i in pick:
        store = res[i].store
        for client, lease in list(store.items()):
            store.assign(client, 3600.0, 5.0, lease.has, float(wants[k]),
                         lease.subclients, lease.priority)
            k += 1


def _store_inputs(res):
    """(wants, has, subclients) of a Python store, in lease order."""
    import numpy as np

    leases = [l for _c, l in res.store.items()]
    return tuple(np.array([getattr(l, f) for l in leases], np.float64)
                 for f in ("wants", "has", "subclients"))


async def _drive_py(torch, dtype_name, seed):
    import numpy as np

    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    rng = np.random.default_rng(seed)
    prio_ids, cap, group, gcap = _py_layout(rng)
    ids = prio_ids + _resource_ids(rng, PY_LANE)
    ticks = PY_TICKS[dtype_name]
    server = CapacityServer(
        "smoke-py", TrivialElection(), mode="batch", native_store=False,
        solver_dtype=dtype_name, tick_interval=1.0, flightrec_capacity=0,
        device=DEVICE,
    )
    await server.start(0, host="127.0.0.1", tick_loop=False)
    try:
        await server.load_config(parse_yaml_config(_prio_yaml(gcap)))
        t = time.perf_counter()
        res = _populate_py(server, rng, ids)
        populate_s = time.perf_counter() - t
        sample = rng.choice(PY_LANE, min(PY_SAMPLE, PY_LANE), replace=False)
        dense_cuda.reset_launches()  # the path starts here
        walls = []
        for i in range(ticks):
            _churn_py(rng, res)
            if i == ticks - 1:
                inputs = {int(j): _store_inputs(res[PY_PRIO + j])
                          for j in sample}
            t = time.perf_counter()
            await server.tick_once()
            walls.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        return dict(server=server, res=res, walls=walls, launches=launches,
                    inputs=inputs, cap=cap, group=group, gcap=gcap,
                    ticks=ticks, populate_s=populate_s,
                    phase_s=dict(server._solver.phase_s))
    finally:
        await server.stop()


async def _native_priority_part(torch, run, dtype_name):
    """The same PRIORITY_BANDS leases, in the same order, bulk-loaded into
    a native-store batch server: its BatchSolver's priority part, packed
    and solved (not applied). Comparison launches: not counted."""
    import numpy as np

    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer

    server = CapacityServer(
        "smoke-py-native", TrivialElection(), mode="batch", native_store=True,
        solver_dtype=dtype_name, flightrec_capacity=0, device=DEVICE,
    )
    try:
        await server.load_config(parse_yaml_config(_prio_yaml(run["gcap"])))
        engine = server._store_engine
        py_res = run["res"][:PY_PRIO]
        nat_res = [server.get_or_create_resource(r.id) for r in py_res]
        leases = [(r.store._rid, c, l) for p, r in zip(py_res, nat_res)
                  for c, l in p.store.items()]
        n = len(leases)
        col = lambda f: np.fromiter((getattr(l, f) for _r, _c, l in leases),
                                    np.float64, n)  # noqa: E731
        engine.bulk_assign(
            np.fromiter((r for r, _c, _l in leases), np.int32, n),
            np.fromiter((engine.client_handle(c) for _r, c, _l in leases),
                        np.int64, n),
            np.full(n, time.time() + 3600.0), np.full(n, 5.0), col("has"),
            col("wants"), col("subclients").astype(np.int32),
            col("priority").astype(np.int64),
        )
        solver = server._get_solver()
        snap = solver.prepare(nat_res)
        solver.solve(snap)
        return snap.priority_part
    finally:
        await server.stop()


def phase_python_store(torch, card):
    """A batch server on the Python lease store: PRIORITY_BANDS resources
    in binding groups (the BatchSolver's priority part, K3) beside lane
    resources (the edge list), packed and applied lease by lease."""
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.core.resource import algo_kind_for
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.priority import alloc_evaluations

    out = {}

    async def drive():
        for dtype_name, seed in (("f32", 61), ("f64", 62)):
            run = await _drive_py(torch, dtype_name, seed)
            server, res, ticks = run["server"], run["res"], run["ticks"]
            solver = server._solver
            launches = run["launches"]
            per_tick = alloc_evaluations(solver._tdtype, True)
            check(solver.ticks == ticks, f"python-store: {solver.ticks} ticks")
            check(launches["k3"] > 0 and launches["k3"] == per_tick * ticks,
                  f"python-store[{dtype_name}]: K3 launches "
                  f"{launches['k3']} != {per_tick} x {ticks}")
            check(launches["k1"] == launches["k2"] == 0,
                  f"python-store[{dtype_name}]: the lane part launched "
                  f"{launches} (the edge list runs no kernel)")
            snap = solver.last_snapshot
            part = snap.priority_part
            check(snap.engine is None and snap.edges is not None
                  and part.engine is None and part.clients is not None,
                  "python-store: not the Python-store packs")
            check(snap.num_edges == PY_LANE * N_CLIENTS,
                  f"python-store: lane part {snap.num_edges} edges")
            # The lane grants against the f64 oracles on the last
            # tick's inputs (as the overflow tick's edge list is held).
            lane_err = 0.0
            for j, inp in run["inputs"].items():
                r = res[PY_PRIO + j]
                got = np.array([l.has for _c, l in r.store.items()])
                lane_err = max(lane_err, _oracle_err(r, got, inp))
            check(lane_err <= F32_PARITY_REL_BOUND,
                  f"python-store[{dtype_name}]: lane grants vs f64 oracle "
                  f"{lane_err:.3g}")
            totals = np.array([sum(l.has for _c, l in r.store.items())
                               for r in res])
            over = totals[:PY_PRIO] - run["cap"] * (1 + 1e-6)
            check((over <= 0).all(),
                  f"python-store: resource capacity exceeded by {over.max()}")
            for r, tot in zip(res[PY_PRIO:], totals[PY_PRIO:]):
                check(algo_kind_for(r.template) in (0, 1)
                      or tot <= r.template.capacity * (1 + 1e-6),
                      f"python-store {r.id}: {tot:.9g} > capacity")
            ratios = []
            for g, gcap in enumerate(run["gcap"]):
                usage = totals[:PY_PRIO][run["group"] == g].sum()
                check(usage <= gcap * (1 + 1e-6),
                      f"python-store group g{g}: {usage:.9g} > {gcap:.9g}")
                ratios.append(usage / gcap)
            # The native store's BatchSolver on the same leases: the same
            # tables, the same K3 grants bit for bit.
            saved = dict(dense_cuda.LAUNCHES)
            prio_res = res[:PY_PRIO]
            py_snap = solver.prepare(prio_res)
            solver.solve(py_snap)
            nat = await _native_priority_part(torch, run, dtype_name)
            dense_cuda.LAUNCHES.update(saved)
            py_part = py_snap.priority_part
            for f in ("wants", "weights", "band", "active", "capacity",
                      "group", "group_cap"):
                check(torch.equal(getattr(py_part.batch, f),
                                  getattr(nat.batch, f)),
                      f"python-store: the native pack's {f} differs")
            check(np.array_equal(py_part.gets, nat.gets),
                  f"python-store[{dtype_name}]: K3 grants differ from the "
                  "native-store BatchSolver's")
            walls = run["walls"]
            ph = {k: v * 1e3 / ticks for k, v in run["phase_s"].items()}
            say(f"phase python-store[{dtype_name}]: {PY_PRIO} PRIORITY_BANDS "
                f"resources in {len(run['gcap'])} groups of {PY_GROUP_SIZE} "
                f"and {PY_LANE} lane resources x {N_CLIENTS} clients on the "
                f"Python store ({len(res) * N_CLIENTS} leases, populated in "
                f"{run['populate_s']:.1f}s), {ticks} ticks with 5% churn: "
                f"walls ms {[round(w * 1e3, 1) for w in walls]}, launches "
                f"{launches} ({per_tick} K3 a tick), BatchSolver ms per "
                "tick: " + ", ".join(f"{k} {v:.3f}" for k, v in ph.items())
                + f"; lane grants vs f64 oracle {lane_err:.3g} ({len(run['inputs'])}"
                f" resources), group usage / cap in [{min(ratios):.9f}, "
                f"{max(ratios):.9f}], resource caps held, K3 grants "
                f"bit-identical to the native-store BatchSolver's "
                f"({part.num_bands} bands); card {card}")
            out[dtype_name] = dict(
                walls_ms=[w * 1e3 for w in walls], launches=launches,
                phase_ms=ph, lane_oracle_err=lane_err,
                populate_s=run["populate_s"])

    asyncio.run(drive())
    return out


# -- phase 14: immediate mode ------------------------------------------------

IMM_RES = 200
IMM_CLIENTS = 10
IMM_SEQ = 2_000
IMM_CONC = (32, 50)  # concurrent clients x requests each


def _imm_yaml(groups=False):
    """The lane templates, an ungrouped PRIORITY_BANDS template and the
    default; `groups` adds a capacity group (refused outside batch
    mode)."""
    algo = ("{kind: PRIORITY_BANDS, lease_length: 3600, refresh_interval: 5,"
            " learning_mode_duration: 0}")
    lines = ["groups:\n  - name: up\n    capacity: 100"] if groups else []
    lines += ["resources:"] + _lane_templates()
    lines.append(f"  - identifier_glob: 'ip.*'\n    capacity: 500\n"
                 + ("    capacity_group: up\n" if groups else "")
                 + f"    algorithm: {algo}")
    lines.append(
        "  - identifier_glob: '*'\n    capacity: 1000\n"
        "    algorithm: {kind: 0, lease_length: 3600,"
        " refresh_interval: 5, learning_mode_duration: 0}"
    )
    return "\n".join(lines) + "\n"


def _imm_request(rng, ids, has, prefix="c"):
    """One GetCapacity of a random client of a random resource, reporting
    the capacity it was last granted there."""
    from doorman_tpu_torch.proto import doorman_pb2 as pb

    i = int(rng.integers(len(ids)))
    client = f"{prefix}{i}.{int(rng.integers(IMM_CLIENTS))}"
    req = pb.GetCapacityRequest(client_id=client)
    r = req.resource.add()
    r.resource_id, r.wants = ids[i], float(rng.integers(0, 100))
    r.priority = int(rng.choice(PRIORITIES))
    if (client, ids[i]) in has:
        r.has.capacity = has[(client, ids[i])]
    return req


async def _drive_immediate(torch):
    import grpc
    import numpy as np

    from doorman_tpu_torch.algorithms import Request
    from doorman_tpu_torch.core.resource import Resource
    from doorman_tpu_torch.proto.grpc_api import CapacityStub
    from doorman_tpu_torch.server.config import (
        ConfigError,
        find_template,
        parse_yaml_config,
    )
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    rng = np.random.default_rng(71)
    n_prio = IMM_RES // 5
    ids = _resource_ids(rng, IMM_RES - n_prio) + [
        f"ip.r{i}" for i in range(n_prio)]
    now = time.time()
    clock = lambda: now  # noqa: E731  (expiries are compared exactly)
    repo = parse_yaml_config(_imm_yaml())
    dense_cuda.reset_launches()  # the whole phase
    server = CapacityServer("smoke-immediate", TrivialElection(),
                            clock=clock, flightrec_capacity=0, device=DEVICE)
    check(server.mode == "immediate" and server._store_engine is None,
          "the defaults are not immediate mode on the Python store")
    port = await server.start(0, host="127.0.0.1")
    try:
        check(not server._tasks, "an immediate server started a tick loop")
        try:
            await server.load_config(parse_yaml_config(_imm_yaml(True)))
            check(False, "a grouped config loaded in immediate mode")
        except ConfigError:
            pass
        await server.load_config(repo)
        seq, has, seq_lat = [], {}, []
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub = CapacityStub(ch)
            for _ in range(IMM_SEQ):
                req = _imm_request(rng, ids, has)
                t = time.perf_counter()
                got = (await stub.GetCapacity(req)).response[0]
                seq_lat.append(time.perf_counter() - t)
                r = req.resource[0]
                has[(req.client_id, r.resource_id)] = got.gets.capacity
                seq.append((req, got))
        # The same sequence, in process, through Resource.decide on fresh
        # Python stores: every field bit for bit.
        replay, mism = {}, 0
        for req, got in seq:
            r = req.resource[0]
            res = replay.get(r.resource_id)
            if res is None:
                res = replay[r.resource_id] = Resource(
                    r.resource_id, find_template(repo, r.resource_id),
                    clock=clock)
            lease = res.decide(Request(
                req.client_id, r.has.capacity if r.HasField("has") else 0.0,
                r.wants, 1, priority=r.priority))
            if (lease.has, int(lease.expiry), int(lease.refresh_interval),
                    res.safe_capacity()) != (
                    got.gets.capacity, got.gets.expiry_time,
                    got.gets.refresh_interval, got.safe_capacity):
                mism += 1
        check(mism == 0, f"immediate: {mism} of {IMM_SEQ} grants differ "
              "from the in-process replay")
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        check(not any(launches.values()),
              f"immediate mode launched kernels: {launches}")
        check(server._solver is None and server._resident is None,
              "immediate mode made a solver")
        leases = server.status()["leases"]
    finally:
        await server.stop()
    return dict(seq_lat=seq_lat, launches=launches, leases=leases,
                resources=len(replay), ids=ids)


def _channel(grpc, port, creds=None):
    """A loopback channel to `port`: TLS when given credentials."""
    if creds is not None:
        return grpc.aio.secure_channel(f"localhost:{port}", creds)
    return grpc.aio.insecure_channel(f"127.0.0.1:{port}")


async def _load(port, ids, creds=None):
    """IMM_CONC[0] concurrent clients, a channel each, of IMM_CONC[1]
    sequential GetCapacity each: (request latencies, wall seconds)."""
    import grpc
    import numpy as np

    from doorman_tpu_torch.proto.grpc_api import CapacityStub

    lat = []

    async def client(k):
        # Each concurrent client speaks for clients of its own.
        crng, mine = np.random.default_rng(100 + k), {}
        async with _channel(grpc, port, creds) as ch:
            stub = CapacityStub(ch)
            for _ in range(IMM_CONC[1]):
                req = _imm_request(crng, ids, mine, prefix=f"w{k}.")
                t = time.perf_counter()
                got = (await stub.GetCapacity(req)).response[0]
                lat.append(time.perf_counter() - t)
                mine[(req.client_id, got.resource_id)] = got.gets.capacity

    t = time.perf_counter()
    await asyncio.gather(*(client(k) for k in range(IMM_CONC[0])))
    return lat, time.perf_counter() - t


async def _cli_load(ids):
    """The server binary with the reference's default flags (immediate
    mode, the Python store) in a process of its own, under _load from
    this one; the process is stopped on the way out."""
    import os
    import socket
    import tempfile

    import grpc

    from doorman_tpu_torch.proto import doorman_pb2 as pb
    from doorman_tpu_torch.proto.grpc_api import CapacityStub

    with tempfile.TemporaryDirectory() as tmp, socket.socket() as sock:
        cfg = Path(tmp) / "cfg.yml"
        cfg.write_text(_imm_yaml())
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        with open(Path(tmp) / "server.log", "w+") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "doorman_tpu_torch.cmd.server",
                 "--config", f"file:{cfg}", "--host", "127.0.0.1",
                 "--port", str(port), "--device", DEVICE,
                 "--log-level", "warning"],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            )
            try:
                deadline = time.time() + 120.0
                async with _channel(grpc, port) as ch:
                    stub = CapacityStub(ch)
                    while True:
                        check(proc.poll() is None and time.time() < deadline,
                              "the server binary did not come up")
                        try:
                            d = await stub.Discovery(pb.DiscoveryRequest(),
                                                     timeout=1.0)
                            if d.is_master:
                                break
                        except grpc.aio.AioRpcError:
                            pass
                        await asyncio.sleep(0.5)
                lat, secs = await _load(port, ids)
                check(proc.poll() is None, "the server binary exited")
            except PhaseFailed:
                log.seek(0)
                say(log.read()[-4000:])
                raise
            finally:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    return lat, secs


def phase_immediate(torch, card):
    """Immediate mode on the Python store: the in-process server's grants
    against a replay, then the server binary with the default flags under
    concurrent clients from this process."""
    import numpy as np

    run = asyncio.run(_drive_immediate(torch))
    lat, secs = asyncio.run(_cli_load(run["ids"]))
    lat = np.asarray(lat) * 1e3
    seq = np.asarray(run["seq_lat"]) * 1e3
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    sp50, sp99 = float(np.percentile(seq, 50)), float(np.percentile(seq, 99))
    rps = len(lat) / secs
    say(f"phase immediate: {IMM_SEQ} sequential GetCapacity over "
        f"{run['resources']} resources x {IMM_CLIENTS} clients on the Python "
        f"store equal the in-process replay bit for bit (request p50 "
        f"{sp50:.3f} ms, p99 {sp99:.3f} ms, client and server on one event "
        f"loop); {run['leases']} leases; launches {run['launches']}; a grouped "
        f"config refused. The server binary with the default flags, "
        f"{IMM_CONC[0]} concurrent clients x {IMM_CONC[1]} requests from "
        f"another process: p50 {p50:.3f} ms, p99 {p99:.3f} ms, {rps:.0f} "
        f"requests/s; card {card}")
    return dict(p50_ms=p50, p99_ms=p99, seq_p50_ms=sp50, seq_p99_ms=sp99,
                requests_per_s=rps, launches=run["launches"])


# -- phases 15-17: streaming lease push (WatchCapacity) ------------------------

# The parity schedule of the reference's push-vs-poll pin: two resources,
# mixed bands on one stream, churn from three clients, a mastership flip,
# and a disconnect with a resume-from-seq reconnect.
SP_CONFIG = """
resources:
- identifier_glob: prop
  capacity: 100
  safe_capacity: 3
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
- identifier_glob: "*"
  capacity: 80
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
"""
SP_RESOURCES = ("prop", "fair")
SP_PRIO = {"prop": 2, "fair": 0}
SP_CHURN = (  # (tick, churner, resource, wants)
    (1, "c1", "prop", 70.0), (2, "c2", "fair", 55.0),
    (3, "c1", "prop", 20.0), (3, "c2", "fair", 90.0),
    (5, "c3", "prop", 40.0), (8, "c1", "prop", 75.0),
    (9, "c2", "fair", 10.0), (11, "c3", "prop", 5.0),
    (13, "c1", "prop", 60.0),
)
SP_TICKS, SP_FLIP, SP_DISCONNECT, SP_RECONNECT = 15, 6, 10, 12

# The lane cell with 100,000 subscriptions (bench.py's FANOUT_TIERS top
# tier), 10 to a resource, beside a twin that re-decides all of them.
ST_SUBS_PER_RES = 10
ST_SHARDS = 4
# Warm, churn and quiet ticks: cut from bench.py's 3 + 6 + 3 for the
# run's time (the check-all twin re-decides 100,000 subscriptions a tick,
# 7-10 s on an H100 machine's host). The 5 s refresh beat lands on the
# quiet tick. The scoped pair (the default solve a --stream-push server
# runs) stops before the beat: after its first (full, check-all) tick
# every tick is scoped, the delta source the unscoped pair does not
# reach — the first delivery of every row, then one churned set.
# One churn tick less in each pair (from 2 + 3 + 1 and 1 + 2 + 0), for
# the admission and frontend phases' time; then the unscoped pair's
# second churn tick and its quiet tick (from 2 + 2 + 1), for the fleet
# and TLS phases'.
ST_TICKS = (2, 1, 0)
ST_SCOPED_TICKS = (1, 1, 0)

# bench.py's server_stream_fanout_scaling shape.
FT_TIERS = (1_000, 10_000, 100_000)
FT_SUBS_PER_RES = 50
FT_CHURN_RES = 4
FT_TICKS = (3, 6, 2, 3)  # warm, churn, settle, quiet
FT_CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 600
  safe_capacity: 1
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 7200,
              refresh_interval: 3600, learning_mode_duration: 0}
"""


class _StreamReader:
    """Reads a WatchCapacity call without cancelling it on a timeout (a
    cancelled read cancels the RPC): the pending read is kept."""

    def __init__(self, call):
        self.call = call
        self._pending = None

    async def read(self, timeout=30.0):
        if self._pending is None:
            self._pending = asyncio.ensure_future(self.call.read())
        done, _ = await asyncio.wait({self._pending}, timeout=timeout)
        check(bool(done), "stream read timed out")
        task, self._pending = self._pending, None
        return task.result()

    async def poll(self, timeout):
        """The next message, or None when none came within `timeout`."""
        if self._pending is None:
            self._pending = asyncio.ensure_future(self.call.read())
        done, _ = await asyncio.wait({self._pending}, timeout=timeout)
        if not done:
            return None
        task, self._pending = self._pending, None
        return task.result()

    def cancel(self):
        if self._pending is not None:
            self._pending.cancel()
            self._pending = None
        self.call.cancel()


def _watch_request(spb, client_id, leases, resume_seq=0):
    req = spb.WatchCapacityRequest(client_id=client_id, resume_seq=resume_seq)
    for rid in SP_RESOURCES:
        rr = req.resource.add()
        rr.resource_id, rr.priority, rr.wants = rid, SP_PRIO[rid], 30.0
        if leases.get(rid) is not None:
            rr.has.CopyFrom(leases[rid])
    return req


async def _sp_churn(pb, stubs, leases, rows):
    """GetCapacity for each (churner, resource, wants) on every server, in
    the same order, each carrying its last lease as has."""
    for cid, rid, wants in rows:
        for stub in stubs:
            held = leases[id(stub)]
            req = pb.GetCapacityRequest(client_id=cid)
            rr = req.resource.add()
            rr.resource_id, rr.priority, rr.wants = rid, 1, wants
            if held.get((cid, rid)) is not None:
                rr.has.CopyFrom(held[(cid, rid)])
            out = await stub.GetCapacity(req)
            lease = pb.Lease()
            lease.CopyFrom(out.response[0].gets)
            held[(cid, rid)] = lease


async def _stream_parity(torch):
    """The reference's push-vs-poll parity pin over loopback gRPC on the
    card: a poll server and a stream server, native store, one clock."""
    import grpc

    from doorman_tpu_torch.proto import doorman_pb2 as pb
    from doorman_tpu_torch.proto import doorman_stream_pb2 as spb
    from doorman_tpu_torch.proto.grpc_api import CapacityStub
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    t = [1000.0]
    servers, addrs = [], []
    for push in (False, True):
        s = CapacityServer(
            "parity", TrivialElection(), mode="batch", tick_interval=1.0,
            minimum_refresh_interval=0.0, clock=lambda: t[0],
            native_store=True, stream_push=push, flightrec_capacity=0,
            device=DEVICE)
        port = await s.start(0, host="127.0.0.1", tick_loop=False)
        await s.load_config(parse_yaml_config(SP_CONFIG))
        await asyncio.sleep(0)
        s.current_master = f"127.0.0.1:{port}"
        servers.append(s)
        addrs.append(s.current_master)
    pserver, sserver = servers
    channels = [grpc.aio.insecure_channel(a) for a in addrs]
    stubs = [CapacityStub(c) for c in channels]
    pstub, sstub = stubs
    churn_leases = {id(s): {} for s in stubs}
    poll_leases, keys, rows = {}, {}, {}
    changed = {rid: [] for rid in SP_RESOURCES}
    pushed = {rid: [] for rid in SP_RESOURCES}
    stream_leases, last_seq = {}, [0]
    registry = sserver._streams

    async def poll(record=True):
        req = pb.GetCapacityRequest(client_id="w")
        for rid in SP_RESOURCES:
            rr = req.resource.add()
            rr.resource_id, rr.priority, rr.wants = rid, SP_PRIO[rid], 30.0
            if poll_leases.get(rid) is not None:
                rr.has.CopyFrom(poll_leases[rid])
        out = await pstub.GetCapacity(req)
        check(not out.HasField("mastership"), "stream-parity: poll redirected")
        for row in out.response:
            rid = row.resource_id
            key = (row.gets.capacity, row.safe_capacity,
                   row.gets.refresh_interval)
            if record and key != keys.get(rid):
                changed[rid].append(row.SerializeToString())
            keys[rid], rows[rid] = key, row.SerializeToString()
            lease = pb.Lease()
            lease.CopyFrom(row.gets)
            poll_leases[rid] = lease

    def apply(msg):
        check(msg.seq > last_seq[0] or msg.snapshot,
              f"stream-parity: seq {msg.seq} after {last_seq[0]}")
        last_seq[0] = int(msg.seq)
        for row in msg.response:
            pushed[row.resource_id].append(row.SerializeToString())
            lease = pb.Lease()
            lease.CopyFrom(row.gets)
            stream_leases[row.resource_id] = lease

    def parity(where):
        for rid in SP_RESOURCES:
            check(pushed[rid] == changed[rid],
                  f"stream-parity {where}: {rid} pushed {len(pushed[rid])} "
                  f"rows, the polls changed {len(changed[rid])}")

    def churn_rows(tick):
        return [(c, r, w) for at, c, r, w in SP_CHURN if at == tick]

    dense_cuda.reset_launches()  # the stream-parity path starts here
    try:
        await poll()
        reader = _StreamReader(sstub.WatchCapacity(
            _watch_request(spb, "w", stream_leases)))
        snap = await reader.read()
        check(snap.snapshot and len(snap.response) == 2,
              "stream-parity: no opening snapshot")
        apply(snap)
        parity("establishment")
        terminal = None
        disconnected = False
        for tick in range(1, SP_TICKS):
            if tick == SP_FLIP:
                await pserver._on_is_master(False)
                await sserver._on_is_master(False)
                terminal = await reader.read()
                check(terminal.HasField("mastership")
                      and terminal.mastership.master_address == addrs[1],
                      "stream-parity: the flip sent no terminal redirect")
                reader.cancel()
                await pserver._on_is_master(True)
                await sserver._on_is_master(True)
                current = {}
                for at, c, r, w in SP_CHURN:
                    if at < tick:
                        current[(c, r)] = w
                await _sp_churn(pb, stubs, churn_leases, [
                    (c, r, w) for (c, r), w in sorted(current.items())])
                reader = _StreamReader(sstub.WatchCapacity(_watch_request(
                    spb, "w", stream_leases, resume_seq=last_seq[0])))
                resumed = await reader.read()
                check(resumed.snapshot, "stream-parity: resume not a snapshot")
                apply(resumed)
                await poll()
                parity(f"flip at tick {tick}")
                continue
            if tick == SP_DISCONNECT:
                reader.cancel()
                await asyncio.sleep(0.05)
                disconnected = True
            if tick == SP_RECONNECT:
                disconnected = False
            await _sp_churn(pb, stubs, churn_leases, churn_rows(tick))
            t[0] += 1.0
            await pserver.tick_once()
            if disconnected or tick == SP_RECONNECT:
                await sserver.tick_once()
                await poll()
            if disconnected:
                continue
            if tick == SP_RECONNECT:
                reader = _StreamReader(sstub.WatchCapacity(_watch_request(
                    spb, "w", stream_leases, resume_seq=last_seq[0])))
                resumed = await reader.read()
                check(resumed.snapshot, "stream-parity: resume not a snapshot")
                for row in resumed.response:
                    check(row.SerializeToString() == rows[row.resource_id]
                          and row.gets.capacity
                          != stream_leases[row.resource_id].capacity,
                          "stream-parity: a resumed row diverged")
                apply(resumed)
                for rid in SP_RESOURCES:
                    changed[rid] = list(pushed[rid])
                continue
            before = registry.total_messages
            await sserver.tick_once()
            for _ in range(registry.total_messages - before):
                apply(await reader.read())
            await poll()
            parity(f"tick {tick}")
        reader.cancel()
        torch.cuda.synchronize()
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        total = sum(len(v) for v in pushed.values())
        check(6 <= total < SP_TICKS * len(SP_RESOURCES),
              f"stream-parity: {total} pushed rows")
        check(launches["k2"] > 0, "stream-parity: K2 never launched")
        errors = registry.fanout_errors
        check(errors == 0, f"stream-parity: {errors} fanout errors")
        return dict(pushed_rows=total, launches=launches,
                    matched_total=sserver._stream_matcher.matched_total,
                    seq=registry.status()["seq"])
    finally:
        for c in channels:
            await c.close()
        for s in servers:
            await s.stop()


class _MatchLog:
    """Records every SubscriptionMatcher.match while active: the matcher,
    the changed rows it was given and the pairs it returned."""

    def __enter__(self):
        from doorman_tpu_torch.server import match as match_mod

        self.entries = []
        self._cls = match_mod.SubscriptionMatcher
        self._real = real = self._cls.match
        entries = self.entries

        def recorded(matcher, changed_rids):
            pairs = real(matcher, changed_rids)
            entries.append((matcher, list(changed_rids), pairs))
            return pairs

        self._cls.match = recorded
        return self

    def __exit__(self, *exc):
        self._cls.match = self._real
        return False


def _match_device_ms(torch, matcher, work):
    """The device time of one match (the changed rows' mask, the
    compaction and the pair gather) on the matcher's resident table,
    between CUDA events, the launches queued behind a spin."""
    import numpy as np

    from doorman_tpu_torch.server.match import _pow2

    changed = np.full(_pow2(len(work)), -1, np.int32)
    changed[: len(work)] = work
    changed_d = torch.from_numpy(changed).cuda()
    cap = _pow2(sum(matcher.watchers(r) for r in work))
    return _time_ms(
        torch, lambda: matcher._match_on_device(changed_d, cap), queued=True)


def _drain(queue_of):
    """Every queued push of each subscription (bytes), in order."""
    out = []
    for sub in queue_of:
        got = []
        while not sub.queue.empty():
            got.append(sub.queue.get_nowait())
        out.append(got)
    return out


async def _stream_lane(torch, scoped, ticks, pooled=False):
    """The lane cell (f32) with 100,000 subscriptions on a stream server
    with the delta filter, beside a twin from the same seed and churn that
    re-decides every subscription every tick. scoped=False puts K2 under
    every fanout; scoped=True is the server's default solve, whose scoped
    ticks take their changed rows from K1 and a compare. pooled=True is
    frontend-parity: the filtered server's streams are pooled over an
    InlineFrontendPool (FE_WORKERS workers, FE_RING_BYTES rings), so each
    of its pushes reaches the subscription through its worker's ring and
    pump before it is held against the twin's."""
    side = {}
    try:
        return await _stream_lane_run(torch, side, scoped, ticks, pooled)
    finally:
        for s in side.values():
            await s["server"].stop()


async def _stream_lane_run(torch, side, scoped, ticks, pooled):
    import numpy as np

    from doorman_tpu_torch.proto import doorman_stream_pb2 as spb
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    t = [float(int(time.time()))]
    rng_subs = np.random.default_rng(61)
    sub_wants = rng_subs.integers(0, 100, N_RES * ST_SUBS_PER_RES)
    label = "streams scoped" if scoped else "streams"
    for name in ("filtered", "check-all"):
        # The reference server's defaults where the cell names none: the
        # tick pipeline depth 1. Scoped solve off: every narrow tick is a
        # full tracked tick, so K2's changed flags feed every fanout. On:
        # a scoped tick compares the scope's rows outside K2, as the
        # reference's does.
        server = CapacityServer(
            name, TrivialElection(), mode="batch", native_store=True,
            solver_dtype="f32", scoped_solve=scoped, tick_interval=1.0,
            clock=lambda: t[0], stream_push=True, stream_shards=ST_SHARDS,
            flightrec_capacity=0,
            device=DEVICE)
        pool = (server.attach_frontend(FE_WORKERS, ring_bytes=FE_RING_BYTES)
                if pooled and name == "filtered" else None)
        side[name] = dict(server=server, pool=pool, laps=0)
        await server.start(0, host="127.0.0.1", tick_loop=False)
        await server.load_config(parse_yaml_config(_config_yaml()))
        tp = time.perf_counter()
        resources, rids, cids = _populate(server, np.random.default_rng(60))
        populate_s = time.perf_counter() - tp
        registry, subs = server._streams, []
        tp = time.perf_counter()
        for i, res in enumerate(resources):
            for j in range(ST_SUBS_PER_RES):
                req = spb.WatchCapacityRequest(client_id=f"s{i}.{j}")
                rr = req.resource.add()
                rr.resource_id = res.id
                rr.wants = float(sub_wants[i * ST_SUBS_PER_RES + j])
                sub = registry.subscribe(req)
                server._stream_match_add(sub)
                subs.append(sub)
            if pool is not None and i % 1000 == 999:
                side[name]["laps"] += _fe_pump(pool)
        if pool is not None:
            side[name]["laps"] += _fe_pump(pool)
        establish_s = time.perf_counter() - tp
        snaps = _drain(subs)
        registry.take_tick_stats()  # the snapshots are not tick 1's
        side[name].update(rids=rids, cids=cids, subs=subs, snaps=snaps,
                          walls=[], fanout=[], launches=[],
                          populate_s=populate_s, establish_s=establish_s)
    fil, twin = side["filtered"], side["check-all"]
    check(fil["snaps"] == twin["snaps"],
          f"{label}: the establishment snapshots differ")
    # Every device match of the filtered server (the changed rows and the
    # pairs it returned) is held against the host mirror after the tick.
    churn_rng = {n: np.random.default_rng(62) for n in side}
    warm, churn, quiet = ticks
    per_tick = []
    with _MatchLog() as matches:
        log = matches.entries
        for tick in range(warm + churn + quiet):
            t[0] += 1.0
            row = {"tick": tick + 1,
                   "kind": ("warm" if tick < warm else "churn"
                            if tick < warm + churn else "quiet")}
            for name, s in side.items():
                server = s["server"]
                if row["kind"] == "churn":
                    _churn(server._store_engine, churn_rng[name],
                           s["rids"], s["cids"])
                if name == "check-all":
                    server._stream_check_all = True  # the filter defeated
                phases = dict(server._stream_matcher.phase_s) \
                    if server._stream_matcher is not None else {}
                del log[:]
                dense_cuda.reset_launches()  # this server's tick starts here
                tw = time.perf_counter()
                await server.tick_once()
                torch.cuda.synchronize()
                s["walls"].append(time.perf_counter() - tw)
                if s["pool"] is not None:
                    # The tick's frames through the rings to the queues.
                    tp = time.perf_counter()
                    s["laps"] += _fe_pump(s["pool"])
                    s.setdefault("pump_ms", []).append(
                        (time.perf_counter() - tp) * 1e3)
                s["launches"].append(dict(dense_cuda.LAUNCHES))
                registry = server._streams
                s["fanout"].append(registry.last_fanout_seconds)
                st = registry.take_tick_stats()
                row[name] = dict(
                    walked=st["subs_walked"], matched=st["matched_pairs"],
                    messages=st["messages"], bytes=st["push_bytes"],
                    fanout_ms=registry.last_fanout_seconds * 1e3,
                    wall_ms=s["walls"][-1] * 1e3)
                check(registry.fanout_errors == 0,
                      f"{label}: {registry.fanout_errors} fanout errors "
                      f"({name})")
                if name != "filtered":
                    continue
                matcher = server._stream_matcher
                row["changed_rows"] = sum(len(c) for _m, c, _p in log)
                row["match_pairs"] = sum(len(p) for _m, _c, p in log)
                if matcher is not None:
                    row["matcher_ms"] = {
                        k: (matcher.phase_s[k] - phases.get(k, 0.0)) * 1e3
                        for k in ("staging", "match", "download")}
                    st_m = matcher.status()
                    check(st_m["device"]
                          and matcher._indices_d.device.type == "cuda",
                          f"{label}: the matcher's table is not on the card")
                # The device pairs against the host mirror on the same
                # changed rows, and the match's device time between CUDA
                # events on the same inputs (outside the timed fanout).
                for m, changed, pairs in log:
                    work = [r for r in changed if m._members.get(r)]
                    host = m._match_host(work)
                    check(len(pairs) == len(host) and set(map(tuple, pairs))
                          == set(map(tuple, host)),
                          f"{label}: tick {tick + 1}: device pairs "
                          f"{len(pairs)} != host mirror {len(host)}")
                    row["match_device_ms"] = _match_device_ms(torch, m, work)
            got_f, got_t = _drain(fil["subs"]), _drain(twin["subs"])
            diff = sum(a != b for a, b in zip(got_f, got_t))
            check(diff == 0, f"{label}: tick {tick + 1}: {diff} subscriptions"
                  " pushed other bytes than the check-all twin's")
            row["pushed_subs"] = sum(1 for g in got_f if g)
            per_tick.append(row)
    modes = dict(fil["server"]._resident.solve_modes)  # before the flush
    for s in side.values():
        await s["server"].flush_ticks()
    diff = _byte_diff(_packed_has(fil["server"]), _packed_has(twin["server"]))
    check(diff == 0, f"{label}: {diff} leases differ between the filtered "
          "server's store and the twin's")
    frontend = None
    if fil["pool"] is not None:
        check(fil["laps"] == 0, f"frontend-parity: {fil['laps']} ring laps")
        check(all(s.worker is not None for s in fil["subs"]),
              "frontend-parity: a pooled subscription has no worker")
        frontend = dict(workers=FE_WORKERS, ring_bytes=FE_RING_BYTES,
                        laps=fil["laps"], pump_ms=fil["pump_ms"],
                        publisher=fil["pool"].publisher.status(),
                        pushes=sum(r["filtered"]["messages"]
                                   for r in per_tick))
    n_ticks = warm + churn + quiet
    k2 = [x["k2"] for x in fil["launches"]]
    k1 = [x["k1"] for x in fil["launches"]]
    if scoped:
        # K2 on each full tick, K1 on each scoped one, and at least one
        # fanout fed by a scoped tick's compare.
        check(sum(k2) == modes["full"] and modes["scoped"] >= 1
              and all(a + b >= 1 for a, b in zip(k1, k2)),
              f"{label}: filtered server launches K2 {k2}, K1 {k1} on "
              f"{modes} (K2 a full tick, K1 a scoped one)")
    else:
        check(k2 == [1] * n_ticks and sum(k1) == 0,
              f"{label}: filtered server launches K2 {k2}, K1 {k1} "
              "(one K2 a narrow tick)")
    churn_rows = [r for r in per_tick if r["kind"] == "churn"]
    check(sum(r["filtered"]["messages"] for r in churn_rows) > 0,
          f"{label}: no push in the churn ticks")
    check(sum(r["match_pairs"] for r in churn_rows) > 0,
          f"{label}: the matcher matched no pair")
    out = dict(
        label=label, solve_modes=modes,
        subscriptions=len(fil["subs"]), shards=ST_SHARDS,
        leases=int(fil["server"]._store_engine.total_leases),
        populate_s=fil["populate_s"], establish_s=fil["establish_s"],
        twin_establish_s=twin["establish_s"], per_tick=per_tick,
        launches={"k1": sum(k1), "k2": sum(k2)},
        matcher=fil["server"]._stream_matcher.status(), frontend=frontend)
    for name, s in side.items():
        cw = s["walls"][warm:warm + churn]
        out[name] = dict(
            tick_p50_ms=float(np.percentile(cw, 50)) * 1e3,
            tick_p95_ms=float(np.percentile(cw, 95)) * 1e3,
            churn_fanout_ms=[f * 1e3 for f in s["fanout"][warm:warm + churn]],
            walls_ms=[w * 1e3 for w in s["walls"]])
    return out


async def _fanout_tier(torch, n_subs):
    """One tier of bench.py's fanout scaling: n_subs subscriptions, 50 to
    a resource; 4 rows churned a tick with the churner's 500 <-> 1 flip."""
    from doorman_tpu_torch.algorithms import Request
    from doorman_tpu_torch.proto import doorman_stream_pb2 as spb
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    server = CapacityServer(
        "fanout", TrivialElection(), mode="batch", tick_interval=1.0,
        minimum_refresh_interval=0.0, native_store=True, stream_push=True,
        stream_shards=ST_SHARDS, flightrec_capacity=0, device=DEVICE)
    await server.start(0, host="127.0.0.1", tick_loop=False)
    try:
        await server.load_config(parse_yaml_config(FT_CONFIG))
        registry = server._streams
        n_res = max(n_subs // FT_SUBS_PER_RES, 1)
        by_rid = {}
        tp = time.perf_counter()
        for i in range(n_subs):
            rid = f"r{i % n_res}"
            req = spb.WatchCapacityRequest(client_id=f"s{i}")
            rr = req.resource.add()
            rr.resource_id, rr.wants = rid, 10.0
            sub = registry.subscribe(req)
            server._stream_match_add(sub)
            by_rid.setdefault(rid, []).append(sub)
        establish_s = time.perf_counter() - tp
        subs = [s for group in by_rid.values() for s in group]
        _drain(subs)
        warm, churn, settle, quiet = FT_TICKS
        dense_cuda.reset_launches()  # this tier's path starts here
        for _ in range(warm):
            await server.tick_once()
            _drain(subs)
        registry.take_tick_stats()
        churned, flipped, churn_fanout, pushed = set(), set(), [], set()

        def collect():
            for sub, got in zip(subs, _drain(subs)):
                if got:
                    pushed.add(sub)

        for k in range(churn):
            rows = [f"r{(k * FT_CHURN_RES + j) % n_res}"
                    for j in range(FT_CHURN_RES)]
            wants = 500.0 if k % 2 == 0 else 1.0
            for rid in rows:
                server._decide(rid, Request("churner", 0.0, wants, 1,
                                            priority=0))
            churned.update(rows)
            if wants > 1.0:
                flipped.update(rows)
            await server.tick_once()
            churn_fanout.append(registry.last_fanout_seconds)
            collect()
        for _ in range(settle):
            await server.tick_once()
            collect()
        churn_stats = registry.take_tick_stats()
        # A row the churner took past its capacity (wants 500 against 50
        # x 10 and 600) moves every subscriber's grant: all 50 are pushed.
        # A row only ever churned with wants 1 stays under its capacity
        # and moves no grant: none is.
        missed = sum(1 for rid in flipped for s in by_rid[rid]
                     if s not in pushed)
        check(missed == 0, f"stream-fanout-tiers[{n_subs}]: {missed} "
              "subscribers of rows whose grants moved got no push")
        extra = sum(1 for rid in churned - flipped for s in by_rid[rid]
                    if s in pushed)
        check(extra == 0, f"stream-fanout-tiers[{n_subs}]: {extra} "
              "subscribers of rows whose grants held were pushed")
        quiet_fanout, quiet_walked, quiet_rows = [], [], set()
        for _ in range(quiet):
            with _MatchLog() as log:
                await server.tick_once()
            quiet_fanout.append(registry.last_fanout_seconds)
            st = registry.take_tick_stats()
            names = server._rid_resource_map()
            rows = {names[int(r)] for _m, _c, p in log.entries for r in p[:, 1]}
            quiet_rows |= rows
            quiet_walked.append(st["subs_walked"])
            # A quiet tick walks no subscription but the subscribers of
            # the rows the engine reported changed: churned rows whose
            # last move reaches the store with the delivery rotation.
            check(st["subs_walked"] == st["matched_pairs"]
                  == FT_SUBS_PER_RES * len(rows) and rows <= churned,
                  f"stream-fanout-tiers[{n_subs}]: a quiet tick walked "
                  f"{st['subs_walked']} subscriptions for the changed rows "
                  f"{sorted(rows)}")
            _drain(subs)
        torch.cuda.synchronize()
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        check(registry.fanout_errors == 0,
              f"stream-fanout-tiers[{n_subs}]: fanout errors")
        return dict(
            subscribers=n_subs, resources=n_res, establish_s=establish_s,
            churn_fanout_ms=[f * 1e3 for f in churn_fanout],
            quiet_fanout_ms=[f * 1e3 for f in quiet_fanout],
            quiet_walked=quiet_walked, quiet_rows=len(quiet_rows),
            matched_pairs=churn_stats["matched_pairs"],
            churn_subs_walked=churn_stats["subs_walked"],
            churned_rows=len(churned), flipped_rows=len(flipped),
            pushed_subs=len(pushed), launches=launches)
    finally:
        await server.stop()


# The two halves of the streams phase, each run in a process of its own
# (BESIDE): stream-parity, the unscoped pair with frontend-parity and the
# fanout tiers; and the scoped pair.
ST_PARTS = {
    "main": (("streams", False, ST_TICKS),),
    "scoped": (("streams_scoped", True, ST_SCOPED_TICKS),),
}


def phase_streams(torch, card, part="main"):
    """Stream push on the card: part "main" is stream-parity, streams (the
    lane cell with 100,000 subscriptions, pooled: frontend-parity) and
    stream-fanout-tiers; part "scoped" is the same cell's scoped pair."""
    import numpy as np

    out = {}
    if part == "main":
        out.update(_stream_parity_phase(torch))
    for key, scoped, ticks in ST_PARTS[part]:
        out[key] = _stream_pair_phase(torch, card, scoped, ticks)
    if part == "main":
        out["fanout_tiers"] = _fanout_tiers_phase(torch, np)
    return out


def _stream_parity_phase(torch):
    t0 = time.perf_counter()
    sp = asyncio.run(_stream_parity(torch))
    say(f"phase stream-parity: 2 native batch servers over loopback gRPC, "
        f"{SP_TICKS - 1} ticks with a mastership flip at tick {SP_FLIP} and a "
        f"resume at {SP_RECONNECT}: {sp['pushed_rows']} pushed rows equal the "
        f"polls' changed rows byte for byte; terminal redirect on the flip; "
        f"launches {sp['launches']}; matcher pairs {sp['matched_total']} "
        f"({time.perf_counter() - t0:.1f}s)")
    return {"stream_parity": sp}


def _stream_pair_phase(torch, card, scoped, ticks):
    t0 = time.perf_counter()
    st = asyncio.run(_stream_lane(torch, scoped, ticks,
                                  pooled=not scoped))
    name = st["label"]
    say(f"phase {name}: {st['leases']} leases, {st['subscriptions']} "
        f"subscriptions on {st['shards']} shards (populate "
        f"{st['populate_s']:.1f}s, establish {st['establish_s']:.1f}s / "
        f"twin {st['twin_establish_s']:.1f}s); {len(st['per_tick'])} "
        f"ticks ({st['solve_modes']}): every subscription's pushes "
        f"byte-identical to the check-all twin's, device pairs == host "
        f"mirror, stores byte-identical after the flush, no fanout "
        f"error; filtered launches {st['launches']}; tick wall p50 / p95 "
        f"filtered {st['filtered']['tick_p50_ms']:.2f} / "
        f"{st['filtered']['tick_p95_ms']:.2f} ms, check-all "
        f"{st['check-all']['tick_p50_ms']:.2f} / "
        f"{st['check-all']['tick_p95_ms']:.2f} ms; card {card} "
        f"({time.perf_counter() - t0:.1f}s)")
    for row in st["per_tick"]:
        f, c = row["filtered"], row["check-all"]
        lap = row.get("matcher_ms")
        dev = row.get("match_device_ms")
        say(f"phase {name}: tick {row['tick']} ({row['kind']}): changed "
            f"rows {row['changed_rows']}, matched pairs "
            f"{row['match_pairs']}"
            + (f" (device time of the match {dev:.4f} ms)" if dev else "")
            + f", walked {f['walked']} (twin {c['walked']}), pushed "
            f"{f['messages']} messages {f['bytes']} bytes to "
            f"{row['pushed_subs']} subscriptions; fanout ms "
            f"{f['fanout_ms']:.2f} (twin {c['fanout_ms']:.2f}); matcher ms "
            + (", ".join(f"{k} {v:.3f}" for k, v in lap.items())
               if lap else "none (check-all)")
            + f"; tick wall ms {f['wall_ms']:.2f} (twin "
            f"{c['wall_ms']:.2f})")
    fe = st["frontend"]
    if fe is not None:
        pub = fe["publisher"]
        say(f"phase frontend-parity: the {name} phase's filtered server "
            f"pooled over {fe['workers']} workers' "
            f"{fe['ring_bytes'] >> 20} MiB rings: every one of its "
            f"{st['subscriptions']} streams' frames, pumped from its "
            f"worker's ring, equal the check-all twin's pushes byte for "
            f"byte on all {len(st['per_tick'])} ticks (and the "
            f"establishment snapshots); 0 ring laps; "
            f"{pub['published_frames']} frames, {pub['published_bytes']}"
            f" bytes published; pump ms a tick "
            f"{[round(x, 1) for x in fe['pump_ms']]}; K2 under every "
            f"fanout {st['launches']}; card {card}")
    return st


def _fanout_tiers_phase(torch, np):
    tiers = []
    for n in FT_TIERS:
        t0 = time.perf_counter()
        tier = asyncio.run(_fanout_tier(torch, n))
        say(f"phase stream-fanout-tiers[{n}]: {tier['resources']} resources, "
            f"establish {tier['establish_s']:.1f}s; churn fanout ms "
            f"{[round(x, 3) for x in tier['churn_fanout_ms']]}, quiet "
            f"{[round(x, 4) for x in tier['quiet_fanout_ms']]} (walked "
            f"{tier['quiet_walked']}: the subscribers of "
            f"{tier['quiet_rows']} churned rows the rotation delivered); "
            f"matched pairs {tier['matched_pairs']}, walked "
            f"{tier['churn_subs_walked']}; {tier['pushed_subs']} subscribers "
            f"pushed: every one of the {tier['flipped_rows']} rows taken past "
            f"capacity, none of the other {tier['churned_rows'] - tier['flipped_rows']}"
            f" churned rows; launches "
            f"{tier['launches']} ({time.perf_counter() - t0:.1f}s)")
        tiers.append(tier)
    xs = np.log([t["subscribers"] for t in tiers])
    ys = np.log([np.mean(t["churn_fanout_ms"]) for t in tiers])
    exponent = float(np.polyfit(xs, ys, 1)[0])
    say(f"phase stream-fanout-tiers: log-log exponent of the churn fanout "
        f"time against subscribers {exponent:.3f} (reported; the reference's "
        f"floor is 1.0)")
    return dict(tiers=tiers, exponent=exponent)


# -- the kernels' JSON line --------------------------------------------------

def _time_ms(torch, fn, reps=20, queued=False):
    """Mean ms a call between two CUDA events, after two warm-up calls.
    `queued` first holds the card in a spin of about 10 ms, so that all
    `reps` launches are enqueued before the first runs: the events then
    time the kernels back to back, without the host's enqueue cost."""
    fn()
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _ops(torch, batch):
    """Floating-point operations the lane solve needs on these inputs,
    per row ([R] float64), counted per lane element by the row's lane
    and load (overloaded iterative rows run their bounded loops; fitting
    rows do not)."""
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
    return per * K


def _bytes(torch, batch):
    """Bytes the lane solve must move on these inputs, per row ([R]
    float64): the row's four per-row values and its whole active mask
    are read; of the [R, K] arrays only those its lane reads, and only
    at active elements — wants on every row but a learning one; has on
    PROPORTIONAL_SHARE, PROPORTIONAL_TOPUP and learning rows;
    subclients on PROPORTIONAL_TOPUP rows and on FAIR_SHARE,
    BALANCED_FAIRNESS and PROPORTIONAL_FAIRNESS rows that overflow
    (MAX_MIN_FAIR weighs every client 1); the row of grants is written."""
    K = batch.wants.shape[1]
    it = batch.wants.element_size()
    kind, learn = batch.algo_kind, batch.learning
    n = batch.active.sum(dim=1).double()
    over = (torch.where(batch.active, batch.wants, 0).sum(1) > batch.capacity)
    reads_has = learn | (kind == 2) | (kind == 4)
    reads_sub = ~learn & (
        (kind == 4) | (over & ((kind == 3) | (kind == 8) | (kind == 9))))
    arrays = (~learn).double() + reads_has.double() + reads_sub.double()
    return (2 * it + 4 + 1) + K + n * it * arrays + K * it


def _k3_ops(torch, wants, weights, band, active, eff_cap, num_bands, gets):
    """Floating-point operations one K3 launch needs on these inputs,
    counted per lane element and band: the band mask, its sum, the share
    and the running remainder (9); a band that overflows its remaining
    capacity adds the level finder — ratio and max (4), the bisection (3
    per step), the two snap steps (10). Every lane of the row is visited
    (padding lanes too)."""
    K = wants.shape[1]
    it = 30 if wants.dtype == torch.float32 else 48
    remaining = eff_cap.double()
    per_row = torch.zeros_like(remaining)
    for rank in range(num_bands):
        m = active & (band == rank)
        over = torch.where(m, wants, 0).double().sum(1) > remaining
        per_row += 9.0 + torch.where(over, 14.0 + 3.0 * it, 0.0).double()
        remaining = (
            remaining - torch.where(m, gets, 0).double().sum(1)
        ).clamp_min(0.0)
    return float((per_row * K).sum().item())


def _k3_entry(torch, prio, parity, solve_err, registers):
    """K3 on the f32 priority server's own tables, at a representative
    theta evaluation (grouped rows at theta = 0.5): against the plain
    version, timed beside it and beside the block-per-row layout
    launched on the same tables (in turns: block, warp, warp, block),
    and the whole grouped solve of one tick (K3 path against the plain
    solve, timed)."""
    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.priority import (
        _alloc_banded,
        alloc_evaluations,
        solve_priority,
    )
    from doorman_tpu_torch.solver.priority_cuda import (
        _launch_layout,
        alloc_banded_k3,
        k3_layout,
    )

    snap = prio["server"]._solver.last_snapshot.priority_part
    b, nb = snap.batch, snap.num_bands
    wants = torch.where(b.active, b.wants, 0)
    weights = torch.where(b.active, b.weights, 0)
    half = torch.where(b.group >= 0, 0.5, 1.0).to(b.capacity.dtype)
    eff = b.capacity * half
    args = (wants, weights, b.band, b.active, eff, nb)
    saved = dict(dense_cuda.LAUNCHES)
    k3 = alloc_banded_k3(*args)
    plain = _alloc_banded(*args)
    rel = _k3_rel(torch, k3, plain, wants, b.active, eff)
    check(rel <= F32_PARITY_REL_BOUND, f"K3 vs plain {rel:.3g} (server)")
    err = (k3.double() - plain.double()).abs().max().item()
    ks = solve_priority(b, nb, use_kernel=True)
    ps = solve_priority(b, nb, use_kernel=False)
    srel = ((ks.double() - ps.double()).abs()
            / b.capacity.double().clamp_min(1e-30)[:, None]).max().item()
    check(srel <= K3_SOLVE_RTOL, f"grouped solve vs plain {srel:.3g} (server)")
    R, K = wants.shape
    it = wants.element_size()
    check(k3_layout(K, it) == "warp", f"the server's K = {K} is not a warp row")
    block = _launch_layout("block", *args, False)[0]
    brel = _k3_rel(torch, block, plain, wants, b.active, eff)
    check(brel <= F32_PARITY_REL_BOUND, f"K3 block layout vs plain {brel:.3g}")

    def run_warp():
        return alloc_banded_k3(*args)

    def run_block():
        return _launch_layout("block", *args, False)

    ms, block_ms, turns = _turns(torch, run_block, run_warp)
    check(ms < block_ms,
          f"K3 warp layout {ms:.4f} ms not below the block layout's "
          f"{block_ms:.4f} ms")
    wrapper_ms = _time_ms(torch, run_warp)
    pms = _time_ms(torch, lambda: _alloc_banded(*args), reps=3)
    solve_ms = _time_ms(
        torch, lambda: solve_priority(b, nb, use_kernel=True), reps=3
    )
    dense_cuda.LAUNCHES.update(saved)  # comparison and timing launches
    nbytes = R * K * (2 * it + 4 + 1) + R * K * it + R * it
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = _k3_ops(torch, *args, plain) / H100_F32_FLOPS * 1e3
    return {
        "name": "K3 banded water-fill", "route": "cuda",
        "source": "doorman_tpu_torch/csrc/dense_solve.cu",
        "replaces": "doorman_tpu/solver/pallas_priority.py:32",
        "launches": int(prio["launches"]["k3"]), "max_abs_err": err,
        "ms": ms, "plain_ms": pms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "shape": [R, K], "dtype": str(wants.dtype),
        "num_bands": nb,
        "launches_per_tick": alloc_evaluations(wants.dtype, True),
        "solve_priority_ms": solve_ms, "server_rel_err": rel,
        "server_solve_rel_err": srel, "layout": k3_layout(K, it),
        "block_ms": block_ms, "turns_ms": turns, "wrapper_ms": wrapper_ms,
        "block_rel_err": brel,
        "parity_rel_err": {f"{d} {lay}": v for (d, lay), v in parity.items()},
        "solve_rel_err": solve_err, "registers": {
            n[3:]: u["registers"] for n, u in sorted(registers.items())
            if n.startswith("K3")},
    }


def _turns(torch, run_block, run_warp, reps=50):
    """(warp ms, block ms, [block, warp, warp, block] ms): the two
    layouts timed in turns, each with its launches queued behind a spin
    so that the host's enqueue is not timed."""
    turns = [_time_ms(torch, fn, reps=reps, queued=True)
             for fn in (run_block, run_warp, run_warp, run_block)]
    return (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2, turns


def kernel_line(torch, server, tracked_launches, main_launches, worst,
                registers):
    """K1 and K2 on the f32 lane server's own tables: against the plain
    version, and timed. K1 over the whole table and over a scope of
    ~1,000 gathered rows (the scoped tick's shape) and K2 over the whole
    table are each timed in the warp layout the wrappers launch and in
    the block layout on the same tensors, in turns (block, warp, warp,
    block) with the launches queued behind a spin, as K3 is; `wrapper_ms`
    is the wrapper timed without the spin, as K1/K2 were timed before
    they had a warp layout."""
    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.dense import fused_tick_plain, solve_dense

    solver = server._resident
    cfg = solver._config
    batch = solver.table()
    R, K = batch.wants.shape
    check(dense_cuda.k1_layout(K) == "warp",
          f"the server's K = {K} is not a warp row")
    g = torch.Generator(device="cpu").manual_seed(4)
    delivered = (torch.rand(R, generator=g) < 0.2).cuda()
    # The server table's K1 grants, against the plain version.
    saved = dict(dense_cuda.LAUNCHES)
    k1 = dense_cuda.solve_dense_k1(batch)
    k1_block = dense_cuda._launch_k1("block", batch)
    dense_cuda.LAUNCHES.update(saved)
    p1 = solve_dense(batch)
    rel1 = _rel_err(torch, k1, p1, batch)
    check(rel1 <= F32_PARITY_REL_BOUND, f"K1 vs plain {rel1:.3g} (server)")
    brel1 = _rel_err(torch, k1_block, p1, batch)
    check(brel1 <= F32_PARITY_REL_BOUND,
          f"K1 block layout vs plain {brel1:.3g} (server)")
    err1 = (k1 - p1).abs().max().item()
    # K2 at the same shape, with prev = the resident has where a third
    # of the rows moved since their last delivery; f32 and bf16 prev.
    prev = batch.has.clone()
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
    # The scoped tick's shape: K1 over a scope of ~1,000 gathered rows.
    scope = torch.randperm(R, generator=g)[:1024].to(torch.int32).cuda()
    saved = dict(dense_cuda.LAUNCHES)
    timing = {
        "K1": _turns(
            torch, lambda: dense_cuda._launch_k1("block", batch),
            lambda: dense_cuda.solve_dense_k1(batch)),
        "K1 scoped": _turns(
            torch, lambda: dense_cuda._launch_k1("block", batch, scope),
            lambda: dense_cuda.solve_dense_k1(batch, rows=scope)),
        "K2": _turns(
            torch, lambda: dense_cuda._launch_k2("block", batch, prev, delivered),
            lambda: dense_cuda.fused_tick_k2(batch, prev, delivered)),
    }
    for name in ("K1", "K2"):
        ms, block_ms, _t = timing[name]
        check(ms < block_ms,
              f"{name} warp layout {ms:.4f} ms not below the block layout's "
              f"{block_ms:.4f} ms")
    wrapper1_ms = _time_ms(torch, lambda: dense_cuda.solve_dense_k1(batch))
    wrapper2_ms = _time_ms(
        torch, lambda: dense_cuda.fused_tick_k2(batch, prev, delivered))
    scope_wrapper_ms = _time_ms(
        torch, lambda: dense_cuda.solve_dense_k1(batch, rows=scope))
    plain1_ms = _time_ms(torch, lambda: solve_dense(batch), reps=3)
    plain2_ms = _time_ms(
        torch, lambda: fused_tick_plain(batch, prev, delivered), reps=3
    )
    dense_cuda.LAUNCHES.update(saved)  # timing launches: not counted
    # The bound: the bytes and operations these rows need (_bytes,
    # _ops). `bound_all_inputs_ms` is the bytes bound with every input
    # array read whole, as the block layout's bound was first counted.
    it = batch.wants.element_size()
    row_ops, row_bytes = _ops(torch, batch), _bytes(torch, batch)
    prev_bytes = K * 2 * prev.element_size() + 2  # prev, prev_new, flags
    all1 = R * K * (3 * it + 1) + R * (4 + 4 + 1 + 4) + R * K * it
    sel = scope.long()
    bounds = {
        "K1": (row_bytes.sum().item(), row_ops.sum().item(), all1),
        "K2": (row_bytes.sum().item() + R * prev_bytes,
               row_ops.sum().item(), all1 + R * (prev_bytes - 2) + 2 * R),
        "K1 scoped": (row_bytes[sel].sum().item() + 4 * len(sel),
                      row_ops[sel].sum().item(), None),
    }

    def bound(key):
        nbytes, ops, _all = bounds[key]
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_F32_FLOPS * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    entries = []
    for name, key, pms, launches, err, wrapper_ms, repl in (
        ("K1 dense lane solve", "K1", plain1_ms, main_launches["k1"],
         err1, wrapper1_ms, "doorman_tpu/solver/pallas_dense.py:40"),
        ("K2 fused solve + delivered delta", "K2", plain2_ms,
         tracked_launches["k2"], err2, wrapper2_ms,
         "doorman_tpu/solver/pallas_dense.py:57"),
    ):
        ms, block_ms, turns = timing[key]
        bound_ms, bound_by = bound(key)
        entries.append({
            "name": name, "route": "cuda",
            "source": "doorman_tpu_torch/csrc/dense_solve.cu",
            "replaces": repl,
            "launches": int(launches), "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": bounds[key][0],
            "bound_all_inputs_ms": bounds[key][2] / H100_BYTES_PER_S * 1e3,
            "library_ms": None, "shape": [R, K], "dtype": str(batch.wants.dtype),
            "layout": dense_cuda.k1_layout(K), "block_ms": block_ms,
            "turns_ms": turns, "wrapper_ms": wrapper_ms,
            "registers": {n[3:]: u["registers"]
                          for n, u in sorted(registers.items())
                          if n.startswith(key)},
        })
    ms, block_ms, turns = timing["K1 scoped"]
    entries[0].update(
        scoped_ms=ms, scoped_block_ms=block_ms, scoped_turns_ms=turns,
        scoped_bound_ms=bound("K1 scoped")[0],
        scoped_wrapper_ms=scope_wrapper_ms, scoped_rows=int(scope.numel()),
        block_rel_err=brel1,
        parity_rel_err={f"{d} {lay}": v for (d, lay), v in worst.items()},
    )
    return {"kernels": entries}


# -- phases 18-19: the capacity tree --------------------------------------------

# Phase tree: tools/drives/drive_tree3.py's topology (root <- region <-
# leaf, after the reference's simulation scenario five), three port
# servers in this process over loopback gRPC, batch + native store on
# the card at f64, tick 0.4 s, minimum refresh 1.0 s on the lower hops.
# Each runs with stream push on (no subscriber), so its resident tick
# tracks deltas: full ticks run K2, scoped ones K1.
TREE_ROOT_CAP = 400.0
TREE_LANE_CAP = 50.0
TREE_HI, TREE_LO, TREE_WANTS = 4, 8, 40.0  # priority 9 and priority 1
TREE_LANE_WANTS = (90.0, 60.0)
TREE_TICK_S = 0.4
# drive_tree3's lease_length is 30 s; cut to 6 s so the lapse after the
# root stops shows within seconds.
TREE_LEASE_S = 6
TREE_CONVERGE_BOUND_S = 60.0  # drive_tree3.py's CONVERGE_BOUND_S
TREE_REL = 1e-9

# Phase tree-root: one root at scale, 100 downstream servers' band
# sub-leases over 1,000 resources (900 PROPORTIONAL_SHARE, 100
# PRIORITY_BANDS). Cut from the lane cell's 10,000 resources: the root's
# per-band decide is Python per lease in both packages.
TR_SERVERS = 100
TR_LANE = 900
TR_PRIO = 100
# (dtype, rounds, seed); f32 cut from 3 rounds for the run's time.
TR_RUNS = (("f32", 2, 81), ("f64", 2, 82))


def _tree_yaml():
    algo = ("lease_length: {lease}, refresh_interval: 2, "
            "learning_mode_duration: 0")
    algo = algo.format(lease=TREE_LEASE_S)
    return (
        "resources:\n"
        f"  - identifier_glob: shared\n    capacity: {TREE_ROOT_CAP}\n"
        f"    algorithm: {{kind: PRIORITY_BANDS, {algo}}}\n"
        f"  - identifier_glob: '*'\n    capacity: {TREE_LANE_CAP}\n"
        f"    algorithm: {{kind: PROPORTIONAL_SHARE, {algo}}}\n"
    )


def _band_has(server, rid, sid):
    """Σ of `server`'s grants to downstream server `sid`'s bands of
    resource `rid`."""
    from doorman_tpu_torch.server.server import _band_key

    res = server.resources[rid]
    prios = server._server_bands.get((rid, sid), set())
    return sum(res.store.get(_band_key(sid, p)).has for p in sorted(prios))


async def _drive_tree(torch):
    import numpy as np

    from doorman_tpu_torch.client import Client
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer, _band_key
    from doorman_tpu_torch.solver import dense_cuda

    def make(sid, parent=""):
        return CapacityServer(
            sid, TrivialElection(), parent_addr=parent, mode="batch",
            native_store=True, tick_interval=TREE_TICK_S,
            minimum_refresh_interval=1.0 if parent else 5.0,
            stream_push=True, flightrec_capacity=0, device=DEVICE,
        )

    dense_cuda.reset_launches()  # the tree path starts here
    root = make("root")
    root_port = await root.start(0, host="127.0.0.1", tick_loop=False)
    await root.load_config(parse_yaml_config(_tree_yaml()))
    region = make("region", f"127.0.0.1:{root_port}")
    region_port = await region.start(0, host="127.0.0.1", tick_loop=False)
    leaf = make("leaf", f"127.0.0.1:{region_port}")
    leaf_port = await leaf.start(0, host="127.0.0.1", tick_loop=False)
    servers = {"root": root, "region": region, "leaf": leaf}
    for s in (region, leaf):
        # Skip the default template's 20 s learning window, as the
        # reference's tests/test_hierarchy.py does.
        s.became_master_at -= 1000.0
    # The region's parent exchanges, timed.
    exchange_walls = []
    perform = region._perform_parent_requests

    async def timed_exchange(retry):
        t = time.perf_counter()
        out = await perform(retry)
        if out[1] == 0:  # the successful exchanges
            exchange_walls.append(time.perf_counter() - t)
        return out

    region._perform_parent_requests = timed_exchange
    stats = {n: {"k1": 0, "k2": 0, "k3": 0, "ticks": 0, "full": 0,
                 "scoped": 0, "config_epoch_full": 0, "walls": []}
             for n in servers}
    live = dict.fromkeys(servers, True)

    async def ticker():
        # One tick of each server in turn every TREE_TICK_S: the kernel
        # launches between two reads of the counters are that server's
        # (nothing else in this process launches).
        while True:
            await asyncio.sleep(TREE_TICK_S)
            for name, s in servers.items():
                if not live[name]:
                    continue
                before = dict(dense_cuda.LAUNCHES)
                modes = (dict(s._resident.solve_modes)
                         if s._resident is not None else {})
                t = time.perf_counter()
                await s.tick_once()
                st = stats[name]
                st["walls"].append(time.perf_counter() - t)
                st["ticks"] += 1
                for k in ("k1", "k2", "k3"):
                    st[k] += dense_cuda.LAUNCHES[k] - before[k]
                if s._resident is not None:
                    for m in ("full", "scoped"):
                        moved = s._resident.solve_modes.get(m, 0) - modes.get(
                            m, 0)
                        st[m] += moved
                        if (m == "full" and moved and s._resident
                                .last_full_reason == "config-epoch"):
                            st["config_epoch_full"] += 1

    tick_task = asyncio.create_task(ticker())
    clients, hi, lo, lane = [], [], [], []
    t_start = time.perf_counter()
    try:
        addr = f"127.0.0.1:{leaf_port}"
        for group, n, prio in ((hi, TREE_HI, 9), (lo, TREE_LO, 1)):
            for i in range(n):
                c = await Client.connect(addr, f"p{prio}.{i}",
                                         minimum_refresh_interval=1.0)
                clients.append(c)
                group.append(await c.resource("shared", TREE_WANTS, prio))
        for i, w in enumerate(TREE_LANE_WANTS):
            c = await Client.connect(addr, f"lane{i}",
                                     minimum_refresh_interval=1.0)
            clients.append(c)
            lane.append(await c.resource("lane", w))
        lo_share = (TREE_ROOT_CAP - TREE_HI * TREE_WANTS) / TREE_LO
        lane_want = [TREE_LANE_CAP * w / sum(TREE_LANE_WANTS)
                     for w in TREE_LANE_WANTS]
        want = ([TREE_WANTS] * TREE_HI + [lo_share] * TREE_LO + lane_want)
        ress = hi + lo + lane

        def worst():
            got = np.array([r.current_capacity() for r in ress])
            return float((np.abs(got - want) / np.asarray(want)).max())

        deadline = time.perf_counter() + TREE_CONVERGE_BOUND_S
        stable, converged_s = 0, None
        while time.perf_counter() < deadline:
            await asyncio.sleep(1.0)
            stable = stable + 1 if worst() <= TREE_REL else 0
            if stable >= 2:
                converged_s = time.perf_counter() - t_start
                break
        check(converged_s is not None,
              f"tree: not converged within {TREE_CONVERGE_BOUND_S:g}s "
              f"(worst relative error {worst():.3g}; grants "
              f"{[r.current_capacity() for r in ress]})")
        err = worst()
        # Conservation at every hop, from each server's own state.
        hops = {}
        for rid, cap in (("shared", TREE_ROOT_CAP), ("lane", TREE_LANE_CAP)):
            leaf_r, region_r = leaf.resources[rid], region.resources[rid]
            leaf_sum = leaf_r.store.sum_has
            leaf_grant = _band_has(region, rid, "leaf")
            region_grant = _band_has(root, rid, "region")
            root_sum = root.resources[rid].store.sum_has
            h = dict(leaf_sum=leaf_sum, leaf_cap=leaf_r.capacity,
                     region_grant=leaf_grant,
                     region_sum=region_r.store.sum_has,
                     region_cap=region_r.capacity,
                     root_grant=region_grant, root_sum=root_sum,
                     root_cap=cap)
            tol = 1 + TREE_REL
            check(leaf_sum <= leaf_r.capacity * tol
                  and abs(leaf_r.capacity - leaf_grant) <= TREE_REL * cap
                  and h["region_sum"] <= region_r.capacity * tol
                  and abs(region_r.capacity - region_grant) <= TREE_REL * cap
                  and root_sum <= cap * tol,
                  f"tree: conservation broken on {rid}: {h}")
            hops[rid] = h
        band = {p: root.resources["shared"].store.get(
            _band_key("region", p)).wants for p in (9, 1)}
        check(band == {9: TREE_HI * TREE_WANTS, 1: TREE_LO * TREE_WANTS},
              f"tree: the root's band sub-leases of the region: {band}")
        # The root stops: the region's parent lease lapses, then the
        # leaf's (the region grants it nothing once its capacity is 0).
        await root.stop()
        live["root"] = False
        t_stop = time.perf_counter()
        lapse = {}
        deadline = t_stop + TREE_LEASE_S + 20.0
        while time.perf_counter() < deadline and len(lapse) < 4:
            await asyncio.sleep(0.2)
            for name, s in (("region", region), ("leaf", leaf)):
                for rid in ("shared", "lane"):
                    if (name, rid) not in lapse and (
                            s.resources[rid].capacity == 0.0):
                        lapse[(name, rid)] = time.perf_counter() - t_stop
        check(len(lapse) == 4,
              f"tree: capacity not 0 after the parent lease lapsed: "
              f"{ {(n, r): servers[n].resources[r].capacity for n in ('region', 'leaf') for r in ('shared', 'lane')} }")
        tick_task.cancel()
        try:
            await tick_task
        except asyncio.CancelledError:
            pass
        torch.cuda.synchronize()
        launches = dict(dense_cuda.LAUNCHES)  # read just after
    finally:
        tick_task.cancel()
        for c in clients:
            c.conn.max_retries = 0
            c.RELEASE_TIMEOUT = 2.0
            await c.close()
        for name, s in servers.items():
            if live[name]:
                await s.stop()
    for name, st in stats.items():
        check(st["k3"] > 0, f"tree: K3 never launched on the {name}")
        check(st["k1"] + st["k2"] > 0,
              f"tree: neither K1 nor K2 launched on the {name}")
    return dict(converged_s=converged_s, worst_rel_err=err, hops=hops,
                root_bands=band, lapse_s={f"{n} {r}": v
                                          for (n, r), v in lapse.items()},
                exchange_walls=exchange_walls, stats=stats,
                launches=launches)


def _tree_root_layout(rng):
    """Resource ids, capacities, kinds (0 lane, 1 priority), and each
    downstream server's band composition: one band a lane resource, 1-2
    bands a PRIORITY_BANDS one, at wire priorities from PRIORITIES,
    with 1-50 clients each."""
    import numpy as np

    n = TR_LANE + TR_PRIO
    tier = rng.integers(0, len(CAP_TIERS), n)
    ids = [f"tl.t{t}.r{i}" if i < TR_LANE else f"tb.t{t}.r{i}"
           for i, t in enumerate(tier)]
    cap = np.asarray(CAP_TIERS)[tier]
    comp = []
    for _s in range(TR_SERVERS):
        rows = []
        for i in range(n):
            k = 1 if i < TR_LANE else int(rng.integers(1, 3))
            prios = rng.choice(np.asarray(PRIORITIES), k, replace=False)
            rows.append([(int(p), int(rng.integers(1, 51))) for p in prios])
        comp.append(rows)
    return ids, cap, comp


def _tree_root_yaml():
    lines = ["resources:"]
    for t, cap in enumerate(CAP_TIERS):
        for prefix, kind in (("tl", "PROPORTIONAL_SHARE"),
                             ("tb", "PRIORITY_BANDS")):
            lines.append(
                f"  - identifier_glob: '{prefix}.t{t}.*'\n"
                f"    capacity: {cap}\n    algorithm: {{kind: {kind}, "
                "lease_length: 60, refresh_interval: 1, "
                "learning_mode_duration: 0}")
    lines.append("  - identifier_glob: '*'\n    capacity: 0\n"
                 "    algorithm: {kind: 0, lease_length: 60,"
                 " refresh_interval: 1, learning_mode_duration: 0}")
    return "\n".join(lines) + "\n"


def _tree_root_requests(rng, ids, comp, prev):
    """Each downstream server's GetServerCapacityRequest as
    _build_server_capacity_request forms it: per resource the bands with
    demand (fresh wants 0-99 this round), the previous round's grant as
    `has` while it is positive, no line where no band has demand.
    Returns ([(server id, request, each line's band priorities)], the
    number of bands sent)."""
    from doorman_tpu_torch.proto import doorman_pb2 as pb

    out, nbands = [], 0
    for s, rows in enumerate(comp):
        sid = f"mid{s}"
        req = pb.GetServerCapacityRequest(server_id=sid)
        wants = rng.integers(0, 100, sum(len(r) for r in rows))
        k = 0
        lines = []
        for rid, row in zip(ids, rows):
            bands = []
            for p, n in row:
                if wants[k] > 0:
                    bands.append((p, n, float(wants[k])))
                k += 1
            if not bands:
                continue
            rr = req.resource.add()
            rr.resource_id = rid
            lease = prev.get((sid, rid))
            if lease is not None and lease.capacity > 0:
                rr.has.capacity = lease.capacity
                rr.has.expiry_time = lease.expiry_time
            for p, n, w in bands:
                band = rr.wants.add()
                band.priority, band.num_clients, band.wants = p, n, w
            lines.append([p for p, _n, _w in bands])
            nbands += len(bands)
        out.append((sid, req, lines))
    return out, nbands


def _tree_root_kernels(torch, server, dtype_name):
    """K1 (and K2 on a tracked root) and K3 against their plain versions
    on the root's own tables after its last tick: comparison launches,
    not counted."""
    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.dense import solve_dense
    from doorman_tpu_torch.solver.priority import solve_priority

    solver = server._resident
    cfg = solver._config
    batch = solver.table()
    bound = F64_RTOL if dtype_name == "f64" else F32_PARITY_REL_BOUND
    saved = dict(dense_cuda.LAUNCHES)
    k1 = dense_cuda.solve_dense_k1(batch)
    part = server._solver.last_snapshot.priority_part
    k3 = solve_priority(part.batch, part.num_bands, use_kernel=True)
    dense_cuda.LAUNCHES.update(saved)
    out = {"k1": _rel_err(torch, k1, solve_dense(batch), batch)}
    check(bool(torch.isfinite(k1).all()), "tree-root: K1 non-finite")
    check(out["k1"] <= bound, f"tree-root: K1 vs plain {out['k1']:.3g}")
    plain3 = solve_priority(part.batch, part.num_bands, use_kernel=False)
    scale = part.batch.capacity.double().clamp_min(1e-30)[:, None]
    out["k3"] = ((k3.double() - plain3.double()).abs() / scale).max().item()
    check(out["k3"] <= K3_SOLVE_RTOL, f"tree-root: K3 vs plain {out['k3']:.3g}")
    if solver.delta_tracking:
        delivered = torch.ones(batch.wants.shape[0], dtype=torch.bool,
                               device=batch.wants.device)
        _res, _abs, out["k2"] = _check_k2(torch, batch, solver.prev_table(),
                                          delivered, "tree-root")
    return out


async def _drive_tree_root(torch, dtype_name, rounds, seed):
    import numpy as np

    from doorman_tpu_torch.algorithms.kinds import AlgoKind
    from doorman_tpu_torch.algorithms.priority import priority_alloc
    from doorman_tpu_torch.algorithms.tick import (
        F32_PARITY_REL_BOUND,
        oracle_row,
    )
    from doorman_tpu_torch.client.connection import Connection
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer, _band_key
    from doorman_tpu_torch.solver import dense_cuda

    rng = np.random.default_rng(seed)
    ids, cap, comp = _tree_root_layout(rng)
    tracked = dtype_name == "f64"
    server = CapacityServer(
        "smoke-root", TrivialElection(), mode="batch", native_store=True,
        solver_dtype=dtype_name, tick_interval=1.0, stream_push=tracked,
        flightrec_capacity=0,
        device=DEVICE,
    )
    port = await server.start(0, host="127.0.0.1", tick_loop=False)
    conns = [Connection(f"127.0.0.1:{port}", max_retries=0)
             for _ in range(TR_SERVERS)]
    bound = 1e-12 if dtype_name == "f64" else F32_PARITY_REL_BOUND
    prev, round_s, us_band, tick_walls = {}, [], [], []
    worst_lane = worst_prio = 0.0
    try:
        await server.load_config(parse_yaml_config(_tree_root_yaml()))
        dense_cuda.reset_launches()  # the tree-root path starts here
        for _r in range(rounds):
            reqs, nbands = _tree_root_requests(rng, ids, comp, prev)
            t = time.perf_counter()
            outs = [await c.execute(
                lambda stub, req=req: stub.GetServerCapacity(req))
                for c, (_sid, req, _l) in zip(conns, reqs)]
            round_s.append(time.perf_counter() - t)
            us_band.append(round_s[-1] * 1e6 / nbands)
            # Every response's capacity is the sum of the store's grants
            # to that server's bands, in the order the root summed them.
            mism = 0
            for (sid, req, lines), out in zip(reqs, outs):
                check(len(out.response) == len(req.resource),
                      "tree-root: a response misses lines")
                for rr, pr, prios in zip(req.resource, out.response, lines):
                    store = server.resources[rr.resource_id].store
                    total = 0.0
                    for p in prios:
                        total += store.get(_band_key(sid, p)).has
                    mism += total != pr.gets.capacity
                    prev[(sid, rr.resource_id)] = pr.gets
            check(mism == 0, f"tree-root: {mism} response lines differ from "
                  "the sum of the store's band grants")
            # The solve's inputs, then one tick, collected.
            inputs = {rid: server.resources[rid].store.dump_rows()
                      for rid in ids[:TR_LANE]}
            t = time.perf_counter()
            await server.tick_once()
            await server.flush_ticks()
            torch.cuda.synchronize()
            tick_walls.append(time.perf_counter() - t)
            for i, rid in enumerate(ids):
                total = server.resources[rid].store.sum_has
                check(total <= cap[i] * (1 + 1e-6),
                      f"tree-root {rid}: {total:.9g} > capacity {cap[i]}")
            for i, rid in enumerate(ids[:TR_LANE]):
                rows = inputs[rid]
                w = np.array([r[4] for r in rows])
                h = np.array([r[3] for r in rows])
                s = np.array([r[5] for r in rows], np.float64)
                got = dict((r[0], r[3]) for r in
                           server.resources[rid].store.dump_rows())
                g = np.array([got[r[0]] for r in rows])
                want = oracle_row(AlgoKind.PROPORTIONAL_SHARE, float(cap[i]),
                                  0.0, w, h, s)
                err = float(np.abs(g - want).max()) / max(cap[i], w.max())
                worst_lane = max(worst_lane, err)
            solver = server._solver
            part = solver.last_snapshot.priority_part
            b = part.batch
            wt = b.weights.double().cpu().numpy()
            ww = b.wants.double().cpu().numpy()
            bd = b.band.cpu().numpy()
            a = b.active.cpu().numpy()
            c = b.capacity.double().cpu().numpy()
            gets = part.gets
            name = server._store_engine.client_name
            starts = np.searchsorted(part.ridx, np.arange(len(c) + 1))
            smism = 0
            for r in range(len(c)):
                m = a[r]
                want = priority_alloc(c[r], ww[r, m], wt[r, m], bd[r, m])
                scale = max(c[r], float(ww[r, m].max()))
                worst_prio = max(worst_prio, float(
                    np.abs(gets[r, m] - want).max()) / scale)
                store = server.resources[part.resource_ids[r]].store
                for e in range(starts[r], starts[r + 1]):
                    smism += store.get(name(int(part.cids[e]))).has != float(
                        gets[r, part.pos[e]])
            check(smism == 0, f"tree-root: {smism} priority store grants "
                  "differ from the solve")
        check(worst_lane <= bound,
              f"tree-root[{dtype_name}]: lane grants vs f64 oracle "
              f"{worst_lane:.3g}")
        check(worst_prio <= bound,
              f"tree-root[{dtype_name}]: PRIORITY_BANDS grants vs f64 "
              f"oracle {worst_prio:.3g}")
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        check(launches["k1"] + launches["k2"] > 0 and launches["k3"] > 0,
              f"tree-root[{dtype_name}]: launches {launches}")
        kern = _tree_root_kernels(torch, server, dtype_name)
        leases = server.status()["leases"]
        modes = dict(server._resident.solve_modes)
        phases = {k: v * 1e3 / rounds
                  for k, v in server._resident.phase_s.items() if v > 0}
        prio_phases = {k: v * 1e3 / rounds
                       for k, v in server._solver.phase_s.items() if v > 0}
    finally:
        for c in conns:
            await c.close()
        await server.stop()
    return dict(leases=leases, round_s=round_s, us_per_band=us_band,
                tick_walls_ms=[w * 1e3 for w in tick_walls],
                lane_oracle_err=worst_lane, prio_oracle_err=worst_prio,
                kernel_vs_plain=kern, launches=launches, solve_modes=modes,
                phase_ms=phases, priority_phase_ms=prio_phases)


def phase_tree(torch, card):
    """The capacity tree: drive_tree3's three hops, then a root holding
    100 downstream servers' band sub-leases over 1,000 resources."""
    out = {}
    t0 = time.perf_counter()
    tree = asyncio.run(_drive_tree(torch))
    ex = tree["exchange_walls"]
    ex_p50, ex_p95 = _pcts(ex) if ex else (float("nan"), float("nan"))
    say(f"phase tree: root <- region <- leaf (batch, native store, f64, "
        f"tick {TREE_TICK_S:g}s), {TREE_HI} + {TREE_LO} clients on a "
        f"PRIORITY_BANDS resource of {TREE_ROOT_CAP:g} and 2 on a lane one "
        f"of {TREE_LANE_CAP:g}: converged in {tree['converged_s']:.1f}s "
        f"(bound {TREE_CONVERGE_BOUND_S:g}s), worst grant vs the banded and "
        f"proportional allocation {tree['worst_rel_err']:.3g}; conservation "
        f"held at every hop {tree['hops']}; root bands of the region "
        f"{tree['root_bands']}; capacity 0 after the root stopped (lease "
        f"{TREE_LEASE_S}s) at {tree['lapse_s']} s; region parent exchange "
        f"p50 {ex_p50:.2f} ms p95 {ex_p95:.2f} ms over {len(ex)}; per "
        "server: " + "; ".join(
            f"{n} ticks {s['ticks']} (full {s['full']}, of them "
            f"{s['config_epoch_full']} on a config-epoch move, scoped "
            f"{s['scoped']}), K1 {s['k1']} K2 {s['k2']} K3 {s['k3']}"
            for n, s in tree["stats"].items())
        + f" ({time.perf_counter() - t0:.1f}s); card {card}")
    for s in tree["stats"].values():
        s["tick_p50_ms"], s["tick_p95_ms"] = _pcts(s.pop("walls"))
    tree["exchange_p50_ms"], tree["exchange_p95_ms"] = ex_p50, ex_p95
    tree.pop("exchange_walls")
    out["tree"] = tree
    roots = {}
    for dtype_name, rounds, seed in TR_RUNS:
        t0 = time.perf_counter()
        run = asyncio.run(_drive_tree_root(torch, dtype_name, rounds, seed))
        p50, p95 = _pcts([w / 1e3 for w in run["tick_walls_ms"]])
        run["tick_p50_ms"], run["tick_p95_ms"] = p50, p95
        say(f"phase tree-root[{dtype_name}]: {TR_SERVERS} downstream "
            f"servers over loopback gRPC, {TR_LANE} PROPORTIONAL_SHARE + "
            f"{TR_PRIO} PRIORITY_BANDS resources, {run['leases']} band "
            f"sub-leases; {rounds} rounds: walls "
            f"{[round(x, 2) for x in run['round_s']]} s, "
            f"{[round(x, 1) for x in run['us_per_band']]} us a band; root "
            f"tick p50 {p50:.1f} ms p95 {p95:.1f} ms ({run['solve_modes']}"
            f"), resident host ms a tick {run['phase_ms']}, BatchSolver ms "
            f"a tick {run['priority_phase_ms']}; responses == store band "
            f"sums bit for bit; vs f64 oracles lane "
            f"{run['lane_oracle_err']:.3g} priority "
            f"{run['prio_oracle_err']:.3g}; kernels vs plain "
            f"{run['kernel_vs_plain']}; capacities held; launches "
            f"{run['launches']} ({time.perf_counter() - t0:.1f}s); card "
            f"{card}")
        roots[dtype_name] = run
    out["tree_root"] = roots
    return out


# -- the last phase: observability (obs/) on the lane and priority cells ------

OBS_WARM, OBS_CHURN = 6, 14  # warm ticks without churn, then 5% churn
OBS_PROFILE_TICKS = 8  # the lane capture; the priority capture is 4 ticks
OBS_PRIO_PROFILE_TICKS = 4
OBS_AUDIT_SAMPLE = 4
OBS_GAP = 1e-12  # a store-vs-oracle gap above this is a grant fault
OBS_REPS = 50  # launches a kernel is timed over, by events and profiler

_KERNEL_NAME = re.compile(
    r"(dense_solve(?:_warp)?_kernel|banded_fill\w*_kernel)<([^>]*)>")


def _kernel_label(name: str):
    """K1 / K2 / K3 for a demangled kernel name from a profiler trace
    (K2 is K1's template with kFused = true), else None."""
    m = _KERNEL_NAME.search(name)
    if m is None:
        return None
    if m.group(1).startswith("banded"):
        return "K3"
    args = [a.strip() for a in m.group(2).split(",")]
    return "K2" if len(args) > 2 and args[2] == "true" else "K1"


def _trace_summary(path):
    """From a torch.profiler Chrome trace: the window (first to last
    event), the device's busy time (the union of its kernel, memcpy and
    memset intervals) and share of the window, and per kernel label
    (K1/K2/K3) and per kernel name the launches and device time."""
    doc = json.loads(Path(path).read_text())
    evs = [e for e in doc["traceEvents"]
           if e.get("ph") == "X" and "ts" in e]
    check(evs, f"profiler trace {path} holds no events")
    lo = min(float(e["ts"]) for e in evs)
    hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in evs)
    dev = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        for e in evs if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, None
    for a, b in dev:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_label, by_name = {}, {}
    for e in evs:
        if e.get("cat") != "kernel":
            continue
        dur = float(e.get("dur", 0.0))
        name = e["name"]
        n = by_name.setdefault(name, [0, 0.0])
        n[0] += 1
        n[1] += dur
        label = _kernel_label(name)
        if label is not None:
            k = by_label.setdefault(label, {"launches": 0, "sum_ms": 0.0})
            k["launches"] += 1
            k["sum_ms"] += dur / 1e3
    for k in by_label.values():
        k["mean_ms"] = k["sum_ms"] / k["launches"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    window_ms = (hi - lo) / 1e3
    return {
        "window_ms": window_ms, "busy_ms": busy / 1e3,
        "busy_share": busy / 1e3 / window_ms if window_ms > 0 else 0.0,
        "device_events": len(dev), "kernels": by_label,
        "top_kernels": [{"name": n[:90], "launches": c, "sum_ms": s / 1e3}
                        for n, (c, s) in top],
    }


async def _drive_obs_lane(torch, obs, tmp, seed=91):
    """The lane cell at f64 from `seed` (delta tracking on, so full ticks
    run K2 and scoped ticks K1): OBS_WARM ticks, then OBS_CHURN with 5%
    churn. `obs`: the tracer, the flight recorder at the reference's 512,
    the history, the audit every OBS_AUDIT_SAMPLE ticks, the detector and
    a profiler capture of the first OBS_PROFILE_TICKS ticks; else every
    obs part off. Launches are counted over the ticks."""
    import logging

    import numpy as np

    from doorman_tpu_torch.obs import trace as trace_mod
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    rng = np.random.default_rng(seed)
    kw = dict(flightrec_capacity=0)
    if obs:
        kw = dict(flightrec_capacity=512, history_dir=str(Path(tmp) / "hist"),
                  audit_sample=OBS_AUDIT_SAMPLE, detect=True,
                  profile_dir=str(Path(tmp) / "lane-trace"),
                  profile_ticks=OBS_PROFILE_TICKS)
    server = CapacityServer(
        "smoke-obs" if obs else "smoke-obs-off", TrivialElection(),
        mode="batch", native_store=True, solver_dtype="f64",
        fused_tick=True, scoped_solve=True, tick_pipeline_depth=3,
        tick_interval=1.0, device=DEVICE, **kw,
    )
    tracer = trace_mod.default_tracer()
    if obs:
        tracer.clear()
        tracer.enable(capacity=65536)
        # One log line a confirmed flag (thousands here): the phase
        # prints the flags by class instead.
        logging.getLogger("doorman_tpu_torch.obs.audit").setLevel(
            logging.CRITICAL)
    await server.start(0, host="127.0.0.1", tick_loop=False)
    try:
        await server.load_config(parse_yaml_config(_config_yaml()))
        resources, rids, cids = _populate(server, rng)
        solver = server._resident_solver()
        solver.enable_delta_tracking()
        seen = _audit_record(server, solver) if obs else None
        dense_cuda.reset_launches()  # the obs lane path starts here
        walls, records, capture_ticks, k_at_stop = [], [], None, None
        for i in range(OBS_WARM + OBS_CHURN):
            if i >= OBS_WARM:
                _churn(server._store_engine, rng, rids, cids)
            t = time.perf_counter()
            await server.tick_once()
            walls.append(time.perf_counter() - t)
            solver.take_changed_rids()
            if obs:
                # This tick's record, read now: the audit's error records
                # (one a flag) push tick records out of the 512 ring.
                records.append(next(r for r in reversed(
                    server.flightrec.snapshot()) if "wall_ms" in r))
            if obs and capture_ticks is None and server.profile_trace:
                torch.cuda.synchronize()
                capture_ticks, k_at_stop = i + 1, dict(dense_cuda.LAUNCHES)
        await server.flush_ticks()
        torch.cuda.synchronize()
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        out = dict(server=server, walls=walls, launches=launches,
                   records=records, resources=resources,
                   capture_ticks=capture_ticks,
                   launches_at_capture_stop=k_at_stop)
        if obs:
            out.update(_obs_audit(server, tracer, seen))
        return out
    finally:
        await server.stop()
        if obs:
            tracer.disable()
            tracer.clear()


def _audit_gap(detail):
    """The largest relative gap between the store's grant and the
    oracle's over one flagged row's reported clients."""
    gap = 0.0
    for h, e in zip(detail["has"], detail["expected"]):
        scale = max(abs(h), abs(e))
        if scale > 0:
            gap = max(gap, abs(h - e) / scale)
    return gap


def _audit_record(server, solver):
    """Instruments the obs lane server for the audit's classes: every
    confirmed flag (past the auditor's bounded detail list), the ticks
    it sampled, and the tick after which each row was last written to
    the store (the resident solver's deliveries)."""
    import numpy as np

    from doorman_tpu_torch.obs import trace as trace_mod

    aud = server.shadow_audit
    seen = dict(flags=[], sampled=[], delivered={}, watch=None)
    hook, sample, apply = aud.on_divergence, aud.maybe_sample, \
        solver._apply_grants

    def flagged(d):
        seen["flags"].append(d)
        hook(d)
        if d["rid"] == seen["watch"]:
            # What the server's divergence hook left behind for this
            # flag, read before later flags push it out of the rings.
            key = f"audit.divergence: {d['rid']}"
            seen["watch_records"] = [
                r for r in server.flightrec.snapshot()[-4:]
                if str(r.get("error", "")).startswith(key)]
            seen["watch_instants"] = [
                e for e in trace_mod.default_tracer().snapshot()[-4:]
                if e.name == "audit.divergence"
                and (e.args or {}).get("resource") == d["rid"]]

    aud.on_divergence = flagged

    def sampled(tick, mode, resources):
        took = sample(tick, mode, resources)
        if took:
            seen["sampled"].append(tick)
        return took

    def delivered(handle, gets):
        n = apply(handle, gets)
        tick = solver.ticks + 1  # the applied tick this delivery lands in
        for rid in np.asarray(handle.rids).tolist():
            seen["delivered"].setdefault(int(rid), []).append(tick)
        return n

    aud.maybe_sample = sampled
    solver._apply_grants = delivered
    return seen


def _audit_classes(server, seen):
    """Each flag of the ticking run, by why its store row did not match
    the oracle at two samples: `unwritten` (tick 0 with every reported
    grant 0: no tick had written the store yet; a tick pipeline deeper
    than 1 samples tick 0 more than once), `undelivered` (the row was not
    written between the two samples that confirmed it: the store held
    the grant of an earlier delivery while the device moved on), or
    `delivered` (written in between, and still not the oracle's: the
    grant itself; its gap is held to OBS_GAP)."""
    out = {"unwritten": [], "undelivered": [], "delivered": []}
    ticks = seen["sampled"]
    for d in seen["flags"]:
        d = dict(d, gap=_audit_gap(d))
        t = d["tick"]
        prior = [x for x in ticks[:len(ticks) - ticks[::-1].index(t) - 1]] \
            if t in ticks else []
        t_prev = prior[-1] if prior else -1
        rid = server.resources[d["rid"]].store._rid
        if t == 0 and not any(d["has"]):
            out["unwritten"].append(d)
        elif not any(t_prev < x <= t for x in seen["delivered"].get(rid, ())):
            out["undelivered"].append(d)
        else:
            out["delivered"].append(d)
    return out


def _obs_audit(server, tracer, seen):
    """After the ticks: the auditor's tally and its flags by class
    (_audit_classes); the digest's and the audit snapshot's own cost;
    then one grant of a converged FAIR_SHARE row written 1% high, which
    the auditor must confirm within two samples, with the flight
    record's error entry and the audit.divergence instant."""
    import numpy as np

    from doorman_tpu_torch.algorithms.kinds import AlgoKind
    from doorman_tpu_torch.algorithms.tick import oracle_row
    from doorman_tpu_torch.core.resource import algo_kind_for, static_param
    from doorman_tpu_torch.obs.flightrec import store_digest

    aud = server.shadow_audit
    aud.drain()
    ticked = aud.status()
    classes = _audit_classes(server, seen)
    n_flags = len(seen["flags"])
    digest_s = []
    for _ in range(3):
        t = time.perf_counter()
        store_digest(server.resources)
        digest_s.append(time.perf_counter() - t)
    t = time.perf_counter()
    aud.snapshot(server.resources, 0)
    snapshot_s = time.perf_counter() - t
    # A converged row: the oracle's next tick equals the store exactly.
    target = None
    for rid, res in server.resources.items():
        if algo_kind_for(res.template) != AlgoKind.FAIR_SHARE:
            continue
        rows = res.store.dump_rows()
        has = np.array([r[3] for r in rows])
        want = oracle_row(int(AlgoKind.FAIR_SHARE), float(res.capacity),
                          float(static_param(res.template)),
                          np.array([r[4] for r in rows]), has,
                          np.array([r[5] for r in rows], np.float64))
        pos = np.nonzero(has > 0)[0]
        if len(pos) and np.array_equal(want, has):
            target = (rid, rows[pos[0]][0])
            break
    check(target is not None, "obs: no converged FAIR_SHARE row to corrupt")
    rid, client = target
    store = server.resources[rid].store
    store.regrant(client, store.get(client).has * 1.01)
    before = aud.divergences
    seen["watch"] = rid
    base = (server._ticks_done // aud.sample + 1) * aud.sample
    caught_at = None
    for n, tick in enumerate((base, base + aud.sample), 1):
        aud.maybe_sample(tick, server._solve_mode(), server.resources)
        aud.drain()
        if any(d["rid"] == rid for d in seen["flags"][n_flags:]):
            caught_at = n
            break
    check(caught_at is not None,
          f"obs: the audit missed the corrupted grant of {rid}/{client}")
    check(seen.get("watch_records"),
          f"obs: no flight-record error entry for {rid}")
    check(seen.get("watch_instants"),
          f"obs: no audit.divergence instant for {rid}")
    forced = [dict(d, gap=_audit_gap(d)) for d in seen["flags"][n_flags:]
              if d["rid"] != rid]
    return dict(
        audit=dict(ticked, details=None), classes=classes,
        digest_ms=float(np.median(digest_s)) * 1e3,
        audit_snapshot_ms=snapshot_s * 1e3,
        injected=dict(resource=rid, client=client, caught_at_sample=caught_at,
                      divergences_added=aud.divergences - before,
                      others_flagged_by_the_forced_samples=len(forced),
                      forced_max_gap=max((d["gap"] for d in forced),
                                         default=0.0)),
        spans=sum(1 for e in tracer.snapshot() if e.name == "server.tick"),
    )


def _profiled_kernels(torch, lane_server, prio):
    """K1 and K2 on the f32 lane server's tables and K3 on the f32
    priority server's (the tables the kernels line timed): OBS_REPS
    launches queued behind a spin, timed with CUDA events, then the same
    under the profiler; the profiler's mean device time per launch beside
    the events' time. Comparison launches: not counted."""
    import tempfile

    from doorman_tpu_torch.obs.trace import (
        start_torch_capture,
        stop_torch_capture,
    )
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.priority_cuda import alloc_banded_k3

    solver = lane_server._resident
    cfg = solver._config
    batch = solver.table()
    R = batch.wants.shape[0]
    g = torch.Generator(device="cpu").manual_seed(4)
    delivered = (torch.rand(R, generator=g) < 0.2).cuda()
    prev = batch.has.clone()
    prev[::3] += 1.0
    snap = prio["server"]._solver.last_snapshot.priority_part
    b, nb = snap.batch, snap.num_bands
    half = torch.where(b.group >= 0, 0.5, 1.0).to(b.capacity.dtype)
    k3_args = (torch.where(b.active, b.wants, 0),
               torch.where(b.active, b.weights, 0), b.band, b.active,
               b.capacity * half, nb)
    runs = {
        "K1": lambda: dense_cuda.solve_dense_k1(batch),
        "K2": lambda: dense_cuda.fused_tick_k2(batch, prev, delivered),
        "K3": lambda: alloc_banded_k3(*k3_args),
    }
    saved = dict(dense_cuda.LAUNCHES)
    event_ms = {name: _time_ms(torch, fn, reps=OBS_REPS, queued=True)
                for name, fn in runs.items()}
    with tempfile.TemporaryDirectory() as tmp:
        # One session; the first records after CUPTI starts can be lost
        # (a few of 50 in separate sessions), so each kernel runs a few
        # launches before its queued ones, all of them in the mean.
        prof = start_torch_capture(tmp)
        for fn in runs.values():
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
            torch.cuda._sleep(20_000_000)
            for _ in range(OBS_REPS):
                fn()
            torch.cuda.synchronize()
        summ = _trace_summary(stop_torch_capture(prof, tmp))
    out = {}
    for name in runs:
        k = summ["kernels"].get(name, {})
        check(k.get("launches", 0) > 0,
              f"obs: the profiler saw no {name} launch; its kernels "
              f"{summ['kernels']}, top {summ['top_kernels']}")
        out[name] = {"event_ms": event_ms[name], "profiler_ms": k["mean_ms"],
                     "profiler_over_event": k["mean_ms"] / event_ms[name],
                     "profiler_launches": k["launches"],
                     "launched": OBS_REPS + 5}
    dense_cuda.LAUNCHES.update(saved)
    return out


async def _obs_binary():
    """The server binary with --mode batch --native-store --debug-port on
    a small config, in a process of its own: GetCapacity from three
    clients, then /metrics and /debug/status fetched while it ticks."""
    import os
    import socket
    import tempfile
    import urllib.request

    import grpc

    from doorman_tpu_torch.proto import doorman_pb2 as pb
    from doorman_tpu_torch.proto.grpc_api import CapacityStub

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    def fetch(port, path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            return resp.read().decode()

    with tempfile.TemporaryDirectory() as tmp:
        cfg = Path(tmp) / "cfg.yml"
        cfg.write_text(_config_yaml())
        port, dport = free_port(), free_port()
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        with open(Path(tmp) / "server.log", "w+") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "doorman_tpu_torch.cmd.server",
                 "--config", f"file:{cfg}", "--host", "127.0.0.1",
                 "--port", str(port), "--debug-port", str(dport),
                 "--mode", "batch", "--native-store", "--device", DEVICE,
                 "--tick-interval", "0.2", "--log-level", "warning"],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            )
            try:
                deadline = time.time() + 120.0
                async with grpc.aio.insecure_channel(
                        f"127.0.0.1:{port}") as ch:
                    stub = CapacityStub(ch)
                    while True:
                        check(proc.poll() is None and time.time() < deadline,
                              "obs: the server binary did not come up")
                        try:
                            d = await stub.Discovery(pb.DiscoveryRequest(),
                                                     timeout=1.0)
                            if d.is_master:
                                break
                        except grpc.aio.AioRpcError:
                            pass
                        await asyncio.sleep(0.5)
                    for c in range(3):
                        req = pb.GetCapacityRequest(client_id=f"c{c}")
                        for r in range(20):
                            rr = req.resource.add()
                            rr.resource_id = f"prop.t{r % 4}.r{r}"
                            rr.wants, rr.priority = 10.0 + c, 1
                        await stub.GetCapacity(req)
                    pages = {}
                    while time.time() < deadline:
                        await asyncio.sleep(1.0)
                        pages = {p: await asyncio.to_thread(fetch, dport, p)
                                 for p in ("/metrics", "/debug/status")}
                        if (f"backend: {DEVICE}" in pages["/debug/status"]
                                and 'component="resident"'
                                in pages["/metrics"]):
                            break
                check(proc.poll() is None, "obs: the server binary exited")
            except PhaseFailed:
                log.seek(0)
                say(log.read()[-4000:])
                raise
            finally:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    metrics, status = pages.get("/metrics", ""), pages.get("/debug/status", "")
    phases = [ln for ln in metrics.splitlines() if ln.startswith(
        'doorman_tick_phase_seconds_count{component="resident"')]
    reqs = [ln for ln in metrics.splitlines() if ln.startswith(
        'doorman_server_requests_count{method="GetCapacity"}')]
    check(phases, "obs: /metrics has no doorman_tick_phase_seconds for "
          "the resident component")
    check(reqs, "obs: /metrics has no GetCapacity request count")
    check(f"backend: {DEVICE}" in status,
          f"obs: /debug/status does not show the backend as {DEVICE}")
    return {"tick_phase_series": len(phases), "requests": reqs[0],
            "status_bytes": len(status)}


def phase_obs(torch, card, servers, prio):
    """The obs package on the card: the lane cell at f64 with every obs
    part on, its twin from the same seed with every part off, the
    priority cell at f32 under the profiler, the kernels' profiler times
    beside their CUDA-event times on the kernels line's tables, and the
    server binary's debug pages."""
    import tempfile

    import numpy as np

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        on = asyncio.run(_drive_obs_lane(torch, True, tmp))
        off = asyncio.run(_drive_obs_lane(torch, False, tmp))
        check(on["server"].profile_trace, "obs: the lane capture wrote no "
              "profiler trace")
        lane = _trace_summary(on["server"].profile_trace)
        check(lane["kernels"].get("K1", {}).get("launches", 0)
              + lane["kernels"].get("K2", {}).get("launches", 0) > 0,
              f"obs: the lane trace holds no K1 or K2 launch: {lane}")
        cap = on["launches_at_capture_stop"]
        for k in ("K1", "K2"):
            got = lane["kernels"].get(k, {}).get("launches", 0)
            check(got == cap[k.lower()],
                  f"obs: the lane trace holds {got} {k} launches, the "
                  f"counters {cap[k.lower()]} over the captured ticks")
        prio_run = asyncio.run(_drive_prio(
            torch, "f32", OBS_PRIO_PROFILE_TICKS + 1, 92,
            profile_dir=str(Path(tmp) / "prio-trace"),
            profile_ticks=OBS_PRIO_PROFILE_TICKS))
        ptrace = prio_run["server"].profile_trace
        check(ptrace, "obs: the priority capture wrote no profiler trace")
        pr = _trace_summary(ptrace)
        k3 = pr["kernels"].get("K3", {}).get("launches", 0)
        check(k3 == 38 * OBS_PRIO_PROFILE_TICKS,
              f"obs: the priority trace holds {k3} K3 launches over "
              f"{OBS_PRIO_PROFILE_TICKS} ticks, not 38 a tick")
    kernels = _profiled_kernels(torch, servers["f32"]["server"], prio["f32"])
    binary = asyncio.run(_obs_binary())
    won, woff = on["walls"][OBS_WARM:], off["walls"][OBS_WARM:]
    p50, p95 = _pcts(won)
    op50, op95 = _pcts(woff)
    after = won[max(on["capture_ticks"] - OBS_WARM, 0):]
    a50, a95 = _pcts(after) if after else (float("nan"), float("nan"))
    say(f"phase obs: lane cell f64, {OBS_WARM} warm + {OBS_CHURN} churn "
        f"ticks; every obs part on: churn tick p50 {p50:.2f} ms p95 "
        f"{p95:.2f} ms ({len(after)} churn ticks after the capture closed: "
        f"p50 {a50:.2f} p95 {a95:.2f}); every part off, same seed: p50 "
        f"{op50:.2f} ms p95 {op95:.2f} ms; launches on {on['launches']} off "
        f"{off['launches']}; card {card}")
    say("phase obs: tick walls ms on " + ", ".join(
        f"{w * 1e3:.1f}" for w in on["walls"]) + "; off " + ", ".join(
        f"{w * 1e3:.1f}" for w in off["walls"]))
    for r in on["records"]:
        top = sorted(r.get("phases", {}).items(), key=lambda kv: -kv[1])
        say(f"phase obs: flight record tick {r['tick']} "
            f"{r.get('solve_mode')}: wall {r['wall_ms']:.2f} ms; phases ms "
            + ", ".join(f"{k} {v:.2f}" for k, v in top))
    au = on["audit"]
    classes = {}
    for name, flags in on["classes"].items():
        kinds, ticks = {}, {}
        for d in flags:
            kinds[d["kind"]] = kinds.get(d["kind"], 0) + 1
            ticks[d["tick"]] = ticks.get(d["tick"], 0) + 1
        classes[name] = dict(count=len(flags), by_lane_kind=kinds,
                             by_tick=ticks, max_gap=max(
                                 (d["gap"] for d in flags), default=0.0))
    say(f"phase obs: store_digest over {len(on['resources'])} resources "
        f"{on['digest_ms']:.2f} ms a tick; the audit's host snapshot "
        f"{on['audit_snapshot_ms']:.1f} ms a sampled tick; audit "
        f"{au['samples']} sampled ticks, {au['compared_resources']} "
        f"resources compared, {au['divergences']} divergences; by class "
        f"{classes}; injected: {on['injected']}")
    bad = [d for d in on["classes"]["delivered"] if d["gap"] > OBS_GAP]
    check(not bad, f"obs: {len(bad)} flagged rows written between their "
          f"two samples are above {OBS_GAP} of the oracle (a grant fault): "
          f"{bad[:3]}")
    say(f"phase obs: lane capture ({on['capture_ticks']} ticks): window "
        f"{lane['window_ms']:.1f} ms, device busy {lane['busy_ms']:.3f} ms "
        f"= {lane['busy_share'] * 100:.3f}%, kernels {lane['kernels']}")
    say(f"phase obs: priority capture ({OBS_PRIO_PROFILE_TICKS} ticks): "
        f"window {pr['window_ms']:.1f} ms, device busy {pr['busy_ms']:.3f} "
        f"ms = {pr['busy_share'] * 100:.3f}%, kernels {pr['kernels']}")
    say(f"phase obs: top kernels of the lane capture {lane['top_kernels']}")
    say("phase obs: profiler vs CUDA events, same tables, "
        f"{OBS_REPS} queued launches: " + ", ".join(
            f"{k} {v['profiler_ms']:.5f} vs {v['event_ms']:.5f} ms "
            f"({v['profiler_over_event']:.3f})" for k, v in kernels.items()))
    say(f"phase obs: the server binary's /metrics and /debug/status: "
        f"{binary}")
    out.update(
        lane_on=dict(p50=p50, p95=p95, after_capture_p50=a50,
                     after_capture_p95=a95, walls_ms=[w * 1e3 for w in on["walls"]],
                     launches=on["launches"], capture_ticks=on["capture_ticks"],
                     tick_spans=on["spans"]),
        lane_off=dict(p50=op50, p95=op95,
                      walls_ms=[w * 1e3 for w in off["walls"]],
                      launches=off["launches"]),
        digest_ms=on["digest_ms"], audit_snapshot_ms=on["audit_snapshot_ms"],
        audit=dict(on["audit"], classes=classes),
        injected=on["injected"], lane_trace=lane, prio_trace=pr,
        prio_launches=prio_run["launches"],
        prio_walls_ms=[w * 1e3 for w in prio_run["walls"]],
        kernels=kernels, binary=binary,
    )
    return out


# -- phase takeover: persistence, warm master takeover, etcd election -------

TK_SNAPSHOT_S = 4.0  # snapshot interval; the fake clock moves 1 s a tick
TK_CHURN = 5  # A's churn ticks: snapshot beats at ticks 0 and 4
TK_B_CHURN = 1  # B's churn ticks after its first tick and the pipeline's
TK_LEARN_S = 30  # the takeover config's learning window
TK_AGE = 5.0  # the crash takeover's staleness (< TK_LEARN_S)
TK_C_TICKS = 4  # C's ticks inside its shortened learning window
TK_PRIO_TICKS = 2  # the priority cell's ticks on each side of its takeover
TK_BIN_LEARN_S = 5  # the server binary's learning window
TK_BIN_CAP = (100.0, 30.0)  # the binary's capacity before / after the put
TK_BIN_WANTS = 40.0


class _FakeClock:
    """One clock for the servers of a takeover: it moves only when the
    phase moves it."""

    def __init__(self, t):
        self.t = float(t)

    def __call__(self):
        return self.t


class _Laps:
    """Wall ms of named calls while installed: each wraps an attribute
    (a module function, a class method or an instance method) and adds
    its time under a label; `sizes` keeps the byte length of the first
    argument where asked (the snapshot a backend writes)."""

    def __init__(self):
        self.ms = {}
        self.sizes = []
        self._undo = []

    def wrap(self, owner, attr, label, size=False):
        fn = getattr(owner, attr)

        def timed(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.ms[label] = self.ms.get(label, 0.0) + (
                    time.perf_counter() - t) * 1e3
                if size:
                    self.sizes.append(len(args[0]))

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def take(self):
        out, self.ms = self.ms, {}
        return out

    def undo(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []


def _tk_server(name, clock, persist=None, dtype="f32"):
    """A batch server of the takeover phase: native store, fused scoped
    tick, depth-3 pipeline, stream push on with no subscriber (delta
    tracking on, so a full tick launches K2)."""
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer

    return CapacityServer(
        name, TrivialElection(), mode="batch", native_store=True,
        solver_dtype=dtype, fused_tick=True, scoped_solve=True,
        tick_pipeline_depth=3, tick_interval=1.0, flightrec_capacity=0,
        stream_push=True, clock=clock, persist=persist, device=DEVICE,
    )


def _tk_persist(path, clock, interval=TK_SNAPSHOT_S):
    from doorman_tpu_torch.persist import PersistManager, parse_backend

    return PersistManager(parse_backend(f"file:{path}"),
                          snapshot_interval=interval, clock=clock)


def _journal_rows(server, resources, pick):
    """Journal the rows a churn refreshed, as the request path's _decide
    journals a refresh: the lease as the store holds it."""
    from doorman_tpu_torch.core.lease import Lease

    record = server._persist.record_assign
    for i in pick:
        res = resources[i]
        for c, e, ri, h, w, sub, pr in res.store.dump_rows():
            record(res.id, c, Lease(e, ri, h, w, sub, pr))


def _dumps(server):
    return {rid: sorted(res.store.dump_rows())
            for rid, res in server.resources.items()}


def _restored_equal(want, got, summary):
    """The stores a warm restore rebuilt against the old master's at its
    step-down: every row equal, except on the resources the restore
    clamped (restored grants summing past the live capacity are scaled
    down to it, the reference's documented semantics: NO_ALGORITHM and
    STATIC rows by design, others by an ulp of rounding), whose rows
    must be the old ones with `has` scaled by capacity / sum. Returns
    (differing resource ids, {lane kind: clamped resources})."""
    info = summary["resources"]
    bad, clamped = [], {}
    if set(got) != set(want):
        bad.append(f"resource sets differ by {len(set(got) ^ set(want))}")
    for rid, rows in want.items():
        g = got.get(rid, [])
        if not info.get(rid, {}).get("clamped"):
            if g != rows:
                bad.append(rid)
            continue
        kind = rid.split(".")[0]
        clamped[kind] = clamped.get(kind, 0) + 1
        cap = info[rid]["capacity"]
        scale = cap / sum(r[3] for r in rows)
        if len(g) != len(rows) or any(
            a[:3] != b[:3] or a[4:] != b[4:]
            or abs(b[3] - a[3] * scale) > 1e-12 * max(cap, a[3])
            for a, b in zip(rows, g)
        ):
            bad.append(rid)
    return bad, clamped


def _restore_laps(laps, backend):
    """Wrap the restore's parts: the backend reads, the snapshot decode,
    the journal parse, load_state (read + decode + parse + replay), the
    row inserts (the bulk C call inside them) and the re-baseline
    snapshot."""
    from doorman_tpu_torch import native, persist
    from doorman_tpu_torch.persist import restore as restore_mod

    laps.wrap(backend, "read_snapshot", "read")
    laps.wrap(backend, "read_journal", "read")
    laps.wrap(restore_mod, "decode", "decode")
    laps.wrap(restore_mod.journal_mod, "read_records", "journal_parse")
    laps.wrap(restore_mod, "load_state", "load_state")
    laps.wrap(restore_mod, "_restore_rows", "rows")
    laps.wrap(native.StoreEngine, "bulk_assign", "bulk_assign")
    laps.wrap(persist.PersistManager, "snapshot_now", "rebaseline")


def _restore_split(ms, wall_ms):
    """The restore wall by part: load/decode (the backend reads and the
    snapshot decode), replay (the journal parse and merge: the rest of
    load_state), rows (the per-row handles and arrays) and bulk_assign,
    the re-baseline snapshot, and the rest (template lookups, learning
    ends, the band map)."""
    load = ms.get("read", 0.0) + ms.get("decode", 0.0)
    replay = ms.get("load_state", 0.0) - load
    rows = ms.get("rows", 0.0) - ms.get("bulk_assign", 0.0)
    out = {"load_decode": load, "replay": replay, "rows": rows,
           "bulk_assign": ms.get("bulk_assign", 0.0),
           "rebaseline": ms.get("rebaseline", 0.0), "wall": wall_ms}
    out["rest"] = wall_ms - sum(v for k, v in out.items() if k != "wall")
    return out


async def _tk_lane(torch, card, tmp):
    """The lane cell at f32 with persistence: A beside its persist-off
    twin, A's clean step-down and B's warm takeover, B's ticks, then B's
    crash and C's shortened learning window."""
    import numpy as np

    from doorman_tpu_torch import persist
    from doorman_tpu_torch.persist import journal as journal_mod
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.solver import dense_cuda

    cfg = parse_yaml_config(_config_yaml(learning=TK_LEARN_S))
    clock = _FakeClock(time.time())
    out = {}
    laps = _Laps()
    state = Path(tmp) / "lane"
    pa = _tk_persist(state, clock)
    a = _tk_server("tk-a", clock, pa)
    twin = _tk_server("tk-twin", clock)
    sides = {}
    for name, server in (("a", a), ("twin", twin)):
        await server.load_config(cfg)
        # Out of learning mode before the leases exist: this cell's
        # masters have held their leases for an hour.
        server.became_master_at = clock() - 3600.0
        rng = np.random.default_rng(31)
        resources, rids, cids = _populate(server, rng)
        sides[name] = dict(server=server, rng=rng, resources=resources,
                           rids=rids, cids=cids, walls=[], journal_ms=[])
    check(a.last_restore["mode"] == "cold_empty",
          f"takeover: A's first mastership restored {a.last_restore}")
    say(f"phase takeover: lane cell f32, A (persist file:, snapshot every "
        f"{TK_SNAPSHOT_S:g} s) and its persist-off twin, "
        f"{a._store_engine.total_leases} leases each; card {card}")
    laps.wrap(persist, "take_snapshot", "dump_rows")
    laps.wrap(persist, "encode", "encode")
    laps.wrap(pa.backend, "write_snapshot", "write", size=True)
    laps.wrap(journal_mod.Journal, "flush", "journal_flush")
    snaps = []
    dense_cuda.reset_launches()  # A's path starts here
    launches = {}
    for i in range(TK_CHURN):
        for name in ("a", "twin"):
            sd = sides[name]
            server = sd["server"]
            pick = _churn(server._store_engine, sd["rng"], sd["rids"],
                          sd["cids"])
            if server is a:
                t = time.perf_counter()
                _journal_rows(a, sd["resources"], pick)
                sd["journal_ms"].append((time.perf_counter() - t) * 1e3)
                laps.take()
                n_sizes = len(laps.sizes)
            t = time.perf_counter()
            await server.tick_once()
            sd["walls"].append(time.perf_counter() - t)
            if server is a:
                parts = laps.take()
                sd.setdefault("flush_ms", []).append(
                    parts.get("journal_flush", 0.0))
                if len(laps.sizes) > n_sizes:
                    snaps.append(dict(
                        tick=i, wall_ms=sd["walls"][-1] * 1e3,
                        bytes=laps.sizes[-1],
                        **{k: parts.get(k, 0.0)
                           for k in ("dump_rows", "encode", "write")}))
        if i == TK_CHURN - 1:
            torch.cuda.synchronize()
            launches["a"] = dict(dense_cuda.LAUNCHES)
        clock.t += 1.0
    check(len(snaps) >= 2,
          f"takeover: snapshot beats inside the churn ticks {snaps}")
    for name in ("a", "twin"):
        sd = sides[name]
        sd["p50"], sd["p95"] = _pcts(sd["walls"])
    say(f"phase takeover: {TK_CHURN} churn ticks (journaled on A: "
        f"{np.mean(sides['a']['journal_ms']):.1f} ms a tick to record "
        f"{CHURN * N_CLIENTS} refreshed rows, flush "
        f"{np.mean(sides['a']['flush_ms']):.2f} ms a tick): A tick p50 "
        f"{sides['a']['p50']:.2f} ms p95 {sides['a']['p95']:.2f} ms, twin "
        f"p50 {sides['twin']['p50']:.2f} ms p95 {sides['twin']['p95']:.2f} "
        f"ms; A walls ms {[round(w * 1e3, 1) for w in sides['a']['walls']]}"
        f", twin {[round(w * 1e3, 1) for w in sides['twin']['walls']]}; "
        f"launches on A and the twin {launches['a']}; card {card}")
    for sn in snaps:
        say(f"phase takeover: snapshot tick {sn['tick']}: wall "
            f"{sn['wall_ms']:.1f} ms; snapshot_now dump_rows "
            f"{sn['dump_rows']:.1f} ms, encode {sn['encode']:.1f} ms, write "
            f"{sn['write']:.1f} ms, {sn['bytes']} bytes")
    await twin.stop()
    # A's clean step-down: the in-flight ticks land, a final snapshot
    # beat, one more journaled churn (no tick), its flush, the marker.
    await a.flush_ticks()
    clock.t += TK_SNAPSHOT_S
    a.persist_step()
    sd = sides["a"]
    pick = _churn(a._store_engine, sd["rng"], sd["rids"], sd["cids"])
    _journal_rows(a, sd["resources"], pick)
    a.persist_step()
    check(pa.journal.pending == 0 and pa.journal.flushed_records > 0,
          "takeover: A's post-snapshot journal did not flush")
    want = _dumps(a)
    n_leases = sum(len(v) for v in want.values())
    await a._on_is_master(False)
    await a.stop()
    laps.undo()

    # B: same config, clock and backend; the restore runs inside its
    # first mastership (load_config enters the trivial election).
    clock.t += 1.0
    pb_ = _tk_persist(state, clock, interval=3600.0)
    b = _tk_server("tk-b", clock, pb_)
    _restore_laps(laps, pb_.backend)
    t = time.perf_counter()
    await b.load_config(cfg)
    b_wall = (time.perf_counter() - t) * 1e3
    b_split = _restore_split(laps.take(), b_wall)
    laps.undo()
    lr = b.last_restore
    check(lr is not None and lr["mode"] == "warm" and lr["clean_down"],
          f"takeover: B's restore {lr and {k: lr[k] for k in ('mode', 'clean_down', 'detail')}}")
    check(lr["leases_restored"] == n_leases,
          f"takeover: B restored {lr['leases_restored']} of {n_leases}")
    learning = {v["learning"] for v in lr["resources"].values()}
    check(learning == {"skip"}, f"takeover: B's learning {learning}")
    check(not any(r.in_learning_mode for r in b.resources.values()),
          "takeover: a resource of B is in learning mode")
    bad, b_clamped = _restored_equal(want, _dumps(b), lr)
    check(not bad, f"takeover: {len(bad)} of B's stores differ from A's "
          f"at the step-down ({bad[:3]})")
    say(f"phase takeover: A stepped down clean; B restored warm "
        f"{lr['leases_restored']} leases ({lr['records_applied']} journal "
        f"records replayed), every store equal to A's row for row (the "
        f"clamped resources scaled to capacity: {b_clamped}), learning "
        f"skipped; restore ms {b_split}")
    ids = [r.id for r in sides["a"]["resources"]]
    b_res = [b.resources[r] for r in ids]
    b_rids = np.asarray([[r.store._rid] * N_CLIENTS for r in b_res],
                        np.int32)
    engine = b._store_engine
    b_cids = np.asarray(
        [[engine.client_handle(f"c{i}.{c}") for c in range(N_CLIENTS)]
         for i in range(N_RES)], np.int64)
    rng = np.random.default_rng(32)
    dense_cuda.reset_launches()  # B's path starts here
    t = time.perf_counter()
    await b.tick_once()
    first_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    solver = b._resident
    first = dict(mode=solver.last_solve_mode,
                 reason=solver.last_full_reason,
                 k2=dense_cuda.LAUNCHES["k2"],
                 rebuild_ms=solver.phase_s.get("rebuild", 0.0) * 1e3)
    check(first["mode"] == "full" and first["reason"] == "rebuild",
          f"takeover: B's first tick {first}")
    check(first["k2"] == 1, f"takeover: B's first tick launched K2 "
          f"{first['k2']} times")
    check(first["rebuild_ms"] > 0, "takeover: B's laps show no rebuild")
    clock.t += 1.0
    b_walls = []
    for i in range(2 + TK_B_CHURN + QUIET_TICKS):
        if 2 <= i < 2 + TK_B_CHURN:
            pick = _churn(engine, rng, b_rids, b_cids)
            _journal_rows(b, b_res, pick)
        t = time.perf_counter()
        await b.tick_once()
        b_walls.append(time.perf_counter() - t)
        clock.t += 1.0
    await b.flush_ticks()
    torch.cuda.synchronize()
    launches["b"] = dict(dense_cuda.LAUNCHES)
    err, oracle_err, settling = _check_server_grants(torch, b, b_res)
    say(f"phase takeover: B's first tick full ({first['reason']}), "
        f"{first_ms:.1f} ms, K2 {first['k2']}, rebuild lap "
        f"{first['rebuild_ms']:.1f} ms; then {len(b_walls)} ticks "
        f"({TK_B_CHURN} churned, journaled): walls ms "
        f"{[round(w * 1e3, 1) for w in b_walls]}; launches {launches['b']}; "
        f"K1 vs plain {err:.3g}, vs f64 oracle {oracle_err:.3g}, store == "
        f"device on converged rows ({settling} of 400 sampled in scope)")

    # B crashes (no step-down marker) after one more journaled churn;
    # C takes over TK_AGE seconds after B's last persisted fact.
    pick = _churn(engine, rng, b_rids, b_cids)
    _journal_rows(b, b_res, pick)
    b.persist_step()
    journal_seq = pb_.journal.seq
    await b.stop()
    del b, b_res, solver
    clock.t += TK_AGE
    pc = _tk_persist(state, clock, interval=3600.0)
    c = _tk_server("tk-c", clock, pc)
    _restore_laps(laps, pc.backend)
    t = time.perf_counter()
    await c.load_config(cfg)
    c_wall = (time.perf_counter() - t) * 1e3
    c_split = _restore_split(laps.take(), c_wall)
    laps.undo()
    lr = c.last_restore
    check(lr["mode"] == "warm" and not lr["clean_down"],
          f"takeover: C's restore {lr['mode']} clean_down {lr['clean_down']}")
    check(lr["journal_seq"] == journal_seq,
          f"takeover: C replayed to seq {lr['journal_seq']}, B wrote "
          f"{journal_seq}")
    check(abs(lr["age"] - TK_AGE) < 1e-6, f"takeover: C's age {lr['age']}")
    ends = {r.learning_mode_end for r in c.resources.values()}
    check(ends == {c.became_master_at + lr["age"]},
          f"takeover: C's learning ends {sorted(ends)[:3]} != "
          f"{c.became_master_at + lr['age']}")
    kinds = {v["learning"] for v in lr["resources"].values()}
    check(kinds == {"shorten"}, f"takeover: C's learning {kinds}")
    restored = _dumps(c)
    dense_cuda.reset_launches()  # C's path starts here
    for _ in range(TK_C_TICKS):
        clock.t += 1.0
        check(all(r.in_learning_mode for r in c.resources.values()),
              "takeover: C left learning before its window ended")
        await c.tick_once()
    await c.flush_ticks()
    torch.cuda.synchronize()
    launches["c"] = dict(dense_cuda.LAUNCHES)
    check(launches["c"]["k2"] >= 1, f"takeover: C launched {launches['c']}")
    after = _dumps(c)
    # The learning replay grants each row its has, through the f32
    # solve: a row's grant is its restored has or that value's f32
    # rounding (rows a clamp scaled carry f64 values).
    moved = sum(
        1 for rid, rows in restored.items()
        for r0, r1 in zip(rows, after[rid])
        if r1[3] not in (r0[3], float(np.float32(r0[3]))))
    check(moved == 0, f"takeover: {moved} of C's grants moved off the "
          f"restored has inside the learning window")
    say(f"phase takeover: B crashed; C restored warm {lr['leases_restored']}"
        f" leases (journal seq {lr['journal_seq']}, "
        f"{lr['records_applied']} records replayed), age {lr['age']:.3f} s,"
        f" every learning window shortened to it; {TK_C_TICKS} ticks inside"
        f" it, launches {launches['c']}, every grant equal to the restored "
        f"has; restore ms {c_split}")
    await c.stop()
    out.update(
        a=dict(p50=sides["a"]["p50"], p95=sides["a"]["p95"],
               walls_ms=[w * 1e3 for w in sides["a"]["walls"]],
               journal_record_ms=sides["a"]["journal_ms"],
               journal_flush_ms=sides["a"]["flush_ms"]),
        twin=dict(p50=sides["twin"]["p50"], p95=sides["twin"]["p95"],
                  walls_ms=[w * 1e3 for w in sides["twin"]["walls"]]),
        snapshots=snaps, restore_b=b_split, restore_c=c_split,
        clamped_b=b_clamped,
        leases=n_leases, b_first=dict(first, wall_ms=first_ms),
        b_walls_ms=[w * 1e3 for w in b_walls], b_k1_err=err,
        b_oracle_err=oracle_err, c_age=lr["age"], launches=launches,
    )
    return out


async def _tk_prio(torch, card, tmp):
    """The priority cell at f32: P ticks with persistence, steps down
    clean after a final snapshot beat, and Q takes over warm."""
    import numpy as np

    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.solver import dense_cuda

    clock = _FakeClock(time.time())
    rng = np.random.default_rng(35)
    prio_ids, cap, group, gcap = _prio_layout(rng)
    ids = prio_ids + _resource_ids(rng, N_PRIO_LANE)
    cfg = parse_yaml_config(_prio_yaml(gcap))
    state = Path(tmp) / "prio"
    p = _tk_server("tk-p", clock, _tk_persist(state, clock))
    await p.load_config(cfg)
    resources, rids, cids = _populate_prio(p, rng, ids)
    for _ in range(TK_PRIO_TICKS):
        _churn_prio(p._store_engine, rng, rids, cids)
        await p.tick_once()
        clock.t += 1.0
    await p.flush_ticks()
    clock.t += TK_SNAPSHOT_S
    p.persist_step()
    want = _dumps(p)
    await p._on_is_master(False)
    await p.stop()
    clock.t += 1.0
    pq = _tk_persist(state, clock, interval=3600.0)
    q = _tk_server("tk-q", clock, pq)
    laps = _Laps()
    _restore_laps(laps, pq.backend)
    t = time.perf_counter()
    await q.load_config(cfg)
    split = _restore_split(laps.take(), (time.perf_counter() - t) * 1e3)
    laps.undo()
    check(q.last_restore["mode"] == "warm",
          f"takeover: Q's restore {q.last_restore['mode']}")
    bad, q_clamped = _restored_equal(want, _dumps(q), q.last_restore)
    check(not bad, f"takeover: {len(bad)} of Q's stores differ from P's "
          f"({bad[:3]})")
    q_res = [q.resources[r] for r in ids]
    engine = q._store_engine
    q_rids = np.asarray([[r.store._rid] * N_CLIENTS for r in q_res],
                        np.int32)
    q_cids = np.asarray(
        [[engine.client_handle(f"c{i}.{c}") for c in range(N_CLIENTS)]
         for i in range(len(ids))], np.int64)
    walls, first_k3 = [], None
    dense_cuda.reset_launches()  # Q's path starts here
    for i in range(TK_PRIO_TICKS):
        _churn_prio(engine, rng, q_rids, q_cids)
        t = time.perf_counter()
        await q.tick_once()
        walls.append(time.perf_counter() - t)
        if i == 0:
            first_k3 = dense_cuda.LAUNCHES["k3"]
        clock.t += 1.0
    await q.flush_ticks()
    torch.cuda.synchronize()
    launches = dict(dense_cuda.LAUNCHES)
    check(first_k3 == 38, f"takeover: Q's first tick launched K3 "
          f"{first_k3} times, not 38")
    lo, hi, oracle_err, nb = _check_prio(torch, dict(
        server=q, resources=q_res, launches=launches, cap=cap,
        group=group, gcap=gcap, ticks=TK_PRIO_TICKS))
    say(f"phase takeover: priority cell f32, P stepped down clean, Q "
        f"restored warm {q.last_restore['leases_restored']} leases, every "
        f"store equal row for row (clamped: {q_clamped}); restore ms "
        f"{split}; Q's first tick "
        f"{first_k3} K3 launches, walls ms "
        f"{[round(w * 1e3, 1) for w in walls]}, launches {launches}, group "
        f"usage / cap in [{lo:.9f}, {hi:.9f}], uncoupled rows vs f64 "
        f"oracle {oracle_err:.3g}; card {card}")
    await q.stop()
    return dict(restore=split, launches=launches, first_k3=first_k3,
                clamped=q_clamped,
                walls_ms=[w * 1e3 for w in walls],
                leases=q.last_restore["leases_restored"])


def _tk_bin_yaml(cap):
    return ("resources:\n  - identifier_glob: '*'\n"
            f"    capacity: {cap}\n    algorithm: {{kind: PROPORTIONAL_SHARE,"
            f" lease_length: 20, refresh_interval: 1, learning_mode_duration:"
            f" {TK_BIN_LEARN_S}}}\n")


async def _tk_binary(card):
    """Two server binaries under an etcd election (tests/fake_etcd.py),
    config and persistence in etcd: a client's grant, SIGKILL of the
    master, the standby's warm takeover, a config put through etcd."""
    import os
    import socket
    import tempfile
    import urllib.request

    import importlib.util

    from doorman_tpu_torch.client import Client
    from doorman_tpu_torch.server.etcd import EtcdGateway

    # By path: a `tests` package installed on the machine may shadow the
    # checkout's tests/ directory.
    spec = importlib.util.spec_from_file_location(
        "fake_etcd", ROOT / "tests" / "fake_etcd.py")
    fake_etcd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fake_etcd)
    FakeEtcd = fake_etcd.FakeEtcd

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    def fetch(port, path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            return json.loads(resp.read().decode())

    def status(dport):
        """The server's status() from /debug/vars; None until the debug
        port answers."""
        try:
            return fetch(dport, "/debug/vars")["servers"][0]
        except OSError:
            return None

    def flight(dport):
        views = fetch(dport, "/debug/flightrec?format=json")
        return next(iter(views.values()))["records"]

    async def until(cond, what, timeout=60.0):
        deadline = time.time() + timeout
        while True:
            got = cond()
            if got:
                return got
            check(time.time() < deadline, f"takeover binary: {what}")
            await asyncio.sleep(0.05)

    fake = FakeEtcd()
    fake.start()
    procs, logs, client = {}, {}, None
    try:
        gw = EtcdGateway([fake.address])
        gw.put("/doorman/config", _tk_bin_yaml(TK_BIN_CAP[0]))
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        tmp = tempfile.mkdtemp(prefix="tk-bin-")
        ports = {}
        for name in ("x", "y"):
            port, dport = free_port(), free_port()
            ports[name] = (port, dport)
            logs[name] = open(Path(tmp) / f"{name}.log", "w+")
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "doorman_tpu_torch.cmd.server",
                 "--host", "127.0.0.1", "--port", str(port),
                 "--debug-port", str(dport),
                 "--server-id", f"127.0.0.1:{port}",
                 "--mode", "batch", "--native-store", "--device", DEVICE,
                 "--tick-interval", "0.2", "--solver-dtype", "f32",
                 "--minimum-refresh-interval", "1",
                 "--config", "etcd:/doorman/config",
                 "--etcd-endpoints", fake.address,
                 "--master-election-lock", "/doorman/lock",
                 "--master-delay", "2",
                 "--persist", "etcd:/doorman/state",
                 "--snapshot-interval", "1", "--log-level", "warning"],
                cwd=ROOT, env=env, stdout=logs[name],
                stderr=subprocess.STDOUT,
            )
        addr = {n: f"127.0.0.1:{p}" for n, (p, _d) in ports.items()}
        master = await until(lambda: fake.value("/doorman/lock"),
                             "no server won the lock", 120.0)
        m = next(n for n in addr if addr[n] == master)
        s = next(n for n in addr if n != m)
        # The standby must be up too (it answers with a redirect).
        await until(lambda: procs[s].poll() is None and status(
            ports[s][1]) is not None, "the standby never came up")
        # The client's seed is the standby: it redirects to the master,
        # and after the master dies the client redials its seed.
        client = await Client.connect(addr[s], "tk-client",
                                      minimum_refresh_interval=1.0)
        res = await client.resource("tk.r0", TK_BIN_WANTS)
        await until(lambda: res.lease is not None
                    and res.lease.capacity == TK_BIN_WANTS
                    and client.master() == addr[m],
                    "the client was never granted by the master", 120.0)
        # A few snapshot beats past the learning window, then the kill.
        await asyncio.sleep(TK_BIN_LEARN_S + 2.0)
        held = res.lease
        procs[m].kill()
        t_kill = time.perf_counter()
        procs[m].wait()
        await until(lambda: fake.value("/doorman/lock") == addr[s],
                    "the standby did not win", 60.0)
        t_won = time.perf_counter()
        await until(lambda: client.master() == addr[s]
                    and res.lease is not held
                    and res.lease.capacity == TK_BIN_WANTS,
                    "the client's grant did not return", 60.0)
        regained_s = time.perf_counter() - t_kill
        st = status(ports[s][1])
        check(st["is_master"], "takeover binary: the standby is not master")
        lr = st.get("last_restore") or {}
        check(lr.get("mode") == "warm" and lr.get("leases_restored", 0) >= 1,
              f"takeover binary: the standby's restore {lr}")
        check(st.get("persist") is not None
              and st["persist"]["journal_seq"] >= 1,
              f"takeover binary: persist block {st.get('persist')}")
        # A config put through etcd: the next tick is full on the card
        # and the grant moves to the new capacity.
        await asyncio.sleep(TK_BIN_LEARN_S)
        before = flight(ports[s][1])
        last_tick = max((r.get("tick", -1) for r in before), default=-1)
        gw.put("/doorman/config", _tk_bin_yaml(TK_BIN_CAP[1]))
        t_put = time.perf_counter()
        await until(lambda: res.lease is not None
                    and res.lease.capacity == TK_BIN_CAP[1],
                    "the grant never moved to the new capacity", 60.0)
        moved_s = time.perf_counter() - t_put
        recs = [r for r in flight(ports[s][1])
                if r.get("tick", -1) > last_tick]
        full = [r for r in recs if r.get("solve_mode") == "full:config-epoch"]
        check(full, "takeover binary: no full:config-epoch tick after the "
              f"put: {[r.get('solve_mode') for r in recs]}")
        check(full[0].get("dispatches", 0) > 0,
              f"takeover binary: the config-epoch tick dispatched nothing: "
              f"{full[0]}")
        st = status(ports[s][1])
        check(st.get("backend") == DEVICE,
              f"takeover binary: the master solves on {st.get('backend')}")
        check(procs[s].poll() is None, "takeover binary: the master exited")
        say(f"phase takeover: server binaries under the etcd election: "
            f"killed the master, the standby won "
            f"{t_won - t_kill:.2f} s later and restored warm "
            f"({lr.get('leases_restored')} lease, age {lr.get('age', 0):.3f}"
            f" s) through the etcd backend; the client's grant returned "
            f"{regained_s:.2f} s after the kill; a config put moved it to "
            f"{TK_BIN_CAP[1]:g} in {moved_s:.2f} s through a "
            f"full:config-epoch tick on {st.get('backend')} "
            f"({full[0].get('dispatches')} dispatches); card {card}")
        return dict(won_s=t_won - t_kill, regained_s=regained_s,
                    moved_s=moved_s, restore=lr,
                    config_tick=full[0].get("tick"))
    except PhaseFailed:
        for name, log in logs.items():
            log.seek(0)
            say(f"--- server {name} log ---\n{log.read()[-3000:]}")
        raise
    finally:
        if client is not None:
            try:
                await asyncio.wait_for(client.close(), 15)
            except Exception:
                pass
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        for log in logs.values():
            log.close()
        fake.stop()


# -- the federation phase ----------------------------------------------------
# Sharded roots, the straddle reconciler and the federated intermediate
# (doorman_tpu_torch/federation/): the reference's parity schedule at
# f64, bench.py's federated-roots workload at f32 with one straddling
# resource per reconcilable lane, the aggregation adapter at the lane
# cell's 10,000 x 100, and a federated intermediate over the two roots.

# tests/test_federation.py PARITY_TEMPLATES / PARITY_SCHEDULE (:181-208):
# (resource, wire kind, capacity) and (resource, client, shard placement
# or None for the router's, wants per phase).
FP_TEMPLATES = (
    ("strad-none", 0, 100.0),
    ("strad-static", 1, 7.0),
    ("strad-prop", 2, 400.0),
    ("strad-fair", 3, 300.0),
    ("solo-a", 2, 50.0),
    ("solo-b", 2, 64.0),
)
FP_SCHEDULE = (
    ("strad-none", "n0", 0, (10.0, 35.0, 20.0)),
    ("strad-none", "n1", 1, (50.0, 5.0, 40.0)),
    ("strad-static", "t0", 0, (3.0, 11.0, 5.0)),
    ("strad-static", "t1", 1, (9.0, 2.0, 13.0)),
    ("strad-prop", "p0", 0, (100.0, 40.0, 100.0)),
    ("strad-prop", "p1", 0, (150.0, 90.0, 150.0)),
    ("strad-prop", "p2", 1, (250.0, 500.0, 250.0)),
    ("strad-prop", "p3", 1, (300.0, 70.0, 300.0)),
    ("strad-fair", "f0", 0, (50.0, 500.0, 50.0)),
    ("strad-fair", "f1", 0, (100.0, 20.0, 100.0)),
    ("strad-fair", "f2", 1, (150.0, 60.0, 150.0)),
    ("strad-fair", "f3", 1, (200.0, 10.0, 200.0)),
    ("solo-a", "sa", None, (30.0, 80.0, 45.0)),
    ("solo-b", "sb", None, (64.0, 10.0, 128.0)),
)
FP_ROUNDS = 6  # rounds a phase, 3 phases

# fed-roots: bench.py's server_tick_federated_roots shard (build_shard,
# :2828): 10,000 resources x 100 clients a shard, kinds NO_ALGORITHM /
# STATIC / PROPORTIONAL_SHARE / FAIR_SHARE at 5/5/65/25%, capacities
# 100-100,000, wants 0-99, refresh 16 s (delivery every 16 ticks), seed
# 1100 + shard, 5% churn a round; FED_WARMUP 3 + FED_TICKS 12 rounds.
FED_R = N_RES
FED_C = N_CLIENTS
FED_WARMUP = 3
FED_ROUNDS = 12
FED_REFRESH = 16
FED_QUIET = 2 * FED_REFRESH  # two delivery rotations: store == device
# Ticks with no beat after the quiet rounds: the last beat's config
# epoch makes the first a full tick, which seeds the whole table into the
# scope frontier; two scoped ticks let the converged rows leave it
# before store == device is held.
FED_SETTLE = 3
# One straddling resource per reconcilable lane, 100 clients on each
# shard, overloaded (wants 1-99 against 4,000).
FED_STRADDLE = (
    ("fs.prop", 2, None), ("fs.fair", 3, None), ("fs.maxmin", 3, "maxmin"),
    ("fs.pf", 2, "logutil"), ("fs.bal", 3, "balanced"),
)
FED_STRADDLE_CAP = 4_000.0
FED_SHARE_REL = 1e-9  # Σ shares <= capacity x (1 + this)
# aggregate: the adapter over the lane cell's shape, 10 dirty ticks.
AGG_TICKS = 10
# fed-intermediate: 1,000 resources x 100 clients at PRIORITIES, 100 of
# them PRIORITY_BANDS on the roots; exchanges timed, then one with a
# root blocked.
FI_RES = 1_000
FI_PRIO = 100
FI_EXCHANGES = 6
FI_CAP = 2_000.0


def _fed_server(name, clock, shard=None, dtype="f32"):
    """A root shard (or single root) of the federation phase: batch mode,
    native store, the server's default tick pipeline, stream push on with
    no subscriber (delta tracking on, so a full tick launches K2)."""
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer

    return CapacityServer(
        name, TrivialElection(), mode="batch", native_store=True,
        solver_dtype=dtype, tick_interval=1.0, minimum_refresh_interval=0.0,
        clock=clock, shard=shard, flightrec_capacity=0, stream_push=True,
        device=DEVICE,
    )


def _fp_repo():
    from doorman_tpu_torch.proto import doorman_pb2 as pb

    repo = pb.ResourceRepository()
    for rid, kind, capacity in FP_TEMPLATES + (("*", 2, 1.0),):
        tpl = repo.resources.add()
        tpl.identifier_glob, tpl.capacity = rid, capacity
        tpl.algorithm.kind = kind
        tpl.algorithm.lease_length = 600
        tpl.algorithm.refresh_interval = 1
        tpl.algorithm.learning_mode_duration = 0
    return repo


async def _fed_parity(torch, card):
    """tests/test_federation.py's parity schedule at f64 on the card: two
    shard roots and the reconciliation beat against one single root,
    every grant equal where the reference test holds it equal (FAIR_SHARE
    within 1 ulp of the grant scale), Σ shard shares within the
    configured capacity at every beat."""
    import math

    from doorman_tpu_torch.algorithms import Request
    from doorman_tpu_torch.federation import FederatedRoots, ShardRouter
    from doorman_tpu_torch.solver import dense_cuda

    clock = _FakeClock(1000.0)
    straddle = [r for r, *_ in FP_TEMPLATES if r.startswith("strad")]
    router = ShardRouter(2, straddle=straddle)
    root = _fed_server("fp-root", clock, dtype="f64")
    shards = {s: _fed_server(f"fp-shard{s}", clock, s, "f64") for s in (0, 1)}
    servers = [root, *shards.values()]
    for s in servers:
        await s.load_config(_fp_repo())
    fed = FederatedRoots(router, shards, share_ttl=30.0, clock=clock)
    has = {"root": {}, "fed": {}}
    caps = {rid: cap for rid, kind, cap in FP_TEMPLATES if kind in (2, 3)}
    worst_share = 0.0
    dense_cuda.reset_launches()  # the fed-parity path starts here
    try:
        fed.reconcile_once()
        for phase in range(3):
            for _ in range(FP_ROUNDS):
                for rid, client, placement, wants in FP_SCHEDULE:
                    w = wants[phase]
                    lease, _ = root._decide(rid, Request(
                        client, has["root"].get((rid, client), 0.0), w))
                    has["root"][(rid, client)] = lease.has
                    shard = (placement if placement is not None
                             else router.shard_of(rid))
                    lease, _ = shards[shard]._decide(rid, Request(
                        client, has["fed"].get((rid, client), 0.0), w))
                    has["fed"][(rid, client)] = lease.has
                for s in servers:
                    await s.tick_once()
                fed.reconcile_once()
                clock.t += 1.0
                for rid in straddle:
                    if rid not in caps:
                        continue
                    total = sum(shards[s]._straddle_shares.get(rid, 0.0)
                                for s in (0, 1))
                    check(total <= caps[rid],
                          f"fed-parity: Σ shares of {rid} {total!r} > "
                          f"{caps[rid]}")
                    worst_share = max(worst_share, total / caps[rid])
                    granted = sum(shards[s].resources[rid].store.sum_has
                                  for s in (0, 1) if rid in shards[s].resources)
                    check(granted <= caps[rid] + 1e-6,
                          f"fed-parity: Σ grants of {rid} {granted}")
        torch.cuda.synchronize()
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        worst_fair = 0.0
        for rid, client, placement, _w in FP_SCHEDULE:
            shard = placement if placement is not None else router.shard_of(rid)
            want = root.resources[rid].store.get(client).has
            got = shards[shard].resources[rid].store.get(client).has
            if rid == "strad-fair":
                gap = abs(got - want)
                worst_fair = max(worst_fair, gap / math.ulp(max(want, 1.0)))
                check(gap <= math.ulp(max(want, 1.0)),
                      f"fed-parity: {rid}/{client} {got!r} vs single root "
                      f"{want!r}")
            else:
                check(got == want, f"fed-parity: {rid}/{client} {got!r} vs "
                      f"single root {want!r}")
        check(has["root"][("strad-prop", "p0")] == 50.0,
              "fed-parity: the end state did not run overloaded")
        check(launches["k1"] > 0 and launches["k2"] > 0,
              f"fed-parity: launches {launches}")
        say(f"phase fed-parity[f64]: {len(FP_SCHEDULE)} clients over 3 "
            f"phases x {FP_ROUNDS} rounds, 2 shard roots + 1 root on the "
            f"card: every grant equal to the single root's (FAIR_SHARE "
            f"within {worst_fair:g} ulp), Σ shares at most "
            f"{worst_share:.6f} of capacity; launches {launches}; "
            f"card {card}")
        return dict(launches=launches, fair_ulps=worst_fair,
                    share_of_capacity=worst_share)
    finally:
        for s in servers:
            await s.stop()


def _fed_root_yaml():
    """The roots' config: the straddling resources, the intermediate's
    resources (lane and PRIORITY_BANDS), and "*" (bench.py's resources
    get their own template each after creation)."""
    lines = ["resources:"]

    def line(glob, cap, kind, variant=None):
        params = (f", parameters: [{{name: variant, value: {variant}}}]"
                  if variant else "")
        lines.append(
            f"  - identifier_glob: '{glob}'\n    capacity: {cap}\n"
            f"    algorithm: {{kind: {kind}, lease_length: 600, "
            f"refresh_interval: {FED_REFRESH}, learning_mode_duration: 0"
            f"{params}}}")

    for rid, kind, variant in FED_STRADDLE:
        line(rid, FED_STRADDLE_CAP, kind, variant)
    line("fi.p.*", FI_CAP, "PRIORITY_BANDS")
    line("fi.l.*", FI_CAP, "PROPORTIONAL_SHARE")
    line("*", 1000.0, 0)
    return "\n".join(lines) + "\n"


def _fed_populate(server, shard, clock, names=None):
    """bench.py build_shard's workload on a shard root's native engine
    (its rng order: kinds, capacities, wants, then the churn stream),
    then the straddling resources' 100 clients. `names` are the
    resource ids (bench.py's `s<shard>-res<r>` by default)."""
    import numpy as np

    from doorman_tpu_torch.proto import doorman_pb2 as pb

    R, C = FED_R, FED_C
    if names is None:
        names = [f"s{shard}-res{r}" for r in range(R)]
    rng = np.random.default_rng(1100 + shard)
    kinds = rng.choice(np.array([0, 1, 2, 3], np.int64), size=R,
                       p=[0.05, 0.05, 0.65, 0.25])
    capacity = rng.integers(100, 100_000, R).astype(np.float64)
    resources = []
    for r in range(R):
        res = server.get_or_create_resource(names[r])
        res.load_config(pb.ResourceTemplate(
            identifier_glob=res.id, capacity=float(capacity[r]),
            algorithm=pb.Algorithm(
                kind=int(kinds[r]), lease_length=600,
                refresh_interval=FED_REFRESH, learning_mode_duration=0),
        ), None)
        resources.append(res)
    server._config_epoch += 1  # the templates moved outside load_config
    engine = server._store_engine
    rids = np.repeat([r.store._rid for r in resources], C).astype(np.int32)
    cids = np.fromiter((engine.client_handle(f"s{shard}-c{i}")
                        for i in range(R * C)), np.int64, count=R * C)
    wants = rng.integers(0, 100, R * C).astype(np.float64)
    engine.bulk_assign(rids, cids, np.full(R * C, clock() + 600.0),
                       np.full(R * C, float(FED_REFRESH)), np.zeros(R * C),
                       wants, np.ones(R * C, np.int32))
    churn = max(R // 20, 1)
    n = FED_WARMUP + FED_ROUNDS
    churn_rows = [rng.choice(R, churn, replace=False) for _ in range(n)]
    churn_wants = [rng.integers(0, 100, churn * C).astype(np.float64)
                   for _ in range(n)]
    srng = np.random.default_rng(1200 + shard)
    strad = {}
    for rid, _kind, _variant in FED_STRADDLE:
        res = server.get_or_create_resource(rid)
        s_cids = np.array([engine.client_handle(f"{rid}.s{shard}.c{i}")
                           for i in range(C)], np.int64)
        s_rids = np.full(C, res.store._rid, np.int32)
        engine.bulk_assign(s_rids, s_cids, np.full(C, clock() + 600.0),
                           np.full(C, float(FED_REFRESH)), np.zeros(C),
                           srng.integers(1, 100, C).astype(np.float64),
                           np.ones(C, np.int32))
        strad[rid] = (s_rids, s_cids)
    return dict(server=server, resources=resources, rids=rids.reshape(R, C),
                cids=cids.reshape(R, C), names=names, churn_rows=churn_rows,
                churn_wants=churn_wants, capacity=capacity, kinds=kinds,
                strad=strad, srng=srng, walls=[], modes=[],
                k1=0, k2=0, k3=0)


def _fed_union_err(shards, rid, kind, variant):
    """One straddling resource's grants merged over both shards against
    the f64 oracle over the union of its clients at the configured
    capacity: max |grant - oracle| / max(capacity, max wants)."""
    import numpy as np

    from doorman_tpu_torch.algorithms.kinds import AlgoKind
    from doorman_tpu_torch.algorithms.tick import oracle_row

    lane = {(2, None): AlgoKind.PROPORTIONAL_SHARE,
            (3, None): AlgoKind.FAIR_SHARE,
            (3, "maxmin"): AlgoKind.MAX_MIN_FAIR,
            (2, "logutil"): AlgoKind.PROPORTIONAL_FAIRNESS,
            (3, "balanced"): AlgoKind.BALANCED_FAIRNESS}[(kind, variant)]
    rows = [row for sd in shards.values()
            for row in sd["server"].resources[rid].store.dump_rows()]
    has = np.array([r[3] for r in rows])
    wants = np.array([r[4] for r in rows])
    sub = np.array([float(r[5]) for r in rows])
    want = oracle_row(int(lane), FED_STRADDLE_CAP, 0.0, wants, has, sub)
    scale = max(FED_STRADDLE_CAP, float(wants.max()))
    return float(np.abs(has - want).max()) / scale, float(has.sum())


async def _fed_roots(torch, card, clock, live):
    """Two 1M-lease shard roots on the one card and the reconciliation
    beat: per-shard tick walls, the beat's ms, full vs scoped ticks and
    K1/K2 launches per shard, Σ shares within capacity at every beat,
    the straddling grants against the f64 oracle over the union, and
    store == device on converged rows. Returns the live roots (started
    on loopback) for the intermediate."""
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.federation import FederatedRoots, ShardRouter
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.solver import dense_cuda

    router = ShardRouter(2, straddle=[rid for rid, *_ in FED_STRADDLE])
    cfg = parse_yaml_config(_fed_root_yaml())
    shards, received = {}, {}
    t = time.perf_counter()
    for s in (0, 1):
        server = _fed_server(f"fed-root{s}", clock, s)
        live.append(server)
        received[s] = []
        serve = server.GetServerCapacity

        async def recorded(request, context, serve=serve, log=received[s]):
            log.append((request.server_id,
                        [r.resource_id for r in request.resource]))
            return await serve(request, context)

        # Bound before start: the servicer's handlers are looked up then.
        server.GetServerCapacity = recorded
        await server.start(0, host="127.0.0.1", tick_loop=False)
        server.current_master = f"127.0.0.1:{server.port}"
        await server.load_config(cfg)
        shards[s] = _fed_populate(server, s, clock)
    say(f"phase fed-roots[f32]: 2 shard roots, "
        f"{sum(sd['server']._store_engine.total_leases for sd in shards.values())}"
        f" leases on the card, populated in {time.perf_counter() - t:.1f}s; "
        f"card {card}")
    for sd in shards.values():
        # Per-resource templates landed outside the config: the device
        # capacity column must carry them.
        res = sd["resources"][7]
        check(res.capacity == sd["capacity"][7],
              f"fed-roots: {res.id} capacity {res.capacity}")
    fed = FederatedRoots(router, {s: sd["server"] for s, sd in shards.items()},
                         clock=clock)
    beat_ms, round_ms, worst_share = [], [], 0.0
    fed.reconcile_once()  # the bootstrap split, before any tick
    dense_cuda.reset_launches()  # the fed-roots path starts here
    n_churn = FED_WARMUP + FED_ROUNDS
    for rnd in range(n_churn + FED_QUIET):
        for s, sd in shards.items():
            engine = sd["server"]._store_engine
            if rnd < n_churn:
                sel = sd["churn_rows"][rnd]
                engine.bulk_refresh(
                    sd["rids"][sel].ravel(), sd["cids"][sel].ravel(),
                    np.full(sel.size * FED_C, clock() + 600.0),
                    np.full(sel.size * FED_C, float(FED_REFRESH)),
                    sd["churn_wants"][rnd])
                for rid, (s_rids, s_cids) in sd["strad"].items():
                    if sd["srng"].random() < 0.5:
                        engine.bulk_refresh(
                            s_rids, s_cids, np.full(FED_C, clock() + 600.0),
                            np.full(FED_C, float(FED_REFRESH)),
                            sd["srng"].integers(1, 100, FED_C).astype(
                                np.float64))
        t_round = time.perf_counter()
        for s, sd in shards.items():
            server = sd["server"]
            before = dict(dense_cuda.LAUNCHES)
            t = time.perf_counter()
            await server.tick_once()
            wall = time.perf_counter() - t
            torch.cuda.synchronize()
            if FED_WARMUP <= rnd < n_churn:
                sd["walls"].append(wall)
                mode = server._resident.last_solve_mode
                reason = server._resident.last_full_reason
                sd["modes"].append(f"full:{reason}" if mode == "full"
                                   and reason else mode)
            for k in ("k1", "k2", "k3"):
                sd[k] += dense_cuda.LAUNCHES[k] - before[k]
        t = time.perf_counter()
        installed = fed.reconcile_once()
        beat_ms.append((time.perf_counter() - t) * 1e3)
        if FED_WARMUP <= rnd < n_churn:
            round_ms.append((time.perf_counter() - t_round) * 1e3)
        for rid, _k, _v in FED_STRADDLE:
            total = sum(shards[s]["server"]._straddle_shares.get(rid, 0.0)
                        for s in (0, 1))
            check(total <= FED_STRADDLE_CAP * (1 + FED_SHARE_REL),
                  f"fed-roots: Σ shares of {rid} {total!r} at beat {rnd}")
            check(set(installed.get(rid, {})) == {0, 1},
                  f"fed-roots: beat {rnd} installed {installed.get(rid)}")
            worst_share = max(worst_share, total / FED_STRADDLE_CAP)
        clock.t += 1.0
    for _ in range(FED_SETTLE):
        for sd in shards.values():
            before = dict(dense_cuda.LAUNCHES)
            await sd["server"].tick_once()
            torch.cuda.synchronize()
            for k in ("k1", "k2", "k3"):
                sd[k] += dense_cuda.LAUNCHES[k] - before[k]
    torch.cuda.synchronize()
    launches = dict(dense_cuda.LAUNCHES)  # read just after
    out = {"shards": {}, "beat_ms": beat_ms, "round_ms": round_ms,
           "share_of_capacity": worst_share, "launches": launches}
    for s, sd in shards.items():
        server = sd["server"]
        err, worst, settling = _check_server_grants(
            torch, server, list(server.resources.values()))
        p50, p95 = _pcts(sd["walls"])
        full = sum(1 for m in sd["modes"] if m.startswith("full"))
        out["shards"][s] = dict(
            p50=p50, p95=p95, full=full, scoped=len(sd["modes"]) - full,
            modes=sorted(set(sd["modes"])), k1=sd["k1"], k2=sd["k2"],
            k3=sd["k3"], k1_vs_plain=err, oracle_err=worst,
            settling=settling, leases=int(server._store_engine.total_leases))
        say(f"phase fed-roots[f32] shard {s}: tick p50 {p50:.2f} ms p95 "
            f"{p95:.2f} ms over {FED_ROUNDS} rounds ("
            f"{'held' if p95 <= 100.0 else 'MISSED'}: lane limit 100 ms "
            f"p95), {full} full / {len(sd['modes']) - full} scoped "
            f"({sorted(set(sd['modes']))}), launches K1 {sd['k1']} K2 "
            f"{sd['k2']} over all {len(beat_ms)} rounds and {FED_SETTLE} "
            f"settle ticks; K1 vs plain "
            f"{err:.3g}, vs f64 oracle {worst:.3g}, {settling} sampled rows "
            f"settling; card {card}")
    worst_union = {}
    for rid, kind, variant in FED_STRADDLE:
        err, granted = _fed_union_err(shards, rid, kind, variant)
        worst_union[rid] = err
        check(err <= F32_PARITY_REL_BOUND,
              f"fed-roots: {rid} merged grants vs the f64 union oracle "
              f"{err:.3g} > {F32_PARITY_REL_BOUND:g}")
        check(granted <= FED_STRADDLE_CAP * (1 + 1e-6),
              f"fed-roots: {rid} grants {granted} past capacity")
    out["union_oracle_err"] = worst_union
    check(launches["k1"] + launches["k2"] > 0,
          f"fed-roots: launches {launches}")
    check(all(out["shards"][s]["k2"] > 0 for s in (0, 1)),
          "fed-roots: no K2 on a config-epoch full tick")
    say(f"phase fed-roots[f32]: round wall p50 / p95 "
        f"{_pcts([x / 1e3 for x in round_ms])[0]:.2f} / "
        f"{_pcts([x / 1e3 for x in round_ms])[1]:.2f} ms, reconcile beat "
        f"p50 / p95 {_pcts([x / 1e3 for x in beat_ms])[0]:.3f} / "
        f"{_pcts([x / 1e3 for x in beat_ms])[1]:.3f} ms "
        f"({len(FED_STRADDLE)} straddling resources), Σ shares at most "
        f"{worst_share:.9f} of capacity, merged straddling grants vs the "
        f"f64 union oracle {max(worst_union.values()):.3g}; card {card}")
    return out, shards, router, received


def _agg_numpy(wants, subs, bands, band_vals):
    """{row: [(band, Σ wants, Σ subclients rounded)]} of the rows' nonzero
    band sums: the per-band sum the adapter's device sums are held to."""
    import numpy as np

    out = {}
    ws = np.stack([np.where(bands == b, wants, 0.0).sum(1) for b in band_vals])
    cs = np.stack([np.where(bands == b, subs, 0.0).sum(1) for b in band_vals])
    for b, r in zip(*np.nonzero(ws)):
        out.setdefault(int(r), []).append(
            (int(band_vals[b]), float(ws[b, r]), int(round(cs[b, r]))))
    return out


def _fed_aggregate(torch, card):
    """The AggregationTickAdapter on the card over 10,000 resources x 100
    children at four priorities: one rebuild dispatch, then 10 dirty
    ticks at 5% churn, at f32 and f64; totals against numpy per-band
    sums, and the f64 adapter against the native store's band_aggregates
    on the same leases."""
    import numpy as np

    from doorman_tpu_torch import native
    from doorman_tpu_torch.federation import AggregationTickAdapter
    from doorman_tpu_torch.federation.aggregate import band_sums

    R, C = FED_R, FED_C
    rng = np.random.default_rng(1300)
    wants0 = rng.integers(0, 100, (R, C)).astype(np.float64)
    subs = rng.integers(1, 4, (R, C)).astype(np.float64)
    bands = rng.choice(np.asarray(PRIORITIES), (R, C)).astype(np.int32)
    churn = max(R // 20, 1)
    picks = [rng.choice(R, churn, replace=False) for _ in range(AGG_TICKS)]
    news = [rng.integers(0, 100, (churn, C)).astype(np.float64)
            for _ in range(AGG_TICKS)]
    ids = [f"ag.r{r}" for r in range(R)]
    band_vals = np.asarray(sorted(PRIORITIES), np.int32)
    out = {}
    for dtype_name, dtype in (("f32", np.float32), ("f64", np.float64)):
        agg = AggregationTickAdapter(dtype=dtype, device=DEVICE)
        check(agg.device.type == torch.device(DEVICE).type,
              f"aggregate: adapter on {agg.device}")
        wants = wants0.copy()
        walls, laps, worst = [], [], 0.0
        for t in range(1 + AGG_TICKS):
            rows = range(R) if t == 0 else picks[t - 1]
            if t:
                wants[picks[t - 1]] = news[t - 1]
            before = dict(agg.phase_s)
            t0 = time.perf_counter()
            for r in rows:
                agg.update(ids[r], wants[r], subs[r], bands[r])
            got = agg.step()
            walls.append((time.perf_counter() - t0) * 1e3)
            laps.append({k: (v - before[k]) * 1e3
                         for k, v in agg.phase_s.items() if v > before[k]})
            want = _agg_numpy(wants, subs, bands, band_vals)
            check(len(got) == len(want),
                  f"aggregate[{dtype_name}] tick {t}: {len(got)} resources "
                  f"vs {len(want)}")
            for r, bl in want.items():
                g = got.get(ids[r])
                check(g is not None and [(b, c) for b, _w, c in g]
                      == [(b, c) for b, _w, c in bl],
                      f"aggregate[{dtype_name}]: {ids[r]} bands {g} vs {bl}")
                for (_b, gw, _c), (_b2, ww, _c2) in zip(g, bl):
                    gap = abs(gw - ww)
                    # Integer wants below 2^24 sum exactly at f32 as at
                    # f64; the stated bound is the order bound
                    # 2 (K - 1) u of the sum.
                    bound = 2 * (C - 1) * np.finfo(dtype).eps / 2 * ww
                    check(gap <= bound if dtype_name == "f32" else gap == 0,
                          f"aggregate[{dtype_name}]: {ids[r]} {gw} vs {ww}")
                    worst = max(worst, gap / max(ww, 1.0))
        if torch.device(DEVICE).type == "cuda":
            dev_ms = _time_ms(torch, lambda: band_sums(
                agg._wants_d, agg._weights_d, agg._bands_d, agg._band_vals_d))
        else:
            dev_ms = None
        nbytes = (agg._wants_d.numel() * agg._wants_d.element_size() * 2
                  + agg._bands_d.numel() * 4
                  + 2 * len(band_vals) * agg._wants_d.shape[0]
                  * agg._wants_d.element_size())
        dirty = laps[1:]
        mean = {k: sum(l.get(k, 0.0) for l in dirty) / len(dirty)
                for k in sorted({k for l in dirty for k in l})}
        cells = sum(len(v) for v in got.values())
        out[dtype_name] = dict(
            rebuild_ms=walls[0], rebuild_laps=laps[0], dirty_ms=walls[1:],
            dirty_laps_mean=mean, aggregate_device_ms=dev_ms,
            bound_ms=nbytes / H100_BYTES_PER_S * 1e3, cells=cells,
            max_rel_err=worst, table=list(agg._wants_d.shape))
        say(f"phase aggregate[{dtype_name}]: {R} x {C} on {agg.device} "
            f"(table {list(agg._wants_d.shape)}, {cells} nonzero band "
            f"cells): rebuild tick {walls[0]:.1f} ms {laps[0]}, dirty ticks "
            f"p50 {float(np.median(walls[1:])):.2f} ms, mean laps ms "
            f"{ {k: round(v, 3) for k, v in mean.items()} }; the masked "
            f"sum's device time "
            f"{'%.4f ms' % dev_ms if dev_ms is not None else 'not measured'}"
            f" (bytes bound {out[dtype_name]['bound_ms']:.4f} ms); max rel "
            f"err vs numpy {worst:.3g}; card {card}")
    # The f64 adapter's last totals against the native store's own C
    # aggregation of the same leases.
    engine = native.StoreEngine()
    stores = [engine.store(i) for i in ids]
    rids = np.repeat([s._rid for s in stores], C).astype(np.int32)
    cids = np.fromiter((engine.client_handle(f"ag.c{i}") for i in range(R * C)),
                       np.int64, count=R * C)
    engine.bulk_assign(rids, cids, np.full(R * C, time.time() + 600.0),
                       np.full(R * C, 1.0), np.zeros(R * C), wants.ravel(),
                       subs.ravel().astype(np.int32),
                       priority=bands.ravel().astype(np.int64))
    mism = 0
    for r, store in enumerate(stores):
        want = [(p, w, n) for p, w, n in sorted(store.band_aggregates())
                if w > 0]
        if got.get(ids[r], []) != want:
            mism += 1
    check(mism == 0, f"aggregate: {mism} resources differ from "
          "band_aggregates")
    say(f"phase aggregate: the f64 adapter's totals equal band_aggregates "
        f"on the native store for all {R} resources; card {card}")
    return out


async def _fed_intermediate(torch, card, clock, shards, router, received):
    """A FederatedIntermediate on the card over 1,000 resources x 100
    clients at four priorities (100 of them PRIORITY_BANDS on the roots),
    its upstream the two shard roots over loopback gRPC through
    ShardDiscovery: one GetServerCapacity per root per exchange carrying
    only its resources, the roots' band sub-leases equal to the
    intermediate's aggregates, the roots' next ticks launching K3, the
    intermediate's capacities equal to the roots' grants; then one root
    blocked, the other's resources unaffected."""
    import random
    import socket

    import numpy as np

    from doorman_tpu_torch.federation import (
        FederatedIntermediate,
        ShardDiscovery,
        ShardRouter,
    )
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import _band_key
    from doorman_tpu_torch.solver import dense_cuda

    roots = {s: sd["server"] for s, sd in shards.items()}
    addrs = {s: f"127.0.0.1:{r.port}" for s, r in roots.items()}
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_addr = f"127.0.0.1:{dead.getsockname()[1]}"
    dead.close()

    current = dict(addrs)  # where each shard's master answers

    async def resolver(shard, _seeds):
        return current[shard]

    discovery = ShardDiscovery(addrs, resolver=resolver, clock=clock,
                               rng=random.Random(0))
    inter = FederatedIntermediate(
        "fed-inter", TrivialElection(), router=ShardRouter(2),
        discovery=discovery, mode="batch", native_store=True,
        solver_dtype="f32", tick_interval=1.0, minimum_refresh_interval=1.0,
        clock=clock, flightrec_capacity=0, device=DEVICE,
    )
    check(inter.aggregator.device == inter.device,
          f"fed-intermediate: aggregator on {inter.aggregator.device}")
    await inter.start(0, host="127.0.0.1", tick_loop=False)
    for task in inter._tasks:  # the exchanges are driven here
        task.cancel()
    inter._tasks.clear()
    inter.became_master_at = clock() - 3600.0  # out of learning mode
    rng = np.random.default_rng(1400)
    ids = [f"fi.p.r{i}" if i < FI_PRIO else f"fi.l.r{i}"
           for i in range(FI_RES)]
    res = [inter.get_or_create_resource(i) for i in ids]
    engine = inter._store_engine
    C = FED_C
    rids = np.repeat([r.store._rid for r in res], C).astype(np.int32)
    cids = np.fromiter((engine.client_handle(f"fi.c{i}")
                        for i in range(FI_RES * C)), np.int64,
                       count=FI_RES * C)
    n = FI_RES * C
    engine.bulk_assign(rids, cids, np.full(n, clock() + 600.0),
                       np.full(n, 1.0), np.zeros(n),
                       rng.integers(0, 100, n).astype(np.float64),
                       np.ones(n, np.int32),
                       priority=rng.choice(np.asarray(PRIORITIES), n))
    captured = {}
    aggregate = inter._aggregate_demand

    def capture():
        captured["agg"] = aggregate()
        return captured["agg"]

    inter._aggregate_demand = capture
    exch_ms, k = [], {"k1": 0, "k2": 0, "k3": 0}
    root_k3 = {0: 0, 1: 0}
    try:
        for ex in range(FI_EXCHANGES):
            for log in received.values():
                log.clear()
            t = time.perf_counter()
            _interval, retry = await inter._perform_parent_requests(0)
            exch_ms.append((time.perf_counter() - t) * 1e3)
            check(retry == 0, f"fed-intermediate: exchange {ex} failed")
            agg = captured["agg"]
            for s, log in received.items():
                check(len(log) == 1, f"fed-intermediate: root {s} got "
                      f"{len(log)} requests in exchange {ex}")
                sid, rids_seen = log[0]
                check(sid == inter.id and rids_seen and all(
                    router.shard_of(r) == s for r in rids_seen),
                      f"fed-intermediate: root {s} got foreign resources")
            check(sorted(r for _s, l in received.items() for r in l[0][1])
                  == sorted(agg), "fed-intermediate: requests vs aggregates")
            for rid, bl in agg.items():
                root = roots[router.shard_of(rid)]
                store = root.resources[rid].store
                granted = 0.0
                for p, w, nc in bl:
                    lease = store.get(_band_key(inter.id, p))
                    check(lease.wants == w and lease.subclients == max(nc, 1),
                          f"fed-intermediate: {rid} band {p} on the root "
                          f"{lease.wants}/{lease.subclients} vs {w}/{nc}")
                    granted += lease.has
                cap = inter.resources[rid].capacity
                check(cap == granted, f"fed-intermediate: {rid} capacity "
                      f"{cap} vs the root's grants {granted}")
            # The roots' next ticks solve the band rows: K3 on the
            # PRIORITY_BANDS resources, K1/K2 on the lane ones.
            for s, root in roots.items():
                before = dict(dense_cuda.LAUNCHES)
                await root.tick_once()
                torch.cuda.synchronize()
                root_k3[s] += dense_cuda.LAUNCHES["k3"] - before["k3"]
                for key in k:
                    k[key] += dense_cuda.LAUNCHES[key] - before[key]
            before = dict(dense_cuda.LAUNCHES)
            await inter.tick_once()
            torch.cuda.synchronize()
            for key in k:
                k[key] += dense_cuda.LAUNCHES[key] - before[key]
            pick = rng.choice(FI_RES, FI_RES // 20, replace=False)
            m = pick.size * C
            engine.bulk_refresh(
                rids.reshape(FI_RES, C)[pick].ravel(),
                cids.reshape(FI_RES, C)[pick].ravel(),
                np.full(m, clock() + 600.0), np.full(m, 1.0),
                rng.integers(0, 100, m).astype(np.float64))
            clock.t += 1.0
        owners = {r: router.shard_of(r) for r in ids}
        check(all(root_k3[s] > 0 for s in (0, 1)
                  if any(o == s for r, o in owners.items()
                         if r.startswith("fi.p"))),
              f"fed-intermediate: roots' K3 launches {root_k3}")
        # Block root 1: its discovery entry points at a closed port.
        current[1] = dead_addr
        discovery.invalidate(1)
        inter._shard_conns.pop(1, None)
        before_caps = {r: inter.resources[r].capacity for r in ids}
        for log in received.values():
            log.clear()
        _interval, retry = await inter._perform_parent_requests(0)
        check(retry == 1, f"fed-intermediate: blocked exchange retry {retry}")
        check(len(received[0]) == 1 and not received[1],
              f"fed-intermediate: blocked exchange reached "
              f"{[len(l) for l in received.values()]} roots")
        agg = captured["agg"]
        unaffected = 0
        for rid in ids:
            if owners[rid] != 0 or rid not in agg:
                continue
            store = roots[0].resources[rid].store
            granted = sum(store.get(_band_key(inter.id, p)).has
                          for p, _w, _n in agg[rid])
            check(inter.resources[rid].capacity == granted,
                  f"fed-intermediate: {rid} on the live root "
                  f"{inter.resources[rid].capacity} vs {granted}")
            unaffected += 1
        lost = sum(1 for r in ids if owners[r] == 1
                   and inter.resources[r].capacity != before_caps[r])
        p50, p95 = _pcts([x / 1e3 for x in exch_ms])
        say(f"phase fed-intermediate: {FI_RES} resources x {C} clients "
            f"({FI_PRIO} PRIORITY_BANDS), {FI_EXCHANGES} exchanges with the "
            f"two 1M-lease roots: exchange p50 {p50:.2f} ms p95 {p95:.2f} "
            f"ms; roots' K3 launches {root_k3}; launches {k}; root 1 "
            f"blocked: {unaffected} resources of root 0 re-granted, "
            f"{lost} of root 1 moved (the reference's merged template "
            f"load: they fall to the default template); card {card}")
        return dict(exchange_ms=exch_ms, p50=p50, p95=p95, root_k3=root_k3,
                    launches=k, blocked_unaffected=unaffected,
                    blocked_moved=lost,
                    aggregate_laps={kk: v * 1e3 for kk, v in
                                    inter.aggregator.phase_s.items() if v})
    finally:
        await inter.stop()


async def _fed_cell(torch, card):
    clock = _FakeClock(time.time())
    live = []  # the roots, stopped however the cell ends
    try:
        roots_out, shards, router, received = await _fed_roots(
            torch, card, clock, live)
        inter = await _fed_intermediate(torch, card, clock, shards, router,
                                        received)
    finally:
        for server in live:
            await server.stop()
    return roots_out, inter


def phase_federation(torch, card):
    """Federation: fed-parity (f64), fed-roots (f32, 2 x 1M leases),
    aggregate (f32, f64) and fed-intermediate. Returns each sub-path's
    K1/K2/K3 launches under `launches` for the kernels line."""
    parity = asyncio.run(_fed_parity(torch, card))
    roots, inter = asyncio.run(_fed_cell(torch, card))
    agg = _fed_aggregate(torch, card)
    launches = {
        "fed-parity f64": parity["launches"],
        "fed-roots f32": roots["launches"],
        "fed-intermediate": inter["launches"],
    }
    total = {k: sum(v[k] for v in launches.values())
             for k in ("k1", "k2", "k3")}
    check(all(total[k] > 0 for k in total),
          f"federation: a kernel never launched on its paths {launches}")
    return dict(parity=parity, roots=roots, intermediate=inter,
                aggregate=agg, launches=launches, total=total)


def phase_takeover(torch, card):
    """Persistence and warm master takeover at the lane cell's full size,
    the priority cell's takeover, and the server binary failing over
    under an etcd election."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        lane = asyncio.run(_tk_lane(torch, card, tmp))
        prio = asyncio.run(_tk_prio(torch, card, tmp))
    binary = asyncio.run(_tk_binary(card))
    return dict(lane=lane, prio=prio, binary=binary)


# -- phases 24-28: admission, the forecaster, the frontend pool ----------------

# admission-fused: the lane cell at f32 on the native store, every churn
# tick's 5% of resources (500 x 100 = 50,000 refreshes) sent through the
# coalescer's windows, beside a twin whose windows do not stage.
# Warm-up, churn, quiet. Four warm-up ticks, not the two asked for: at
# pipeline depth 3 the first tick applies on the fourth, and until then
# every refresh is a first-response decide (a full upload, which the
# fused tick packs afresh), so the cache serves from the first churn tick.
AF_TICKS = (4, 3, 4)  # churn cut 6 -> 3 for the fleet and TLS phases' time
AF_WINDOW = 0.005  # the coalescer's window (cmd/server.py's default)
AF_CHUNK = 5_000  # refreshes submitted together: a window each
AF_WINDOW_BUDGET_S = 3.0  # the windows' time a tick worth writing down

# admission-storm: bench.py's bench_server_rpc_storm.
STORM_CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 1000000
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
"""
STORM_WORKERS = 48
STORM_PROCS = 4
STORM_SECONDS = 2.0
STORM_CALIB_SECONDS = 0.8
STORM_SATURATION = 3.0  # off p99 >= this x the one-worker p50
STORM_BANDS = (0, 1, 2)
STORM_RELEASE_EVERY = 25  # a worker's release between its refreshes

# forecast: the flash-crowd scenario's predictive config
# (doorman_tpu/workload/scenarios.py:260-289).
FC_SERIES, FC_PERIOD, FC_ALPHA, FC_BETA, FC_TICKS = 2, 16, 0.25, 0.5, 60

# frontend-parity: bench.py's frontend pool shape (:2263-2264) on the
# streams phase's lane cell (its unscoped pair's filtered server).
FE_WORKERS = 4
FE_RING_BYTES = 4 << 20

# frontend-pool: bench.py's bench_server_frontend, its held population
# cut from 1,000,000 to 100,000 streams, its push ticks from 30 to 10 and
# its hold from 90 s to 24 s for the run's time.
FP_CORES_NEEDED = FE_WORKERS + 2
FP_EST_SECONDS = 5.0
FP_EST_FLOOR = 50_000.0  # establishments/s (bench.py FRONTEND_EST_FLOOR)
FP_HELD_TARGET = 100_000
FP_HOLD_SECONDS = 12.0  # cut 24 -> 12 for the fleet and TLS phases' time
FP_PUSH_TICKS = 6  # cut 10 -> 6, likewise
FP_TICK_INTERVAL = 1.0
FP_READY_SECONDS = 60.0
FP_SUBS_PER_RESOURCE = 50  # bench.py FANOUT_SUBS_PER_RESOURCE
FP_CHURN_WANTS = (1_000.0, 1.0)  # the sentinel row's churner, alternating
FP_PUSH_EDGES = 5  # tick edges a churned sentinel may wait for its push
# bench.py's template, and the sentinel's row on a 1 s refresh: the
# resident tick delivers a row's moved grant on the delivery rotation of
# the config's fastest refresh, so the sentinel's push can ride the tick
# that moved it (on the reference's Python store every tick delivers).
FP_CONFIG = """
resources:
- identifier_glob: sentinel
  capacity: 600
  safe_capacity: 1
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
- identifier_glob: "*"
  capacity: 600
  safe_capacity: 1
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 7200,
              refresh_interval: 3600, learning_mode_duration: 0}
"""


def _af_requests(pb, rng, server, resources, cids):
    """One churn tick's refreshes: CHURN resources picked as _churn picks
    them, each of their N_CLIENTS clients with new wants and, as `has`,
    the grant its lease holds (one bulk pack of the picked stores), as a
    refreshing client sends them."""
    pick = rng.choice(N_RES, CHURN, replace=False)
    wants = rng.integers(0, 100, CHURN * N_CLIENTS).astype(float)
    ridx, cid, _w, has, _s, _p = server._store_engine.pack(
        [resources[i].store for i in pick])
    held = dict(zip(zip(ridx.tolist(), cid.tolist()), has.tolist()))
    reqs = []
    k = 0
    for n, i in enumerate(pick):
        rid = resources[i].id
        for c in range(N_CLIENTS):
            req = pb.GetCapacityRequest(client_id=f"c{i}.{c}")
            rr = req.resource.add()
            # Priority 0: the populated leases' (a changed priority
            # would make the row a full upload).
            rr.resource_id, rr.wants, rr.priority = rid, wants[k], 0
            rr.has.capacity = held[(n, int(cids[i, c]))]
            reqs.append(req)
            k += 1
    return reqs


async def _af_windows(server, reqs):
    """The refreshes through the admission coalescer (serve_get_capacity:
    the admitted path), AF_CHUNK at a time; (capacity, safe_capacity)
    of every answer, in order."""
    adm = server._admission
    out = []
    for at in range(0, len(reqs), AF_CHUNK):
        chunk = reqs[at:at + AF_CHUNK]
        got = await asyncio.gather(
            *(adm.serve_get_capacity(r) for r in chunk))
        out += [(g.response[0].gets.capacity, g.response[0].safe_capacity)
                for g in got]
    return out


async def _admission_fused(torch, card):
    import random

    import numpy as np

    from doorman_tpu_torch.admission import Admission
    from doorman_tpu_torch.proto import doorman_pb2 as pb
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    warm, churn, quiet = AF_TICKS
    side = {}
    try:
        for name, fuse in (("fused", True), ("unfused", False)):
            server = CapacityServer(
                f"af-{name}", TrivialElection(), mode="batch",
                native_store=True, solver_dtype="f32", tick_interval=1.0,
                tick_pipeline_depth=3, flightrec_capacity=0,
                admission=Admission(coalesce_window=AF_WINDOW,
                                    rng=random.Random(71)),
                fuse_admission=fuse, device=DEVICE)
            side[name] = dict(server=server, walls=[], windows=[],
                              launches=[], pack=[], staging=[],
                              staged=[], hits=[])
            await server.start(0, host="127.0.0.1", tick_loop=False)
            await server.load_config(parse_yaml_config(_config_yaml()))
            resources, _r, cids = _populate(server,
                                            np.random.default_rng(70))
            side[name].update(resources=resources, cids=cids)
        fu, un = side["fused"], side["unfused"]
        check(fu["server"]._resident is None, "solver built before a tick")
        rng = np.random.default_rng(72)
        for tick in range(warm + churn + quiet):
            reqs = (_af_requests(pb, rng, fu["server"], fu["resources"],
                                 fu["cids"])
                    if warm <= tick < warm + churn else [])
            answers = {}
            for name, s in side.items():
                server = s["server"]
                solver = server._resident
                staged0 = (solver.staging.status()["staged_rows_total"]
                           if solver is not None and solver.staging is not None
                           else 0)
                t = time.perf_counter()
                answers[name] = await _af_windows(server, reqs)
                s["windows"].append(time.perf_counter() - t)
                solver = server._resident
                ph0 = dict(solver.phase_s) if solver is not None else {}
                dense_cuda.reset_launches()  # this twin's tick starts here
                t = time.perf_counter()
                await server.tick_once()
                torch.cuda.synchronize()
                s["walls"].append(time.perf_counter() - t)
                s["launches"].append(dict(dense_cuda.LAUNCHES))
                solver = server._resident
                for lap in ("pack", "staging"):
                    s[lap].append((solver.phase_s[lap] - ph0.get(lap, 0.0))
                                  * 1e3)
                if solver.staging is not None:
                    s["staged"].append(
                        solver.staging.status()["staged_rows_total"]
                        - staged0)
                    s["hits"].append(int(solver.last_fused["rows"]))
            check(answers["fused"] == answers["unfused"],
                  f"admission-fused: tick {tick + 1}: the twins answered "
                  "differently")
            diff = _byte_diff(_packed_has(fu["server"]),
                              _packed_has(un["server"]))
            check(diff == 0, f"admission-fused: tick {tick + 1}: {diff} "
                  "leases differ between the twins' stores")
            check(torch.equal(fu["server"]._resident.table().has,
                              un["server"]._resident.table().has),
                  f"admission-fused: tick {tick + 1}: device grants differ")
            check(fu["launches"][-1] == un["launches"][-1],
                  f"admission-fused: tick {tick + 1}: launches "
                  f"{fu['launches'][-1]} != {un['launches'][-1]}")
            if warm <= tick < warm + churn:
                check(fu["staged"][-1] > 0 and fu["hits"][-1] > 0,
                      f"admission-fused: churn tick {tick + 1}: staged "
                      f"{fu['staged'][-1]} rows, {fu['hits'][-1]} served "
                      "from the cache")
        for s in side.values():
            await s["server"].flush_ticks()
        diff = _byte_diff(_packed_has(fu["server"]), _packed_has(un["server"]))
        check(diff == 0, f"admission-fused: {diff} leases differ after the "
              "flush")
        check(un["server"]._resident.staging is None,
              "admission-fused: the unfused twin staged")
        out = dict(leases=int(fu["server"]._store_engine.total_leases),
                   refreshes_per_churn_tick=CHURN * N_CLIENTS)
        churn_sl = slice(warm, warm + churn)
        for name, s in side.items():
            p50, p95 = _pcts(s["walls"][churn_sl])
            win = [w * 1e3 for w in s["windows"][churn_sl]]
            k = {key: sum(x[key] for x in s["launches"]) for key in
                 ("k1", "k2", "k3")}
            out[name] = dict(
                tick_p50_ms=p50, tick_p95_ms=p95,
                walls_ms=[w * 1e3 for w in s["walls"]], windows_ms=win,
                pack_ms=s["pack"], staging_ms=s["staging"], launches=k,
                staged_rows=s["staged"], cache_hits=s["hits"],
                coalescer=s["server"]._admission.coalescer.status())
        over = [w for w in out["fused"]["windows_ms"]
                if w > AF_WINDOW_BUDGET_S * 1e3]
        fmt = lambda xs: [round(x, 2) for x in xs]  # noqa: E731
        say(f"phase admission-fused: {out['leases']} leases, {warm} warm-up, "
            f"{churn} churn ({CHURN * N_CLIENTS} refreshes a tick through "
            f"the coalescer, {AF_CHUNK} a submission, window {AF_WINDOW}s) and "
            f"{quiet} quiet ticks on each twin: answers, stores and device "
            f"grants equal after every tick, launches equal "
            f"{out['fused']['launches']}; fused twin staged rows "
            f"{fu['staged'][churn_sl]}, cache hits {fu['hits'][churn_sl]}; "
            f"churn tick p50 / p95 fused {out['fused']['tick_p50_ms']:.2f} / "
            f"{out['fused']['tick_p95_ms']:.2f} ms, unfused "
            f"{out['unfused']['tick_p50_ms']:.2f} / "
            f"{out['unfused']['tick_p95_ms']:.2f} ms; pack ms fused "
            f"{fmt(fu['pack'][churn_sl])} unfused {fmt(un['pack'][churn_sl])}; "
            f"staging ms fused {fmt(fu['staging'][churn_sl])} unfused "
            f"{fmt(un['staging'][churn_sl])}; windows ms a churn tick fused "
            f"{fmt(out['fused']['windows_ms'])} unfused "
            f"{fmt(out['unfused']['windows_ms'])}; card {card}")
        if over:
            say(f"phase admission-fused: the windows took more than "
                f"{AF_WINDOW_BUDGET_S:.0f} s on {len(over)} of {churn} churn "
                f"ticks ({fmt(over)} ms): written down, traffic kept")
        out["windows_over_budget"] = len(over)
        return out
    finally:
        for s in side.values():
            await s["server"].stop()


# -- the storm's client processes (spawned: this module's top level imports
# nothing heavier than the standard library) ----------------------------------

def _percentile(sorted_values, q):
    """Nearest-rank percentile of an ascending list (0 when empty)."""
    if not sorted_values:
        return 0.0
    idx = min(len(sorted_values) - 1,
              max(0, int(round(q * (len(sorted_values) - 1)))))
    return sorted_values[idx]


def _retry_hint(err, key):
    for k, v in err.trailing_metadata() or ():
        if k == key:
            return v
    return None


async def _poll_storm(addr, workers, index_base, duration, bands, seed):
    """Closed-loop GetCapacity workers (bands round-robin), honouring the
    retry-after hint with the client's half jitter; every
    STORM_RELEASE_EVERY-th call of a worker is a ReleaseCapacity."""
    import random

    import grpc

    from doorman_tpu_torch.admission.policy import RETRY_AFTER_KEY
    from doorman_tpu_torch.proto import doorman_pb2 as pb
    from doorman_tpu_torch.proto.grpc_api import CapacityStub

    st = dict(ok=0, shed=0, errors=0, shed_no_hint=0, releases=0,
              release_shed=0, ok_by_band={}, shed_by_band={}, lat={})
    deadline = time.monotonic() + duration
    rng = random.Random(seed)

    async def worker(i):
        band = bands[(index_base + i) % len(bands)]
        wrng = random.Random(rng.random())
        async with grpc.aio.insecure_channel(addr) as ch:
            stub = CapacityStub(ch)
            req = pb.GetCapacityRequest(client_id=f"storm-{index_base + i}")
            rr = req.resource.add()
            rr.resource_id, rr.wants, rr.priority = "storm", 10.0, band
            n = 0
            while time.monotonic() < deadline:
                n += 1
                if n % STORM_RELEASE_EVERY == 0:
                    try:
                        await stub.ReleaseCapacity(pb.ReleaseCapacityRequest(
                            client_id=req.client_id, resource_id=["storm"]))
                        st["releases"] += 1
                    except grpc.aio.AioRpcError as e:
                        if e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED:
                            st["release_shed"] += 1
                        else:
                            st["errors"] += 1
                    rr.ClearField("has")
                    continue
                t0 = time.monotonic()
                try:
                    out = await stub.GetCapacity(req)
                    lat = time.monotonic() - t0
                    st["ok"] += 1
                    st["ok_by_band"][band] = st["ok_by_band"].get(band, 0) + 1
                    st["lat"].setdefault(band, []).append(lat)
                    rr.has.CopyFrom(out.response[0].gets)
                except grpc.aio.AioRpcError as e:
                    if e.code() != grpc.StatusCode.RESOURCE_EXHAUSTED:
                        st["errors"] += 1
                        continue
                    st["shed"] += 1
                    st["shed_by_band"][band] = (
                        st["shed_by_band"].get(band, 0) + 1)
                    hint = _retry_hint(e, RETRY_AFTER_KEY)
                    if hint is None or hint != f"{float(hint):.3f}":
                        st["shed_no_hint"] += 1
                        hint = "1.0"
                    h = float(hint)
                    await asyncio.sleep(min(
                        0.5 * h + wrng.uniform(0, 0.5 * h),
                        max(deadline - time.monotonic(), 0.0)))

    t = time.monotonic()
    await asyncio.gather(*(worker(i) for i in range(workers)))
    st["duration_s"] = time.monotonic() - t
    return st


async def _stream_storm(addr, workers, index_base, duration, bands, seed,
                        streams_per_worker, spread, ramp=64):
    """WatchCapacity workers, each holding up to `streams_per_worker`
    streams over one channel and opening at most `ramp` at a time
    (bench.py's mux worker): ok counts establishments (the first message
    of a stream), pushes every message; a shed honours the retry-after
    hint before that stream reopens. Streams stay held until the end."""
    import random
    from collections import deque

    import grpc

    from doorman_tpu_torch.admission.policy import RETRY_AFTER_KEY
    from doorman_tpu_torch.proto import doorman_stream_pb2 as spb
    from doorman_tpu_torch.proto.grpc_api import CapacityStub

    st = dict(ok=0, shed=0, errors=0, shed_no_hint=0, pushes=0, resets=0,
              ok_by_band={}, shed_by_band={}, lat={})
    deadline = time.monotonic() + duration
    rng = random.Random(seed)

    async def worker(i):
        wrng = random.Random(rng.random())
        async with grpc.aio.insecure_channel(
                addr, options=(("grpc.use_local_subchannel_pool", 1),)) as ch:
            stub = CapacityStub(ch)
            done_q = asyncio.Queue()
            streams = []
            for j in range(streams_per_worker):
                gi = (index_base + i) * streams_per_worker + j
                band = bands[gi % len(bands)]
                req = spb.WatchCapacityRequest(
                    client_id=f"storm-{index_base + i}-{j}")
                rr = req.resource.add()
                rr.resource_id = f"storm-{gi % spread}"
                rr.wants, rr.priority = 5.0, band
                streams.append(dict(req=req, band=band, call=None, fut=None,
                                    est=False, t0=0.0, wake=0.0))
            unopened, waking, opening = deque(streams), [], 0

            def close(s, wake_in):
                if s["fut"] is not None:
                    s["fut"].cancel()
                    s["fut"] = None
                if s["call"] is not None:
                    s["call"].cancel()
                    s["call"] = None
                s["est"] = False
                s["wake"] = time.monotonic() + wake_in
                waking.append(s)

            def read(s):
                s["fut"] = asyncio.ensure_future(s["call"].read())
                s["fut"].add_done_callback(
                    lambda f, s=s: done_q.put_nowait((f, s)))

            try:
                while True:
                    now = time.monotonic()
                    if now >= deadline:
                        return
                    still = []
                    for s in waking:
                        (unopened.append if s["wake"] <= now
                         else still.append)(s)
                    waking[:] = still
                    while unopened and opening < ramp:
                        s = unopened.popleft()
                        s["t0"] = time.monotonic()
                        s["call"] = stub.WatchCapacity(s["req"])
                        read(s)
                        opening += 1
                    try:
                        fut, s = await asyncio.wait_for(
                            done_q.get(), timeout=max(min(
                                deadline - now, 0.05), 0.01))
                    except asyncio.TimeoutError:
                        continue
                    if s["fut"] is not fut:
                        continue
                    s["fut"] = None
                    if not s["est"]:
                        opening -= 1
                    try:
                        msg = fut.result()
                    except asyncio.CancelledError:
                        continue
                    except grpc.aio.AioRpcError as e:
                        if e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED:
                            st["shed"] += 1
                            b = s["band"]
                            st["shed_by_band"][b] = (
                                st["shed_by_band"].get(b, 0) + 1)
                            hint = _retry_hint(e, RETRY_AFTER_KEY)
                            if hint is None:
                                st["shed_no_hint"] += 1
                                hint = "1.0"
                            h = float(hint)
                            close(s, 0.5 * h + wrng.uniform(0, 0.5 * h))
                        else:
                            st["errors"] += 1
                            close(s, 0.2)
                        continue
                    if msg is grpc.aio.EOF or msg.HasField("mastership"):
                        st["resets"] += 1
                        close(s, 0.0)
                        continue
                    if not s["est"]:
                        s["est"] = True
                        st["ok"] += 1
                        b = s["band"]
                        st["ok_by_band"][b] = st["ok_by_band"].get(b, 0) + 1
                        st["lat"].setdefault(b, []).append(
                            time.monotonic() - s["t0"])
                    st["pushes"] += 1
                    s["req"].resume_seq = max(s["req"].resume_seq,
                                              int(msg.seq))
                    mine = s["req"].resource[0]
                    for row in msg.response:
                        if row.resource_id == mine.resource_id:
                            mine.has.CopyFrom(row.gets)
                    read(s)
            finally:
                # End every call and let its read settle while the
                # channel is still open: a read left pending past the
                # loop's close can hang the interpreter's exit.
                pending = [s["fut"] for s in streams if s["fut"] is not None]
                for s in streams:
                    if s["call"] is not None:
                        s["call"].cancel()
                for f in pending:
                    f.cancel()
                await asyncio.gather(*pending, return_exceptions=True)

    t = time.monotonic()
    await asyncio.gather(*(worker(i) for i in range(workers)))
    st["duration_s"] = time.monotonic() - t
    return st


def _storm_child(out_q, kind, kwargs):
    """Spawned storm process: one event loop's share of the workers. The
    result is flushed to the parent and the process ends at once: with
    many streams cancelled at the deadline, grpc's teardown at the event
    loop's close can block the interpreter's exit."""
    import os

    async def run():
        fn = _poll_storm if kind == "poll" else _stream_storm
        try:
            out_q.put(await fn(**kwargs))
        except Exception as exc:  # reported to the parent, which fails
            out_q.put({"error": f"{type(exc).__name__}: {exc}"})
        out_q.close()
        out_q.join_thread()
        os._exit(0)

    sys.path.insert(0, str(ROOT))
    asyncio.run(run())


def _storm(kind, addr, *, procs, workers, duration, bands, seed, **kw):
    """`workers` storm workers split over `procs` spawned processes; the
    merged counts, goodput and exact latency percentiles by band.
    Blocking: run it off the serving loop."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    children, base = [], 0
    share, extra = divmod(workers, procs)
    for p in range(procs):
        n = share + (1 if p < extra else 0)
        if not n:
            continue
        proc = ctx.Process(target=_storm_child, args=(out_q, kind, dict(
            addr=addr, workers=n, index_base=base, duration=duration,
            bands=bands, seed=seed * 1000 + p, **kw)), daemon=True)
        proc.start()
        children.append(proc)
        base += n
    started = time.monotonic()
    parts, deadline = [], started + duration + 120.0
    try:
        while len(parts) < len(children):
            # Liveness is read before the wait: a child that puts its
            # result and exits between the wait's timeout and the read is
            # still alive here, and its result is read on the next turn.
            alive = any(proc.is_alive() for proc in children)
            try:
                parts.append(out_q.get(timeout=1.0))
            except queue.Empty:
                check(alive and time.monotonic() < deadline,
                      f"storm: {len(children) - len(parts)} of "
                      f"{len(children)} processes gave no result in "
                      f"{time.monotonic() - started:.1f}s (exit codes "
                      f"{[proc.exitcode for proc in children]})")
    finally:
        for proc in children:
            proc.join(timeout=20.0)
            if proc.is_alive():
                proc.kill()
                proc.join()
    errors = [p["error"] for p in parts if "error" in p]
    check(not errors, f"storm process failed: {errors[:1]}")
    merged = {k: sum(p.get(k, 0) for p in parts) for k in (
        "ok", "shed", "errors", "shed_no_hint", "releases", "release_shed",
        "pushes", "resets")}
    for key in ("ok_by_band", "shed_by_band"):
        merged[key] = {}
        for p in parts:
            for b, n in p[key].items():
                merged[key][b] = merged[key].get(b, 0) + n
    lat_by = {}
    for p in parts:
        for b, v in p["lat"].items():
            lat_by.setdefault(b, []).extend(v)
    lat = sorted(x for v in lat_by.values() for x in v)
    elapsed = max(p["duration_s"] for p in parts)
    merged.update(
        procs=len(parts), workers=workers, duration_s=elapsed,
        goodput_qps=merged["ok"] / elapsed,
        offered_qps=(merged["ok"] + merged["shed"] + merged["errors"])
        / elapsed,
        p50_s=_percentile(lat, 0.50), p99_s=_percentile(lat, 0.99),
        p50_s_by_band={b: _percentile(sorted(v), 0.50)
                       for b, v in sorted(lat_by.items())},
        p99_s_by_band={b: _percentile(sorted(v), 0.99)
                       for b, v in sorted(lat_by.items())})
    return merged


async def _storm_run(admission, workers, seconds, procs):
    """An immediate-mode server in this process under a poll storm from
    `procs` other processes."""
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer

    server = CapacityServer(
        "storm", TrivialElection(), mode="immediate",
        minimum_refresh_interval=0.0, admission=admission,
        flightrec_capacity=0, device=DEVICE)
    port = await server.start(0, host="127.0.0.1")
    try:
        await server.load_config(parse_yaml_config(STORM_CONFIG))
        await asyncio.sleep(0)
        st = await asyncio.get_running_loop().run_in_executor(
            None, lambda: _storm(
                "poll", f"127.0.0.1:{port}", procs=procs, workers=workers,
                duration=seconds, bands=STORM_BANDS, seed=7))
        if admission is not None:
            st["server_tallies"] = {
                f"{m}/{b}": dict(v)
                for (m, b), v in sorted(admission.tallies.items())}
            st["level"] = admission.controller.level
        return st
    finally:
        await server.stop()


def phase_admission_storm(torch, card):
    """bench.py's RPC storm: a one-worker calibration, then 48 closed-loop
    workers in other processes against the immediate-mode server with
    admission off, then on (a budget of 70% of the off run's goodput)."""
    from doorman_tpu_torch.admission import Admission
    from doorman_tpu_torch.obs import slo as slo_mod

    async def drive():
        calib = await _storm_run(None, 1, STORM_CALIB_SECONDS, 1)
        off = await _storm_run(None, STORM_WORKERS, STORM_SECONDS,
                               STORM_PROCS)
        floor = STORM_SATURATION * max(calib["p50_s"], 1e-6)
        if off["p99_s"] < floor or off["ok"] == 0:
            say(f"phase admission-storm: the admission-off storm did not "
                f"queue: p99 {off['p99_s'] * 1e3:.3f} ms below the "
                f"saturation floor {floor * 1e3:.3f} ms ({STORM_SATURATION}x"
                f" the one-worker p50 {calib['p50_s'] * 1e3:.3f} ms): no "
                "comparison")
            check(False, "admission-storm: the storm never queued")
        adm = Admission(coalesce_window=0.005, window=0.25,
                        max_rps=off["goodput_qps"] * 0.7)
        on = await _storm_run(adm, STORM_WORKERS, STORM_SECONDS, STORM_PROCS)
        return calib, off, on

    calib, off, on = asyncio.run(drive())
    top = max(STORM_BANDS)
    verdicts = slo_mod.storm_slo_verdicts(off, on, goodput_floor_ratio=0.7)
    ms = lambda d: {b: round(v * 1e3, 3) for b, v in d.items()}  # noqa: E731
    say(f"phase admission-storm: one-worker calibration p50 "
        f"{calib['p50_s'] * 1e3:.3f} ms; {STORM_WORKERS} workers in "
        f"{STORM_PROCS} processes for {STORM_SECONDS}s: admission off "
        f"goodput {off['goodput_qps']:.1f}/s p50 {off['p50_s'] * 1e3:.3f} ms "
        f"p99 {off['p99_s'] * 1e3:.3f} ms (p99 by band "
        f"{ms(off['p99_s_by_band'])}); on (max_rps "
        f"{off['goodput_qps'] * 0.7:.1f}) goodput {on['goodput_qps']:.1f}/s "
        f"p50 {on['p50_s'] * 1e3:.3f} ms p99 {on['p99_s'] * 1e3:.3f} ms (by "
        f"band {ms(on['p99_s_by_band'])}), shed by band {on['shed_by_band']}"
        f", admitted by band {on['ok_by_band']}, final level "
        f"{on['level']:.3f}; releases {on['releases']} (shed "
        f"{on['release_shed']}), sheds without the retry-after trailer "
        f"{on['shed_no_hint']}; card {card}")
    say("phase admission-storm: SLO verdicts " + json.dumps(
        [{k: v[k] for k in ("slo", "status", "observed", "target")
          if k in v} for v in verdicts]))
    check(on["shed_by_band"].get(top, 0) == 0,
          f"admission-storm: the top band {top} was shed "
          f"{on['shed_by_band'].get(top, 0)} times")
    check(on["shed_no_hint"] == 0,
          f"admission-storm: {on['shed_no_hint']} sheds without "
          "doorman-retry-after")
    check(on["release_shed"] == 0 and on["releases"] > 0,
          f"admission-storm: releases {on['releases']}, shed "
          f"{on['release_shed']}")
    return dict(calibration_p50_ms=calib["p50_s"] * 1e3,
                off={k: v for k, v in off.items()},
                on={k: v for k, v in on.items()}, slo=verdicts)


def _flash_crowd_rates(np):
    """The flash-crowd scenario's offered rates by band: six band-1 base
    clients at 10/s, a 24-client band-0 crowd at 10/s for 4 ticks every
    FC_PERIOD ticks from tick 8."""
    xs = np.zeros((FC_TICKS, FC_SERIES), np.float32)
    xs[:, 1] = 60.0
    for t in range(FC_TICKS):
        if t >= 8 and (t - 8) % FC_PERIOD < 4:
            xs[t, 0] = 240.0
    return xs


def phase_forecast(torch, card):
    """The forecaster's step on the card against the numpy oracle, bit for
    bit, over the flash-crowd stream; its time a step."""
    import numpy as np

    from doorman_tpu_torch.workload.forecast import SeasonalForecaster

    xs = _flash_crowd_rates(np)
    runs = {}
    for engine in ("device", "host"):
        f = SeasonalForecaster(FC_SERIES, FC_PERIOD, alpha=FC_ALPHA,
                               beta=FC_BETA, engine=engine, device=DEVICE)
        out, times = [], []
        for x in xs:
            t = time.perf_counter()
            out.append(f.observe(x))
            times.append(time.perf_counter() - t)
        runs[engine] = dict(f=f, out=np.stack(out), times=times)
    dev, host = runs["device"], runs["host"]
    check(dev["f"].device.type == "cuda"
          and dev["f"]._state[0].device.type == "cuda",
          "forecast: the device step is not on the card")
    same = np.array_equal(dev["out"].view(np.uint32),
                          host["out"].view(np.uint32)) and all(
        np.array_equal(a.view(np.uint32), b.view(np.uint32))
        for a, b in zip(dev["f"].state(), host["f"].state()))
    check(same, "forecast: the card's step differs from the numpy oracle")
    us = np.asarray(dev["times"][1:]) * 1e6
    hus = np.asarray(host["times"][1:]) * 1e6
    say(f"phase forecast: {FC_SERIES} series, period {FC_PERIOD}, alpha "
        f"{FC_ALPHA}, beta {FC_BETA}, {FC_TICKS} ticks on the card: every "
        f"forecast and the final state equal the numpy oracle bit for bit; "
        f"observe (upload, step, download) p50 {np.percentile(us, 50):.1f} "
        f"us, p95 {np.percentile(us, 95):.1f} us a step (host oracle p50 "
        f"{np.percentile(hus, 50):.1f} us); card {card}")
    return dict(step_p50_us=float(np.percentile(us, 50)),
                step_p95_us=float(np.percentile(us, 95)),
                host_p50_us=float(np.percentile(hus, 50)), bit_equal=True)


def _proc_maps_torch(pid):
    """True when the process maps a torch or CUDA library."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
    except OSError:
        return None
    return any(x in maps for x in ("libtorch", "libc10", "libcuda.so"))


async def _frontend_pool(torch, card):
    import os
    import socket

    import grpc

    from doorman_tpu_torch.algorithms import Request
    from doorman_tpu_torch.obs import slo as slo_mod
    from doorman_tpu_torch.proto import doorman_stream_pb2 as spb
    from doorman_tpu_torch.proto.grpc_api import CapacityStub
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    cores = os.cpu_count() or 1
    say(f"phase frontend-pool: os.cpu_count() = {cores} (needs "
        f"{FP_CORES_NEEDED}: {FE_WORKERS} listener workers, the tick "
        "process and the storm clients)")
    check(cores >= FP_CORES_NEEDED,
          f"frontend-pool: {cores} cores, fewer than {FP_CORES_NEEDED}")
    server = CapacityServer(
        "fe-pool", TrivialElection(), mode="batch", native_store=True,
        solver_dtype="f32", tick_interval=FP_TICK_INTERVAL,
        minimum_refresh_interval=0.0, stream_push=True,
        stream_shards=ST_SHARDS, flightrec_capacity=0, device=DEVICE)
    pool = server.attach_frontend(FE_WORKERS, ring_bytes=FE_RING_BYTES,
                                  inline=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        public = f"127.0.0.1:{s.getsockname()[1]}"
    loop = asyncio.get_running_loop()
    held = lambda: sum(pool.control.status()["worker_held"].values())  # noqa
    try:
        backend = await server.start(0, host="127.0.0.1", tick_loop=False)
        await server.load_config(parse_yaml_config(FP_CONFIG))
        await asyncio.sleep(0)
        server.current_master = public
        t = time.perf_counter()
        await pool.start(public, f"127.0.0.1:{backend}")
        deadline = time.monotonic() + FP_READY_SECONDS
        while len(pool.control.status()["worker_held"]) < FE_WORKERS:
            check(time.monotonic() < deadline,
                  "frontend-pool: the workers never heartbeat")
            await asyncio.sleep(0.2)
        ready_s = time.perf_counter() - t
        pids = [p.pid for p in pool._procs.values()]
        torch_in = [pid for pid in pids if _proc_maps_torch(pid)]
        check(not torch_in, f"frontend-pool: workers {torch_in} map torch "
              "or CUDA")
        procs = max(2, min(cores - FE_WORKERS - 1, 8))
        # Leg 1: the establishment storm (band 0): enough streams to keep
        # the window busy at the floor rate.
        est_streams = int(FP_EST_FLOOR * FP_EST_SECONDS)
        est_workers = procs * 16
        est = await loop.run_in_executor(None, lambda: _storm(
            "stream", public, procs=procs, workers=est_workers,
            duration=FP_EST_SECONDS, bands=(0,), seed=7,
            streams_per_worker=max(est_streams // est_workers, 1),
            spread=max(est_streams // FP_SUBS_PER_RESOURCE, 1)))
        est_rate = est["ok"] / max(est["duration_s"], 1e-9)
        settle = time.monotonic() + 10.0
        while time.monotonic() < settle and held() > 0:
            await asyncio.sleep(0.2)
        # Leg 2: a held population and the sentinel's push laps.
        hold_workers = procs * 32
        hold_future = loop.run_in_executor(None, lambda: _storm(
            "stream", public, procs=procs, workers=hold_workers,
            duration=FP_HOLD_SECONDS, bands=(0,), seed=11,
            streams_per_worker=-(-FP_HELD_TARGET // hold_workers),
            spread=max(FP_HELD_TARGET // FP_SUBS_PER_RESOURCE, 1)))
        # The server ticks at its cadence while the population ramps: the
        # tick edge's beat keeps every held stream inside its worker's
        # stall margin (3 ticks), as the tick loop would.
        held_max, ramp_ticks = 0, 0
        ramp_end = time.monotonic() + FP_HOLD_SECONDS / 2
        while time.monotonic() < ramp_end:
            t_tick = time.monotonic()
            await server.tick_once()
            ramp_ticks += 1
            held_max = max(held_max, held())
            if held_max >= FP_HELD_TARGET:
                break
            await asyncio.sleep(max(
                FP_TICK_INTERVAL - (time.monotonic() - t_tick), 0.0))
        push_lat, push_edges, launches = [], [], []
        async with grpc.aio.insecure_channel(public) as chan:
            stub = CapacityStub(chan)
            wreq = spb.WatchCapacityRequest(client_id="sentinel")
            rr = wreq.resource.add()
            rr.resource_id, rr.wants, rr.priority = "sentinel", 10.0, 1
            call = stub.WatchCapacity(wreq)
            reader = _StreamReader(call)
            while not (await reader.read(timeout=30.0)).response:
                pass
            for k in range(FP_PUSH_TICKS):
                # The churner flips between overloading the row and not,
                # so the sentinel's grant moves every time (bench.py's
                # 500 never passes the capacity of 600 beside the
                # sentinel's 10: its grant would not move). The server
                # keeps its 1 s cadence until the push arrives: the
                # resident tick lands a solve's grants in the store at
                # the next tick's collect, and the fanout pushes from
                # the store.
                server._decide("sentinel", Request(
                    "churner", 0.0, FP_CHURN_WANTS[k % 2], 1, priority=0))
                t0, msg, edges = time.monotonic(), None, 0
                while msg is None:
                    check(edges < FP_PUSH_EDGES,
                          f"frontend-pool: no push to the sentinel in "
                          f"{edges} ticks after its churn {k + 1}")
                    t_edge = time.monotonic()
                    dense_cuda.reset_launches()  # this tick starts here
                    await server.tick_once()
                    launches.append(dict(dense_cuda.LAUNCHES))
                    edges += 1
                    while msg is None:
                        left = FP_TICK_INTERVAL - (time.monotonic() - t_edge)
                        got = await reader.poll(max(left, 0.0))
                        if got is None:
                            break
                        check(got is not grpc.aio.EOF,
                              f"frontend-pool: the sentinel's stream ended "
                              f"after its churn {k + 1}")
                        if got.response:
                            msg = got
                push_lat.append(time.monotonic() - t0)
                push_edges.append(edges)
                held_max = max(held_max, held())
                await asyncio.sleep(max(
                    FP_TICK_INTERVAL - (time.monotonic() - t_edge), 0.0))
            reader.cancel()
        # The cadence goes on until the held population's storm ends.
        while not hold_future.done():
            t_edge = time.monotonic()
            dense_cuda.reset_launches()
            await server.tick_once()
            launches.append(dict(dense_cuda.LAUNCHES))
            held_max = max(held_max, held())
            await asyncio.sleep(max(
                FP_TICK_INTERVAL - (time.monotonic() - t_edge), 0.0))
        hold = await hold_future
        push_lat.sort()
        p50 = _percentile(push_lat, 0.50) * 1e3
        p99 = _percentile(push_lat, 0.99) * 1e3
        verdicts = slo_mod.SloEngine([
            slo_mod.SloSpec(
                "frontend_establishment_storm:rate", "min", FP_EST_FLOOR,
                {"type": "scalar", "key": "est_rate"}, unit="est_per_s"),
            slo_mod.SloSpec(
                "frontend_held_streams:held", "min", float(FP_HELD_TARGET),
                {"type": "scalar", "key": "held_max"}, unit="streams"),
            slo_mod.SloSpec(
                "frontend_held_streams:push_p99", "max",
                1000.0 * FP_TICK_INTERVAL,
                {"type": "scalar", "key": "push_p99_ms"}, unit="ms"),
        ]).evaluate(slo_mod.SloInputs(scalars={
            "est_rate": est_rate, "held_max": float(held_max),
            "push_p99_ms": p99}))
        st = pool.status()
        say(f"phase frontend-pool: {FE_WORKERS} spawned workers ready in "
            f"{ready_s:.1f}s (none maps torch or CUDA); establishment storm "
            f"{FP_EST_SECONDS:.0f}s band 0 from {procs} processes x "
            f"{est_workers // procs} workers: {est['ok']} established, "
            f"{est_rate:.1f}/s against the reference's floor "
            f"{FP_EST_FLOOR:.0f}/s, shed {est['shed']}, errors "
            f"{est['errors']}, establish p50 {est['p50_s'] * 1e3:.2f} ms p99 "
            f"{est['p99_s'] * 1e3:.2f} ms; held streams max {held_max} of "
            f"{FP_HELD_TARGET} ({ramp_ticks} ticks at the 1 s cadence while it "
            f"ramped); sentinel push latency (its churn's first tick edge "
            f"to the client's message) over {FP_PUSH_TICKS} churns p50 "
            f"{p50:.2f} ms p99 {p99:.2f} ms against one tick "
            f"({FP_TICK_INTERVAL * 1e3:.0f} ms), tick edges a push "
            f"{push_edges}; hold storm pushes "
            f"{hold['pushes']} resets {hold['resets']} errors "
            f"{hold['errors']}; frames published "
            f"{st['publisher']['published_frames']}; card {card}")
        say("phase frontend-pool: SLO verdicts " + json.dumps(
            [{k: v[k] for k in ("slo", "status", "observed", "target")
              if k in v} for v in verdicts]))
        check(est["ok"] > 0 and held_max > 0,
              "frontend-pool: nothing established")
        return dict(cores=cores, ready_s=ready_s, est_rate=est_rate,
                    est={k: v for k, v in est.items()}, held_max=held_max,
                    push_p50_ms=p50, push_p99_ms=p99,
                    push_ms=[x * 1e3 for x in push_lat],
                    push_edges=push_edges,
                    hold={k: hold[k] for k in ("ok", "pushes", "resets",
                                               "errors", "shed")},
                    slo=verdicts, launches={
                        k: sum(x[k] for x in launches)
                        for k in ("k1", "k2", "k3")})
    finally:
        await server.stop()


def _frontend_smoke(card):
    """cmd/frontend_smoke's kill-and-resume arc on the real pool."""
    import os

    t = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "doorman_tpu_torch.cmd.frontend_smoke",
         "--workers", "2", "--device", DEVICE, "--timeout", "120"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    secs = time.perf_counter() - t
    if out.returncode != 0:
        say(out.stdout[-2000:] + out.stderr[-4000:])
    check(out.returncode == 0,
          f"frontend_smoke exited {out.returncode}")
    result = json.loads(out.stdout.strip().splitlines()[-1])
    say(f"phase frontend-pool: cmd.frontend_smoke exited 0 in {secs:.1f}s: "
        f"worker {result['victim']} killed, its stream ended, resumed at "
        f"seq {result['resumed_seq']} with no replay; card {card}")
    return dict(seconds=secs, **result)


def phase_admission(torch, card):
    """admission-fused, admission-storm and forecast."""
    fused = asyncio.run(_admission_fused(torch, card))
    storm = phase_admission_storm(torch, card)
    forecast = phase_forecast(torch, card)
    return dict(fused=fused, storm=storm, forecast=forecast)


def _fe_pump(pool):
    """One pump pass of an inline pool; its ring laps (a corrupt frame or
    a stalled stream fails)."""
    res = pool.pump_all()
    check(res["corrupt"] == 0 and res["stalled"] == 0,
          f"frontend-parity: pump {res}")
    return res["lapped"]


def phase_frontend(torch, card):
    """frontend-pool, then cmd.frontend_smoke (frontend-parity runs in the
    streams phase)."""
    pool = asyncio.run(_frontend_pool(torch, card))
    pool["smoke"] = _frontend_smoke(card)
    return dict(pool=pool)


# -- the fleet (fleet/, cmd/fleet.py) and TLS on every hop ------------------

# fleet-reshard: three shard roots of bench.py's build_shard shape
# (_fed_server / _fed_populate: 10,000 resources x 100 clients a shard, the
# five FED_STRADDLE straddlers at 4,000 on every active shard). The
# resources are hash-routed (`fl-r<i>`, each shard populated with the
# first 10,000 the 2-shard router gives it); FL_WARMUP + FL_ROUNDS rounds
# at 2 shards, then reshard(3) and FL_ROUNDS rounds at 3, 5% churn a
# round (the demand of a moved resource follows it to its new owner).
FL_WARMUP = 3
FL_ROUNDS = 6
# Ticks with no beat after the last round: the first is full (the last
# beat's epoch), the rest scoped (K1), as fed-roots' FED_SETTLE.
FL_SETTLE = 3
FL_STALE = 1_000  # stale-router refreshes sent to the old owners
FL_STALE_CONC = 50
FL_SMOKE_TIMEOUT = 300.0  # cmd.fleet --smoke's own budget (s)
FL_SMOKE_ROUNDS = 4  # beat rounds before and after its reshard (CLI: 8)


def _fleet_names(n_per_shard, n_shards=2):
    """{shard: the first `n_per_shard` ids `fl-r<i>` the n-shard router
    gives it}."""
    from doorman_tpu_torch.federation import stable_shard

    out = {s: [] for s in range(n_shards)}
    i = 0
    while min(len(v) for v in out.values()) < n_per_shard:
        rid = f"fl-r{i}"
        s = stable_shard(rid, n_shards)
        if len(out[s]) < n_per_shard:
            out[s].append(rid)
        i += 1
    return out


def _fleet_strad(server, shard, clock, srng):
    """The straddling resources' 100 clients on a shard that joins the
    fleet (what _fed_populate gives the shards it populates)."""
    import numpy as np

    engine = server._store_engine
    strad = {}
    for rid, _kind, _variant in FED_STRADDLE:
        res = server.get_or_create_resource(rid)
        s_cids = np.array([engine.client_handle(f"{rid}.s{shard}.c{i}")
                           for i in range(FED_C)], np.int64)
        s_rids = np.full(FED_C, res.store._rid, np.int32)
        engine.bulk_assign(s_rids, s_cids, np.full(FED_C, clock() + 600.0),
                           np.full(FED_C, float(FED_REFRESH)),
                           np.zeros(FED_C),
                           srng.integers(1, 100, FED_C).astype(np.float64),
                           np.ones(FED_C, np.int32))
        strad[rid] = (s_rids, s_cids)
    return strad


def _device_rows(torch, server, resources):
    """The resident solver's device grant rows of `resources` (the first
    FED_C lanes), on the host."""
    solver = server._resident
    rows = [solver._row_lut[res.store._rid] for res in resources]
    has = solver.table().has
    idx = torch.as_tensor(rows, dtype=torch.long, device=has.device)
    return has[idx, :FED_C].cpu()


def _carry(servers, moved):
    """The moved resources' client rows from their old owners to their
    new ones, `has` included (what each client reports on its first
    refresh there), under the same templates; ({new owner: its carried
    resources}, rows carried)."""
    import numpy as np

    from doorman_tpu_torch.proto import doorman_pb2 as pb

    carried, n_rows = {}, 0
    for new in sorted({n for _r, _o, n in moved}):
        dst = servers[new]
        engine = dst._store_engine
        cols = [[] for _ in range(7)]
        carried[new] = []
        for rid, old, _n in (m for m in moved if m[2] == new):
            res = servers[old].resources[rid]
            tpl = pb.ResourceTemplate()
            tpl.CopyFrom(res.template)
            new_res = dst.get_or_create_resource(rid)
            new_res.load_config(tpl, None)
            rows = res.store.dump_rows()
            cols[0].append(np.full(len(rows), new_res.store._rid, np.int32))
            cols[1].append(np.fromiter(
                (engine.client_handle(r[0]) for r in rows), np.int64,
                count=len(rows)))
            for k in range(1, 6):
                cols[k + 1].append(np.fromiter(
                    (r[k] for r in rows), np.float64, count=len(rows)))
            carried[new].append(new_res)
        dst._config_epoch += 1  # templates moved outside load_config
        rids, cids, exp, ref, has, wants, sub = (np.concatenate(c)
                                                 for c in cols)
        engine.bulk_assign(rids, cids, exp, ref, has, wants,
                           sub.astype(np.int32), np.ones(len(rids), np.int32))
        n_rows += len(rids)
    return carried, n_rows


def _moved_oracle_err(torch, server, resources, inputs):
    """The new owner's device grants of the moved resources after their
    first tick there against the f64 oracle on the rows they were
    solved from: max |grant - oracle| / max(capacity, max wants)."""
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import oracle_row

    solver = server._resident
    cfg = solver._config
    grants = _device_rows(torch, server, resources).double().numpy()
    statc = solver.table().static_capacity.double().cpu().numpy()
    worst = 0.0
    for i, res in enumerate(resources):
        row = solver._row_lut[res.store._rid]
        has, wants, sub = inputs[res.id]
        want = oracle_row(int(cfg.kind_h[row]), float(cfg.cap_h[row]),
                          float(statc[row]), wants, has, sub)
        scale = max(float(cfg.cap_h[row]), float(wants.max()), 1e-30)
        worst = max(worst, float(np.abs(grants[i, :len(wants)] - want).max())
                    / scale)
    return worst


async def _stale_refreshes(servers, addrs, moved, names):
    """FL_STALE refreshes of moved resources sent, with the 2-shard
    router, to their old owners over loopback gRPC (FL_STALE_CONC at a
    time): every answer a redirect to the new owner's address and no
    grant; returns (sent per old owner, ms per refresh)."""
    import grpc

    from doorman_tpu_torch.proto import doorman_pb2 as pb
    from doorman_tpu_torch.proto.grpc_api import CapacityStub

    chans = {s: grpc.aio.insecure_channel(addrs[s]) for s in (0, 1)}
    stubs = {s: CapacityStub(ch) for s, ch in chans.items()}
    sent = {0: 0, 1: 0}
    lat = []
    sem = asyncio.Semaphore(FL_STALE_CONC)
    bad = []

    async def one(k):
        rid, old, new = moved[k % len(moved)]
        req = pb.GetCapacityRequest(client_id=names[rid][k % FED_C])
        rr = req.resource.add()
        rr.resource_id, rr.wants = rid, 10.0
        async with sem:
            t = time.perf_counter()
            resp = await stubs[old].GetCapacity(req, timeout=30)
            lat.append((time.perf_counter() - t) * 1e3)
        sent[old] += 1
        if (resp.mastership.master_address != addrs[new]
                or len(resp.response)):
            bad.append((rid, resp.mastership.master_address))

    try:
        await asyncio.gather(*(one(k) for k in range(FL_STALE)))
    finally:
        for ch in chans.values():
            await ch.close()
    check(not bad, f"fleet-reshard: {len(bad)} stale refreshes not "
          f"redirected to the new owner, e.g. {bad[:3]}")
    return sent, lat


async def _fleet_reshard(torch, card):
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.fleet import FleetController
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.solver import dense_cuda

    clock = _FakeClock(time.time())
    cfg = parse_yaml_config(_fed_root_yaml())
    names = _fleet_names(FED_R)
    servers, addrs, live = {}, {}, []
    shards = {}
    t = time.perf_counter()
    try:
        for s in (0, 1, 2):
            server = _fed_server(f"fleet-shard{s}", clock, s)
            live.append(server)
            await server.start(0, host="127.0.0.1", tick_loop=False)
            addrs[s] = f"127.0.0.1:{server.port}"
            server.current_master = addrs[s]
            await server.load_config(cfg)
            servers[s] = server
        for s in (0, 1):
            shards[s] = _fed_populate(servers[s], s, clock, names[s])
        populate_s = time.perf_counter() - t
        fleet = FleetController(
            servers, straddle=[rid for rid, *_ in FED_STRADDLE], active=2,
            addrs=addrs, clock=clock)
        fleet.note_resources(names[0] + names[1])
        say(f"phase fleet-reshard[f32]: 3 shard roots provisioned, 2 "
            f"active with "
            f"{sum(servers[s]._store_engine.total_leases for s in (0, 1))} "
            f"leases on the card, populated in {populate_s:.1f}s; card "
            f"{card}")
        walls = {s: {"pre": [], "post": [], "settle": []} for s in (0, 1, 2)}
        modes = {s: {"pre": [], "post": [], "settle": []} for s in (0, 1, 2)}
        beat_ms, worst_share = [], 0.0
        srng2 = np.random.default_rng(1202)
        strad2 = None
        moved_idx = {0: np.zeros(FED_R, bool), 1: np.zeros(FED_R, bool)}
        new_handles = {}  # (old owner, row) -> (rid handles, cid handles)
        handoff = FL_WARMUP + FL_ROUNDS
        # The resources each shard keeps at 3 shards, and the rounds each
        # of their rows was churned in.
        from doorman_tpu_torch.federation import stable_shard

        stay = {s: [(r, res) for r, res in enumerate(shards[s]["resources"])
                    if stable_shard(res.id, 3) == s] for s in (0, 1)}
        churned = {s: {} for s in (0, 1)}
        rest = {}
        out = {}
        fleet.reconcile_once()  # the bootstrap split, before any tick
        dense_cuda.reset_launches()  # the fleet-reshard path starts here
        for rnd in range(handoff + FL_ROUNDS):
            phase = "pre" if rnd < handoff else "post"
            if rnd == handoff:
                t = time.perf_counter()
                change = fleet.reshard(3)
                install_ms = (time.perf_counter() - t) * 1e3
                moved = change.moved
                check(change.added == (2,) and moved,
                      f"fleet-reshard: change {change.as_log()['added']}")
                for s in (0, 1):
                    table = servers[s]._fleet_routing
                    held = set(names[s])
                    got = {rid: a for rid, a in table.items() if rid in held}
                    want = {rid: addrs[new] for rid, old, new in moved
                            if old == s}
                    check(got == want, f"fleet-reshard: shard {s}'s routing "
                          f"table over its resources holds {len(got)} "
                          f"entries, the moved set {len(want)}")
                    check(servers[s]._fleet_epoch == 1,
                          f"fleet-reshard: shard {s} at epoch "
                          f"{servers[s]._fleet_epoch}")
                check(not any(rid in servers[new]._fleet_routing
                              for rid, _o, new in moved),
                      "fleet-reshard: a new owner redirects a moved "
                      "resource")
                t = time.perf_counter()
                carried, carried_rows = _carry(servers, moved)
                carry_ms = (time.perf_counter() - t) * 1e3
                strad2 = _fleet_strad(servers[2], 2, clock, srng2)
                index = {rid: r for s in (0, 1)
                         for r, rid in enumerate(names[s])}
                engine2 = servers[2]._store_engine
                for rid, old, new in moved:
                    r = index[rid]
                    moved_idx[old][r] = True
                    dst = servers[new]
                    new_handles[(old, r)] = (
                        dst._store_engine,
                        np.full(FED_C, dst.resources[rid].store._rid,
                                np.int32),
                        np.fromiter(
                            (dst._store_engine.client_handle(
                                f"s{old}-c{r * FED_C + c}")
                             for c in range(FED_C)), np.int64, count=FED_C))
            for s in (0, 1):
                sd = shards[s]
                engine = servers[s]._store_engine
                sel = sd["churn_rows"][rnd]
                cw = sd["churn_wants"][rnd].reshape(len(sel), FED_C)
                keep = ~moved_idx[s][sel]
                for r in sel[keep]:
                    churned[s].setdefault(int(r), set()).add(rnd)
                if keep.any():
                    ks = sel[keep]
                    engine.bulk_refresh(
                        sd["rids"][ks].ravel(), sd["cids"][ks].ravel(),
                        np.full(ks.size * FED_C, clock() + 600.0),
                        np.full(ks.size * FED_C, float(FED_REFRESH)),
                        cw[keep].ravel())
                for j in np.flatnonzero(~keep):
                    eng, r_h, c_h = new_handles[(s, int(sel[j]))]
                    eng.bulk_refresh(
                        r_h, c_h, np.full(FED_C, clock() + 600.0),
                        np.full(FED_C, float(FED_REFRESH)), cw[j])
                for rid, (s_rids, s_cids) in sd["strad"].items():
                    if sd["srng"].random() < 0.5:
                        engine.bulk_refresh(
                            s_rids, s_cids, np.full(FED_C, clock() + 600.0),
                            np.full(FED_C, float(FED_REFRESH)),
                            sd["srng"].integers(1, 100, FED_C).astype(
                                np.float64))
            if strad2 is not None:
                for rid, (s_rids, s_cids) in strad2.items():
                    if srng2.random() < 0.5:
                        engine2.bulk_refresh(
                            s_rids, s_cids, np.full(FED_C, clock() + 600.0),
                            np.full(FED_C, float(FED_REFRESH)),
                            srng2.integers(1, 100, FED_C).astype(np.float64))
            if rnd == handoff:
                # The moved rows as their new owners' first tick solves
                # them.
                inputs = {}
                for res in (r for rs in carried.values() for r in rs):
                    rows = res.store.dump_rows()
                    inputs[res.id] = tuple(
                        np.array([r[k] for r in rows], np.float64)
                        for k in (3, 4, 5))
            for s in range(fleet.active):
                server = servers[s]
                t = time.perf_counter()
                await server.tick_once()
                wall = time.perf_counter() - t
                torch.cuda.synchronize()
                if rnd >= FL_WARMUP:
                    mode = server._resident.last_solve_mode
                    reason = server._resident.last_full_reason
                    walls[s][phase].append(wall)
                    modes[s][phase].append(f"full:{reason}" if mode == "full"
                                           and reason else mode)
            if rnd in (handoff - 2, handoff - 1):
                # The stayed resources' device grants after the last two
                # ticks before the install.
                for s in (0, 1):
                    rest.setdefault(s, []).append(_device_rows(
                        torch, servers[s], [res for _r, res in stay[s]]))
            if rnd == handoff:
                # Rows at rest before the install (their grants did not
                # move over the last tick) whose demand did not change in
                # the last round or the handoff round must come through
                # the install and the full tick after it unchanged.
                same, compared = 0, 0
                for s in (0, 1):
                    a, b = rest[s]
                    after = _device_rows(torch, servers[s],
                                         [res for _r, res in stay[s]])
                    for i, (r, _res) in enumerate(stay[s]):
                        quiet = not churned[s].get(r, set()) & {
                            handoff - 1, handoff}
                        if quiet and torch.equal(a[i], b[i]):
                            compared += 1
                            same += bool(torch.equal(b[i], after[i]))
                check(compared > 0 and same == compared,
                      f"fleet-reshard: {compared - same} of {compared} "
                      "stayed resources at rest changed grants across the "
                      "install")
                moved_err = max(
                    _moved_oracle_err(torch, servers[new], rs, inputs)
                    for new, rs in carried.items())
                check(moved_err <= F32_PARITY_REL_BOUND,
                      f"fleet-reshard: moved rows vs the f64 oracle "
                      f"{moved_err:.3g} > {F32_PARITY_REL_BOUND:g}")
                before = {s: servers[s].fed_stats["fleet_redirects"]
                          for s in (0, 1)}
                sent, stale_ms = await _stale_refreshes(
                    servers, addrs, moved,
                    {rid: [f"s{old}-c{index[rid] * FED_C + c}"
                           for c in range(FED_C)] for rid, old, _n in moved})
                for s in (0, 1):
                    got = servers[s].fed_stats["fleet_redirects"] - before[s]
                    check(got == sent[s],
                          f"fleet-reshard: shard {s} counted {got} "
                          f"redirects of {sent[s]} stale refreshes")
            t = time.perf_counter()
            fleet.reconcile_once()
            beat_ms.append((time.perf_counter() - t) * 1e3)
            for rid, _k, _v in FED_STRADDLE:
                total = sum(sv._straddle_shares.get(rid, 0.0)
                            for sv in servers.values())
                check(total <= FED_STRADDLE_CAP * (1 + FED_SHARE_REL),
                      f"fleet-reshard: Σ shares of {rid} {total!r} at beat "
                      f"{rnd}")
                worst_share = max(worst_share, total / FED_STRADDLE_CAP)
            clock.t += 1.0
        for _ in range(FL_SETTLE):
            for s, server in servers.items():
                t = time.perf_counter()
                await server.tick_once()
                wall = time.perf_counter() - t
                torch.cuda.synchronize()
                mode = server._resident.last_solve_mode
                reason = server._resident.last_full_reason
                walls[s]["settle"].append(wall)
                modes[s]["settle"].append(f"full:{reason}" if mode == "full"
                                          and reason else mode)
            clock.t += 1.0
        torch.cuda.synchronize()
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        check(launches["k1"] > 0 and launches["k2"] > 0,
              f"fleet-reshard: K1 and K2 must both launch: {launches}")
        out = dict(launches=launches, install_ms=install_ms,
                   carry_ms=carry_ms, moved=len(moved),
                   moved_rows=carried_rows, beat_ms=beat_ms,
                   share_of_capacity=worst_share, rest_compared=compared,
                   moved_oracle_err=moved_err, stale=sum(sent.values()),
                   stale_p50_ms=_pcts([x / 1e3 for x in stale_ms])[0],
                   populate_s=populate_s, shards={})
        for s in (0, 1, 2):
            entry = {}
            for phase in ("pre", "post", "settle"):
                if walls[s][phase]:
                    p50, p95 = _pcts(walls[s][phase])
                    entry[phase] = dict(p50=p50, p95=p95,
                                        modes=sorted(set(modes[s][phase])))
            out["shards"][s] = entry
            say(f"phase fleet-reshard[f32] shard {s}: " + "; ".join(
                f"{ph} tick p50 {v['p50']:.2f} ms p95 {v['p95']:.2f} ms "
                f"({'held' if v['p95'] <= 100.0 else 'MISSED'}: lane limit "
                f"100 ms p95) {v['modes']}" for ph, v in entry.items())
                + f"; card {card}")
        beat50, beat95 = _pcts([x / 1e3 for x in beat_ms])
        say(f"phase fleet-reshard[f32]: reshard 2 -> 3 moved {len(moved)} "
            f"resources ({carried_rows} rows carried with their has in "
            f"{carry_ms:.1f} ms; the install, epoch + routing tables on 3 "
            f"shards, {install_ms:.1f} ms); {sum(sent.values())} stale "
            f"refreshes redirected and counted (p50 "
            f"{out['stale_p50_ms']:.2f} ms); {compared} stayed resources at "
            f"rest byte-identical across the install; moved rows vs the f64 "
            f"oracle {moved_err:.3g}; beat p50 / p95 {beat50:.3f} / "
            f"{beat95:.3f} ms, Σ shares at most {worst_share:.9f} of "
            f"capacity; launches {launches}; card {card}")
        return out
    finally:
        for server in live:
            await server.stop()


def _fleet_procs(card):
    """cmd.fleet --smoke: the fleet head, its RPC beat and three real
    shard processes (batch mode, native store, --device cuda) through a
    live 2 -> 3 reshard."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out_path = Path(tmp) / "verdict.json"
        t = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        out = subprocess.run(
            [sys.executable, "-m", "doorman_tpu_torch.cmd.fleet", "--smoke",
             "--mode", "batch", "--native-store", "--device", DEVICE,
             "--rounds", str(FL_SMOKE_ROUNDS),
             "--timeout", str(FL_SMOKE_TIMEOUT),
             "--out", str(out_path), "--log-dir", str(Path(tmp) / "logs")],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=FL_SMOKE_TIMEOUT + 60)
        secs = time.perf_counter() - t
        if out.returncode != 0:
            say(out.stdout[-2000:] + out.stderr[-4000:])
        check(out.returncode == 0, f"cmd.fleet --smoke exited {out.returncode}")
        verdict = json.loads(out_path.read_text())
    check(verdict["ok"], f"cmd.fleet --smoke: {verdict.get('error')}")
    cap = 120.0  # cmd.fleet's built-in config
    rounds = verdict["rounds"]
    check(rounds and all(r["has_sum"] <= cap + 1e-6 for r in rounds),
          "fleet-procs: Σ has past capacity in a beat round")
    check({r["phase"] for r in rounds} == {"pre", "handoff"},
          "fleet-procs: the smoke did not run through the reshard")
    logs = verdict["shard_logs"]
    check(sorted(logs) == ["0", "1", "2"], f"fleet-procs: shards {logs}")
    for s, v in logs.items():
        check(str(v["device"]).startswith(DEVICE) and (v["ticks"] or 0) > 0,
              f"fleet-procs: shard {s} served on {v['device']} with "
              f"{v['ticks']} ticks")
    say(f"phase fleet-procs: cmd.fleet --smoke ok in {secs:.1f}s: "
        f"{len(rounds)} beat rounds through the live 2 -> 3 reshard, Σ has "
        f"at most {max(r['has_sum'] for r in rounds)} of {cap}; shards "
        + ", ".join(f"{s} on {v['device']} ({v['ticks']} ticks)"
                    for s, v in sorted(logs.items()))
        + f"; shares {verdict['shares']}; card {card}")
    return dict(seconds=secs, rounds=len(rounds), shard_logs=logs,
                shares=verdict["shares"])


def phase_fleet(torch, card):
    """fleet-reshard (in process) and fleet-procs (cmd.fleet --smoke)."""
    reshard = asyncio.run(_fleet_reshard(torch, card))
    procs = _fleet_procs(card)
    return dict(reshard=reshard, procs=procs)


# tls: a self-signed localhost pair (openssl, as tests/test_tls.py makes
# it); the server binary in batch mode on the native store with
# --tls-cert / --tls-key beside a plaintext twin (TLS_CLIENTS port Clients
# of TLS_RES resources each, at f64: the FAIR_SHARE resources overloaded,
# the PROPORTIONAL_SHARE ones not, so both twins reach one fixpoint
# whatever ticks each ran — an overloaded proportional row moves by an
# ulp a tick); immediate mode's IMM_CONC load over TLS beside plaintext;
# two pools of TLS_FE_WORKERS real listener workers, one terminating TLS,
# one plaintext, under TLS_FE_WATCHERS streams; an intermediate dialing a
# TLS root with --parent-tls-ca.
TLS_CONFIG = """
resources:
- identifier_glob: "t.prop*"
  capacity: 1000
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
"""
TLS_CLIENTS = 20
TLS_RES = 10
TLS_ROUNDS = 12  # refresh rounds at most, until two in a row agree
TLS_TICK = 0.25
TLS_FE_WORKERS = 2
TLS_FE_WATCHERS = 8
TLS_FE_TICKS = 6
TLS_READY_S = 120.0


def _tls_certs(tmp):
    """A self-signed localhost cert/key pair; fails loudly without
    openssl."""
    import shutil

    check(shutil.which("openssl") is not None,
          "tls: openssl is not on the PATH")
    key, cert = Path(tmp) / "key.pem", Path(tmp) / "cert.pem"
    out = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout",
         str(key), "-out", str(cert), "-days", "1", "-nodes", "-subj",
         "/CN=localhost", "-addext",
         "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"tls: openssl failed: {out.stderr[-500:]}")
    return str(cert), str(key)


class _Binary:
    """One server binary in a process of its own, its log in `tmp`;
    stopped (SIGTERM: the binary's own shutdown, then its last log line)
    on exit."""

    def __init__(self, tmp, name, args):
        import os
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            self.port = sock.getsockname()[1]
        self.log_path = Path(tmp) / f"{name}.log"
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "doorman_tpu_torch.cmd.server",
             "--host", "127.0.0.1", "--port", str(self.port),
             "--debug-port", "-1", *args],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
            stdout=self._log, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL)

    async def ready(self, creds=None):
        import grpc

        from doorman_tpu_torch.proto import doorman_pb2 as pb
        from doorman_tpu_torch.proto.grpc_api import CapacityStub

        deadline = time.monotonic() + TLS_READY_S
        async with _channel(grpc, self.port, creds) as ch:
            stub = CapacityStub(ch)
            while True:
                if self.proc.poll() is not None or time.monotonic() > deadline:
                    say(self.log_path.read_text()[-3000:])
                    check(False, f"tls: {self.log_path.name} did not come up")
                try:
                    d = await stub.Discovery(pb.DiscoveryRequest(),
                                             timeout=2.0)
                    if d.is_master:
                        return
                except grpc.aio.AioRpcError:
                    pass
                await asyncio.sleep(0.3)

    def stop(self):
        """SIGTERM, then the log's (tick device, ticks)."""
        import re

        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self._log.close()
        text = self.log_path.read_text()
        dev = re.search(r"tick device (\S+?),", text)
        ticks = re.search(r"stopped after (\d+) ticks", text)
        return (dev.group(1) if dev else None,
                int(ticks.group(1)) if ticks else None)


async def _tls_clients_round(clients):
    for c in clients:
        check(await asyncio.wait_for(c.refresh_once(), 30),
              f"tls: client {c.id}'s refresh failed")
    return {(c.id, rid): res.current_capacity()
            for c in clients for rid, res in c.resources.items()}


async def _tls_server(tmp, cert, key):
    """The batch-mode, native-store server binary on the card over TLS
    beside its plaintext twin: the same config, the same port Clients'
    requests; grants equal once both have converged."""
    import numpy as np

    from doorman_tpu_torch.client import Client

    cfg = Path(tmp) / "tls.yml"
    cfg.write_text(TLS_CONFIG)
    common = ["--config", f"file:{cfg}", "--mode", "batch", "--native-store",
              "--device", DEVICE, "--solver-dtype", "f64",
              "--tick-interval", str(TLS_TICK),
              "--minimum-refresh-interval", "0"]
    bins = {"tls": _Binary(tmp, "tls-server", common + [
                "--tls-cert", cert, "--tls-key", key]),
            "plain": _Binary(tmp, "plain-server", common)}
    clients = {}
    try:
        import grpc

        with open(cert, "rb") as f:
            creds = grpc.ssl_channel_credentials(root_certificates=f.read())
        await bins["tls"].ready(creds)
        await bins["plain"].ready()
        rng = np.random.default_rng(151)
        asks = [[(f"t.{'prop' if (i + r) % 2 else 'fair'}{r}",
                  float(rng.integers(1, 30))) for r in range(TLS_RES)]
                for i in range(TLS_CLIENTS)]
        for side, b in bins.items():
            clients[side] = []
            host = "localhost" if side == "tls" else "127.0.0.1"
            for i in range(TLS_CLIENTS):
                c = Client(f"{host}:{b.port}", f"tls-c{i}",
                           minimum_refresh_interval=0.0, max_retries=3,
                           tls_ca=cert if side == "tls" else None)
                for rid, wants in asks[i]:
                    await c.resource(rid, wants)
                clients[side].append(c)
        last, rounds, lat = None, 0, []
        for rounds in range(1, TLS_ROUNDS + 1):
            got = {}
            for side in bins:
                t = time.perf_counter()
                got[side] = await _tls_clients_round(clients[side])
                lat.append((side, time.perf_counter() - t))
            await asyncio.sleep(3 * TLS_TICK)
            if got["tls"] == got["plain"] and got == last:
                break
            last = got
        check(got["tls"] == got["plain"],
              f"tls: grants over TLS differ from the plaintext twin's after "
              f"{rounds} rounds")
        check(any(v > 0 for v in got["tls"].values()),
              "tls: no grant over TLS")
    finally:
        for side in clients:
            for c in clients[side]:
                c.RELEASE_TIMEOUT = 2.0
                await c.close()
        served = {side: b.stop() for side, b in bins.items()}
    for side, (dev, ticks) in served.items():
        check(str(dev).startswith(DEVICE) and (ticks or 0) > 0,
              f"tls: the {side} binary served on {dev} with {ticks} ticks")
    return dict(rounds=rounds, grants=len(got["tls"]), served=served)


def _imm_binaries(tmp, cert, key):
    """Immediate mode's server binary (the reference's default flags)
    over TLS and in the clear, started together."""
    cfg = Path(tmp) / "imm.yml"
    cfg.write_text(_imm_yaml())
    common = ["--config", f"file:{cfg}", "--device", DEVICE,
              "--log-level", "warning"]
    return {"tls": _Binary(tmp, "imm-tls", common + [
                "--tls-cert", cert, "--tls-key", key]),
            "plain": _Binary(tmp, "imm-plain", common)}


async def _tls_latency(bins, cert, ids):
    """Phase immediate's IMM_CONC load on the two immediate-mode
    binaries in turns (plaintext, TLS, TLS, plaintext)."""
    import grpc
    import numpy as np

    with open(cert, "rb") as f:
        creds = {"tls": grpc.ssl_channel_credentials(
            root_certificates=f.read()), "plain": None}
    lat = {"plain": [], "tls": []}
    secs = {"plain": 0.0, "tls": 0.0}
    try:
        for side, b in bins.items():
            await b.ready(creds[side])
        for side in ("plain", "tls", "tls", "plain"):
            got, s = await _load(bins[side].port, ids, creds[side])
            check(bins[side].proc.poll() is None,
                  f"tls-latency: the {side} binary exited")
            lat[side] += got
            secs[side] += s
    finally:
        for b in bins.values():
            b.stop()
    out = {}
    for side, xs in lat.items():
        xs = np.asarray(xs) * 1e3
        out[side] = dict(p50_ms=float(np.percentile(xs, 50)),
                         p99_ms=float(np.percentile(xs, 99)),
                         requests_per_s=len(xs) / secs[side])
    return out


async def _tls_frontend(torch, cert, key):
    """Two batch-mode stream servers on one fake clock, each behind a pool
    of TLS_FE_WORKERS real listener workers, one pool terminating TLS:
    TLS_FE_WATCHERS WatchCapacity streams through each public port, the
    same churn, every frame byte-equal across the two."""
    import socket

    import grpc

    from doorman_tpu_torch.algorithms import Request
    from doorman_tpu_torch.proto import doorman_stream_pb2 as spb
    from doorman_tpu_torch.proto.grpc_api import SERVICE_NAME
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    now = [time.time()]
    clock = lambda: now[0]  # noqa: E731
    with open(cert, "rb") as f:
        creds = grpc.ssl_channel_credentials(root_certificates=f.read())
    sides = {}
    try:
        for side in ("tls", "plain"):
            server = CapacityServer(
                f"fe-{side}", TrivialElection(), mode="batch",
                native_store=True, solver_dtype="f32", tick_interval=1.0,
                minimum_refresh_interval=0.0, stream_push=True,
                stream_shards=4, flightrec_capacity=0, clock=clock,
                device=DEVICE)
            tls = dict(tls_cert=cert, tls_key=key) if side == "tls" else {}
            pool = server.attach_frontend(TLS_FE_WORKERS, ring_bytes=1 << 20,
                                          inline=False, **tls)
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            sides[side] = dict(server=server, pool=pool, port=port)
            backend = await server.start(0, host="127.0.0.1", tick_loop=False)
            await server.load_config(parse_yaml_config(TLS_CONFIG))
            server.current_master = f"127.0.0.1:{port}"
            await pool.start(f"127.0.0.1:{port}", f"127.0.0.1:{backend}")
        deadline = time.monotonic() + TLS_READY_S
        for side, d in sides.items():
            while len(d["pool"].control.status()["worker_held"]) < \
                    TLS_FE_WORKERS:
                check(time.monotonic() < deadline,
                      f"tls-frontend: the {side} workers never heartbeat")
                await asyncio.sleep(0.2)
        dense_cuda.reset_launches()  # the tls-frontend path starts here
        for side, d in sides.items():
            d["chan"] = _channel(grpc, d["port"],
                                 creds if side == "tls" else None)
            d["watch"] = d["chan"].unary_stream(
                f"/{SERVICE_NAME}/WatchCapacity",
                request_serializer=spb.WatchCapacityRequest.SerializeToString,
                response_deserializer=None)
            d["calls"], d["frames"], d["readers"] = [], [], []

        async def reader(call, frames):
            async for msg in call:
                frames.append(msg)

        def total():
            return sum(len(f) for d in sides.values() for f in d["frames"])

        async def settle(quiet=0.3, limit=10.0):
            """Until no frame has arrived on any stream for `quiet` s."""
            deadline = time.monotonic() + limit
            seen = -1
            while total() != seen and time.monotonic() < deadline:
                seen = total()
                await asyncio.sleep(quiet)

        async def tick_both():
            for d in sides.values():
                await d["server"].tick_once()
            now[0] += 1.0

        for w in range(TLS_FE_WATCHERS):
            req = spb.WatchCapacityRequest(client_id=f"fe-w{w}")
            for r in range(2):
                rr = req.resource.add()
                rr.resource_id = f"t.{'prop' if r else 'fair'}{w % 3}"
                rr.wants, rr.priority = 10.0 + w, 1
            for d in sides.values():
                call = d["watch"](req)
                d["calls"].append(call)
                d["frames"].append([])
                d["readers"].append(asyncio.ensure_future(
                    reader(call, d["frames"][-1])))
                deadline = time.monotonic() + 30
                while not d["frames"][-1]:
                    check(time.monotonic() < deadline
                          and not d["readers"][-1].done(),
                          "tls-frontend: no establishment snapshot")
                    await asyncio.sleep(0.02)
        for tick in range(TLS_FE_TICKS):
            for k in range(4):
                for d in sides.values():
                    d["server"]._decide(
                        f"t.{'prop' if k % 2 else 'fair'}{(tick + k) % 3}",
                        Request(f"churn{k}", 0.0, 20.0 + 7 * tick + k, 1,
                                priority=1))
            await tick_both()
            await settle()
        ended = [t for d in sides.values() for t in d["readers"] if t.done()]
        check(not ended, f"tls-frontend: {len(ended)} streams ended")
        torch.cuda.synchronize()
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        got, want = sides["tls"]["frames"], sides["plain"]["frames"]
        pushes = sum(len(f) for f in got)
        check(got == want, "tls-frontend: the TLS pool's frames differ from "
              "the plaintext pool's")
        check(pushes > TLS_FE_WATCHERS,
              f"tls-frontend: {pushes} frames, no push after establishment")
        check(launches["k1"] + launches["k2"] > 0,
              f"tls-frontend: the stream servers' ticks launched {launches}")
        return dict(watchers=TLS_FE_WATCHERS, frames=pushes,
                    bytes=sum(len(m) for f in got for m in f),
                    launches=launches)
    finally:
        for d in sides.values():
            for call in d.get("calls", ()):
                call.cancel()
            for t in d.get("readers", ()):
                t.cancel()
            if "chan" in d:
                await d["chan"].close()
            await asyncio.wait_for(d["server"].stop(), 60)


async def _tls_parent(torch, cert, key):
    """A batch-mode root on the card serving TLS and an intermediate
    dialing it with parent_tls_ca: the intermediate's capacities converge
    to the root's grants, as its plaintext twin's do."""
    from doorman_tpu_torch.algorithms import Request
    from doorman_tpu_torch.proto import doorman_pb2 as pb
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import (
        CapacityServer,
        default_resource_template,
    )

    out = {}
    for side in ("tls", "plain"):
        root = CapacityServer(
            f"root-{side}", TrivialElection(), mode="batch",
            native_store=True, solver_dtype="f32",
            minimum_refresh_interval=0.0, flightrec_capacity=0,
            device=DEVICE)
        inter = CapacityServer(
            f"inter-{side}", TrivialElection(), flightrec_capacity=0,
            minimum_refresh_interval=0.0, device=DEVICE,
            parent_tls_ca=cert if side == "tls" else None)
        try:
            tls = dict(tls_cert=cert, tls_key=key) if side == "tls" else {}
            port = await root.start(0, host="127.0.0.1", tick_loop=False,
                                    **tls)
            await root.load_config(parse_yaml_config(TLS_CONFIG))
            # Started as a root: the exchanges are driven by hand.
            await inter.start(0, host="127.0.0.1")
            inter.parent_addr = f"localhost:{port}"
            await inter.load_config(pb.ResourceRepository(
                resources=[default_resource_template()]), {})
            for i, (rid, wants) in enumerate((("t.prop0", 70.0),
                                              ("t.fair1", 45.0),
                                              ("t.prop2", 130.0))):
                inter._decide(rid, Request(f"ic{i}", 0.0, wants, 1))
            rounds = []
            for _ in range(3):
                got = await asyncio.wait_for(
                    inter._perform_parent_requests(0), 30)
                check(got[1] == 0, f"tls-parent: the {side} exchange failed")
                await root.tick_once()
                rounds.append({rid: res.capacity for rid, res in
                               sorted(inter.resources.items())})
            out[side] = rounds
        finally:
            await inter.stop()
            await root.stop()
    check(out["tls"] == out["plain"],
          f"tls-parent: {out['tls'][-1]} over TLS, {out['plain'][-1]} in "
          "the clear")
    check(out["tls"][-1] == {"t.fair1": 45.0, "t.prop0": 70.0,
                             "t.prop2": 130.0},
          f"tls-parent: the intermediate did not converge: {out['tls'][-1]}")
    return dict(capacities=out["tls"][-1], exchanges=len(out["tls"]))


def phase_tls(torch, card):
    """tls: the server binary over TLS beside its plaintext twin, request
    latency over TLS beside plaintext, frontend workers terminating TLS
    beside a plaintext pool, and an intermediate dialing a TLS root."""
    import tempfile

    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        cert, key = _tls_certs(tmp)
        # The latency leg's binaries come up while the grants are held.
        imm = _imm_binaries(tmp, cert, key)
        try:
            server = asyncio.run(_tls_server(tmp, cert, key))
        except BaseException:
            for b in imm.values():
                b.stop()
            raise
        say(f"phase tls-server: the batch-mode native-store binary over TLS "
            f"and its plaintext twin, {TLS_CLIENTS} port Clients x {TLS_RES} "
            f"resources: {server['grants']} grants equal after "
            f"{server['rounds']} rounds; served on {server['served']}; card "
            f"{card}")
        ids = _resource_ids(np.random.default_rng(71), IMM_RES)
        lat = asyncio.run(_tls_latency(imm, cert, ids))
        say(f"phase tls-latency: immediate mode, {IMM_CONC[0]} concurrent "
            f"clients x {IMM_CONC[1]} requests, twice each in turns: TLS p50 "
            f"{lat['tls']['p50_ms']:.3f} ms p99 {lat['tls']['p99_ms']:.3f} ms "
            f"({lat['tls']['requests_per_s']:.0f}/s), plaintext p50 "
            f"{lat['plain']['p50_ms']:.3f} ms p99 "
            f"{lat['plain']['p99_ms']:.3f} ms "
            f"({lat['plain']['requests_per_s']:.0f}/s); card {card}")
        fe = asyncio.run(_tls_frontend(torch, cert, key))
        say(f"phase tls-frontend: {TLS_FE_WORKERS} listener workers "
            f"terminating TLS beside a plaintext pool, {fe['watchers']} "
            f"streams each: {fe['frames']} frames ({fe['bytes']} bytes) "
            f"byte-equal over {TLS_FE_TICKS} churn ticks; launches "
            f"{fe['launches']}; card {card}")
        parent = asyncio.run(_tls_parent(torch, cert, key))
        say(f"phase tls-parent: an intermediate with parent_tls_ca against a "
            f"TLS root converged to {parent['capacities']} in "
            f"{parent['exchanges']} exchanges, as its plaintext twin; card "
            f"{card}")
    return dict(server=server, latency=lat, frontend=fe, parent=parent)


# -- phases beside the main sequence ----------------------------------------

# Host-bound phases that share no state with the main sequence run in
# processes of their own beside it: each builds its servers from its own
# seeds, zeroes and reads its own launch counts around its paths, and
# hands back its result as JSON. They start once the kernels' timings are
# taken (another process's launches would share the card's time with
# them) and are joined before the phases that load every core (the
# admission storm, the frontend pool, the fleet's shard processes, TLS).
# Each one's lines are printed when it is joined.
# -- chaos: every shipped fault plan on the card ------------------------------

CH_REL = 1e-12  # card vs CPU store grants at f64 (the kernels' f64 bound)
CH_CLI_PLAN = "device_tunnel_outage"
CH_CLI_TIMEOUT_S = 300.0


def _chaos_grants(runner):
    """{server/resource: [(client, has)]} over every store of the run,
    and each resource's capacity (the stores stay readable after the
    runner's teardown)."""
    # A downstream server is a client of its parent under its own
    # address, a loopback port that differs from run to run: named here
    # by the server it is.
    names = {p.address: n for n, p in runner.proxies.items()}
    grants, caps = {}, {}
    for name, server in sorted(runner.servers.items()):
        for rid, res in sorted(server.resources.items()):
            key = f"{name}/{rid}"
            rows = []
            for row in res.store.dump_rows():
                head, sep, tail = row[0].partition("\x01")  # band leases
                rows.append((names.get(head, head) + sep + tail, row[3]))
            grants[key] = sorted(rows)
            caps[key] = float(res.capacity)
    return grants, caps


def _chaos_devices(runner):
    """The devices the batch servers of the run tick on: the server's own
    and those of the solvers it built."""
    devs = set()
    for server in runner.servers.values():
        if server.mode != "batch":
            continue
        devs.add(str(server.device))
        for solver, attr in ((server._solver, "device"),
                             (server._resident, "_device"),
                             (server._resident_wide, "_device")):
            if solver is not None:
                devs.add(str(getattr(solver, attr)))
    return devs


def _chaos_run(torch, name, device):
    """One run of a shipped plan through the port's ChaosRunner: the
    verdict, seconds, kernel launches (counted from zero just before the
    run and read just after), store grants and tick devices."""
    from doorman_tpu_torch.chaos import ChaosRunner, get_plan
    from doorman_tpu_torch.solver import dense_cuda

    runner = ChaosRunner(get_plan(name), device=device)
    dense_cuda.reset_launches()
    t = time.perf_counter()
    verdict = asyncio.run(runner.run())
    if device != "cpu":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = dict(dense_cuda.LAUNCHES)
    grants, caps = _chaos_grants(runner)
    ticks = {n: s._ticks_done for n, s in sorted(runner.servers.items())
             if s.mode == "batch"}
    return dict(verdict=verdict, seconds=secs, launches=launches,
                grants=grants, caps=caps, devices=_chaos_devices(runner),
                ticks=ticks)


def _masters(verdict):
    return [(e[0], e[2]) for e in verdict["event_log"] if e[1] == "master"]


def _kinds(verdict):
    """The event log's kinds, less the stream entries that are pushes
    alone: a push fires when a subscriber's grant moves at all, and on
    an overloaded proportional row the plain edge-list solve on the CPU
    moves the grant by an ulp a tick where the card's solve holds still
    (both within CH_REL of each other). Establishments, redirects,
    polls and every other kind stay in."""
    return [e[1] for e in verdict["event_log"]
            if not (e[1] == "stream" and e[3] == "push")]


def _chaos_check_plan(name, card_run, replay, cpu_run):
    """Every check of one plan's card run: the verdict, the plan's own
    arc where it has one, the replay, the tick device and the CPU twin."""
    from doorman_tpu_torch.chaos import get_plan

    plan = get_plan(name)
    v = card_run["verdict"]
    check(v["ok"] and not v["violations"],
          f"chaos {name}: verdict not ok, violations {v['violations'][:3]}")
    conv = v["converged_after_heal_ticks"]
    check(conv is not None and conv <= plan.reconverge_ticks,
          f"chaos {name}: converged after heal {conv} (budget "
          f"{plan.reconverge_ticks})")
    if replay["verdict"]["log_sha256"] != v["log_sha256"]:
        pairs = zip(v["event_log"], replay["verdict"]["event_log"])
        first = next(((a, b) for a, b in pairs if a != b), None)
        check(False, f"chaos {name}: the replay on the card gave another "
              f"log_sha256; first differing events {first}")
    batch = plan.setup.get("mode") == "batch"
    if batch:
        want = "cuda:0" if DEVICE == "cuda" else DEVICE
        check(card_run["devices"] == {want},
              f"chaos {name}: batch ticks on {sorted(card_run['devices'])}")
        check(sum(card_run["ticks"].values()) > 0,
              f"chaos {name}: no batch tick ran ({card_run['ticks']})")
    if name == "grant_corruption":
        audit = v["audit"]["s0"]
        check(audit["divergences"] == 1,
              f"chaos {name}: audit divergences {audit['divergences']}")
        detail = audit["details"][0]
        factor = plan.events[0].params["factor"]
        want = detail["expected"][0] * factor
        check(abs(detail["has"][0] - want) <= 1e-12 * max(abs(want), 1.0),
              f"chaos {name}: audit has {detail['has'][0]} != expected "
              f"{detail['expected'][0]} x {factor}")
    if name == "device_tunnel_outage":
        check(card_run["launches"]["k1"] + card_run["launches"]["k2"] > 0,
              f"chaos {name}: no K1 or K2 launch ({card_run['launches']})")
        errors = [e for e in v["event_log"] if e[1] == "tick_error"]
        check(len(errors) == 3, f"chaos {name}: {len(errors)} tick errors")
    c = cpu_run["verdict"]
    if _kinds(v) != _kinds(c):
        pairs = zip(_kinds(v), _kinds(c))
        first = next(((i, a, b) for i, (a, b) in enumerate(pairs)
                      if a != b), None)
        check(False, f"chaos {name}: the card's event kinds differ from "
              f"the CPU's; first difference (index, card, CPU) {first}")
    pushes = [sum(1 for e in x["event_log"] if e[1] == "stream"
                  and e[3] == "push") for x in (v, c)]
    check(_masters(v) == _masters(c),
          f"chaos {name}: master timeline {_masters(v)} != CPU "
          f"{_masters(c)}")
    check(card_run["grants"].keys() == cpu_run["grants"].keys(),
          f"chaos {name}: the card's stores hold other resources")
    worst = 0.0
    for key, rows in card_run["grants"].items():
        other = cpu_run["grants"][key]
        check([r[0] for r in rows] == [r[0] for r in other],
              f"chaos {name}: {key} holds other clients on the card")
        scale = max(card_run["caps"][key], 1e-300)
        for (_, a), (_, b) in zip(rows, other):
            worst = max(worst, abs(a - b) / max(scale, abs(a), abs(b)))
    check(worst <= CH_REL,
          f"chaos {name}: store grants card vs CPU {worst:.3g} > {CH_REL:g}")
    same_sha = v["log_sha256"] == c["log_sha256"]
    device_solve = batch and sum(card_run["ticks"].values()) > 0
    check(same_sha or device_solve,
          f"chaos {name}: log_sha256 differs from the CPU's with no device "
          "solve in the run")
    return dict(
        seconds=card_run["seconds"], replay_seconds=replay["seconds"],
        cpu_seconds=cpu_run["seconds"], launches=card_run["launches"],
        batch_ticks=card_run["ticks"], devices=sorted(card_run["devices"]),
        log_sha256=v["log_sha256"], sha_equal_cpu=same_sha,
        push_events={"card": pushes[0], "cpu": pushes[1]},
        grants_rel_err=worst, converged_after_heal_ticks=conv,
        events=len(v["event_log"]),
    )


def _chaos_cli(card, want_sha):
    """`python -m doorman_tpu_torch.cmd.chaos --plan device_tunnel_outage
    --device cuda` in a process of its own: exit 0, the in-process card
    run's log_sha256, batch ticks on cuda:0."""
    t = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "doorman_tpu_torch.cmd.chaos",
         "--plan", CH_CLI_PLAN, "--device", DEVICE],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=CH_CLI_TIMEOUT_S)
    secs = time.perf_counter() - t
    if out.returncode != 0:
        say(out.stdout[-2000:] + out.stderr[-4000:])
    check(out.returncode == 0, f"cmd.chaos exited {out.returncode}")
    verdict = json.loads(out.stdout)
    check(verdict["ok"], "cmd.chaos: verdict not ok")
    check(verdict["log_sha256"] == want_sha,
          "cmd.chaos: log_sha256 differs from the in-process card run")
    line = [ln for ln in out.stderr.splitlines() if "tick device" in ln]
    dev = DEVICE if DEVICE == "cpu" else "cuda:0"
    check(line and f"tick device {dev}," in line[-1],
          f"cmd.chaos: {line[-1:] or 'no tick device line'}")
    say(f"phase chaos: cmd.chaos --plan {CH_CLI_PLAN} --device {DEVICE} "
        f"exited 0 in {secs:.1f}s, log_sha256 equal to the in-process "
        f"run; {line[-1].strip()}; card {card}")
    return dict(seconds=secs, stderr_line=line[-1].strip())


def phase_chaos(torch, card):
    """Every shipped fault plan through the port's ChaosRunner on the card
    (twice: the replay pins log_sha256) and once on the CPU (the twin the
    card's run is held to), then cmd.chaos in a process of its own."""
    from doorman_tpu_torch.chaos.plans import PLANS

    t0 = time.perf_counter()
    plans = {}
    for name in PLANS:
        card_run = _chaos_run(torch, name, DEVICE)
        replay = _chaos_run(torch, name, DEVICE)
        cpu_run = _chaos_run(torch, name, "cpu")
        res = _chaos_check_plan(name, card_run, replay, cpu_run)
        plans[name] = res
        say(f"phase chaos[{name}]: ok in {res['seconds']:.2f}s on the card "
            f"(replay {res['replay_seconds']:.2f}s, CPU "
            f"{res['cpu_seconds']:.2f}s), converged "
            f"{res['converged_after_heal_ticks']} ticks after heal, "
            f"{res['events']} events, launches {res['launches']}, batch "
            f"ticks {res['batch_ticks']} on {res['devices'] or 'no batch server'}, "
            f"log_sha256 {'equal to' if res['sha_equal_cpu'] else 'unlike'} "
            f"the CPU's, store grants vs CPU {res['grants_rel_err']:.3g}, "
            f"push events {res['push_events']['card']} (CPU "
            f"{res['push_events']['cpu']})")
    cli = _chaos_cli(card, plans[CH_CLI_PLAN]["log_sha256"])
    secs = time.perf_counter() - t0
    say(f"phase chaos: {len(plans)} plans held on the card in {secs:.1f}s; "
        f"card {card}")
    return dict(plans=plans, cli=cli, seconds=secs)


# -- loadtest-lane: an RPC storm on the lane cell's real tick loop -------------

LT_RESOURCE = "prop.t0.storm"  # the lane config's prop.t0.* template
LT_WORKERS = 48
LT_PROCS = 4
LT_BANDS = (0, 1, 2)
LT_SECONDS = 10.0
LT_WARM_TICKS = 3
LT_FREE_TICKS = 8  # storm-free ticks the storm's ticks are set beside
LT_P99_LIMIT_S = 1.0  # PERF.md §2: the request limit


async def _lt_lane(torch):
    """The f32 lane cell (1M leases, K = 128, native store, depth-3
    pipeline) on its real `_tick_loop` at 1 s with 5% churn a tick, then
    run_storm_procs against it."""
    import functools

    import numpy as np

    from doorman_tpu_torch.loadtest.storm import run_storm_procs
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver import dense_cuda

    rng = np.random.default_rng(16)
    server = CapacityServer(
        "loadtest-lane", TrivialElection(), mode="batch", native_store=True,
        solver_dtype="f32", fused_tick=True, scoped_solve=True,
        tick_pipeline_depth=3, tick_interval=1.0, flightrec_capacity=0,
        device=DEVICE,
    )
    port = await server.start(0, host="127.0.0.1", tick_loop=False)
    try:
        await server.load_config(parse_yaml_config(_config_yaml()))
        t = time.perf_counter()
        resources, rids, cids = _populate(server, rng)
        say(f"phase loadtest-lane: {len(resources)} resources, "
            f"{server._store_engine.total_leases} leases populated in "
            f"{time.perf_counter() - t:.1f}s")
        engine = server._store_engine
        tick_once = server.tick_once
        ticks = []  # (start, wall s, solve mode)

        async def churned_tick():
            # 5% of the resources take new demand before each tick of the
            # loop, as the lane cell's churn does.
            _churn(engine, rng, rids, cids)
            start = time.perf_counter()
            await tick_once()
            ticks.append((start, time.perf_counter() - start,
                          server._resident.last_solve_mode))

        server.tick_once = churned_tick
        loop_task = asyncio.create_task(server._tick_loop())
        server._tasks.append(loop_task)
        while len(ticks) < LT_WARM_TICKS + LT_FREE_TICKS:
            await asyncio.sleep(0.05)
        free = [w for _s, w, _m in ticks[LT_WARM_TICKS:]]
        phase0 = dict(server._resident.phase_s)
        n0 = len(ticks)
        loop = asyncio.get_running_loop()
        dense_cuda.reset_launches()  # the storm's path starts here
        t_call = time.perf_counter()
        try:
            out = await loop.run_in_executor(None, functools.partial(
                run_storm_procs, f"127.0.0.1:{port}", LT_RESOURCE,
                procs=LT_PROCS, workers=LT_WORKERS, duration=LT_SECONDS,
                bands=LT_BANDS, seed=16))
        except RuntimeError as e:
            raise PhaseFailed(f"loadtest-lane: {e}") from None
        t_end = time.perf_counter()
        torch.cuda.synchronize()
        launches = dict(dense_cuda.LAUNCHES)  # read just after
        n1 = len(ticks)
        phases = {k: (v - phase0.get(k, 0.0)) * 1e3 / max(n1 - n0, 1)
                  for k, v in server._resident.phase_s.items()
                  if v - phase0.get(k, 0.0) > 0}
        storm_from = t_end - out["duration_s"]
        storm = [(w, m) for s, w, m in ticks[n0:n1] if s >= storm_from]
        # The loop stops; quiet ticks deliver every row after the last
        # churn, so the store of record can be held to the device.
        loop_task.cancel()
        try:
            await loop_task
        except asyncio.CancelledError:
            pass
        server._tasks.remove(loop_task)
        for _ in range(QUIET_TICKS):
            await tick_once()
        await server.flush_ticks()
        torch.cuda.synchronize()
        storm_res = server.resources.get(LT_RESOURCE)
        check(storm_res is not None, "loadtest-lane: no storm resource")
        err, oracle_err, settling = _check_server_grants(
            torch, server, resources)
        storm_rows = storm_res.store.dump_rows()
        storm_sum = float(sum(row[3] for row in storm_rows))
        return dict(out=out, free=free, storm=storm, launches=launches,
                    phases=phases, call_s=t_end - t_call, err=err,
                    oracle_err=oracle_err, settling=settling,
                    storm_sum=storm_sum, storm_cap=float(storm_res.capacity),
                    storm_clients=len(storm_rows),
                    storm_in_narrow=LT_RESOURCE not in server._wide_ids)
    finally:
        await server.stop()


def phase_loadtest_lane(torch, card):
    """48 closed-loop poll workers in 4 spawned processes, bands 0/1/2,
    against the lane cell's server on its real tick loop: request
    latency by band in batch mode, the tick wall under the storm beside
    the storm-free ticks, and K1/K2 launched by the storm's ticks."""
    t0 = time.perf_counter()
    r = asyncio.run(_lt_lane(torch))
    out = r["out"]
    check(out["errors"] == 0, f"loadtest-lane: {out['errors']} storm errors")
    check(out["procs"] == LT_PROCS,
          f"loadtest-lane: {out['procs']} of {LT_PROCS} processes reported")
    check(out["ok"] > 0, "loadtest-lane: no request answered")
    check(out["p99_s"] <= LT_P99_LIMIT_S and all(
        v <= LT_P99_LIMIT_S for v in out["p99_s_by_band"].values()),
        f"loadtest-lane: request p99 {out['p99_s']} s, by band "
        f"{out['p99_s_by_band']} (limit {LT_P99_LIMIT_S} s)")
    k12 = r["launches"]["k1"] + r["launches"]["k2"]
    check(k12 > 0, f"loadtest-lane: no K1 or K2 launch ({r['launches']})")
    check(r["storm_in_narrow"] and r["storm_clients"] <= 128,
          f"loadtest-lane: the storm row holds {r['storm_clients']} clients "
          "outside the narrow bucket")
    check(r["storm_sum"] <= r["storm_cap"] * (1.0 + 1e-6),
          f"loadtest-lane: Σ grants {r['storm_sum']} on {LT_RESOURCE} past "
          f"its capacity {r['storm_cap']}")
    check(len(r["storm"]) > 0, "loadtest-lane: no tick during the storm")
    free_p50, free_p95 = _pcts(r["free"])
    storm_p50, storm_p95 = _pcts([w for w, _m in r["storm"]])
    modes = [m for _w, m in r["storm"]]
    secs = time.perf_counter() - t0
    by_band = {b: (out["p50_s_by_band"][b] * 1e3, out["p99_s_by_band"][b] * 1e3)
               for b in sorted(out["p50_s_by_band"])}
    say(f"phase loadtest-lane: {out['workers']} poll workers in "
        f"{out['procs']} processes, bands {list(LT_BANDS)}, "
        f"{out['duration_s']:.2f}s: {out['ok']} answered "
        f"({out['goodput_qps']:.1f} ok/s), {out['errors']} errors, "
        f"{out['redirects']} redirects; request p50 / p99 "
        f"{out['p50_s'] * 1e3:.3f} / {out['p99_s'] * 1e3:.3f} ms, by band "
        + ", ".join(f"{b}: {p50:.3f} / {p99:.3f}"
                    for b, (p50, p99) in by_band.items())
        + f" ms; card {card}")
    say(f"phase loadtest-lane: tick wall p50 / p95 {storm_p50:.2f} / "
        f"{storm_p95:.2f} ms over {len(r['storm'])} storm ticks (modes "
        f"scoped={modes.count('scoped')} full={modes.count('full')}) "
        f"against {free_p50:.2f} / {free_p95:.2f} ms over "
        f"{len(r['free'])} storm-free ticks; launches during the storm "
        f"{r['launches']}; host phase ms per storm tick: " + ", ".join(
            f"{k} {v:.3f}" for k, v in r["phases"].items()))
    say(f"phase loadtest-lane: after {QUIET_TICKS} quiet ticks K1 vs plain "
        f"{r['err']:.3g}, vs f64 oracle {r['oracle_err']:.3g}, store == "
        f"device on converged rows; {LT_RESOURCE}: {r['storm_clients']} "
        f"clients, Σ grants {r['storm_sum']:.6g} of {r['storm_cap']:g}; "
        f"{secs:.1f}s")
    return dict(
        storm={k: v for k, v in out.items()
               if k not in ("latencies_sorted", "latencies_sorted_by_band")},
        request_ms_by_band={str(b): {"p50": p50, "p99": p99}
                            for b, (p50, p99) in by_band.items()},
        tick_ms={"storm": {"p50": storm_p50, "p95": storm_p95,
                           "ticks": len(r["storm"])},
                 "storm_free": {"p50": free_p50, "p95": free_p95,
                                "ticks": len(r["free"])}},
        host_phase_ms=r["phases"], launches=r["launches"],
        storm_sum=r["storm_sum"], storm_cap=r["storm_cap"],
        oracle_err=r["oracle_err"], seconds=secs)


# -- workload: the workload harness's scenarios on the card -------------------

WL_SMALL = (
    "diurnal", "flash_crowd", "rolling_deploy", "multi_region",
    "elastic_preempt", "flash_crowd_federated", "diurnal_streaming",
    "diurnal_streaming_pooled", "flash_crowd_predictive", "reshard_diurnal",
)
WL_STREAMING = ("diurnal_streaming", "diurnal_streaming_pooled")
WL_SEED = 0
WL_MILLION_SCALE = 1.0  # diurnal_million: never cut
# flash_crowd_million's decide is quadratic in the parked population in
# both packages (PRIORITY_BANDS decides one request at a time over every
# lease of the store): 1.0 would take days, so the phase runs three small
# scales and fits the exponent of seconds against clients.
WL_FCM_SCALES = (0.001, 0.003, 0.01)
WL_TWIN_SCALE = 0.01  # the million scenarios' CPU twins
WL_PEAK_MIN = 1_000_000
WL_REFRESH_OK_MIN = 0.95
WL_TOP_GOODPUT_MIN = 0.9
WL_CLI_SCENARIO = "flash_crowd_predictive"
WL_CLI_TIMEOUT_S = 300.0


class _WlCapture:
    """Wraps WorkloadRunner's `_setup`, `_teardown` and the forecaster's
    `observe` while it is entered: each run's setup seconds, its
    forecaster's observe walls and, just before teardown stops the
    servers, what the run built and on which device."""

    def __init__(self):
        self.runs = []

    def __enter__(self):
        from doorman_tpu_torch.workload import harness
        from doorman_tpu_torch.workload.forecast import SeasonalForecaster

        cls = harness.WorkloadRunner
        self._saved = (cls._setup, cls._teardown, SeasonalForecaster.observe)
        setup0, teardown0, observe0 = self._saved
        runs = self.runs

        async def setup(runner):
            t = time.perf_counter()
            try:
                await setup0(runner)
            finally:
                runner._wl_setup_s = time.perf_counter() - t

        async def teardown(runner):
            runs.append(_wl_facts(runner))
            t = time.perf_counter()
            try:
                await teardown0(runner)
            finally:
                runs[-1]["teardown_s"] = time.perf_counter() - t

        def observe(fc, x):
            t = time.perf_counter()
            out = observe0(fc, x)
            fc.__dict__.setdefault("_wl_walls", []).append(
                time.perf_counter() - t)
            return out

        cls._setup, cls._teardown = setup, teardown
        SeasonalForecaster.observe = observe
        return self

    def __exit__(self, *exc):
        from doorman_tpu_torch.workload import harness
        from doorman_tpu_torch.workload.forecast import SeasonalForecaster

        cls = harness.WorkloadRunner
        cls._setup, cls._teardown, SeasonalForecaster.observe = self._saved


def _wl_facts(runner):
    """What one run built, read before its teardown: the servers' and the
    forecaster's devices, the stream registries and matchers, the vector
    engine's driver ticks and decide rows."""
    facts = {
        "name": runner.spec.name,
        "setup_s": getattr(runner, "_wl_setup_s", 0.0),
        "server_devices": sorted({str(s.device)
                                  for s in runner.servers.values()}),
        "server_device_types": sorted({s.device.type
                                       for s in runner.servers.values()}),
    }
    streams = {}
    for name, server in sorted(runner.servers.items()):
        if server._streams is None:
            continue
        st = server._streams.status()
        matcher = server._stream_matcher
        streams[name] = {
            "subscribers": st["subscribers"], "deltas": st["deltas_total"],
            "messages": st["messages_total"],
            "matcher": None if matcher is None else {
                "matched_total": matcher.matched_total,
                "device": str(matcher._device)},
        }
    facts["streams"] = streams
    fc = runner.forecaster
    if fc is not None:
        facts["forecaster"] = {
            "engine": fc.engine, "device": str(fc.device),
            "state_devices": sorted({str(getattr(v, "device", "numpy"))
                                     for v in fc._state}),
            "observe_walls": list(fc.__dict__.get("_wl_walls", [])),
            "obj": fc,
        }
    vec = runner._vector
    if vec is not None:
        walls = vec.step_walls
        facts["vector"] = {
            "ticks": len(walls),
            "tick_mean_ms": 1e3 * sum(walls) / max(len(walls), 1),
            "tick_max_ms": 1e3 * max(walls, default=0.0),
            "ticks_s": sum(walls),
            "fast_rows": vec.fast_rows_total, "seq_rows": vec.seq_rows_total,
            "seq_ticks": vec.seq_ticks, "population": vec.population(),
        }
    return facts


def _wl_run(torch, name, device, scale=1.0):
    """One run of a named scenario through run_scenario on `device`: its
    verdict, seconds, kernel launches (counted from zero just before the
    run and read just after) and what each runner of it built."""
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.workload.scenarios import run_scenario

    with _WlCapture() as cap:
        dense_cuda.reset_launches()
        t = time.perf_counter()
        verdict = run_scenario(name, scale=scale, seed=WL_SEED, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = dict(dense_cuda.LAUNCHES)
    return dict(verdict=verdict, seconds=secs, launches=launches,
                runs=cap.runs)


def _wl_shas(verdict):
    """The run's log_sha256 and, for the predictive pair, the reactive
    run's too."""
    return (verdict["log_sha256"],
            (verdict.get("reactive") or {}).get("log_sha256"))


def _wl_same(name, runs):
    """Every run's log_sha256 equal; else the first differing event."""
    (first_label, first), rest = runs[0], runs[1:]
    for label, other in rest:
        if _wl_shas(other["verdict"]) == _wl_shas(first["verdict"]):
            continue
        pairs = zip(first["verdict"]["event_log"], other["verdict"]["event_log"])
        diff = next(((i, a, b) for i, (a, b) in enumerate(pairs) if a != b),
                    None)
        check(False, f"workload {name}: the {label} run's log_sha256 differs "
              f"from the {first_label} run's; first difference (index, "
              f"{first_label}, {label}) {diff}")


def _wl_devices(name, run, want):
    """Every server (and forecaster) of every runner of the run on `want`."""
    for facts in run["runs"]:
        check(facts["server_device_types"] == [want],
              f"workload {name}: servers on {facts['server_devices']}, not "
              f"{want}")
        fc = facts.get("forecaster")
        if fc is not None:
            check(fc["engine"] == "device" and fc["device"].startswith(want)
                  and all(d.startswith(want) for d in fc["state_devices"]),
                  f"workload {name}: forecaster {fc['engine']} on "
                  f"{fc['device']}, state on {fc['state_devices']}")


def _wl_forecast_ms(torch, facts):
    """The forecaster's step on its own device between CUDA events, the
    launches queued behind a spin, on a copy of the run's final state."""
    import numpy as np

    from doorman_tpu_torch.workload.forecast import device_step

    fc = facts["forecaster"]["obj"]
    state = tuple(v.clone() for v in fc._state)
    x = torch.from_numpy(np.full(fc.series, 7.5, np.float32)).to(fc.device)
    return _time_ms(torch, lambda: device_step(
        state, x, 0, 1 % fc.period, fc.alpha, fc.beta), queued=True)


def _wl_small(torch, name):
    """One small scenario: the card run, its replay and the CPU twin."""
    card_run = _wl_run(torch, name, DEVICE)
    replay = _wl_run(torch, name, DEVICE)
    cpu_run = _wl_run(torch, name, "cpu")
    v = card_run["verdict"]
    for label, run in (("card", card_run), ("replay", replay),
                       ("CPU", cpu_run)):
        bad = [x["slo"] for x in run["verdict"]["slo"]["verdicts"]
               if x["status"] == "fail"]
        check(run["verdict"]["ok"], f"workload {name}: the {label} run's "
              f"verdict is not ok (failed {bad})")
    _wl_same(name, [("card", card_run), ("replay", replay),
                    ("CPU", cpu_run)])
    want = "cuda" if DEVICE != "cpu" else "cpu"
    _wl_devices(name, card_run, want)
    _wl_devices(name, replay, want)
    _wl_devices(name, cpu_run, "cpu")
    facts = card_run["runs"][0]
    pushes = v["summary"]["stream_pushes"]
    streams = facts["streams"]
    if name in WL_STREAMING:
        check(pushes > 0 and streams and all(
            s["deltas"] > 0 for s in streams.values()),
            f"workload {name}: no stream push ({pushes}, {streams})")
    matchers = {n: s["matcher"] for n, s in streams.items()}
    forecast_ms = observe_us = None
    if "forecaster" in facts:
        check(v["summary"]["forecaster"]["ticks_observed"] == v["ticks"],
              f"workload {name}: the forecaster observed "
              f"{v['summary']['forecaster']['ticks_observed']} of "
              f"{v['ticks']} ticks")
        if DEVICE != "cpu":
            forecast_ms = _wl_forecast_ms(torch, facts)
        walls = facts["forecaster"]["observe_walls"][1:]
        observe_us = 1e6 * sorted(walls)[len(walls) // 2] if walls else None
    return dict(
        seconds=card_run["seconds"], replay_seconds=replay["seconds"],
        cpu_seconds=cpu_run["seconds"], ticks=v["ticks"],
        peak_population=v["summary"]["peak_population"],
        stream_pushes=pushes, launches=card_run["launches"],
        replay_launches=replay["launches"], log_sha256=v["log_sha256"],
        reactive_sha256=_wl_shas(v)[1], events=len(v["event_log"]),
        setup_s=facts["setup_s"], servers=facts["server_devices"],
        streams={n: {k: s[k] for k in ("subscribers", "deltas", "messages")}
                 for n, s in streams.items()},
        matchers=matchers, forecast_step_ms=forecast_ms,
        forecast_observe_p50_us=observe_us,
        summary={k: x for k, x in v["summary"].items() if k != "forecaster"})


def _wl_million_entry(run):
    """Seconds, setup / ticks / teardown split and the vector engine's
    driver ticks of one million-scenario run."""
    facts = run["runs"][0]
    vec = facts["vector"]
    v = run["verdict"]
    return dict(
        seconds=run["seconds"], setup_s=facts["setup_s"],
        ticks_s=run["seconds"] - facts["setup_s"] - facts["teardown_s"],
        teardown_s=facts["teardown_s"], driver_ticks_s=vec["ticks_s"],
        driver_tick_mean_ms=vec["tick_mean_ms"],
        driver_tick_max_ms=vec["tick_max_ms"], fast_rows=vec["fast_rows"],
        seq_rows=vec["seq_rows"], seq_ticks=vec["seq_ticks"],
        peak_population=v["summary"]["peak_population"],
        refresh_ok_ratio=v["summary"].get("refresh_ok_ratio"),
        top_band_goodput=next(
            (x["observed"] for x in v["slo"]["verdicts"]
             if x["slo"].endswith(":top_band_goodput")), None),
        launches=run["launches"], log_sha256=v["log_sha256"],
        servers=facts["server_devices"])


def _wl_say_million(name, scale, e, card):
    say(f"phase workload[{name} x{scale:g}]: ok in {e['seconds']:.2f}s "
        f"(setup {e['setup_s']:.2f}s, ticks {e['ticks_s']:.2f}s, teardown "
        f"{e['teardown_s']:.2f}s), peak population "
        f"{e['peak_population']:.0f}, refresh ok "
        f"{e['refresh_ok_ratio']}, top-band goodput {e['top_band_goodput']}; "
        f"driver tick mean / max {e['driver_tick_mean_ms']:.2f} / "
        f"{e['driver_tick_max_ms']:.2f} ms; decide rows fast "
        f"{e['fast_rows']} vs sequential {e['seq_rows']} (sequential on "
        f"{e['seq_ticks']} ticks); launches {e['launches']}; servers on "
        f"{e['servers']}; card {card}")


def _wl_million(torch, card):
    """diurnal_million at full scale, flash_crowd_million at the small
    scales with the exponent of seconds against clients, and each one's
    CPU twin at WL_TWIN_SCALE."""
    import numpy as np

    want = "cuda" if DEVICE != "cpu" else "cpu"
    out = {}
    name = "diurnal_million"
    run = _wl_run(torch, name, DEVICE, scale=WL_MILLION_SCALE)
    v = run["verdict"]
    check(v["ok"], f"workload {name}: verdict not ok")
    _wl_devices(name, run, want)
    e = _wl_million_entry(run)
    check(e["peak_population"] >= WL_PEAK_MIN * WL_MILLION_SCALE,
          f"workload {name}: peak population {e['peak_population']}")
    check(e["refresh_ok_ratio"] >= WL_REFRESH_OK_MIN,
          f"workload {name}: refresh ok ratio {e['refresh_ok_ratio']}")
    _wl_say_million(name, WL_MILLION_SCALE, e, card)
    out[name] = {f"{WL_MILLION_SCALE:g}": e}
    name = "flash_crowd_million"
    fcm = {}
    for scale in WL_FCM_SCALES:
        run = _wl_run(torch, name, DEVICE, scale=scale)
        check(run["verdict"]["ok"], f"workload {name} x{scale:g}: verdict "
              "not ok")
        _wl_devices(name, run, want)
        e = _wl_million_entry(run)
        check(e["top_band_goodput"] is not None
              and e["top_band_goodput"] >= WL_TOP_GOODPUT_MIN,
              f"workload {name} x{scale:g}: top-band goodput "
              f"{e['top_band_goodput']}")
        _wl_say_million(name, scale, e, card)
        fcm[f"{scale:g}"] = dict(e, clients=e["peak_population"],
                                 run=run)
    clients = np.log([x["clients"] for x in fcm.values()])
    secs = np.log([x["seconds"] for x in fcm.values()])
    exponent = float(np.polyfit(clients, secs, 1)[0])
    say(f"phase workload[{name}]: seconds against clients "
        + ", ".join(f"{x['clients']:.0f}: {x['seconds']:.2f}s"
                    for x in fcm.values())
        + f"; fitted exponent {exponent:.3f} (scale 1.0, 1,000,000 parked "
        "clients, not run)")
    twins = {}
    for name in ("diurnal_million", "flash_crowd_million"):
        key = f"{WL_TWIN_SCALE:g}"
        card_run = (fcm[key]["run"] if name == "flash_crowd_million"
                    and key in fcm else
                    _wl_run(torch, name, DEVICE, scale=WL_TWIN_SCALE))
        cpu_run = _wl_run(torch, name, "cpu", scale=WL_TWIN_SCALE)
        check(card_run["verdict"]["ok"] and cpu_run["verdict"]["ok"],
              f"workload {name} x{key}: a twin's verdict is not ok")
        _wl_same(f"{name} x{key}", [("card", card_run), ("CPU", cpu_run)])
        _wl_devices(name, cpu_run, "cpu")
        twins[name] = dict(card_seconds=card_run["seconds"],
                           cpu_seconds=cpu_run["seconds"],
                           log_sha256=card_run["verdict"]["log_sha256"])
        say(f"phase workload[{name} x{key} twins]: log_sha256 equal on the "
            f"card ({card_run['seconds']:.2f}s) and the CPU "
            f"({cpu_run['seconds']:.2f}s)")
    for x in fcm.values():
        x.pop("run")
    out["flash_crowd_million"] = fcm
    out["flash_crowd_million_exponent"] = exponent
    out["twins"] = twins
    return out


def _wl_cli(card, want_sha):
    """`python -m doorman_tpu_torch.cmd.workload --scenario
    flash_crowd_predictive --device cuda` in a process of its own: exit 0,
    the in-process card run's log_sha256, the tick device on stderr."""
    t = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "doorman_tpu_torch.cmd.workload",
         "--scenario", WL_CLI_SCENARIO, "--device", DEVICE],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=WL_CLI_TIMEOUT_S)
    secs = time.perf_counter() - t
    if out.returncode != 0:
        say(out.stdout[-2000:] + out.stderr[-4000:])
    check(out.returncode == 0, f"cmd.workload exited {out.returncode}")
    verdict = json.loads(out.stdout)
    check(verdict["ok"], "cmd.workload: verdict not ok")
    check(verdict["log_sha256"] == want_sha,
          "cmd.workload: log_sha256 differs from the in-process card run")
    line = [ln for ln in out.stderr.splitlines() if "tick device" in ln]
    dev = DEVICE if DEVICE == "cpu" else "cuda:0"
    check(line and line[-1].strip().endswith(f"tick device {dev}"),
          f"cmd.workload: {line[-1:] or 'no tick device line'}")
    say(f"phase workload: cmd.workload --scenario {WL_CLI_SCENARIO} --device "
        f"{DEVICE} exited 0 in {secs:.1f}s, log_sha256 equal to the "
        f"in-process run; {line[-1].strip()}; card {card}")
    return dict(seconds=secs, stderr_line=line[-1].strip())


def phase_workload(torch, card):
    """The workload harness's scenarios through run_scenario(..., device=
    "cuda"): the ten small ones at scale 1.0 (each replayed on the card and
    held to its CPU twin, log_sha256 equal), diurnal_million at 1,000,000
    clients, flash_crowd_million at three small scales, then cmd.workload
    in a process of its own."""
    t0 = time.perf_counter()
    small = {}
    for name in WL_SMALL:
        r = _wl_small(torch, name)
        small[name] = r
        if r["forecast_observe_p50_us"] is None:
            dev = "no forecaster"
        else:
            step = ("not timed" if r["forecast_step_ms"] is None
                    else f"{r['forecast_step_ms']:.4f} ms")
            dev = (f"forecaster step {step} between CUDA events, observe "
                   f"(upload, step, download) p50 "
                   f"{r['forecast_observe_p50_us']:.1f} us")
        match = ", ".join(
            f"{n}: {'none built' if m is None else m}"
            for n, m in r["matchers"].items()) or "no stream server"
        say(f"phase workload[{name}]: ok in {r['seconds']:.2f}s on the card "
            f"(replay {r['replay_seconds']:.2f}s, CPU {r['cpu_seconds']:.2f}s)"
            f", {r['ticks']} ticks, peak population "
            f"{r['peak_population']:.0f}, {r['stream_pushes']:.0f} pushes, "
            f"{r['events']} events, log_sha256 equal on card, replay and "
            f"CPU; servers on {r['servers']}; matcher {match}; {dev}; "
            f"launches {r['launches']}")
    small_s = time.perf_counter() - t0
    million = _wl_million(torch, card)
    million_s = time.perf_counter() - t0 - small_s
    cli = _wl_cli(card, small[WL_CLI_SCENARIO]["log_sha256"])
    card_runs = [r["launches"] for r in small.values()] + [
        e["launches"] for name in ("diurnal_million", "flash_crowd_million")
        for e in million[name].values()]
    launches = {k: sum(x[k] for x in card_runs) for k in ("k1", "k2", "k3")}
    secs = time.perf_counter() - t0
    say(f"phase workload: K1/K2/K3 launches over the card runs {launches} "
        f"(immediate mode: no tick solve); {len(small)} small scenarios in "
        f"{small_s:.1f}s, the million scenarios in {million_s:.1f}s, the CLI "
        f"in {cli['seconds']:.1f}s; {secs:.1f}s in all; card {card}")
    return dict(small=small, million=million, cli=cli, launches=launches,
                small_seconds=small_s, million_seconds=million_s,
                seconds=secs)

# -- the mesh (parallel/, solver/resident_mesh.py, --mesh) -------------------

MESH_SHARDS = 4  # shards of one card: mesh=make_mesh([4], [cuda:0] * 4)
MESH_TICKS = 8  # churn ticks (a config-epoch full tick at MESH_EPOCH_TICK)
MESH_EPOCH_TICK = 4
MESH_QUIET = 2
MESH_WIDE_TICKS = (6, 2)  # (churn, quiet) ticks of wide-1m
MESH_WIDE_CLIENTS = 1_000_000


def _mesh(torch, groups=1):
    """The 4-shard mesh of the one card. groups=2 names the card by two
    distinct device objects (cuda:0 for shards 0-1, cuda for 2-3): two
    device groups, each solving in a thread of its own, whose reduces
    meet in the combine across the middle shard boundary."""
    from doorman_tpu_torch.parallel import make_mesh

    half = MESH_SHARDS // 2
    devices = [torch.device(DEVICE, 0)] * MESH_SHARDS if groups == 1 else (
        [torch.device(DEVICE, 0)] * half
        + [torch.device(DEVICE)] * (MESH_SHARDS - half))
    mesh = make_mesh([MESH_SHARDS], ("clients",), devices)
    check(len(mesh.device_groups()) == groups,
          f"mesh: {len(mesh.device_groups())} device groups, not {groups}")
    return mesh


def _mesh_server(name, mesh, dtype_name="f32"):
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer

    return CapacityServer(
        name, TrivialElection(), mode="batch", native_store=True,
        solver_dtype=dtype_name, fused_tick=True, scoped_solve=True,
        tick_pipeline_depth=3, tick_interval=1.0, flightrec_capacity=0,
        device=DEVICE, mesh=mesh,
    )


async def _mesh_tick(torch, server, mesh_run):
    """One tick_once; on the mesh server, the wrappers' launches of that
    tick (dense_cuda.LAUNCHES before and after) and its per-shard bytes."""
    from doorman_tpu_torch.obs.phases import last_shard_bytes
    from doorman_tpu_torch.solver import dense_cuda

    before = dict(dense_cuda.LAUNCHES)
    t = time.perf_counter()
    await server.tick_once()
    wall = time.perf_counter() - t
    if mesh_run is not None:
        for k in ("k1", "k2"):
            mesh_run["launches"][k] += dense_cuda.LAUNCHES[k] - before[k]
        for (comp, direction), per in last_shard_bytes().items():
            acc = mesh_run["bytes"].setdefault(
                f"{comp} {direction}", [0] * MESH_SHARDS)
            for d, b in enumerate(per):
                acc[d] += b
    return wall


def _mesh_walls(walls):
    """Tick p50 / p95 (ms) of the mesh and its twin after the first
    tick, and the first (rebuild) tick's wall on its own."""
    mesh, twin = walls["mesh"], walls["twin"]
    return {"p50": _pcts(mesh[1:])[0], "p95": _pcts(mesh[1:])[1],
            "twin_p50": _pcts(twin[1:])[0], "twin_p95": _pcts(twin[1:])[1],
            "rebuild_ms": mesh[0] * 1e3, "twin_rebuild_ms": twin[0] * 1e3}


async def _mesh_lane(torch):
    """The lane cell on a 4-shard mesh of the one card beside its
    single-device twin, from one seed, delta-tracked: stores and changed
    rows equal after every tick."""
    import numpy as np

    from doorman_tpu_torch.server.config import parse_yaml_config

    servers = [_mesh_server("smoke-mesh", _mesh(torch)),
               _mesh_server("smoke-mesh-twin", None)]
    ports, worlds, rngs = [], [], []
    try:
        for s in servers:
            ports.append(await s.start(0, host="127.0.0.1", tick_loop=False))
            # refresh_interval = the tick interval: every tick delivers
            # every row (rotate 1), since the mesh rotates per shard and
            # the twin over the whole table.
            await s.load_config(parse_yaml_config(_config_yaml(refresh=1)))
            rng = np.random.default_rng(61)
            worlds.append(_populate(s, rng))
            rngs.append(rng)
            s._resident_solver().enable_delta_tracking()
        run = {"launches": {"k1": 0, "k2": 0}, "bytes": {}}
        walls = {"mesh": [], "twin": []}
        modes = []
        for i in range(MESH_TICKS + MESH_QUIET):
            for s, (res, rids, cids), rng in zip(servers, worlds, rngs):
                if i < MESH_TICKS:
                    _churn(s._store_engine, rng, rids, cids)
                if i == MESH_EPOCH_TICK:
                    s._config_epoch += 1  # a full tick: K2 on each shard
            walls["mesh"].append(await _mesh_tick(torch, servers[0], run))
            walls["twin"].append(await _mesh_tick(torch, servers[1], None))
            modes.append(servers[0]._resident.last_solve_mode)
            check(modes[-1] == servers[1]._resident.last_solve_mode,
                  f"mesh-lane tick {i}: solve modes differ")
            diff = _byte_diff(_packed_has(servers[0]), _packed_has(servers[1]))
            check(diff == 0, f"mesh-lane tick {i}: {diff} leases differ "
                  "from the single-device twin")
            ch = [sorted(s._resident.take_changed_rids()) for s in servers]
            check(ch[0] == ch[1], f"mesh-lane tick {i}: changed rows differ")
        for s in servers:
            await s.flush_ticks()
        torch.cuda.synchronize()
        diff = _byte_diff(_packed_has(servers[0]), _packed_has(servers[1]))
        check(diff == 0, f"mesh-lane after the flush: {diff} leases differ")
        solver = servers[0]._resident
        shard = dict(solver.shard_launches)
        for k in ("k1", "k2"):
            check(sum(shard[k]) == run["launches"][k],
                  f"mesh-lane: per-shard {k} calls {shard[k]} do not sum to "
                  f"the wrapper's {run['launches'][k]} launches")
            check(all(n > 0 for n in shard[k]),
                  f"mesh-lane: {k} not launched on every shard: {shard[k]}")
        parity = _mesh_shard_parity(torch, solver)
        served = await _requests(torch, servers[0], ports[0], worlds[0][0])
        ticks = MESH_TICKS + MESH_QUIET
        return {
            "shards": MESH_SHARDS, "rows_per_shard": solver._Rp // MESH_SHARDS,
            "K": solver._K, "ticks": ticks, "modes": modes,
            **_mesh_walls(walls),
            "launches": run["launches"], "shard_launches": shard,
            "bytes_per_tick": {k: [b / ticks for b in v]
                               for k, v in run["bytes"].items()
                               if k.startswith("resident ")},
            "parity": parity, "served": served,
        }
    finally:
        for s in servers:
            await s.stop()


def _mesh_shard_parity(torch, solver):
    """K1 and K2 on shard 0's own tables (comparison launches, not
    counted) against the plain version."""
    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.dense import solve_dense

    batch = solver._shard_batch(0)
    saved = dict(dense_cuda.LAUNCHES)
    k1 = dense_cuda.solve_dense_k1(batch)
    dense_cuda.LAUNCHES.update(saved)
    p1 = solve_dense(batch)
    rel1 = _rel_err(torch, k1, p1, batch)
    check(rel1 <= F32_PARITY_REL_BOUND, f"mesh shard 0: K1 vs plain {rel1:.3g}")
    delivered = torch.zeros(batch.wants.shape[0], dtype=torch.bool,
                            device=batch.wants.device)
    delivered[::5] = True
    _res, err2, rel2 = _check_k2(torch, batch, solver._prev[0], delivered,
                                 "mesh shard 0")
    return {"k1_max_abs_err": (k1 - p1).abs().max().item(),
            "k1_rel_err": rel1, "k2_max_abs_err": err2, "k2_rel_err": rel2,
            "shape": list(batch.wants.shape)}


async def _mesh_wide(torch):
    """wide-1m on the 4-shard mesh, in two device groups, beside its
    single-device twin: one resource of 1,000,000 clients whose 245
    chunk rows straddle all three shard boundaries, the middle one
    between the groups; stores equal after every tick."""
    import numpy as np

    from doorman_tpu_torch.server.config import parse_yaml_config

    clients = MESH_WIDE_CLIENTS
    servers = [_mesh_server("smoke-mesh-wide", _mesh(torch, groups=2)),
               _mesh_server("smoke-mesh-wide-twin", None)]
    worlds, rngs = [], []
    yaml = _wide_yaml(["wide0"], 40.0 * clients).replace(
        "refresh_interval: 5", "refresh_interval: 1")  # rotate 1
    try:
        for s in servers:
            await s.start(0, host="127.0.0.1", tick_loop=False)
            await s.load_config(parse_yaml_config(yaml))
            rng = np.random.default_rng(62)
            res = s.get_or_create_resource("wide0")
            engine = s._store_engine
            rids = np.full(clients, res.store._rid, np.int32)
            cids = np.fromiter((engine.client_handle(f"w{i}")
                                for i in range(clients)), np.int64, clients)
            engine.bulk_assign(
                rids, cids, np.full(clients, time.time() + 3600.0),
                np.full(clients, 5.0), np.zeros(clients),
                rng.integers(1, 100, clients).astype(np.float64),
                np.ones(clients, np.int32),
            )
            worlds.append((rids, cids))
            rngs.append(rng)
        churn, quiet = MESH_WIDE_TICKS
        walls = {"mesh": [], "twin": []}
        n_churn = clients // 20
        modes = []
        for i in range(churn + quiet):
            for s, (rids, cids), rng in zip(servers, worlds, rngs):
                if 0 < i < churn:
                    pick = rng.choice(clients, n_churn, replace=False)
                    s._store_engine.bulk_refresh(
                        rids[pick], cids[pick],
                        np.full(n_churn, time.time() + 3600.0),
                        np.full(n_churn, 5.0),
                        rng.integers(1, 100, n_churn).astype(np.float64),
                    )
            for s, key in zip(servers, ("mesh", "twin")):
                t = time.perf_counter()
                await s.tick_once()
                walls[key].append(time.perf_counter() - t)
            modes.append(servers[0]._resident_wide.last_solve_mode)
            diff = _byte_diff(_packed_has(servers[0]), _packed_has(servers[1]))
            check(diff == 0, f"mesh-wide tick {i}: {diff} leases differ "
                  "from the single-device twin")
        for s in servers:
            await s.flush_ticks()
        torch.cuda.synchronize()
        diff = _byte_diff(_packed_has(servers[0]), _packed_has(servers[1]))
        check(diff == 0, f"mesh-wide after the flush: {diff} leases differ")
        wide = servers[0]._resident_wide
        Rl = wide._Rp // MESH_SHARDS
        check(wide._R > (MESH_SHARDS - 1) * Rl,
              f"mesh-wide: {wide._R} chunk rows do not straddle all "
              f"{MESH_SHARDS - 1} boundaries of {Rl}-row shards")
        return {"chunk_rows": wide._R, "rows_per_shard": Rl,
                "device_groups": len(wide._combine.groups),
                "modes": modes, **_mesh_walls(walls)}
    finally:
        for s in servers:
            await s.stop()


def _mesh_priority(torch):
    """The priority cell's grouped solve (10,000 PRIORITY_BANDS rows x
    100 clients, 16 capacity groups of 500 shuffled over the rows, so
    every group spans every shard) through make_sharded_priority_solver
    on the 4-shard mesh, against the unsharded solve; K3's calls counted
    per shard."""
    import numpy as np

    from doorman_tpu_torch.parallel import (
        make_sharded_priority_solver,
        shard_priority,
    )
    from doorman_tpu_torch.solver import dense_cuda, priority_cuda
    from doorman_tpu_torch.solver.priority import (
        PriorityBatch,
        alloc_evaluations,
        solve_priority,
    )

    rng = np.random.default_rng(63)
    _ids, cap, group, gcap = _prio_layout(rng)
    R, K = N_PRIO, 128
    act = np.zeros((R, K), bool)
    act[:, :N_CLIENTS] = True
    host = PriorityBatch(
        wants=(rng.integers(0, 100, (R, K)) * act).astype(np.float32),
        weights=(rng.integers(1, 4, (R, K)) * act).astype(np.float32),
        band=(rng.integers(0, 4, (R, K)) * act).astype(np.int32),
        active=act, capacity=cap.astype(np.float32),
        group=group.astype(np.int32), group_cap=gcap.astype(np.float32),
    )
    mesh = _mesh(torch)
    batch = shard_priority(mesh, host)
    ptr = {s.data_ptr(): d for d, s in enumerate(batch.active.shards())}
    per_shard = [0] * MESH_SHARDS
    real = priority_cuda.alloc_banded_k3

    def counted(wants, *a, **kw):
        # Each shard's call passes that shard's own active mask (a[2]).
        d = ptr.get(a[2].data_ptr())
        if d is not None:
            per_shard[d] += 1
        return real(wants, *a, **kw)

    solve = make_sharded_priority_solver(mesh, num_bands=4)
    before = dense_cuda.LAUNCHES["k3"]
    priority_cuda.alloc_banded_k3 = counted
    try:
        t = time.perf_counter()
        got = solve(batch).numpy()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        priority_cuda.alloc_banded_k3 = real
    launched = dense_cuda.LAUNCHES["k3"] - before
    evals = alloc_evaluations(torch.float32, True)
    check(launched == MESH_SHARDS * evals,
          f"mesh-priority: {launched} K3 launches, want {MESH_SHARDS} "
          f"shards x {evals} evaluations")
    check(sum(per_shard) == launched and all(n == evals for n in per_shard),
          f"mesh-priority: K3 calls per shard {per_shard}")
    one = PriorityBatch(**{k: torch.from_numpy(np.asarray(v)).to(DEVICE)
                           for k, v in vars(host).items()})
    saved = dict(dense_cuda.LAUNCHES)
    want = solve_priority(one, num_bands=4, use_kernel=True).cpu().numpy()
    dense_cuda.LAUNCHES.update(saved)
    rel = float((np.abs(got - want).max(axis=1) / np.maximum(cap, 1.0)).max())
    check(rel <= K3_SOLVE_RTOL, f"mesh-priority: sharded vs unsharded "
          f"{rel:.3g} of capacity (limit {K3_SOLVE_RTOL})")
    usage = got.astype(np.float64).sum(axis=1)
    over = [g for g in range(N_GROUPS)
            if usage[group == g].sum() > gcap[g] * (1 + K3_SOLVE_RTOL)]
    check(not over, f"mesh-priority: groups {over} past their caps")
    return {"k3_launches": launched, "k3_per_shard": per_shard,
            "evaluations": evals, "rel_err": rel, "wall_ms": wall * 1e3}


def _mesh_procs(torch, tmp):
    """Two processes on the one card joined over gloo
    (tests/_torch_multihost_worker.py at f32): each holds 2 shards on
    cuda:0 and only its half of the edge table, runs the sharded edge
    solve and the sharded grouped priority solve on CUDA tensors, and
    holds its shards to the single-process result within 1e-5 of
    capacity."""
    import os

    worker = ROOT / "tests" / "_torch_multihost_worker.py"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DOORMAN_", "MASTER_"))}
    store = Path(tmp) / "mesh-rendezvous"
    procs, infos = [], []
    t = time.perf_counter()
    try:
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, str(worker), "--device", DEVICE,
                 "--dtype", "f32"],
                env=dict(env, PYTHONPATH=str(ROOT),
                         DOORMAN_COORDINATOR=f"file://{store}",
                         DOORMAN_NUM_PROCESSES="2",
                         DOORMAN_PROCESS_ID=str(rank),
                         DOORMAN_DIST_BACKEND="gloo"),
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, start_new_session=True,
            ))
        outs = [p.communicate(timeout=300)[0] for p in procs]
    except subprocess.TimeoutExpired:
        outs = None
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    check(outs is not None, "mesh-procs: a worker was still running at 300 s")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        line = [x for x in out.splitlines()
                if x.startswith("MULTIHOST WORKER OK ")]
        if p.returncode != 0 or not line:
            say(out[-4000:])
        check(p.returncode == 0 and line,
              f"mesh-procs: worker {rank} failed (rc {p.returncode})")
        infos.append(json.loads(line[0][len("MULTIHOST WORKER OK "):]))
    return {"seconds": time.perf_counter() - t, "workers": infos}


def _mesh_binary(torch, tmp):
    """The server binary with --mesh auto serving GetCapacity, its
    status()'s mesh read from /debug/vars; --mesh 3 exits 2 on the one
    card."""
    import os
    import socket
    import urllib.request

    import grpc

    from doorman_tpu_torch.proto import doorman_pb2 as pb
    from doorman_tpu_torch.proto.grpc_api import CapacityStub

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    cfg = Path(tmp) / "mesh-cfg.yml"
    cfg.write_text(_config_yaml())
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    base = [sys.executable, "-m", "doorman_tpu_torch.cmd.server",
            "--config", f"file:{cfg}", "--host", "127.0.0.1",
            "--mode", "batch", "--native-store", "--device", DEVICE,
            "--tick-interval", "0.2", "--log-level", "warning"]
    t = time.perf_counter()
    bad = subprocess.run(base + ["--port", str(free_port()), "--debug-port",
                                 "-1", "--mesh", "3"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=180)
    check(bad.returncode == 2,
          f"mesh-binary: --mesh 3 exited {bad.returncode}, want 2: "
          f"{bad.stderr[-500:]}")
    bad_s = time.perf_counter() - t
    port, dport = free_port(), free_port()

    async def serve():
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub = CapacityStub(ch)
            deadline = time.time() + 120.0
            while True:
                check(proc.poll() is None and time.time() < deadline,
                      "mesh-binary: the server did not come up")
                try:
                    d = await stub.Discovery(pb.DiscoveryRequest(),
                                             timeout=1.0)
                    if d.is_master:
                        break
                except grpc.aio.AioRpcError:
                    pass
                await asyncio.sleep(0.5)
            served = 0
            for c in range(3):
                req = pb.GetCapacityRequest(client_id=f"c{c}")
                for r in range(20):
                    rr = req.resource.add()
                    rr.resource_id = f"prop.t{r % 4}.r{r}"
                    rr.wants, rr.priority = 10.0 + c, 1
                out = await stub.GetCapacity(req)
                served += len(out.response)
            await asyncio.sleep(1.0)  # ticks run on the mesh
            return served

    with open(Path(tmp) / "mesh-server.log", "w+") as log:
        proc = subprocess.Popen(
            base + ["--port", str(port), "--debug-port", str(dport),
                    "--mesh", "auto"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            served = asyncio.run(serve())
            deadline = time.time() + 60.0
            while True:  # until the mesh has ticked
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{dport}/debug/vars",
                        timeout=30) as resp:
                    status = json.loads(resp.read().decode())["servers"][0]
                if status.get("ticks", 0) > 0 or time.time() > deadline:
                    break
                time.sleep(0.5)
            check(proc.poll() is None, "mesh-binary: the server exited")
        except PhaseFailed:
            log.seek(0)
            say(log.read()[-4000:])
            raise
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    check(status["mesh"] == {"clients": torch.cuda.device_count()},
          f"mesh-binary: status mesh {status['mesh']}")
    check(status.get("ticks", 0) > 0, "mesh-binary: no tick ran")
    check(served == 60, f"mesh-binary: {served} of 60 grants answered")
    return {"mesh": status["mesh"], "ticks": status["ticks"],
            "served": served, "bad_spec_rc": bad.returncode,
            "bad_spec_s": bad_s, "seconds": time.perf_counter() - t}


def phase_mesh(torch, card):
    """Multi-device on the one card (parallel/, solver/resident_mesh.py,
    the server's mesh=, cmd.server --mesh): the lane cell and wide-1m on
    a 4-shard mesh beside single-device twins, byte for byte; the
    priority cell's grouped solve sharded; two processes joined over
    gloo; and the binary's --mesh."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for part, run in (
                ("lane", lambda: asyncio.run(_mesh_lane(torch))),
                ("wide", lambda: asyncio.run(_mesh_wide(torch))),
                ("priority", lambda: _mesh_priority(torch)),
                ("procs", lambda: _mesh_procs(torch, tmp)),
                ("binary", lambda: _mesh_binary(torch, tmp))):
            t = time.perf_counter()
            out[part] = run()
            say(f"phase mesh-{part}: {time.perf_counter() - t:.1f}s "
                f"{json.dumps(out[part])}")
    out["seconds"] = time.perf_counter() - t0
    lane, wide, pr = out["lane"], out["wide"], out["priority"]
    say(f"phase mesh: lane cell on {MESH_SHARDS} shards of {lane['rows_per_shard']}"
        f" rows x K {lane['K']}, {lane['ticks']} ticks byte-identical to "
        f"its twin (modes {lane['modes']}), rebuild tick "
        f"{lane['rebuild_ms']:.1f} ms (twin {lane['twin_rebuild_ms']:.1f}), "
        f"then p50 / p95 {lane['p50']:.2f} / {lane['p95']:.2f} ms (twin "
        f"{lane['twin_p50']:.2f} / {lane['twin_p95']:.2f}), K1 / K2 per shard "
        f"{lane['shard_launches']['k1']} / {lane['shard_launches']['k2']}, "
        f"bytes per tick per shard {lane['bytes_per_tick']}; wide-1m "
        f"{wide['chunk_rows']} chunk rows over shards of "
        f"{wide['rows_per_shard']} in {wide['device_groups']} device groups, "
        f"byte-identical, p50 / p95 "
        f"{wide['p50']:.2f} / {wide['p95']:.2f} ms (twin "
        f"{wide['twin_p50']:.2f} / {wide['twin_p95']:.2f}); priority K3 per "
        f"shard {pr['k3_per_shard']}, {pr['rel_err']:.3g} of capacity from "
        f"the unsharded solve, {pr['wall_ms']:.1f} ms; two gloo processes "
        f"ok in {out['procs']['seconds']:.1f}s "
        f"(staged through host: "
        f"{[w['staged_through_host'] for w in out['procs']['workers']]}); "
        f"--mesh auto status {out['binary']['mesh']}, --mesh 3 exit "
        f"{out['binary']['bad_spec_rc']}; {out['seconds']:.1f}s; card {card}")
    return out


BESIDE = {
    "streams": lambda torch, card: phase_streams(torch, card, "main"),
    "streams-scoped": lambda torch, card: phase_streams(torch, card, "scoped"),
    "takeover": phase_takeover,
    "workload": phase_workload,
}
BESIDE_JOIN_S = 900.0  # script time by which every one must have ended
BESIDE_THREADS = 2  # torch threads in each: four processes share 8 cores


class _Beside:
    """A BESIDE group running as `chip_smoke.py --beside GROUP CARD OUT`,
    in a session of its own so that it and every process it starts are
    stopped together."""

    def __init__(self, group, card, tmp, t0):
        self.group, self.t0 = group, t0
        self.out = Path(tmp) / f"{group}.json"
        self.log = Path(tmp) / f"{group}.log"
        self.start = time.perf_counter() - t0
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--beside",
                 group, card, str(self.out)],
                stdout=log, cwd=str(ROOT), start_new_session=True)

    def join(self):
        left = BESIDE_JOIN_S - (time.perf_counter() - self.t0)
        try:
            rc = self.proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            rc = None
        self.stop()
        for line in self.log.read_text().splitlines():
            say(line)
        end = time.perf_counter() - self.t0
        say(f"phase beside[{self.group}]: started at {self.start:.1f}s of "
            f"the script, joined at {end:.1f}s, rc {rc}")
        check(rc is not None, f"{self.group}: still running at "
              f"{BESIDE_JOIN_S:.0f}s of the script; stopped")
        check(rc == 0, f"{self.group} failed in its own process (rc {rc})")
        return json.loads(self.out.read_text())

    def stop(self):
        """Stops the group's session: its process and what it started."""
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()


def _beside_main(group, card, out) -> int:
    """One BESIDE group in this process; its result is written to `out`.
    Ends the group's session if the script that started it is gone."""
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    parent = os.getppid()

    def orphaned():
        while os.getppid() == parent:
            time.sleep(1.0)
        os.killpg(0, signal.SIGKILL)

    threading.Thread(target=orphaned, daemon=True).start()
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(BESIDE_THREADS)
    try:
        result = BESIDE[group](torch, card)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    Path(out).write_text(json.dumps(result))
    say(f"phase beside[{group}]: done in {time.perf_counter() - t0:.1f}s "
        "in its own process (importing torch included)")
    return 0


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
    beside, tmp = [], tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        name, card = phase_device(torch)
        registers = phase_build()
        worst = phase_kernels(torch)
        worst3, solve_err = phase_kernels_k3(torch)
        servers, prio = phase_server(torch, card)
        say(f"elapsed {time.perf_counter() - t0:.1f}s after server")
        tracked = phase_tracked(torch, servers["f32"]["server"])
        line = kernel_line(
            torch, servers["f32"]["server"], tracked,
            servers["f32"]["launches"], worst, registers,
        )
        line["kernels"].append(
            _k3_entry(torch, prio["f32"], worst3, solve_err, registers)
        )
        line["kernels"][0]["frontier_by_layout"] = phase_frontier(torch)
        say(f"elapsed {time.perf_counter() - t0:.1f}s after frontier")
        worst_global = phase_k3_global(torch)
        wide = phase_wide(torch, card)
        say(f"elapsed {time.perf_counter() - t0:.1f}s after wide")
        batch_lanes = phase_batch_lanes(torch, servers["f32"]["server"])
        overflow = phase_overflow(torch, servers["f32"]["server"])
        wide_prio = phase_wide_prio(torch, card)
        say(f"elapsed {time.perf_counter() - t0:.1f}s after wide_prio")
        timing = _k3_global_timing(torch, {
            **_wide_prio_tables(torch, wide_prio), **_k3_1m_tables(torch)})
        line["kernels"][-1]["cluster_layout"] = {
            "launches": wide_prio["f32"]["run"]["layouts"]["cluster"],
            "launches_f64": wide_prio["f64"]["run"]["layouts"]["cluster"],
            "timing": timing,
            "parity_rel_err": {k: v for k, v in worst_global.items()
                               if k.endswith("cluster")},
            "server_solve_rel_err": {
                k: v["solve_rel_err"] for k, v in wide_prio.items()},
            "solve_split": {k: v["split"] for k, v in wide_prio.items()},
            "tick_walls_ms": {
                k: [w * 1e3 for w in v["run"]["walls"]]
                for k, v in wide_prio.items()},
        }
        line["kernels"][-1]["global_layout"] = {
            "timing": {k: {"ms": v["global_ms"], "bound_ms": v["bound_ms"],
                           "share_of_bound": v["global_share_of_bound"],
                           "plain_ms": v["plain_ms"]}
                       for k, v in timing.items()},
            "parity_rel_err": {k: v for k, v in worst_global.items()
                               if k.endswith("global")},
        }
        line["wide"] = _wide_entry(torch, wide)
        line["wide"]["overflow"] = overflow
        line["wide"]["largest_churn_tick"] = {
            k: v["spike"] for k, v in wide.items()}
        line["kernels"][0]["batch_dense_lanes"] = batch_lanes
        # The phases beside the main sequence start here, after the
        # kernels' timings (BESIDE).
        beside.extend(_Beside(g, card, tmp, t0) for g in BESIDE)
        rt = phase_round_trip(torch, card)
        say(f"elapsed {time.perf_counter() - t0:.1f}s after round_trip")
        py = phase_python_store(torch, card)
        say(f"elapsed {time.perf_counter() - t0:.1f}s after python_store")
        imm = phase_immediate(torch, card)
        say(f"elapsed {time.perf_counter() - t0:.1f}s after immediate")
        tree = phase_tree(torch, card)
        say(f"elapsed {time.perf_counter() - t0:.1f}s after tree")
        obs = phase_obs(torch, card, servers, prio)
        say(f"elapsed {time.perf_counter() - t0:.1f}s after obs")
        fed = phase_federation(torch, card)
        say(f"elapsed {time.perf_counter() - t0:.1f}s after federation")
        done = {b.group: b.join() for b in beside}
        say(f"elapsed {time.perf_counter() - t0:.1f}s after the phases "
            "beside")
        streams = {**done["streams"], **done["streams-scoped"]}
        tk = done["takeover"]
        wl = done["workload"]
        # The round-trip server's K1 launches and the Python-store
        # server's K3 launches (f32) join the main path's counts; every
        # path's count stands beside them.
        k1, k3 = line["kernels"][0], line["kernels"][2]
        k1["launches_by_path"] = {
            "lane f32": k1["launches"],
            **{f"round-trip {d}": v["launches"]["k1"] for d, v in rt.items()
               if "launches" in v},
            **{f"round-trip {d} tracked": v["tracked_launches"]["k1"]
               for d, v in rt.items() if "launches" in v},
        }
        k1["launches"] += rt["f32"]["launches"]["k1"]
        k3["launches_by_path"] = {
            "priority f32": k3["launches"],
            **{f"python-store {d}": v["launches"]["k3"] for d, v in py.items()},
        }
        k3["launches"] += py["f32"]["launches"]["k3"]
        # K2 on the stream phases' tracked ticks (no stream phase carries
        # a PRIORITY_BANDS resource, so none launches K3).
        k2 = line["kernels"][1]
        stream_k2 = {
            "stream-parity": streams["stream_parity"]["launches"]["k2"],
            "streams": streams["streams"]["launches"]["k2"],
            "streams scoped": streams["streams_scoped"]["launches"]["k2"],
            **{f"stream-fanout-tiers {t['subscribers']}": t["launches"]["k2"]
               for t in streams["fanout_tiers"]["tiers"]},
        }
        k2["launches_by_path"] = {"tracked f32": k2["launches"], **stream_k2}
        k2["launches"] += sum(stream_k2.values())
        # K1 on the scoped ticks of the stream phases.
        stream_k1 = {
            "stream-parity": streams["stream_parity"]["launches"]["k1"],
            "streams scoped": streams["streams_scoped"]["launches"]["k1"],
        }
        k1["launches_by_path"].update(stream_k1)
        k1["launches"] += sum(stream_k1.values())
        line["round_trip"] = rt
        line["python_store"] = py
        line["immediate"] = imm
        line["streams"] = streams
        # The capacity tree: each kernel's launches on the tree's three
        # servers and on the root at scale.
        tree_by = {"tree": tree["tree"]["launches"], **{
            f"tree-root {d}": v["launches"]
            for d, v in tree["tree_root"].items()}}
        for key, entry in (("k1", k1), ("k2", k2), ("k3", k3)):
            adds = {path: n[key] for path, n in tree_by.items()}
            entry["launches_by_path"].update(adds)
            entry["launches"] += sum(adds.values())
        line["tree"] = tree
        # Observability: each kernel's launches on the obs lane and
        # priority runs, and its profiler times beside its CUDA-event
        # times.
        obs_by = {"obs lane f64": obs["lane_on"]["launches"],
                  "obs priority f32": obs["prio_launches"]}
        for key, entry in (("k1", k1), ("k2", k2), ("k3", k3)):
            adds = {path: n[key] for path, n in obs_by.items()}
            entry["launches_by_path"].update(adds)
            entry["launches"] += sum(adds.values())
            label = key.upper()
            entry["profiler"] = {
                "same_tables": obs["kernels"][label],
                "lane_capture": obs["lane_trace"]["kernels"].get(label),
                "priority_capture": obs["prio_trace"]["kernels"].get(label),
            }
        line["obs"] = {k: v for k, v in obs.items() if k != "kernels"}
        # Persistence and warm master takeover: each kernel's launches on
        # the takeover paths (the server binaries' launches are in their
        # own processes: their flight records carry the dispatches).
        tk_by = {
            "takeover A+twin f32": tk["lane"]["launches"]["a"],
            "takeover B f32": tk["lane"]["launches"]["b"],
            "takeover C f32": tk["lane"]["launches"]["c"],
            "takeover priority Q f32": tk["prio"]["launches"],
        }
        for key, entry in (("k1", k1), ("k2", k2), ("k3", k3)):
            adds = {path: n[key] for path, n in tk_by.items()}
            entry["launches_by_path"].update(adds)
            entry["launches"] += sum(adds.values())
        line["takeover"] = tk
        # Federation: each kernel's launches on the federation paths
        # (fed-parity, fed-roots, fed-intermediate; by path in
        # line["federation"]["launches"]).
        for key, entry in (("k1", k1), ("k2", k2), ("k3", k3)):
            entry["launches_by_path"]["federation"] = fed["total"][key]
            entry["launches"] += fed["total"][key]
        line["federation"] = fed
        say(f"elapsed {time.perf_counter() - t0:.1f}s before admission")
        # Admission and the frontend: K1/K2 on the admission-fused twins,
        # the pooled stream server and its twin, and the real pool's
        # server (no PRIORITY_BANDS resource on these paths: no K3).
        adm = phase_admission(torch, card)
        say(f"elapsed {time.perf_counter() - t0:.1f}s before frontend")
        fe = phase_frontend(torch, card)
        fe_by = {
            "admission-fused fused f32": adm["fused"]["fused"]["launches"],
            "admission-fused unfused f32":
                adm["fused"]["unfused"]["launches"],
            "frontend-pool f32": fe["pool"]["launches"],
        }
        for key, entry in (("k1", k1), ("k2", k2), ("k3", k3)):
            adds = {path: n[key] for path, n in fe_by.items()}
            entry["launches_by_path"].update(adds)
            entry["launches"] += sum(adds.values())
        line["admission"] = adm
        line["frontend"] = fe
        say(f"elapsed {time.perf_counter() - t0:.1f}s before fleet")
        # The fleet and TLS: K1/K2 on the fleet-reshard shard roots and
        # the TLS frontend's stream servers (no PRIORITY_BANDS resource
        # on these paths: no K3; the fleet-procs shards and the TLS
        # binaries tick in their own processes: their logs carry the
        # tick device and the ticks).
        fleet = phase_fleet(torch, card)
        say(f"elapsed {time.perf_counter() - t0:.1f}s before tls")
        tls = phase_tls(torch, card)
        fl_by = {
            "fleet-reshard f32": fleet["reshard"]["launches"],
            "tls-frontend f32": tls["frontend"]["launches"],
        }
        for key, entry in (("k1", k1), ("k2", k2), ("k3", k3)):
            adds = {path: n[key] for path, n in fl_by.items()}
            entry["launches_by_path"].update(adds)
            entry["launches"] += sum(adds.values())
        line["fleet"] = fleet
        line["tls"] = tls
        say(f"elapsed {time.perf_counter() - t0:.1f}s before chaos")
        # Chaos and the load tester: K1/K2 on the batch plans' ticks (the
        # first card run of each plan; its replay is not counted) and on
        # the lane cell's ticks under the storm. No PRIORITY_BANDS
        # resource on these paths: no K3.
        chaos = phase_chaos(torch, card)
        say(f"elapsed {time.perf_counter() - t0:.1f}s before loadtest-lane")
        lt = phase_loadtest_lane(torch, card)
        ch_by = {f"chaos {n}": v["launches"]
                 for n, v in chaos["plans"].items()
                 if any(v["launches"].values())}
        ch_by["loadtest-lane f32"] = lt["launches"]
        for key, entry in (("k1", k1), ("k2", k2), ("k3", k3)):
            adds = {path: n[key] for path, n in ch_by.items()}
            entry["launches_by_path"].update(adds)
            entry["launches"] += sum(adds.values())
        line["chaos"] = chaos
        line["loadtest_lane"] = lt
        say(f"elapsed {time.perf_counter() - t0:.1f}s before mesh")
        # The mesh: K1/K2 once per shard on the 4-shard lane cell's ticks,
        # K3 once per shard in each evaluation of the sharded grouped
        # solve (the wide mesh ticks run the plain chunked solve). Each
        # kernel's per-shard launches stand beside its total.
        mesh = phase_mesh(torch, card)
        for key, entry in (("k1", k1), ("k2", k2)):
            n = mesh["lane"]["launches"][key]
            entry["launches_by_path"][f"mesh-lane f32 ({MESH_SHARDS} shards)"] = n
            entry["launches"] += n
            entry["shard_launches"] = {
                "mesh-lane f32": mesh["lane"]["shard_launches"][key]}
        k3["launches_by_path"][f"mesh-priority f32 ({MESH_SHARDS} shards)"] = (
            mesh["priority"]["k3_launches"])
        k3["launches"] += mesh["priority"]["k3_launches"]
        k3["shard_launches"] = {
            "mesh-priority f32": mesh["priority"]["k3_per_shard"]}
        line["mesh"] = mesh
        # The workload harness (beside the main sequence): immediate-mode
        # servers, no tick solve, so no K1/K2/K3 launch is expected; the
        # count stands beside the others all the same.
        for key, entry in (("k1", k1), ("k2", k2), ("k3", k3)):
            entry["launches_by_path"]["workload"] = wl["launches"][key]
            entry["launches"] += wl["launches"][key]
        line["workload"] = wl
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for b in beside:
            b.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"summary: f32 tick wall p50 {servers['f32']['p50']:.2f} ms p95 "
        f"{servers['f32']['p95']:.2f} ms, f64 p50 {servers['f64']['p50']:.2f}"
        f" ms p95 {servers['f64']['p95']:.2f} ms at {N_RES * N_CLIENTS} "
        f"leases; priority + lane server f32 p50 {prio['f32']['p50']:.2f} ms "
        f"p95 {prio['f32']['p95']:.2f} ms, f64 p50 {prio['f64']['p50']:.2f} "
        f"ms p95 {prio['f64']['p95']:.2f} ms at "
        f"{(N_PRIO + N_PRIO_LANE) * N_CLIENTS} leases; wide-1m f32 p50 "
        f"{wide['wide-1m f32']['p50']:.2f} ms p95 "
        f"{wide['wide-1m f32']['p95']:.2f} ms, wide-10x100k f32 p50 "
        f"{wide['wide-10x100k f32']['p50']:.2f} ms p95 "
        f"{wide['wide-10x100k f32']['p95']:.2f} ms; wide priority tick "
        f"walls f32 {[round(w * 1e3, 1) for w in wide_prio['f32']['run']['walls']]}"
        f" ms, f64 {[round(w * 1e3, 1) for w in wide_prio['f64']['run']['walls']]}"
        f" ms; K3 cluster layout " + ", ".join(
            f"{k} {v['ms']:.4f} ms (global {v['global_ms']:.3f})"
            for k, v in timing.items())
        + f"; round-trip lane tick f32 p50 {rt['f32']['p50']:.2f} ms p95 "
        f"{rt['f32']['p95']:.2f} ms (fused {rt['f32']['fused_p50']:.2f} / "
        f"{rt['f32']['fused_p95']:.2f}); Python-store tick walls f32 "
        f"{[round(w, 1) for w in py['f32']['walls_ms']]} ms; immediate "
        f"request p50 {imm['p50_ms']:.3f} ms p99 {imm['p99_ms']:.3f} ms"
        f"; streams: 100,000 subscriptions on the lane cell, churn fanout ms "
        f"{[round(x, 1) for x in streams['streams']['filtered']['churn_fanout_ms']]}"
        f" (check-all twin "
        f"{[round(x, 1) for x in streams['streams']['check-all']['churn_fanout_ms']]})"
        f", scoped "
        f"{[round(x, 1) for x in streams['streams_scoped']['filtered']['churn_fanout_ms']]}"
        f", fanout-tier exponent {streams['fanout_tiers']['exponent']:.3f}"
        f"; tree converged in {tree['tree']['converged_s']:.1f}s, region "
        f"parent exchange p50 {tree['tree']['exchange_p50_ms']:.2f} ms; "
        f"tree-root round walls s " + ", ".join(
            f"{d} {[round(x, 2) for x in v['round_s']]}"
            for d, v in tree["tree_root"].items())
        + f"; obs lane f64 p50 {obs['lane_on']['p50']:.2f} ms p95 "
        f"{obs['lane_on']['p95']:.2f} ms (obs off {obs['lane_off']['p50']:.2f}"
        f" / {obs['lane_off']['p95']:.2f}), digest "
        f"{obs['digest_ms']:.1f} ms a tick, device busy "
        f"{obs['lane_trace']['busy_share'] * 100:.3f}% of the lane capture"
        f"; takeover lane f32 persist on p50 {tk['lane']['a']['p50']:.2f} "
        f"ms p95 {tk['lane']['a']['p95']:.2f} ms (off "
        f"{tk['lane']['twin']['p50']:.2f} / {tk['lane']['twin']['p95']:.2f})"
        f", snapshot ticks ms "
        f"{[round(x['wall_ms'], 1) for x in tk['lane']['snapshots']]}, "
        f"restore ms B {tk['lane']['restore_b']['wall']:.1f} C "
        f"{tk['lane']['restore_c']['wall']:.1f} priority "
        f"{tk['prio']['restore']['wall']:.1f}, binary kill to regained "
        f"grant {tk['binary']['regained_s']:.2f}s"
        f"; federation: fed-roots shard tick p50 / p95 " + ", ".join(
            f"{s} {v['p50']:.2f} / {v['p95']:.2f} ms"
            for s, v in fed["roots"]["shards"].items())
        + f", reconcile beat p50 "
        f"{_pcts([x / 1e3 for x in fed['roots']['beat_ms']])[0]:.3f} ms, "
        f"exchange p50 {fed['intermediate']['p50']:.2f} ms"
        f"; admission-fused churn tick p50 / p95 fused "
        f"{adm['fused']['fused']['tick_p50_ms']:.2f} / "
        f"{adm['fused']['fused']['tick_p95_ms']:.2f} ms (unfused "
        f"{adm['fused']['unfused']['tick_p50_ms']:.2f} / "
        f"{adm['fused']['unfused']['tick_p95_ms']:.2f}); storm goodput off "
        f"{adm['storm']['off']['goodput_qps']:.1f}/s on "
        f"{adm['storm']['on']['goodput_qps']:.1f}/s; forecast step p50 "
        f"{adm['forecast']['step_p50_us']:.1f} us; frontend-parity "
        f"{streams['streams']['frontend']['pushes']} pushes equal; "
        f"frontend-pool "
        f"{fe['pool']['est_rate']:.1f} establishments/s, held "
        f"{fe['pool']['held_max']}, push p99 "
        f"{fe['pool']['push_p99_ms']:.2f} ms"
        f"; fleet-reshard shard tick p50 / p95 " + ", ".join(
            f"{s} {ph} {v['p50']:.2f} / {v['p95']:.2f} ms"
            for s, e in fleet["reshard"]["shards"].items()
            for ph, v in e.items())
        + f", install {fleet['reshard']['install_ms']:.1f} ms, carry "
        f"{fleet['reshard']['carry_ms']:.1f} ms, beat p50 "
        f"{_pcts([x / 1e3 for x in fleet['reshard']['beat_ms']])[0]:.3f} ms"
        f"; fleet-procs {fleet['procs']['seconds']:.1f}s; TLS request p50 / "
        f"p99 {tls['latency']['tls']['p50_ms']:.3f} / "
        f"{tls['latency']['tls']['p99_ms']:.3f} ms (plaintext "
        f"{tls['latency']['plain']['p50_ms']:.3f} / "
        f"{tls['latency']['plain']['p99_ms']:.3f})"
        f"; chaos {len(chaos['plans'])} plans held in "
        f"{chaos['seconds']:.1f}s, device_tunnel_outage launches "
        f"{chaos['plans']['device_tunnel_outage']['launches']}; "
        f"loadtest-lane request p99 by band " + ", ".join(
            f"{b} {v['p99']:.2f}" for b, v in lt["request_ms_by_band"].items())
        + f" ms, {lt['storm']['goodput_qps']:.1f} ok/s, tick p50 / p95 "
        f"{lt['tick_ms']['storm']['p50']:.2f} / "
        f"{lt['tick_ms']['storm']['p95']:.2f} ms under the storm (free "
        f"{lt['tick_ms']['storm_free']['p50']:.2f} / "
        f"{lt['tick_ms']['storm_free']['p95']:.2f})"
        f"; mesh lane cell on {MESH_SHARDS} shards tick p50 / p95 "
        f"{mesh['lane']['p50']:.2f} / {mesh['lane']['p95']:.2f} ms (twin "
        f"{mesh['lane']['twin_p50']:.2f} / {mesh['lane']['twin_p95']:.2f}), "
        f"wide-1m {mesh['wide']['p50']:.2f} / {mesh['wide']['p95']:.2f} ms "
        f"(twin {mesh['wide']['twin_p50']:.2f} / "
        f"{mesh['wide']['twin_p95']:.2f}), phase {mesh['seconds']:.1f}s"
        f"; workload {len(wl['small'])} small scenarios ok and replayed in "
        f"{wl['small_seconds']:.1f}s, diurnal_million driver tick mean / max "
        f"{wl['million']['diurnal_million']['1']['driver_tick_mean_ms']:.2f} / "
        f"{wl['million']['diurnal_million']['1']['driver_tick_max_ms']:.2f} "
        f"ms, flash_crowd_million exponent "
        f"{wl['million']['flash_crowd_million_exponent']:.3f}, phase "
        f"{wl['seconds']:.1f}s"
        f"; total {time.perf_counter() - t0:.1f}s")
    say(card)
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


def _mesh_only() -> int:
    """`chip_smoke.py --mesh-only`: the device, the build and the mesh
    phase alone (a quick rerun of that phase; it prints no result line)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        _name, card = phase_device(torch)
        phase_build()
        out = phase_mesh(torch, card)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say(card)
    say(json.dumps(out))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--beside"]:
        sys.exit(_beside_main(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--mesh-only"]:
        sys.exit(_mesh_only())
    sys.exit(main())
