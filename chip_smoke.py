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
f32 lane server runs again on four churn seeds with K1/K2 in each
layout, and the rows left in the scoped tick's frontier are reported.

Then resources of any width: K3's third layout, which reads a row wider
than shared memory from global memory, against its plain version up to
1,048,576 lanes; the lane server with one resource of 1,000,000 clients
and with ten of 100,000 (bench.py's wide shapes, on the chunked wide
resident solver), and one 20,000-client resource per lane kind; a narrow
resource overflowing between two ticks on the 1M-lease lane server (that
tick runs the BatchSolver's edge-list lane part, the next the wide
solver); and 8 PRIORITY_BANDS resources of 100,000 clients in two
binding capacity groups, whose every K3 launch is in the global layout.

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
    # per prev type; K3: 2 block + 8 warp + 2 global.
    counts = {k: sum(n.startswith(k) for n in usage) for k in ("K1", "K2", "K3")}
    check(counts == {"K1": 10, "K2": 20, "K3": 12},
          f"ptxas reported {counts} kernel entries; unlabelled: {unknown}")
    spills = [n for n, u in usage.items() if " warp " in n
              and (u["spill_stores"] or u["spill_loads"])]
    check(not spills, f"warp layout spills: {spills}")
    check(sum(" global " in n for n in usage) == 2,
          "K3's global layout entries missing from ptxas's report")
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
    against each other on one K = 128 table (the global layout, for rows
    wider than the block layout stages, has its own phase); the grouped solve_priority
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

def _lane_templates(lease_length=3600, refresh=5):
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
                f" refresh_interval: {refresh}, learning_mode_duration: 0"
                f"{params}}}"
            )
    return lines


def _config_yaml(lease_length=3600, refresh=5):
    lines = ["resources:"] + _lane_templates(lease_length, refresh)
    lines.append(
        "  - identifier_glob: '*'\n    capacity: 1000\n"
        f"    algorithm: {{kind: 0, lease_length: {lease_length},"
        f" refresh_interval: {refresh}, learning_mode_duration: 0}}"
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
        for g in range(N_GROUPS):
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


async def _drive_prio(torch, dtype_name, ticks, seed):
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


# -- phase 6: the scope frontier under each K1 layout -------------------------

FRONTIER_SEEDS = (1, 2, 3, 4)


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


# -- phase 7: K3's global layout ----------------------------------------------

# Widths the block layout cannot stage (priority_cuda.k3_layout), with
# the rows each table holds.
K3_GLOBAL_WIDTHS = {"f32": ((16_384, 32), (131_072, 8), (1_048_576, 6)),
                    "f64": ((8_192, 32), (131_072, 8))}


def phase_k3_global(torch):
    """K3's global layout against its plain version on the same CUDA
    tensors at the widths above, f32 and f64, 1 and 4 bands (the K3
    phase's special rows included), repeat launches bit-identical and
    the row totals checked; against the block layout on one K = 4,096
    table. Comparison launches: not counted."""
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.priority import _alloc_banded
    from doorman_tpu_torch.solver.priority_cuda import (
        _launch_layout,
        alloc_banded_k3,
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
            check(k3_layout(K, it) == "global",
                  f"K={K} at {name} is not a global-layout row")
            w, wt, band, act, cap = _k3_tables(torch, rng, R, K, dtype)
            for nb in (1, 4):
                before = dense_cuda.K3_LAYOUT_LAUNCHES["global"]
                g1, t1 = alloc_banded_k3(w, wt, band, act, cap, nb, totals=True)
                g2, t2 = alloc_banded_k3(w, wt, band, act, cap, nb, totals=True)
                plain = _alloc_banded(w, wt, band, act, cap, nb)
                torch.cuda.synchronize()
                tag = f"K={K} {name} {nb} band(s) R={R}"
                check(dense_cuda.K3_LAYOUT_LAUNCHES["global"] == before + 2,
                      f"K3 did not launch its global layout ({tag})")
                check(torch.equal(g1, g2) and torch.equal(t1, t2),
                      f"K3 global layout not deterministic ({tag})")
                check(bool(torch.isfinite(g1).all()), f"K3 non-finite ({tag})")
                err = _k3_rel(torch, g1, plain, w, act, cap)
                check(err <= bound,
                      f"K3 global vs plain {err:.3g} > {bound:g} ({tag})")
                check(not bool(g1[:2].any()),
                      f"K3 grants on an inactive or zero-capacity row ({tag})")
                terr = _k3_rel(torch, t1[:, None], g1.double().sum(1)[:, None],
                               w, act, cap)
                check(terr <= tbound, f"K3 global row totals {terr:.3g} ({tag})")
                worst[name] = max(worst.get(name, 0.0), err)
                say(f"phase k3-global: {tag}: vs plain max rel err {err:.3g} "
                    f"(bound {bound:g}), repeat bit-identical, row totals "
                    f"within {terr:.3g}")
            del w, wt, band, act, cap, g1, g2, t1, t2, plain
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


def _k3_global_timing(torch, wide_prio):
    """K3's global layout timed with its launches queued, beside its
    bound and its plain version: on the wide priority server's own
    8 x 131,072 f32 tables at a representative theta evaluation (grouped
    rows at theta = 0.5), and on one 1,048,576-lane row (4 bands, every
    band overflowing its share)."""
    import numpy as np

    from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
    from doorman_tpu_torch.solver import dense_cuda
    from doorman_tpu_torch.solver.priority import _alloc_banded
    from doorman_tpu_torch.solver.priority_cuda import alloc_banded_k3

    b = wide_prio["server"]._solver.last_snapshot.priority_part.batch
    nb = wide_prio["server"]._solver.last_snapshot.priority_part.num_bands
    wants = torch.where(b.active, b.wants, 0)
    weights = torch.where(b.active, b.weights, 0)
    half = torch.where(b.group >= 0, 0.5, 1.0).to(b.capacity.dtype)
    tables = {"8x131072": (wants, weights, b.band, b.active, b.capacity * half,
                           nb)}
    rng = np.random.default_rng(31)
    K = 1 << 20
    act = _put(torch, rng.random((1, K)) < 0.95)
    w1 = _put(torch, rng.integers(0, 100, (1, K)).astype(np.float64),
              torch.float32) * act
    s1 = _put(torch, rng.integers(1, 4, (1, K)).astype(np.float64),
              torch.float32) * act
    b1 = _put(torch, rng.integers(0, 4, (1, K)).astype(np.int32))
    cap1 = w1.sum(1) * 0.1  # every band overflows what the ones above left
    tables["1x1048576"] = (w1, s1, b1, act, cap1, 4)
    saved = dict(dense_cuda.LAUNCHES)
    saved_layouts = dict(dense_cuda.K3_LAYOUT_LAUNCHES)
    out = {}
    for key, args in tables.items():
        R, K = args[0].shape
        got = alloc_banded_k3(*args)
        plain = _alloc_banded(*args)
        rel = _k3_rel(torch, got, plain, args[0], args[3], args[4])
        check(rel <= F32_PARITY_REL_BOUND, f"K3 global {key} vs plain {rel:.3g}")
        ms = _time_ms(torch, lambda: alloc_banded_k3(*args), reps=5,
                      queued=True)
        pms = _time_ms(torch, lambda: _alloc_banded(*args), reps=2)
        nbytes = R * K * (2 * 4 + 4 + 1) + R * K * 4 + R * 4
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = _k3_ops(torch, *args, plain) / H100_F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        out[key] = {
            "ms": ms, "plain_ms": pms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share_of_bound": bound / ms, "rel_err": rel, "shape": [R, K],
            "max_abs_err": (got.double() - plain.double()).abs().max().item(),
        }
        say(f"phase k3-global: timed {key} f32: {ms:.4f} ms queued, plain "
            f"{pms:.3f} ms, bound {bound:.5f} ms "
            f"({out[key]['bound_by']}), {bound / ms:.2%} of bound")
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
                      quiet, seed, lanes=False):
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
        solver_dtype=dtype_name, fused_tick=True, scoped_solve=True,
        tick_pipeline_depth=3, tick_interval=1.0, device=DEVICE,
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
                first = wide._has.clone()  # the first (full) solve's grants
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
    from doorman_tpu_torch.solver.dense import ChunkedDenseBatch, solve_chunked

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
    final = wide._has.double().cpu().numpy().reshape(-1)
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
    batch = ChunkedDenseBatch(
        wants=wide._wants, has=wide._has, subclients=wide._sub,
        active=wide._act, row_seg=wide._row_seg_d, capacity=cfg.cap_d,
        algo_kind=cfg.kind_d, learning=cfg.learn_d,
        static_capacity=cfg.statc_d, lengths=wide._seg_len_d,
    )
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
                out[f"{label} {dtype_name}"] = dict(
                    p50=p50, p95=p95, run=run, check=chk)

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
        tick_pipeline_depth=3, tick_interval=1.0, device=DEVICE,
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
    (every one in the global layout), the store of record against the
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
    check(run["layouts"] == {"warp": 0, "block": 0, "global": n_launch},
          f"K3 layouts {run['layouts']}: not all global")
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
    return min(ratios), max(ratios), srel, nb


def phase_wide_prio(torch, card):
    out = {}

    async def drive():
        for dtype_name, seed in (("f32", 21), ("f64", 22)):
            run = await _drive_wide_prio(torch, dtype_name, seed)
            lo, hi, srel, nb = _check_wide_prio(torch, run)
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
                + f"; card {card}")
            out[dtype_name] = dict(run=run, solve_rel_err=srel)

    asyncio.run(drive())
    return out


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
        registers = phase_build()
        worst = phase_kernels(torch)
        worst3, solve_err = phase_kernels_k3(torch)
        servers, prio = phase_server(torch, card)
        tracked = phase_tracked(torch, servers["f32"]["server"])
        line = kernel_line(
            torch, servers["f32"]["server"], tracked,
            servers["f32"]["launches"], worst, registers,
        )
        line["kernels"].append(
            _k3_entry(torch, prio["f32"], worst3, solve_err, registers)
        )
        line["kernels"][0]["frontier_by_layout"] = phase_frontier(torch)
        worst_global = phase_k3_global(torch)
        wide = phase_wide(torch, card)
        batch_lanes = phase_batch_lanes(torch, servers["f32"]["server"])
        overflow = phase_overflow(torch, servers["f32"]["server"])
        wide_prio = phase_wide_prio(torch, card)
        line["kernels"][-1]["global_layout"] = {
            "launches": wide_prio["f32"]["run"]["layouts"]["global"],
            "launches_f64": wide_prio["f64"]["run"]["layouts"]["global"],
            "timing": _k3_global_timing(torch, wide_prio["f32"]["run"]),
            "parity_rel_err": worst_global,
            "server_solve_rel_err": {
                k: v["solve_rel_err"] for k, v in wide_prio.items()},
        }
        line["wide"] = _wide_entry(torch, wide)
        line["wide"]["overflow"] = overflow
        line["kernels"][0]["batch_dense_lanes"] = batch_lanes
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
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
        f"{wide['wide-10x100k f32']['p95']:.2f} ms; wide priority f32 tick "
        f"walls {[round(w * 1e3, 1) for w in wide_prio['f32']['run']['walls']]}"
        f" ms; total {time.perf_counter() - t0:.1f}s")
    say(card)
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
