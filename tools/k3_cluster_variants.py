#!/usr/bin/env python3
"""K3's cluster layout against variants of itself, on one H100.

    python3 tools/k3_cluster_variants.py

Builds csrc/dense_solve.cu as it is and as variants, each with one
compile-time choice of the cluster kernel changed: the bisection
deciding 1 or 2 steps a pass instead of 3 (`kBisectLevels`), and the
bisection sums without the one-instruction min of finite bands
(`bisect_sums` always taking the NaN-propagating nmin). Every variant
must give the same grants and row totals bit for bit on every cluster
plan (staged and streamed, C = 1..16), on seeded tables at 16,384 /
131,072 / 1,048,576 lanes, f32 and f64, with NaN and inf wants and
weights in some rows. Then each is timed with its launches queued, in
turns with the source as it is, on the wide-priority cell's shape (8 x
131,072 lanes, 100,000 of them clients) and one 1,048,576-lane row, in
the plan the wrapper picks. The builds go to doorman_tpu_torch/_build/.
Exits non-zero without a CUDA device or when a variant differs.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# name -> (text in csrc/dense_solve.cu, its replacement)
VARIANTS = {
    "1 step a pass": ("constexpr int kBisectLevels = 3;",
                      "constexpr int kBisectLevels = 1;"),
    "2 steps a pass": ("constexpr int kBisectLevels = 3;",
                       "constexpr int kBisectLevels = 2;"),
    "nmin always": ("    bool fast = finite;\n", "    bool fast = false;\n"),
}


def _build(dense_cuda, variants):
    """{name: ctypes library}: the source as it is ("as is") and each
    variant, compiled in parallel."""
    src = dense_cuda.SOURCE.read_text()
    out_dir = dense_cuda.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new) in [("as is", ("", "")), *variants.items()]:
        if old and src.count(old) != 1:
            raise SystemExit(f"variant {name!r}: {old!r} not found once")
        stem = name.replace(" ", "_")
        cu = out_dir / f"{stem}.cu"
        cu.write_text(src.replace(old, new) if old else src)
        lib = out_dir / f"{stem}.so"
        procs[name] = (lib, subprocess.Popen(
            [dense_cuda.nvcc_path(), *dense_cuda.NVCC_FLAGS, "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} did not build:\n{log[-3000:]}")
        use = {dense_cuda.entry_label(e): u
               for e, u in dense_cuda.ptxas_usage(log).items()
               if "cluster" in e}
        print(f"{name}: ptxas " + ", ".join(
            f"{k[11:]} {u['registers']} registers, {u['spill_stores']}/"
            f"{u['spill_loads']} B spilled" for k, u in sorted(use.items())),
            flush=True)
        dense_cuda._lib = None
        build = dense_cuda.build
        dense_cuda.build = lambda lib=lib: lib
        try:
            libs[name] = dense_cuda._load()
        finally:
            dense_cuda.build = build
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k3_cluster_variants: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from doorman_tpu_torch.solver import dense_cuda, priority_cuda

    _name, card = cs.phase_device(torch)
    print(card, flush=True)
    libs = _build(dense_cuda, VARIANTS)

    def use(name):
        dense_cuda._lib = libs[name]
        priority_cuda.k3_cluster_max_active.cache_clear()

    def bits(t):
        return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)

    rng = np.random.default_rng(9)
    differ = []
    for dtype in (torch.float32, torch.float64):
        it = torch.empty((), dtype=dtype).element_size()
        for K, R in ((16_384, 32), (131_072, 8), (1_048_576, 8)):
            w, wt, band, act, cap = cs._k3_tables(torch, rng, R, K, dtype)
            odd = w.clone(), wt.clone()
            odd[0][6, 5] = float("nan")
            odd[1][7, 9] = float("inf")
            odd[0][3, 1] = float("inf")
            plans = {(16, False), (8, False), (1, False)} | {
                (C, True) for C in (1, 2, 4, 8, 16)
                if priority_cuda.k3_cluster_smem_bytes(K, C, True, it)
                <= priority_cuda.SMEM_LIMIT}
            for label, ws in (("", (w, wt)), (" nan/inf", odd)):
                args = (*ws, band, act, cap, 4)
                for plan in sorted(plans):
                    got = {}
                    for name in libs:
                        use(name)
                        got[name] = priority_cuda._launch_layout(
                            "cluster", *args, True, plan=plan)
                    for name, (g, t) in got.items():
                        if not (torch.equal(bits(g), bits(got["as is"][0]))
                                and torch.equal(bits(t),
                                                bits(got["as is"][1]))):
                            differ.append(f"{name} {R}x{K} {dtype}{label} "
                                          f"{plan}")
            print(f"bit for bit: {R}x{K} {dtype} (and nan/inf), plans "
                  f"{sorted(plans)}: "
                  f"{'all variants equal' if not differ else differ}",
                  flush=True)
    tables = {}
    for dt, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        w, wt, band, act, cap = cs._k3_tables(torch, rng, 8, 131_072, dtype)
        act[:, 100_000:] = False
        tables[f"8x131072 {dt}"] = (w, wt, band, act, cap, 4)
    tables.update(cs._k3_1m_tables(torch))
    order = list(libs)
    for key, args in tables.items():
        use("as is")
        plan = priority_cuda.k3_cluster_plan_for(args[0], args[5])[:2]
        times = {}
        for name in order + order[::-1]:
            use(name)
            syncs = torch.zeros(args[0].shape[0], dtype=torch.int32,
                                device=cs.DEVICE)
            priority_cuda._launch_layout("cluster", *args, False, plan=plan,
                                         syncs=syncs)
            ms = cs._time_ms(
                torch, lambda: priority_cuda._launch_layout(
                    "cluster", *args, False, plan=plan),
                reps=20, queued=True)
            times.setdefault(name, []).append((ms, int(syncs.max().item())))
        print(f"timed {key} C={plan[0]} "
              f"{'staged' if plan[1] else 'streamed'}: " + "; ".join(
                  f"{name} {sum(m for m, _ in v) / len(v):.4f} ms "
                  f"({v[0][1]} cluster barriers)" for name, v in times.items()),
              flush=True)
    if differ:
        print(f"k3_cluster_variants: FAILED: {differ}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
