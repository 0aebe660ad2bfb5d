"""The harness: finds a cell's configuration, traffic mix and metrics by
name, runs its driver, judges the output, and prints the one result line.

Everything that belongs to one configuration, mix or per-layer metric is
a file of its own that the harness finds by the name BENCHMARK.json
gives it:

  configs/<config>.json   the deployment: sizes, server options, limits;
                          its `layout` names the module that builds it,
                          states its reference and counts its kernels'
                          work (layouts/<layout>.py)
  traffic/<mix>.json      a mix's parameters; its `kind` names the driver
                          (cells/<kind>.py) that reads them
  metrics/<metric>.py     `read(run) -> number or None` over a run's raw
                          measurements (None: nothing to read, left out)
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Top-level module names the benchmark's process may never hold: the JAX
# package the port was made from, and JAX itself. Compared whole, since
# the port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "doorman_tpu")


class Refused(Exception):
    """The run cannot give a result (no card, a forbidden module)."""


def forbidden_modules(modules=None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise Refused(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _by_name(items, name, what):
    for item in items:
        if item["name"] == name:
            return item
    raise Refused(f"BENCHMARK.json has no {what} {name!r}")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _by_name(bench["configs"], name, "configuration")
    return json.loads((root / entry["file"]).read_text())


def load_metric(name: str, here: Path = HERE):
    """The reader of metric `name` (metrics/<name>.py)."""
    path = here / "metrics" / f"{name}.py"
    if not path.is_file():
        raise Refused(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of `workload` reports: its end-to-end metrics,
    or with a trace its per-layer ones."""
    items = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in items if workload in m.get("workloads", [workload])]


@dataclass
class Cell:
    """What a driver gets: the cell's entries and its run's settings."""

    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: str = "cuda"
    control: bool = False


def merge(base: dict, over: Optional[dict]) -> dict:
    """`base` with `over`'s keys, nested dicts merged (tests shrink a
    configuration this way)."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t0: float, device: str = "cuda", root: Path = ROOT,
             config_over: Optional[dict] = None,
             mix_over: Optional[dict] = None, control: bool = False) -> dict:
    """Run one cell once; returns the result line's object (without the
    device check that `main` makes first). `control` adds the numbers of
    the lower-precision reference put in the program's place (`control`,
    read by portbench/control.py; never by the benchmark's runs)."""
    from portbench.gen import traffic

    bench = load_benchmark(root)
    cell = _by_name(bench["workloads"], workload, "workload")
    config = merge(load_config(bench, cell["config"], root), config_over)
    mix = merge(traffic.load_mix(HERE, cell["traffic"]), mix_over)
    driver = importlib.import_module(f"portbench.cells.{mix['kind']}")
    run = driver.run(Cell(config=config, mix=mix, seed=seed, seconds=seconds,
                          trace=trace, t0=t0, device=device, control=control))
    metrics, notes = {}, {}
    for m in cell_metrics(bench, workload, trace):
        reader = load_metric(m["name"])
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if hasattr(reader, "note"):
                notes[m["name"]] = reader.note(run)
    device_info = dict(run["device"])
    if trace and run.get("trace"):
        device_info["busy_s"] = run["trace"]["busy_s"]
        device_info["window_s"] = run["trace"]["window_s"]
    check = run["check"]
    correct = all(v["value"] <= v["limit"] for v in check.values())
    # A gap that is no number (a missing lease) reads as text.
    check = {k: {"value": v["value"] if math.isfinite(v["value"])
                 else str(v["value"]), "limit": v["limit"]}
             for k, v in check.items()}
    out = {
        "correct": correct,
        "attempted": int(run["attempted"]),
        "failed": int(run["failed"]),
        "metrics": metrics,
        "device": device_info,
    }
    if trace and run.get("trace"):
        out["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                            "idle_gaps": run["trace"]["idle_gaps"]}
    if notes:
        out["notes"] = notes
    if "diag" in run:
        out["diag"] = run["diag"]
    if control:
        out["control"] = run["control"]
    out["check"] = check
    return out


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="portbench/run.py",
        description="Run one cell of BENCHMARK.json once and print its "
                    "result as the last line of standard output.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = _parser().parse_args(argv)
    try:
        bench = load_benchmark()
        chips = _by_name(bench["workloads"], args.workload, "workload")["chips"]
        import torch

        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < chips:
            raise Refused(f"{args.workload} needs {chips} cards, found "
                          f"{torch.cuda.device_count()}")
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t0=t0)
        found = forbidden_modules()
        if found:
            raise Refused(f"forbidden modules loaded: {', '.join(found)}")
    except Refused as exc:
        print(f"portbench: {exc}", file=sys.stderr, flush=True)
        return 3
    for name, v in out["check"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
