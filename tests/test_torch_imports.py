"""The port stands alone: no file of doorman_tpu_torch/ nor chip_smoke.py
imports jax, ml_dtypes or anything of the JAX package (an AST scan of
every import statement), and the entry points run on the CUDA device by
default — on a machine without a GPU they raise unless the caller asks
for device="cpu"."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "doorman_tpu")


def _port_files():
    files = sorted((ROOT / "doorman_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", ""))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    # The port's 128 modules and chip_smoke.py: a slice that drops one
    # is noticed here.
    assert len(files) >= 129
    names = {str(f.relative_to(ROOT)) for f in files}
    for mod in ("obs/audit", "obs/debug", "obs/detect", "obs/flightrec",
                "obs/history", "obs/metrics", "obs/phases", "obs/requests",
                "obs/slo", "obs/trace", "cmd/obs", "cmd/shell",
                "server/etcd", "server/election", "server/sources",
                "persist/__init__", "persist/backend", "persist/journal",
                "persist/restore", "persist/snapshot",
                "federation/__init__", "federation/aggregate",
                "federation/client", "federation/discovery",
                "federation/reconcile", "federation/roots",
                "federation/router",
                "admission/__init__", "admission/coalesce",
                "admission/controller", "admission/deadline",
                "admission/policy", "admission/ramp",
                "frontend/__init__", "frontend/control",
                "frontend/pool", "frontend/publisher", "frontend/ring",
                "frontend/worker", "workload/__init__",
                "workload/forecast", "cmd/frontend_smoke",
                "fleet/__init__", "fleet/autoscale", "fleet/beat",
                "fleet/controller", "fleet/epoch", "fleet/rpc",
                "fleet/supervisor", "cmd/fleet",
                "chaos/__init__", "chaos/clock", "chaos/injectors",
                "chaos/invariants", "chaos/plan", "chaos/plans",
                "chaos/runner", "chaos/trace_export", "cmd/chaos",
                "loadtest/__init__", "loadtest/ratecurve",
                "loadtest/recipe", "loadtest/storm", "loadtest/target",
                "loadtest/worker",
                "sim/__init__", "sim/__main__", "sim/core", "sim/model",
                "sim/reporter", "sim/scenarios", "sim/varz",
                "workload/spec", "workload/generators",
                "workload/population", "workload/harness",
                "workload/scenarios", "cmd/workload"):
        assert f"doorman_tpu_torch/{mod}.py" in names, mod
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


@pytest.mark.parametrize(
    "entry", ["solver", "server", "cmd", "device", "aggregate",
              "intermediate", "forecast", "matcher", "chaos", "cmd_chaos",
              "workload", "run_scenario", "cmd_workload"]
)
def test_entry_points_default_to_cuda_and_run_on_cpu_only_when_asked(
    entry, tmp_path
):
    import asyncio

    import numpy as np

    from doorman_tpu_torch import native
    from doorman_tpu_torch.chaos import ChaosRunner, get_plan
    from doorman_tpu_torch.cmd import chaos as cmd_chaos
    from doorman_tpu_torch.cmd import server as cmd_server
    from doorman_tpu_torch.federation import (
        AggregationTickAdapter,
        FederatedIntermediate,
        ShardDiscovery,
        ShardRouter,
    )
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.match import SubscriptionMatcher
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver.resident import ResidentDenseSolver
    from doorman_tpu_torch.utils.backend import resolve_device
    from doorman_tpu_torch.cmd import workload as cmd_workload
    from doorman_tpu_torch.workload import run_scenario
    from doorman_tpu_torch.workload.forecast import SeasonalForecaster
    from doorman_tpu_torch.workload.harness import WorkloadRunner
    from doorman_tpu_torch.workload.scenarios import SCENARIOS

    if not native.native_available():
        pytest.skip("native engine unavailable")
    engine = native.StoreEngine()
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        "resources:\n  - identifier_glob: '*'\n    capacity: 10\n"
        "    algorithm: {kind: FAIR_SHARE, lease_length: 60,"
        " refresh_interval: 5}\n"
    )
    make = {
        "solver": lambda **kw: ResidentDenseSolver(
            engine, dtype=np.float64, **kw
        ),
        "server": lambda **kw: CapacityServer("s", TrivialElection(), **kw),
        "device": lambda **kw: resolve_device(**kw),
        "aggregate": lambda **kw: AggregationTickAdapter(**kw),
        "intermediate": lambda **kw: FederatedIntermediate(
            "i", TrivialElection(), router=ShardRouter(2),
            discovery=ShardDiscovery({}), **kw,
        ),
        "forecast": lambda **kw: SeasonalForecaster(2, 4, **kw),
        "matcher": lambda **kw: SubscriptionMatcher(**kw),
        "chaos": lambda **kw: ChaosRunner(get_plan("grant_corruption"),
                                          **kw),
        # The CLI's exit code: 0 once the batch plan has run and held.
        "cmd_chaos": lambda **kw: asyncio.run(cmd_chaos.run(
            cmd_chaos.make_parser().parse_args(
                ["--plan", "grant_corruption"]
                + (["--device", kw["device"]] if kw else [])
            )
        )),
        "workload": lambda **kw: WorkloadRunner(
            SCENARIOS["rolling_deploy"](), **kw
        ),
        "run_scenario": lambda **kw: run_scenario("rolling_deploy", **kw),
        # The CLI's exit code: 0 once the scenario has run and passed.
        "cmd_workload": lambda **kw: cmd_workload.run(
            cmd_workload.make_parser().parse_args(
                ["--scenario", "rolling_deploy"]
                + (["--device", kw["device"]] if kw else [])
            )
        ),
        "cmd": lambda **kw: asyncio.run(asyncio.wait_for(cmd_server.serve(
            cmd_server.make_parser().parse_args(
                ["--config", f"file:{cfg}", "--port", "0",
                 "--host", "127.0.0.1", "--debug-port", "-1"]
                + (["--device", kw["device"]] if kw else [])
            )
        ), timeout=0.5)),
    }[entry]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    if entry == "cmd":
        # Serves until cancelled: the CPU server starting is the pass.
        with pytest.raises(asyncio.TimeoutError):
            make(device="cpu")
    elif entry in ("cmd_chaos", "cmd_workload"):
        assert make(device="cpu") == 0
    elif entry == "run_scenario":
        verdict = make(device="cpu")
        assert verdict["ok"], verdict["slo"]
    else:
        got = make(device="cpu")
        dev = {"device": got, "matcher": getattr(got, "_device", None)}.get(
            entry, getattr(got, "device", None))
        assert dev == torch.device("cpu")


@pytest.mark.parametrize("module", [
    "doorman_tpu_torch.frontend.worker",
    "doorman_tpu_torch.frontend.ring",
    "doorman_tpu_torch.cmd.frontend_smoke",
])
def test_frontend_worker_modules_leave_torch_out(module):
    """A spawned listener worker imports these (its target and its main
    module); none may pull torch, nor touch the card: a fresh
    interpreter that imports one has no torch in sys.modules."""
    import subprocess
    import sys

    code = (
        f"import sys; import {module}; "
        "bad = [m for m in sys.modules if m == 'torch' "
        "or m.startswith('torch.')]; print(len(bad)); "
        "sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


def test_storm_children_leave_torch_out():
    """`run_storm_procs` spawns children that import the storm module;
    it pulls neither torch nor anything that touches the card."""
    import subprocess
    import sys

    code = (
        "import sys; import doorman_tpu_torch.loadtest.storm; "
        "bad = [m for m in sys.modules if m == 'torch' "
        "or m.startswith('torch.')]; print(len(bad)); "
        "sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
