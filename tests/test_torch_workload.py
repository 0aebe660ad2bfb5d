"""The workload harness on the port (doorman_tpu_torch/workload/,
cmd/workload.py), held against the JAX package's.

  * every case of tests/test_workload.py on the port, with
    device="cpu": byte-stable replay, the seed's divergence, the spec's
    JSON round trip, the scenario library's verdicts, the predictive
    head-to-head and the CLIs;
  * each of the ten small scenarios at scale 1.0, seed 0: verdict ok
    and the reference's `log_sha256`, summary and SLO statuses;
  * `cmd.workload --device cpu` as a subprocess: the reference's
    verdict on stdout, the tick device on stderr;
  * tests/test_fleet.py's reshard_diurnal case on the port.

The servers run in immediate mode: no tick solve, so no kernel is
reached; the forecaster's torch step and the stream matcher run on the
CPU here.
"""

import asyncio
import json
import pathlib
import subprocess
import sys

import pytest

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

from doorman_tpu.workload import scenarios as j_scenarios
from doorman_tpu_torch.obs import slo as slo_mod
from doorman_tpu_torch.workload import harness as harness_mod
from doorman_tpu_torch.workload import scenarios as scen_mod
from doorman_tpu_torch.workload.scenarios import SCENARIOS, scenario_lines
from doorman_tpu_torch.workload.spec import GeneratorSpec, WorkloadSpec

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = [
    "diurnal", "flash_crowd", "rolling_deploy", "multi_region",
    "elastic_preempt", "flash_crowd_federated", "diurnal_streaming",
    "diurnal_streaming_pooled", "flash_crowd_predictive",
    "reshard_diurnal",
]


def run(coro):
    return asyncio.run(coro)


def WorkloadRunner(spec, **kw):
    return harness_mod.WorkloadRunner(spec, device="cpu", **kw)


def run_scenario(name, **kw):
    return scen_mod.run_scenario(name, device="cpu", **kw)


def _small_flash_crowd(seed=0):
    return WorkloadSpec.make(
        "t_flash", 16, seed=seed, capacity=100.0,
        algorithm="PRIORITY_BANDS",
        admission={"max_rps": 10.0},
        base_clients=[(1, 10.0)] * 3,
        generators=[
            GeneratorSpec.make(
                "flash_crowd", at=4, duration=4, clients=10, band=0,
                wants=10.0,
            ),
        ],
        gates={"top_band_satisfaction": 0.9},
    )


# ----------------------------------------------------------------------
# Determinism
# ----------------------------------------------------------------------


def test_event_log_replays_byte_identically():
    a = run(WorkloadRunner(_small_flash_crowd()).run())
    b = run(WorkloadRunner(_small_flash_crowd()).run())
    assert a["event_log"] == b["event_log"]
    assert a["log_sha256"] == b["log_sha256"]
    # And the digest really is over the canonical log bytes.
    import hashlib

    payload = json.dumps(
        a["event_log"], sort_keys=True, separators=(",", ":")
    ).encode()
    assert hashlib.sha256(payload).hexdigest() == a["log_sha256"]


def test_different_seed_diverges():
    a = run(WorkloadRunner(_small_flash_crowd(seed=0)).run())
    b = run(WorkloadRunner(_small_flash_crowd(seed=7)).run())
    # Admission shed draws come from the seed; the logs must differ.
    assert a["log_sha256"] != b["log_sha256"]


def test_spec_round_trips_through_json():
    spec = SCENARIOS["flash_crowd_predictive"]()
    clone = WorkloadSpec.from_dict(
        json.loads(json.dumps(spec.as_dict()))
    )
    assert clone == spec


# ----------------------------------------------------------------------
# Scenario library verdicts
# ----------------------------------------------------------------------


def test_scenario_registry_has_the_named_scenarios():
    for name in ("diurnal", "flash_crowd", "rolling_deploy",
                 "multi_region", "elastic_preempt"):
        assert name in SCENARIOS
    lines = dict(scenario_lines())
    assert all(doc for doc in lines.values()), lines


def test_unknown_scenario_and_unknown_gate_raise():
    with pytest.raises(ValueError, match="unknown scenario"):
        run_scenario("no_such_scenario")
    with pytest.raises(ValueError, match="unknown workload gate"):
        slo_mod.workload_slos({"bogus_gate": 1.0}, name_prefix="x")


def test_rolling_deploy_hands_over_and_reconverges():
    v = run_scenario("rolling_deploy", seed=0)
    assert v["ok"], v["slo"]
    assert v["summary"]["master_changes"] >= 3
    assert v["summary"]["reconverge_ticks"] <= 6
    # The handover arc is in the event log: a deploy entry per server
    # and a master-set change following each.
    kinds = [row[1] for row in v["event_log"]]
    assert kinds.count("deploy") == 2
    assert kinds.count("master") >= 3


def test_elastic_jobs_preempt_and_still_complete():
    v = run_scenario("elastic_preempt", seed=0)
    assert v["ok"], v["slo"]
    assert v["summary"]["preemptions"] >= 1
    assert v["summary"]["completions"] == 6.0
    kinds = [row[1] for row in v["event_log"]]
    assert "elastic_preempt" in kinds and "elastic_complete" in kinds
    # Preempted jobs requeue before completing.
    assert "elastic_requeue" in kinds


def test_federated_crowd_holds_the_capacity_sum():
    v = run_scenario("flash_crowd_federated", seed=0)
    assert v["ok"], v["slo"]
    assert v["summary"]["fed_capacity_violations"] == 0.0
    assert any(row[1] == "straddle" for row in v["event_log"])


def test_flash_crowd_gates_and_flightrec_dump_on_failure():
    v = run_scenario("flash_crowd", seed=0)
    assert v["ok"], v["slo"]
    slos = {x["slo"]: x for x in v["slo"]["verdicts"]}
    assert slos["workload:flash_crowd:top_band_goodput"][
        "status"
    ] == "pass"
    assert v["flightrec_dump"] is None
    # An unreachable gate fails the run and triggers the black-box
    # dump, carrying the per-tick beat for triage.
    spec = _small_flash_crowd().with_(
        gates={"top_band_satisfaction": 2.0}
    )
    bad = run(WorkloadRunner(spec).run())
    assert not bad["ok"]
    assert bad["flightrec_dump"] is not None
    assert bad["flightrec_dump"]["records"], bad["flightrec_dump"]


def test_pooled_streaming_scenario_carries_traffic_and_replays():
    v = run_scenario("diurnal_streaming_pooled", scale=0.5, seed=3,
                     ticks=18)
    assert v["ok"], v["slo"]
    # The serving plane visibly carried the stream traffic: the pool
    # pumped ring frames AND still holds every stream at run end (a
    # silent fall-back to the in-process path would zero both).
    assert v["summary"]["frontend_frames"] > 0
    assert v["summary"]["frontend_held"] == 2.0
    assert v["summary"]["stream_pushes"] > 0
    fe = v["frontend"]["s0"]
    assert fe["live"] == [0, 1] and fe["crashes"] == 0
    # No pump anomalies on a healthy run: laps/corrupt frames would
    # get their own frontend_pump log entry.
    assert not any(row[1] == "frontend_pump" for row in v["event_log"])
    # Byte-stable replay holds with the pool in the loop.
    w = run_scenario("diurnal_streaming_pooled", scale=0.5, seed=3,
                     ticks=18)
    assert w["log_sha256"] == v["log_sha256"]


# ----------------------------------------------------------------------
# Predictive head-to-head
# ----------------------------------------------------------------------


def test_predictive_beats_reactive_on_the_repeating_crowd():
    v = run_scenario("flash_crowd_predictive", seed=0)
    assert v["ok"], v["slo"]
    slos = {x["slo"]: x for x in v["slo"]["verdicts"]}
    pair = slos[
        "workload:flash_crowd_predictive:predictive_over_reactive"
    ]
    assert pair["status"] == "pass", pair
    # Not merely "no worse": the forecaster-primed controller must
    # strictly improve the stressed top band on this scenario.
    assert pair["detail"]["predictive"] > pair["detail"]["reactive"]
    # The forecast reached the controller (logged when it moves).
    assert any(row[1] == "forecast" for row in v["event_log"])
    assert v["summary"]["forecaster"]["ticks_observed"] == v["ticks"]


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------


def test_workload_cli_list_and_verdict(tmp_path, capsys):
    from doorman_tpu_torch.cmd import workload as cli

    assert cli.run(cli.make_parser().parse_args(
        ["--list-scenarios"]
    )) == 0
    listed = capsys.readouterr().out
    for name in SCENARIOS:
        assert name in listed

    out = tmp_path / "verdict.json"
    rc = cli.run(cli.make_parser().parse_args([
        "--scenario", "rolling_deploy", "--out", str(out),
        "--device", "cpu",
    ]))
    assert rc == 0
    v = json.loads(out.read_text())
    assert v["scenario"] == "rolling_deploy" and v["ok"]


def test_sim_cli_lists_scenarios(capsys):
    import sys
    from unittest import mock

    from doorman_tpu_torch.sim.__main__ import main as sim_main

    with mock.patch.object(
        sys, "argv", ["sim", "--list-scenarios"]
    ):
        sim_main()
    out = capsys.readouterr().out
    assert "1_maxmin" in out and "Convergence" in out


# ----------------------------------------------------------------------
# Parity with the reference
# ----------------------------------------------------------------------


def _comparable(verdict):
    """A verdict without its wall-clock parts (the SLO details, and the
    status of the one gate over wall samples, get_capacity_p99_ms) and
    without the port's forecaster device field."""
    summary = dict(verdict["summary"])
    fc = summary.get("forecaster")
    if fc is not None:
        summary["forecaster"] = {
            k: v for k, v in fc.items() if k != "device"
        }
    return {
        "log_sha256": verdict["log_sha256"],
        "event_log": verdict["event_log"],
        "summary": summary,
        "slo": sorted(
            (v["slo"], v["status"]) for v in verdict["slo"]["verdicts"]
            if not v["slo"].endswith(":get_capacity_p99_ms")
        ),
        "reactive": (verdict.get("reactive") or {}).get("log_sha256"),
    }


@pytest.mark.parametrize("name", SMALL)
def test_small_scenario_equals_the_reference(name):
    got = run_scenario(name, scale=1.0, seed=0)
    want = j_scenarios.run_scenario(name, scale=1.0, seed=0)
    assert got["ok"], got["slo"]
    assert _comparable(got) == _comparable(want)


def test_cli_subprocess_equals_the_reference():
    out = subprocess.run(
        [sys.executable, "-m", "doorman_tpu_torch.cmd.workload",
         "--scenario", "flash_crowd", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "tick device cpu" in out.stderr
    got = json.loads(out.stdout)
    want = j_scenarios.run_scenario("flash_crowd", scale=1.0, seed=0)
    assert _comparable(got) == _comparable(want)


def test_reshard_diurnal_scenario_arcs_2_4_2():
    """tests/test_fleet.py's reshard case on the port: the fleet arcs
    2 -> 4 -> 2 shards under diurnal load, holds the capacity sum and
    replays."""
    v = run_scenario("reshard_diurnal", seed=0)
    assert v["ok"], v["slo"]["verdicts"]
    assert v["summary"]["epoch_changes"] == 2.0
    assert v["summary"]["fed_capacity_violations"] == 0.0
    again = run_scenario("reshard_diurnal", seed=0)
    assert again["log_sha256"] == v["log_sha256"]
