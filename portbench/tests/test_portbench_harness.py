"""The harness: names resolve to files, rates and tails take every
sample, the roofline counts on hand-worked shapes, the import check."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.measure import roofline, stats, trace

ROOT = harness.ROOT


def test_every_name_resolves_to_its_file():
    from portbench.gen import deploy, traffic

    bench = harness.load_benchmark()
    for c in bench["configs"]:
        cfg = harness.load_config(bench, c["name"])
        assert cfg["name"] == c["name"]
        layout = deploy.layout(cfg)
        assert callable(layout.build) and callable(layout.check)
        assert callable(layout.work)
    for w in bench["workloads"]:
        mix = traffic.load_mix(harness.HERE, w["traffic"])
        assert (harness.HERE / "cells" / f"{mix['kind']}.py").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)


def test_unknown_names_are_refused():
    bench = harness.load_benchmark()
    with pytest.raises(harness.Refused):
        harness.load_config(bench, "no-such-config")
    with pytest.raises(harness.Refused):
        harness.load_metric("no_such_metric")
    with pytest.raises(ModuleNotFoundError):
        from portbench.gen import deploy

        deploy.layout({"layout": "no_such_layout"})


def test_cell_metrics_follow_workloads_keys():
    bench = harness.load_benchmark()
    cell = "loadtest-1m.random_change"
    e2e = {m["name"] for m in harness.cell_metrics(bench, cell, False)}
    assert e2e == {"refreshes_per_s", "setup_s"}
    layer = {m["name"] for m in harness.cell_metrics(bench, cell, True)}
    assert {"k1_roofline", "tick_ms_p95", "device_idle_pct.tick"} <= layer
    assert harness.cell_metrics(bench, "another.cell", False) == [
        m for m in bench["end_to_end"] if "workloads" not in m]


def test_every_reader_loads():
    for path in sorted((harness.HERE / "metrics").glob("*.py")):
        assert callable(harness.load_metric(path.stem).read)


def test_rates_divide_all_work_by_all_time():
    run = {"refreshes": 200_000 * 37, "window_s": 10.0}
    assert harness.load_metric("refreshes_per_s").read(run) == 740_000.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_tails_take_every_sample():
    # 980 fast samples and 20 slow ones: the p95 sees none of the slow
    # ones, the p99 does (a median of chunk p99s would average them away).
    xs = [0.001] * 980 + [0.5] * 20
    rng = np.random.default_rng(0)
    rng.shuffle(xs)
    assert harness.load_metric("tick_ms_p95").read({"tick_walls": xs}) == 1.0
    assert stats.percentile(xs, 0.99) == 0.5
    assert stats.percentile([], 0.5) is None
    assert harness.load_metric("tick_ms_p95").read({}) is None


def test_per_tick_laps():
    run = {"ticks": 4, "tick_walls": [0.1] * 4, "flush_s": 0.02,
           "ingest_s": [0.01, 0.03],
           "phases": {"drain": 0.004, "pack": 0.008, "apply": 0.012,
                      "staging": 0.02, "fused": 0.04, "download": 0.004}}
    read = lambda n: harness.load_metric(n).read(run)  # noqa: E731
    assert read("store_ms_per_tick") == pytest.approx(6.0)
    assert read("engine_ms_per_tick") == pytest.approx(16.0)
    assert read("ingest_ms_per_tick") == pytest.approx(20.0)
    # (0.4 s of walls + 0.02 s of flush - 0.088 s of laps) / 4 ticks
    assert read("unlapped_ms_per_tick") == pytest.approx(83.0)


def test_lane_counts_on_hand_worked_rows():
    # One STATIC row of two clients that fits: the row's scalars and
    # mask (13 + 2 bytes), the wants (2 x 4), the grants (2 x 4); ops:
    # 4 + 1 per lane.
    nbytes, ops = roofline.lane_work([1], [100.0], [[10.0, 20.0]])
    assert (nbytes, ops) == (31.0, 10.0)
    # PROPORTIONAL_SHARE also reads has: 13 + 2 + 2 x 4 x 2 + 8.
    nbytes, ops = roofline.lane_work([2], [100.0], [[10.0, 20.0]])
    assert (nbytes, ops) == (39.0, 20.0)
    # An overloaded FAIR_SHARE row reads subclients too and runs the
    # level finder (30 steps at f32): 4 + 4 + 90 + 8 + 2 ops a lane.
    nbytes, ops = roofline.lane_work([3], [10.0], [[10.0, 20.0]])
    assert (nbytes, ops) == (39.0, 216.0)


def test_roofline_reader_bounds_and_share():
    run = {"trace": {"kernels": {"K1": {"sum_s": 2e-6}, "K2": {"sum_s": 2e-6}}},
           "k1_work": (3.35e6, 0.0)}
    m = harness.load_metric("k1_roofline")
    # 3.35 MB at 3.35 TB/s is 1 us of the 4 us the kernels ran
    assert m.read(run) == pytest.approx(25.0)
    assert m.note(run) == "bound by bytes"
    assert m.read({"trace": {"kernels": {}}, "k1_work": (1.0, 1.0)}) is None


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.window",
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.tick_once",
         "ts": 100, "dur": 500},
        {"ph": "X", "cat": "kernel", "ts": 200, "dur": 10,
         "name": "void dense_solve_warp_kernel<float, 128, false>(int)"},
        {"ph": "X", "cat": "kernel", "ts": 205, "dur": 10,
         "name": "void banded_fill_warp_kernel<float, 128>(int)"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 700, "dur": 100,
         "name": "Memcpy DtoH"},
    ]
    s = trace.summarize(ev, idle_label="between")
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(115e-6)
    assert s["kernels"]["K1"]["launches"] == 1
    assert s["kernels"]["K3"]["sum_s"] == pytest.approx(1e-5)
    assert s["device_ops"][0] == ["Memcpy DtoH", pytest.approx(1e-4)]
    # gaps: 0-200 (in the tick after 100), 215-700, 800-1000
    assert s["idle_gaps"][0] == ["portbench.tick_once", pytest.approx(485e-6)]
    assert ["between", pytest.approx(200e-6)] in s["idle_gaps"]


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules({"doorman_tpu_torch.server": 1}) == []
    assert harness.forbidden_modules({"doorman_tpu.solver": 1}) == [
        "doorman_tpu"]
    assert harness.forbidden_modules({"jax.numpy": 1, "jaxlib": 1}) == [
        "jax", "jaxlib"]


def test_benchmark_process_loads_no_jax():
    """Everything a run imports, in a fresh interpreter: no JAX, no JAX
    package; the reference imports nothing of the port."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench.reference import judge, vector, oracles\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('doorman_tpu_torch', 'doorman_tpu'))\n"
        "from portbench import harness\n"
        "from portbench.cells import refresh, common\n"
        "from portbench.gen import deploy, traffic\n"
        "from portbench.layouts import templates\n"
        "import doorman_tpu_torch.server.server, doorman_tpu_torch.obs.metrics\n"
                "for m in harness.load_benchmark()['per_layer']:\n"
        "    harness.load_metric(m['name'])\n"
        "print(json.dumps([ref, harness.forbidden_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    ref, found = json.loads(out.stdout.strip().splitlines()[-1])
    assert ref == [] and found == []


def test_run_refuses_without_a_card(tmp_path):
    """The command exits non-zero and prints no result without CUDA."""
    import torch as t

    if t.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "loadtest-1m.random_change",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_program_spans_name_idle_gaps():
    """The program's spans (perf_counter seconds) land on the trace's
    axis by the window's start and name the gaps they cover."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.window",
         "ts": 5000, "dur": 1000},
        {"ph": "X", "cat": "kernel", "ts": 5100, "dur": 10,
         "name": "void dense_solve_warp_kernel<float, 128, false>(int)"},
    ]
    # the window opened at perf_counter 2.0 s; a pack lap from 2.0005 s
    # to 2.0009 s covers the middle of the gap 5110-6000
    spans = [(2.0005, 2.0009, "phase:resident/pack")]
    s = trace.summarize(ev, idle_label="between", spans=spans,
                        window_start_s=2.0)
    assert s["idle_gaps"][0] == ["phase:resident/pack", pytest.approx(890e-6)]
    assert s["idle_gaps"][1] == ["between", pytest.approx(100e-6)]
