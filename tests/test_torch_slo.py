"""The port's SLO engine + trajectory comparator
(doorman_tpu_torch/obs/slo.py), the cases of tests/test_slo.py against
the port: floor/p99/reconvergence specs evaluated over synthetic
streams, Prometheus-style histogram quantiles, and delta-vs-previous-
round math over fabricated BENCH_r*.json artifacts (including the r05
lesson: diagnostics rows must never be ingested as metrics). The
reference's bench.py CPU-fallback case tests bench.py, which the port
has no counterpart of yet (ROADMAP A.8)."""

import json

import tests.conftest  # noqa: F401

from doorman_tpu_torch.obs import metrics as metrics_mod
from doorman_tpu_torch.obs import slo


def _by_name(verdicts):
    return {v["slo"]: v for v in verdicts}


def test_sample_quantile_nearest_rank():
    assert slo.sample_quantile([], 0.5) is None
    assert slo.sample_quantile([7.0], 0.99) == 7.0
    values = list(range(1, 101))
    assert slo.sample_quantile(values, 0.5) in (50, 51)  # rank rounding
    assert slo.sample_quantile(values, 0.99) == 99


def test_histogram_quantile_interpolates():
    reg = metrics_mod.Registry()
    h = reg.histogram("lat", buckets=(0.1, 1.0, 10.0))
    assert slo.histogram_quantile(h, 0.5) is None  # no samples
    for v in (0.05,) * 5 + (0.5,) * 90 + (5.0,) * 5:
        h.observe(v)
    q50 = slo.histogram_quantile(h, 0.5)
    assert 0.1 < q50 < 1.0  # the median lands inside the middle bucket
    # A rank past the last finite bucket reports that bucket's bound.
    h2 = reg.histogram("lat2", buckets=(0.1,))
    h2.observe(5.0)
    assert slo.histogram_quantile(h2, 0.99) == 0.1


def test_histogram_quantile_with_labels():
    reg = metrics_mod.Registry()
    h = reg.histogram("req", labels=("method",), buckets=(0.01, 0.1, 1.0))
    for _ in range(100):
        h.observe(0.05, "GetCapacity")
    assert slo.histogram_quantile(h, 0.99, ("GetCapacity",)) <= 0.1
    assert slo.histogram_quantile(h, 0.99, ("Release",)) is None


def test_ceiling_and_floor_specs_over_samples():
    specs = [
        slo.SloSpec("tick_p50_ms", "max", 100.0,
                    {"type": "samples", "stream": "tick_ms",
                     "quantile": 0.5}, unit="ms"),
        slo.SloSpec("goodput_qps", "min", 1000.0,
                    {"type": "scalar", "key": "goodput"}, unit="qps"),
        slo.SloSpec("missing", "max", 1.0,
                    {"type": "samples", "stream": "nope"}),
    ]
    verdicts = _by_name(slo.SloEngine(specs).evaluate(slo.SloInputs(
        samples={"tick_ms": [80.0] * 9 + [500.0]},
        scalars={"goodput": 900.0},
    )))
    assert verdicts["tick_p50_ms"]["status"] == "pass"
    assert verdicts["tick_p50_ms"]["observed"] == 80.0
    assert verdicts["tick_p50_ms"]["margin"] == 20.0
    assert verdicts["goodput_qps"]["status"] == "fail"
    assert verdicts["goodput_qps"]["margin"] == -100.0
    # A missing stream is loudly no_data, never silently dropped.
    assert verdicts["missing"]["status"] == "no_data"
    assert verdicts["missing"]["observed"] is None


def test_top_band_goodput_floor():
    spec = slo.top_band_goodput_spec(0.99)
    engine = slo.SloEngine([spec])

    # Clean top band while lower bands shed: pass, tallies embedded.
    v = engine.evaluate(slo.SloInputs(band_tallies={
        0: {"admitted": 2, "shed": 98, "fast_fail": 0},
        2: {"admitted": 50, "shed": 0, "fast_fail": 0},
    }))[0]
    assert v["status"] == "pass" and v["observed"] == 1.0
    assert v["detail"]["band"] == 2
    assert v["detail"]["per_band"]["0"]["shed"] == 98

    # Shed reaching the top band: fail.
    v = engine.evaluate(slo.SloInputs(band_tallies={
        0: {"admitted": 0, "shed": 10, "fast_fail": 0},
        2: {"admitted": 90, "shed": 10, "fast_fail": 0},
    }))[0]
    assert v["status"] == "fail" and v["observed"] == 0.9

    # No admission tallies at all: no_data.
    v = engine.evaluate(slo.SloInputs())[0]
    assert v["status"] == "no_data"


def test_reconvergence_spec():
    spec = slo.reconvergence_spec(8)
    ok = slo.SloEngine([spec]).evaluate(
        slo.SloInputs(scalars={"reconverge_ticks": 3.0})
    )[0]
    assert ok["status"] == "pass" and ok["margin"] == 5.0
    blown = slo.SloEngine([spec]).evaluate(
        slo.SloInputs(scalars={"reconverge_ticks": 9.0})
    )[0]
    assert blown["status"] == "fail"


def test_histogram_source_through_registry():
    reg = metrics_mod.Registry()
    h = reg.histogram(
        "doorman_server_requests_durations", labels=("method",),
        buckets=(0.005, 0.01, 0.05, 0.1),
    )
    for _ in range(200):
        h.observe(0.008, "GetCapacity")
    specs = [slo.SloSpec(
        "get_capacity_p99_ms", "max", 50.0,
        {"type": "histogram",
         "metric": "doorman_server_requests_durations",
         "labels": ("GetCapacity",), "quantile": 0.99, "scale": 1000.0},
        unit="ms",
    )]
    v = slo.SloEngine(specs).evaluate(slo.SloInputs(registry=reg))[0]
    assert v["status"] == "pass"
    assert v["observed"] <= 10.0  # ms-scaled
    assert v["detail"]["count"] == 200


def test_server_slos_cover_the_contract():
    names = {s.name for s in slo.server_slos()}
    assert {
        "tick_budget_p50_ms", "tick_budget_p99_ms",
        "get_capacity_p99_ms", "top_band_goodput",
        "restore_staleness_s",
    } <= names


def test_storm_slo_verdicts():
    off = {
        "goodput_qps": 1000.0,
        "p99_s_by_band": {0: 0.030, 1: 0.025, 2: 0.020},
    }
    on = {
        "goodput_qps": 800.0,
        "ok_by_band": {0: 100, 1: 300, 2: 400},
        "shed_by_band": {0: 200, 1: 50},
        "p99_s_by_band": {0: 0.020, 1: 0.018, 2: 0.015},
    }
    verdicts = _by_name(slo.storm_slo_verdicts(
        off, on, goodput_floor_ratio=0.7
    ))
    top = verdicts["server_rpc_storm:top_band_goodput"]
    assert top["status"] == "pass"
    assert top["detail"]["per_band"]["0"]["shed"] == 200
    assert verdicts["server_rpc_storm:goodput_floor"]["status"] == "pass"
    assert verdicts["server_rpc_storm:goodput_floor"]["target"] == 700.0
    for band in (0, 1, 2):
        v = verdicts[f"server_rpc_storm:p99_ms_band{band}"]
        assert v["status"] == "pass", v
    # Admission-on tail past the off tail (+headroom) on one band: fail.
    on_bad = dict(on)
    on_bad["p99_s_by_band"] = {0: 0.200, 1: 0.018, 2: 0.015}
    verdicts = _by_name(slo.storm_slo_verdicts(off, on_bad))
    assert verdicts["server_rpc_storm:p99_ms_band0"]["status"] == "fail"


def test_bench_verdict_applies_to_wall_ms_rows():
    v = slo.bench_verdict({"metric": "server_tick_wide_1res_1m_wall_ms",
                           "value": 80.0})
    assert v["status"] == "pass" and v["target"] == slo.TICK_BUDGET_MS
    assert slo.bench_verdict({"metric": "x_qps", "value": 5.0}) is None
    assert slo.bench_verdict({"metric": "y_wall_ms", "value": "n/a"}) is None


def test_tpu_tick_budget_is_a_standing_spec():
    """The <10 ms one-chip target (ROADMAP "Sub-10 ms TPU tick") is a
    standing SloSpec: accelerator rounds report pass/fail
    automatically, CPU-fallback rounds yield an HONEST no_data verdict
    (never a fail that would poison the trajectory deltas) while still
    recording the CPU number in the detail."""
    spec = slo.tpu_tick_budget_spec()
    assert spec.target == slo.TPU_TICK_BUDGET_MS == 10.0
    assert spec.kind == "max"

    v = slo.tpu_tick_verdict(7.5, cpu_fallback=False)
    assert v["status"] == "pass" and v["margin"] == 2.5

    v = slo.tpu_tick_verdict(12.0, cpu_fallback=False)
    assert v["status"] == "fail"

    v = slo.tpu_tick_verdict(44.0, cpu_fallback=True)
    assert v["status"] == "no_data"
    assert v["observed"] is None
    assert v["detail"]["cpu_p50_ms"] == 44.0


# ----------------------------------------------------------------------
# Trajectory comparator
# ----------------------------------------------------------------------


def _write_round(tmp_path, n, lines):
    tail = "\n".join(json.dumps(obj) for obj in lines)
    (tmp_path / f"BENCH_r{n:02d}.json").write_text(
        json.dumps({"n": n, "cmd": "python bench.py", "rc": 0,
                    "tail": tail})
    )


def test_trajectory_uses_latest_round_and_skips_diagnostics(tmp_path):
    _write_round(tmp_path, 1, [
        {"metric": "tick_wall_ms", "value": 200.0, "unit": "ms",
         "p99_ms": 260.0},
    ])
    _write_round(tmp_path, 2, [
        {"metric": "tick_wall_ms", "value": 150.0, "unit": "ms",
         "p99_ms": 190.0},
        {"metric": "only_in_r02", "value": 7.0, "unit": "x"},
    ])
    # r03 degraded: a diagnostics-only round (the r05 trap) plus a
    # non-JSON noise line; neither may become a metric.
    (tmp_path / "BENCH_r03.json").write_text(json.dumps({
        "n": 3, "rc": 3,
        "tail": "backend probe failed\n" + json.dumps(
            {"metric": "backend_unreachable", "value": 0, "unit": "error"}
        ),
    }))
    comp = slo.TrajectoryComparator(str(tmp_path))
    n, row = comp.previous("tick_wall_ms")
    assert n == 2 and row["value"] == 150.0
    assert comp.previous("backend_unreachable") is None
    assert comp.previous("never_measured") is None

    delta = comp.delta({"metric": "tick_wall_ms", "value": 120.0,
                        "p99_ms": 150.0})
    assert delta["round"] == 2
    assert delta["value"] == {"prev": 150.0, "delta": -30.0, "ratio": 0.8}
    assert delta["p99_ms"]["delta"] == -40.0
    assert comp.delta({"metric": "never_measured", "value": 1.0}) is None


def test_trajectory_slo_delta_matches_embedded_verdicts(tmp_path):
    _write_round(tmp_path, 4, [
        {"metric": "storm_qps", "value": 900.0, "unit": "qps",
         "slo": [{"slo": "server_rpc_storm:top_band_goodput",
                  "status": "pass", "observed": 0.98}]},
        {"metric": "tick_wall_ms", "value": 150.0, "unit": "ms",
         "slo": {"slo": "tick_wall_ms:tick_budget", "status": "fail",
                 "observed": 150.0}},
    ])
    comp = slo.TrajectoryComparator(str(tmp_path))
    d = comp.slo_delta({"slo": "server_rpc_storm:top_band_goodput",
                        "observed": 1.0})
    assert d == {"round": 4, "prev_status": "pass",
                 "prev_observed": 0.98, "delta_observed": 0.02}
    # A dict-valued (single) verdict is matched too.
    d = comp.slo_delta({"slo": "tick_wall_ms:tick_budget",
                        "observed": 90.0})
    assert d["prev_status"] == "fail"
    assert comp.slo_delta({"slo": "unknown", "observed": 1.0}) is None


def test_trajectory_on_missing_dir_is_empty(tmp_path):
    comp = slo.TrajectoryComparator(str(tmp_path / "nope"))
    assert comp.rounds == []
    assert comp.delta({"metric": "x", "value": 1.0}) is None
