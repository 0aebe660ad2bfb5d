"""The load tester on the port (doorman_tpu_torch/loadtest/), held
against the JAX package.

The cases of tests/test_loadtest.py, each on the port:

  * recipes: parse counts and bases, rejected specs, and the schedules
    (constant increase, reset, sin and inc_sin, random change) on a fake
    clock, each QPS sequence equal to the reference's from the same
    clock and seed;
  * the target's request count, and an end-to-end loadtest (recipe
    workers and a target) against a port server on the CPU;
  * rate curves and the arrival sampler: the same values and the same
    seeded arrival counts as the reference's;
  * the storm: CLI flags, the stream / rate-curve refusal, the procs
    flag, `merge_storm_results` equal to the reference's on the same
    parts, and `run_storm_procs` inline and over two spawned processes.
"""

import asyncio
import math
import random

import pytest

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

from doorman_tpu import loadtest as jloadtest
from doorman_tpu.loadtest import ratecurve as jratecurve
from doorman_tpu.loadtest import storm as jstorm
from doorman_tpu_torch.loadtest import RecipeError, parse_recipes
from doorman_tpu_torch.loadtest.target import Target, ping
from doorman_tpu_torch.loadtest.worker import run_worker
from doorman_tpu_torch.server.config import parse_yaml_config
from doorman_tpu_torch.server.election import TrivialElection
from doorman_tpu_torch.server.server import CapacityServer


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _schedule(parse, spec, times, *, seed=None, **kw):
    """One worker's (expired, current_qps, old_qps, reset_count) at each
    of `times` on a fake clock."""
    clock = FakeClock()
    if seed is not None:
        kw["rng"] = random.Random(seed)
    (w,) = parse(spec, clock=clock, **kw)
    out = []
    for t in times:
        clock.now = t
        out.append((w.interval_expired(), w.current_qps, w.old_qps,
                    w.reset_count))
    return out


@pytest.mark.parametrize("spec,times,seed,kw", [
    ("1x100+constant_increase(5)", [0, 61, 61.5, 122, 300], None,
     dict(interval=60, reset=3600)),
    ("1x10+constant_increase(10)", [1.1, 2.2, 3.3, 5.5, 6.7], None,
     dict(interval=1, reset=5)),
    ("1x0+sin(80)", [10.0, 50.0, 101.0, 151.0, 175.5], None,
     dict(interval=1, reset=100.0)),
    ("1x0+inc_sin(80)", [50.0, 101.0, 151.0, 230.0, 333.3], None,
     dict(interval=1, reset=100.0)),
    ("1x100+random_change(20)", [(k + 1) * 1.01 for k in range(50)], 3,
     dict(interval=1, reset=10_000)),
])
def test_schedules_equal_the_reference(spec, times, seed, kw):
    assert _schedule(parse_recipes, spec, times, seed=seed, **kw) == (
        _schedule(jloadtest.parse_recipes, spec, times, seed=seed, **kw)
    )


def test_parse_recipes_counts_and_base():
    workers = parse_recipes("5x100+sin(30),2x10+constant_increase(1)")
    assert len(workers) == 7
    assert workers[0].recipe.name == "sin"
    assert workers[0].current_qps == 100.0
    assert workers[5].recipe.name == "constant_increase"
    assert workers[5].current_qps == 10.0
    assert workers[0].recipe is workers[4].recipe
    ref = jloadtest.parse_recipes("5x100+sin(30),2x10+constant_increase(1)")
    assert [(w.recipe.name, w.current_qps) for w in workers] == [
        (w.recipe.name, w.current_qps) for w in ref
    ]


def test_parse_recipes_rejects_garbage():
    for bad in ["", "5x100", "5x100+nope(1)", "x100+sin(1)",
                "5x100+sin(1,2)", "5x100+sin()"]:
        with pytest.raises(RecipeError):
            parse_recipes(bad)
        with pytest.raises(jloadtest.RecipeError):
            jloadtest.parse_recipes(bad)


def test_constant_increase_schedule():
    clock = FakeClock()
    (w,) = parse_recipes(
        "1x100+constant_increase(5)", interval=60, reset=3600, clock=clock
    )
    assert not w.interval_expired()
    clock.now = 61
    assert w.interval_expired()
    assert w.current_qps == 105.0 and w.old_qps == 100.0
    assert not w.interval_expired()
    clock.now = 122
    assert w.interval_expired()
    assert w.current_qps == 110.0


def test_reset_snaps_back_to_base():
    clock = FakeClock()
    (w,) = parse_recipes(
        "1x10+constant_increase(10)", interval=1, reset=5, clock=clock
    )
    for t in (1.1, 2.2, 3.3):
        clock.now = t
        assert w.interval_expired()
    assert w.current_qps == 40.0
    clock.now = 5.5
    assert w.interval_expired()
    assert w.current_qps == 10.0
    assert w.reset_count == 1


def test_sin_and_inc_sin_shapes():
    clock = FakeClock()
    reset = 100.0
    (s,) = parse_recipes("1x0+sin(80)", interval=1, reset=reset, clock=clock)
    (i,) = parse_recipes(
        "1x0+inc_sin(80)", interval=1, reset=reset, clock=clock
    )
    clock.now = 50.0
    assert s.interval_expired()
    assert s.current_qps == pytest.approx(80.0)
    assert i.interval_expired()
    assert i.current_qps == pytest.approx(0.0)
    clock.now = 101.0
    assert i.interval_expired()
    clock.now = 151.0
    assert i.interval_expired()
    assert i.current_qps == pytest.approx(
        1 * 80.0 * math.sin(math.pi * 50.0 / reset)
    )


def test_random_change_bounded():
    clock = FakeClock()
    (w,) = parse_recipes(
        "1x100+random_change(20)", interval=1, reset=10_000, clock=clock,
        rng=random.Random(3),
    )
    for k in range(50):
        clock.now = (k + 1) * 1.01
        assert w.interval_expired()
        assert 80.0 <= w.current_qps <= 120.0


def test_target_counts_requests():
    async def body():
        target = Target()
        port = await target.start(0)
        call, close = await ping("127.0.0.1", port)
        for _ in range(7):
            await call()
        assert target.requests == 7
        await close()
        await target.stop()

    asyncio.run(body())


def test_loadtest_end_to_end():
    """Two recipe workers against a port server and a target: requests
    flow and the server sees the demand."""
    config = """
resources:
- identifier_glob: "*"
  capacity: 1000
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
"""

    async def body():
        server = CapacityServer(
            "lt-server", TrivialElection(), minimum_refresh_interval=0.0,
            device="cpu",
        )
        port = await server.start(0, host="127.0.0.1")
        await server.load_config(parse_yaml_config(config))
        await asyncio.sleep(0)
        server.current_master = f"127.0.0.1:{port}"

        target = Target()
        tport = await target.start(0)

        workers = parse_recipes(
            "2x50+constant_increase(0)", interval=3600, reset=7200
        )
        stats = {}
        tasks = [
            asyncio.create_task(
                run_worker(
                    i, w, f"127.0.0.1:{port}", f"lt-{i}", "shared",
                    f"127.0.0.1:{tport}", stats,
                    minimum_refresh_interval=0.0,
                )
            )
            for i, w in enumerate(workers)
        ]
        await asyncio.sleep(1.5)
        res = server.resources.get("shared")
        assert res is not None
        assert res.store.sum_wants == pytest.approx(100.0)

        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass

        assert target.requests > 20, target.requests

        await target.stop()
        await server.stop()

    asyncio.run(body())


# ----------------------------------------------------------------------
# Rate curves
# ----------------------------------------------------------------------


def test_rate_curve_parse_interpolate_and_integrate():
    from doorman_tpu_torch.loadtest.ratecurve import RateCurve

    curve = RateCurve.parse("0:10,30:45,60:0")
    assert curve.rate_at(0) == 10.0
    assert curve.rate_at(15) == 27.5
    assert curve.rate_at(-5) == 10.0
    assert curve.rate_at(90) == 0.0
    assert curve.integral(0, 60) == pytest.approx(1500.0)
    assert curve.end_time == 60.0
    ref = jratecurve.RateCurve.parse("0:10,30:45,60:0")
    ts = [x * 0.7 - 3.0 for x in range(100)]
    assert [curve.rate_at(t) for t in ts] == [ref.rate_at(t) for t in ts]
    assert [curve.integral(t, t + 7.3) for t in ts] == [
        ref.integral(t, t + 7.3) for t in ts
    ]


def test_rate_curve_rejects_garbage():
    from doorman_tpu_torch.loadtest.ratecurve import RateCurve

    for bad in ("", "abc", "0:10,5", "10:5,0:10", "0:-3"):
        with pytest.raises(ValueError):
            RateCurve.parse(bad)


def test_arrival_sampler_is_deterministic_and_tracks_the_curve():
    from doorman_tpu_torch.loadtest.ratecurve import ArrivalSampler, RateCurve

    curve = RateCurve.parse("0:5,10:5")
    a = ArrivalSampler(curve, jitter=0.3, rng=random.Random(11))
    b = ArrivalSampler(curve, jitter=0.3, rng=random.Random(11))
    counts_a = [a.take(t, t + 1.0) for t in range(10)]
    counts_b = [b.take(t, t + 1.0) for t in range(10)]
    assert counts_a == counts_b
    assert sum(counts_a) == pytest.approx(50, abs=50 * 0.35)
    ref = jratecurve.ArrivalSampler(
        jratecurve.RateCurve.parse("0:5,10:5"), jitter=0.3,
        rng=random.Random(11),
    )
    assert counts_a == [ref.take(t, t + 1.0) for t in range(10)]


def test_arrival_sampler_wraps_periodic_curves():
    from doorman_tpu_torch.loadtest.ratecurve import ArrivalSampler, RateCurve

    curve = RateCurve.parse("0:0,5:10,10:0")
    s = ArrivalSampler(curve, jitter=0.0, rng=random.Random(0),
                       period=10.0)
    first = [s.take(t, t + 1.0) for t in range(10)]
    second = [s.take(10 + t, 11 + t) for t in range(10)]
    assert sum(first) == sum(second)
    ref = jratecurve.ArrivalSampler(
        jratecurve.RateCurve.parse("0:0,5:10,10:0"), jitter=0.0,
        rng=random.Random(0), period=10.0,
    )
    assert first + second == [ref.take(t, t + 1.0) for t in range(20)]


# ----------------------------------------------------------------------
# The storm
# ----------------------------------------------------------------------


def test_storm_parser_accepts_rate_curve_flags():
    from doorman_tpu_torch.loadtest.storm import make_parser

    argv = ["--server", "x:1", "--rate-curve", "0:10,30:45",
            "--rate-jitter", "0.1", "--seed", "3"]
    args = make_parser().parse_args(argv)
    assert args.rate_curve == "0:10,30:45"
    assert args.rate_jitter == 0.1
    assert args.seed == 3
    assert vars(args) == vars(jstorm.make_parser().parse_args(argv))


def test_storm_rejects_rate_curve_with_streams():
    from doorman_tpu_torch.loadtest.storm import run_storm

    with pytest.raises(ValueError, match="stream"):
        asyncio.run(run_storm(
            "127.0.0.1:1", workers=1, duration=0.1, stream=True,
            rate_curve="0:10,1:10",
        ))


def test_storm_parser_accepts_procs_flag():
    from doorman_tpu_torch.loadtest.storm import make_parser

    args = make_parser().parse_args(["--procs", "4"])
    assert args.procs == 4
    assert make_parser().parse_args([]).procs == 1


def _part(ok, shed, band_lat, dur, band=0):
    return {
        "ok": ok, "shed": shed, "errors": 0, "redirects": 1,
        "ok_by_band": {band: ok}, "shed_by_band": {band: shed},
        "workers": 2, "duration_s": dur,
        "latencies_sorted": sorted(band_lat),
        "latencies_sorted_by_band": {band: sorted(band_lat)},
    }


def test_storm_merge_sums_counters_and_keeps_exact_tails():
    from doorman_tpu_torch.loadtest.storm import (
        merge_storm_results,
        percentile,
    )

    a = _part(3, 1, [0.010, 0.020, 0.030], 5.0)
    b = _part(5, 2, [0.001, 0.002, 0.003, 0.004, 0.005], 5.2)
    merged = merge_storm_results([a, b])
    assert merged["procs"] == 2 and merged["workers"] == 4
    assert merged["ok"] == 8 and merged["shed"] == 3
    assert merged["redirects"] == 2
    assert merged["ok_by_band"] == {0: 8}
    assert merged["duration_s"] == 5.2
    assert merged["goodput_qps"] == round(8 / 5.2, 1)
    population = sorted(
        a["latencies_sorted"] + b["latencies_sorted"]
    )
    assert merged["p99_s"] == round(percentile(population, 0.99), 6)
    assert merged["p50_s"] == round(percentile(population, 0.50), 6)
    assert merged["p99_s_by_band"][0] == merged["p99_s"]
    with pytest.raises(ValueError, match="no storm results"):
        merge_storm_results([])
    # The same parts, seeded, over three bands: the reference's output.
    rng = random.Random(5)
    parts = [
        _part(rng.randint(0, 50), rng.randint(0, 9),
              [rng.random() for _ in range(rng.randint(1, 40))],
              5.0 + rng.random(), band=p % 3)
        for p in range(6)
    ]
    assert merge_storm_results(parts) == jstorm.merge_storm_results(parts)


def test_storm_procs_single_proc_falls_through_inline():
    from doorman_tpu_torch.loadtest.storm import run_storm_procs

    out = run_storm_procs(
        "127.0.0.1:1", procs=1, workers=2, duration=0.2,
        rpc_timeout=0.05,
    )
    assert out["procs"] == 1 and out["workers"] == 2
    assert out["ok"] == 0 and out["errors"] > 0


def test_storm_procs_spawned_children_merge():
    """Two spawned children against a dead address: both report, the
    merge has the single-process shape, and no child outlives it."""
    import multiprocessing as mp

    from doorman_tpu_torch.loadtest.storm import run_storm_procs

    out = run_storm_procs(
        "127.0.0.1:1", procs=2, workers=3, duration=0.3,
        rpc_timeout=0.05, bands=(0, 1),
    )
    assert out["procs"] == 2 and out["workers"] == 3
    assert out["ok"] == 0 and out["errors"] > 0
    assert not mp.active_children()
