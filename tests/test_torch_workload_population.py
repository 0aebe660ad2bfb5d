"""The vector population engine on the port
(doorman_tpu_torch/workload/population.py), admission's vector gate
(`AimdController.admit_many`, `Admission.check_get_capacity_band` /
`check_get_capacity_many`), held against the JAX package's.

  * every case of tests/test_workload_population.py on the port, with
    device="cpu": the vector-vs-clients parity pin (python and native
    stores, the federated deploy), grouped establishment order, the
    batched admission draws, forecaster warm-start, trace replay, the
    storm seams and the million scenarios' specs;
  * across packages: both engines of both packages give one
    `log_sha256`; the million scenarios at scale 0.001 equal the
    reference's; `admit_many`'s masks, levels and RNG stream and
    `check_get_capacity_many`'s tallies equal the reference's and a
    loop of `admit` on one seeded RNG, window after window while the
    AIMD level moves.
"""

import asyncio
import json
import random

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

from doorman_tpu.workload import harness as j_harness
from doorman_tpu.workload import scenarios as j_scenarios
from doorman_tpu.workload import spec as j_spec
from doorman_tpu_torch import native
from doorman_tpu_torch.workload import scenarios as scen_mod
from doorman_tpu_torch.workload.harness import WorkloadRunner
from doorman_tpu_torch.workload import spec as spec_mod
from doorman_tpu_torch.workload.spec import GeneratorSpec, WorkloadSpec

G = GeneratorSpec.make


def run(coro):
    return asyncio.run(coro)


def churn_spec(engine: str, seed: int, native_store: bool,
               pkg=None) -> WorkloadSpec:
    """The churny parity workload: diurnal arrivals/departures,
    multi-region RTT, elastic preemption, AIMD admission — every
    mutator and draw surface the vector engine must replay exactly.
    `pkg` is the spec module to build it with (the port's by default,
    the reference's for the cross-package pins)."""
    G = (pkg or spec_mod).GeneratorSpec.make
    return (pkg or spec_mod).WorkloadSpec.make(
        "churn", 24, seed=seed, capacity=120.0,
        algorithm="PROPORTIONAL_SHARE", safe_capacity=2.0,
        lease_length=4.0, native_store=native_store,
        admission={"max_rps": 40.0, "min_level": 0.05},
        base_clients=((0, 10.0), (1, 12.0), (2, 8.0)),
        generators=(
            G("diurnal", curve="0:2,8:6,16:2", period=16.0, jitter=0.2,
              bands=[[0, 1.0], [1, 1.0]], wants=6.0, lifetime_ticks=5,
              max_population=40),
            G("multi_region",
              regions=[["local", 2.0, 2.0], ["far", 150.0, 1.0]]),
            G("elastic", jobs=3, total_work=90.0, min_wants=4.0),
        ),
        population_engine=engine,
    )


def fed_spec(engine: str, seed: int, pkg=None) -> WorkloadSpec:
    """Federated two-shard topology under a rolling deploy: sticky
    redirect chasing, one-tick mastership blindness, and the fed
    pointer walk all in play."""
    G = (pkg or spec_mod).GeneratorSpec.make
    return (pkg or spec_mod).WorkloadSpec.make(
        "fed", 26, seed=seed, servers=2, capacity=200.0,
        lease_length=3.0, election_ttl=2.0,
        federated={"straddle": ["r0"], "client_shards": [0, 0, 1, 1]},
        base_clients=((0, 20.0), (1, 10.0), (0, 20.0), (1, 10.0)),
        generators=(
            G("flash_crowd", at=6, duration=5, clients=8, band=0,
              wants=15.0),
            G("rolling_deploy", at=12, down_ticks=2, gap_ticks=4),
        ),
        population_engine=engine,
    )


def _run_spec(spec: WorkloadSpec):
    runner = WorkloadRunner(spec, device="cpu")
    verdict = run(runner.run())
    return verdict, runner


# ----------------------------------------------------------------------
# The parity pin
# ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_vector_engine_parity_churn(seed):
    """Byte-identical log_sha256, vector vs per-client, churny spec."""
    ref, _ = _run_spec(churn_spec("clients", seed, False))
    vec, runner = _run_spec(churn_spec("vector", seed, False))
    assert vec["log_sha256"] == ref["log_sha256"]
    # The pin must exercise the ARRAY decide path, not just the
    # sequential fallback dressed in arrays.
    assert runner._vector.fast_rows_total > 0


@pytest.mark.skipif(
    not native.native_available(), reason="native store unavailable"
)
def test_vector_engine_parity_churn_native_store():
    """Same pin through the native C++ store: cross-store and
    cross-engine byte-identity in one comparison."""
    ref, _ = _run_spec(churn_spec("clients", 0, True))
    vec, _ = _run_spec(churn_spec("vector", 0, True))
    assert vec["log_sha256"] == ref["log_sha256"]
    # The native store changes the engine, not the log: the python
    # store's run hashes identically (the repo's standing discipline).
    py, _ = _run_spec(churn_spec("clients", 0, False))
    assert py["log_sha256"] == ref["log_sha256"]


def test_vector_engine_parity_federated_deploy():
    """Parity through shard redirects and a mastership flip: the
    sticky-chase replay (conn column) must reproduce the per-client
    connection's parked-server behavior, including the one-tick
    MasterUnknown blindness at the abdication tick."""
    ref, _ = _run_spec(fed_spec("clients", 0))
    vec, _ = _run_spec(fed_spec("vector", 0))
    assert vec["log_sha256"] == ref["log_sha256"]


# ----------------------------------------------------------------------
# Grouped establishment order (population-engine-independent)
# ----------------------------------------------------------------------


PROP_CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 100
  safe_capacity: 2
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
"""


async def _prop_server(clock):
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer

    server = CapacityServer(
        "pop-test", TrivialElection(), mode="immediate",
        minimum_refresh_interval=0.0, clock=clock, device="cpu",
    )
    port = await server.start(0, host="127.0.0.1")
    await server.load_config(parse_yaml_config(PROP_CONFIG))
    await asyncio.sleep(0)
    server.current_master = f"127.0.0.1:{port}"
    return server


def test_decide_bulk_matches_per_request_establishment_order():
    """The canonical per-resource establishment order: decide_bulk's
    batch and a per-request _decide loop in the same arrival order
    leave two fresh servers with identical stores and grants."""
    from doorman_tpu_torch.algorithms import Request

    async def body():
        # One shared frozen clock: expiry stamps must agree exactly.
        clock = FakeClock(1000.0)
        bulk_srv = await _prop_server(clock)
        seq_srv = await _prop_server(clock)
        try:
            cids = [f"c{i}" for i in range(6)]
            wants = np.array([30.0, 10.0, 25.0, 40.0, 5.0, 20.0])
            prios = np.zeros(6, np.int64)
            zeros = np.zeros(6)
            grants, expiry, refresh, safe, fast = (
                bulk_srv.decide_bulk(
                    "r0", cids, zeros, wants, prios,
                    old_has=zeros, old_wants=zeros,
                    new_mask=np.ones(6, bool), expected_count=0,
                )
            )
            seq = [
                seq_srv._decide(
                    "r0", Request(cid, 0.0, float(w), 1, priority=0)
                )[0]
                for cid, w in zip(cids, wants)
            ]
            assert list(grants) == [lease.has for lease in seq]
            assert list(expiry) == [lease.expiry for lease in seq]
            bulk_rows = sorted(
                bulk_srv.resources["r0"].store.dump_rows()
            )
            seq_rows = sorted(
                seq_srv.resources["r0"].store.dump_rows()
            )
            assert bulk_rows == seq_rows
            # A refresh batch over the established rows (non-new) must
            # agree too — the running-aggregate cumsum argument.
            wants2 = wants + 3.0
            grants2, _, _, _, _ = bulk_srv.decide_bulk(
                "r0", cids, grants, wants2, prios,
                old_has=grants, old_wants=wants,
                new_mask=np.zeros(6, bool), expected_count=6,
            )
            seq2 = [
                seq_srv._decide(
                    "r0",
                    Request(cid, float(h), float(w), 1, priority=0),
                )[0]
                for cid, h, w in zip(cids, grants, wants2)
            ]
            assert list(grants2) == [lease.has for lease in seq2]
            assert sorted(
                bulk_srv.resources["r0"].store.dump_rows()
            ) == sorted(seq_srv.resources["r0"].store.dump_rows())
        finally:
            await bulk_srv.stop()
            await seq_srv.stop()

    run(body())


# ----------------------------------------------------------------------
# Batched admission draws
# ----------------------------------------------------------------------


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _controller(seed, pkg="doorman_tpu_torch"):
    import importlib

    AimdController = importlib.import_module(
        f"{pkg}.admission.controller"
    ).AimdController
    return AimdController(
        window=1.0, clock=FakeClock(5.0), rng=random.Random(seed),
        max_rps=8.0, min_level=0.05,
    )


def test_admit_many_replays_the_sequential_draw_sequence():
    """admit_many == admit-loop: same mask, same RNG stream after —
    including unseen-band discovery mid-batch and hard-cap overflow."""
    # 30 arrivals vs max_rps 8: the tail crosses the hard cap; band 2
    # first appears at index 7 (a mid-batch band-set change).
    batch = [0, 1, 0, 0, 1, 1, 0, 2, 2, 0, 1] + [0, 1, 2] * 7
    for seed in (0, 3):
        a, b = _controller(seed), _controller(seed)
        loop_mask = [a.admit(p)[0] for p in batch]
        many_mask = b.admit_many(batch)
        assert list(many_mask) == loop_mask
        # Controllers fully converged: subsequent draws identical.
        follow_a = [a.admit(0)[0] for _ in range(10)]
        follow_b = [b.admit(0)[0] for _ in range(10)]
        assert follow_a == follow_b
        assert a.level == b.level


def test_check_get_capacity_many_matches_per_call_tallies():
    from doorman_tpu_torch.admission import Admission

    batch = [1, 0, 0, 2, 1, 0] * 6
    one = Admission(controller=_controller(7))
    many = Admission(controller=_controller(7))
    loop_mask = [one.check_get_capacity_band(b) for b in batch]
    many_mask = many.check_get_capacity_many(batch)
    assert list(many_mask) == loop_mask
    assert one.tallies == many.tallies


# ----------------------------------------------------------------------
# Forecaster warm-start bit-identity (the --history-dir seam)
# ----------------------------------------------------------------------


def test_forecaster_warm_start_bit_identical_to_online(tmp_path):
    from doorman_tpu_torch.obs.history import HistoryStore
    from doorman_tpu_torch.workload.forecast import SeasonalForecaster

    offered = [12.0, 30.0, 7.0, 44.0, 19.0, 3.0, 28.0, 15.0]
    store = HistoryStore(str(tmp_path), component="workload:pin")
    for tick, v in enumerate(offered):
        store.append({"tick": tick, "offered": v})
    store.close()

    warm = SeasonalForecaster(series=2, period=4, alpha=0.25,
                              beta=0.5, engine="host")
    reopened = HistoryStore(str(tmp_path), component="workload:pin")
    fed = warm.warm_start(reopened, field="offered", interval=2.0)
    reopened.close()
    assert fed == len(offered)

    live = SeasonalForecaster(series=2, period=4, alpha=0.25,
                              beta=0.5, engine="host")
    last = None
    for v in offered:
        last = live.observe(np.full(2, np.float32(v / 2.0),
                                    np.float32))
    for got, want in zip(warm._state, live._state):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    # And the next observation diverges nowhere: same forecast bits.
    nxt = np.full(2, np.float32(9.5), np.float32)
    assert np.array_equal(warm.observe(nxt), live.observe(nxt))
    assert last is not None


def test_run_scenario_history_dir_warm_starts_and_appends(tmp_path):
    from doorman_tpu_torch.workload.scenarios import run_scenario

    first = run_scenario(
        "flash_crowd_predictive", scale=0.25, seed=0,
        history_dir=str(tmp_path), device="cpu",
    )
    assert first["forecaster_warm_start"] == 0
    second = run_scenario(
        "flash_crowd_predictive", scale=0.25, seed=0,
        history_dir=str(tmp_path), device="cpu",
    )
    # The second run primes from exactly the first run's tick records.
    assert second["forecaster_warm_start"] == first["ticks"]


# ----------------------------------------------------------------------
# Trace record/replay (the storm --record seam)
# ----------------------------------------------------------------------


def test_trace_generator_replays_events_deterministically(tmp_path):
    lines = [
        {"tick": 0, "band": 0, "wants": 10.0},
        {"tick": 0, "band": 1, "wants": 5.0},
        {"tick": 2, "band": 0, "wants": 7.5},
    ]
    path = tmp_path / "arrivals.jsonl"
    path.write_text(
        "".join(json.dumps(rec) + "\n" for rec in lines)
    )
    spec = WorkloadSpec.make(
        "trace_replay", 6, seed=0, capacity=100.0,
        generators=(
            G("trace", path=str(path), lifetime_ticks=2),
        ),
    )
    a, _ = _run_spec(spec)
    b, _ = _run_spec(spec)
    assert a["log_sha256"] == b["log_sha256"]
    arrive = [e for e in a["event_log"] if e[1] == "trace_arrive"]
    assert [(e[0], e[2]) for e in arrive] == [(0, 2), (2, 1)]


def test_trace_generator_inline_events_and_validation():
    from doorman_tpu_torch.workload.generators import GENERATORS

    assert "trace" in GENERATORS
    with pytest.raises(ValueError, match="events or path"):
        GENERATORS["trace"]({})
    spec = WorkloadSpec.make(
        "trace_inline", 5, seed=1, capacity=50.0,
        generators=(
            G("trace", events=((1, 0, 8.0), (1, 1, 4.0)),
              lifetime_ticks=2),
        ),
    )
    v, _ = _run_spec(spec)
    arrive = [e for e in v["event_log"] if e[1] == "trace_arrive"]
    assert [(e[0], e[2]) for e in arrive] == [(1, 2)]


def test_storm_record_flags_and_stream_guard():
    from doorman_tpu_torch.loadtest.storm import make_parser, run_storm

    args = make_parser().parse_args(
        ["--record", "/tmp/x.jsonl", "--record-tick", "0.5"]
    )
    assert args.record == "/tmp/x.jsonl"
    assert args.record_tick == 0.5
    assert make_parser().parse_args([]).record == ""
    with pytest.raises(ValueError, match="record"):
        run(run_storm(
            "127.0.0.1:1", workers=1, duration=0.1, stream=True,
            record=True,
        ))


def test_storm_merge_concatenates_arrival_logs():
    from doorman_tpu_torch.loadtest.storm import merge_storm_results

    def part(arrivals):
        return {
            "ok": 1, "shed": 0, "errors": 0, "redirects": 0,
            "ok_by_band": {0: 1}, "shed_by_band": {},
            "workers": 1, "duration_s": 1.0,
            "latencies_sorted": [0.01],
            "latencies_sorted_by_band": {0: [0.01]},
            "arrivals": arrivals,
        }

    merged = merge_storm_results([
        part([[0.5, 0, 10.0], [0.1, 1, 5.0]]),
        part([[0.3, 0, 10.0]]),
    ])
    assert merged["arrivals"] == [
        [0.1, 1, 5.0], [0.3, 0, 10.0], [0.5, 0, 10.0],
    ]


# ----------------------------------------------------------------------
# Million-scenario registration (spec shape; runs live in tier1 smoke)
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "name", ["diurnal_million", "flash_crowd_million"]
)
def test_million_scenarios_registered_at_scale(name):
    from doorman_tpu_torch.workload.scenarios import SCENARIOS

    spec = SCENARIOS[name](scale=1.0, seed=0)
    assert spec.population_engine == "vector"
    assert spec.native_store
    assert sum(int(c) for c, _b, _w in spec.base_population) == 1_000_000
    # Leases must outlive a full deadline-wheel lap.
    assert spec.lease_length > spec.refresh_spread * spec.tick_interval
    assert spec.gate_targets()["peak_population"] >= 1_000_000


def test_million_scenario_smoke_at_small_scale():
    from doorman_tpu_torch.workload.scenarios import run_scenario

    v = run_scenario("diurnal_million", scale=0.001, seed=0, device="cpu")
    assert v["ok"], v["slo"]["verdicts"]
    assert v["summary"]["peak_population"] >= 1000


# ----------------------------------------------------------------------
# Parity with the reference
# ----------------------------------------------------------------------


def _j_run_spec(spec):
    return asyncio.run(j_harness.WorkloadRunner(spec).run())


@pytest.mark.parametrize("case", ["churn0", "churn1", "churn_native",
                                  "fed"])
def test_both_engines_of_both_packages_agree(case):
    """Four runs, one digest: the port's vector and clients engines and
    the reference's two, on the same spec and seed."""
    if case == "churn_native" and not native.native_available():
        pytest.skip("native store unavailable")

    def make(engine, pkg=None):
        if case == "fed":
            return fed_spec(engine, 0, pkg=pkg)
        seed = 1 if case == "churn1" else 0
        return churn_spec(engine, seed, case == "churn_native", pkg=pkg)

    digests = {
        ("port", engine): _run_spec(make(engine))[0]["log_sha256"]
        for engine in ("vector", "clients")
    }
    for engine in ("vector", "clients"):
        digests[("ref", engine)] = _j_run_spec(
            make(engine, pkg=j_spec)
        )["log_sha256"]
    assert len(set(digests.values())) == 1, digests


@pytest.mark.parametrize("name", ["diurnal_million",
                                  "flash_crowd_million"])
def test_million_scenario_equals_the_reference_at_small_scale(name):
    got = scen_mod.run_scenario(name, scale=0.001, seed=0, device="cpu")
    want = j_scenarios.run_scenario(name, scale=0.001, seed=0)
    assert got["ok"], got["slo"]["verdicts"]
    assert got["log_sha256"] == want["log_sha256"]
    assert got["summary"] == want["summary"]


def _batches(seed):
    """Six windows of arrivals: a first window over the hard cap, bands
    that first appear mid-batch, and (once the level has moved down)
    fractional band probabilities, so the RNG is drawn."""
    rng = random.Random(1000 + seed)
    out = [[0, 1, 0, 0, 1, 1, 0, 2, 2, 0, 1] + [0, 1, 2] * 7]
    for k in range(5):
        n = rng.randrange(5, 40)
        bands = [0, 1, 2] + ([3] if k >= 2 else [])
        out.append([rng.choice(bands) for _ in range(n)])
    return out


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_admit_many_equals_the_reference_and_the_loop(seed):
    port_many = _controller(seed)
    port_loop = _controller(seed)
    ref_many = _controller(seed, pkg="doorman_tpu")
    drew = False
    for k, batch in enumerate(_batches(seed)):
        for ctl in (port_many, port_loop, ref_many):
            ctl._clock.t = 5.0 + k * 1.0
        level = port_many.level
        got = port_many.admit_many(batch)
        assert list(got) == [port_loop.admit(p)[0] for p in batch]
        assert list(got) == list(ref_many.admit_many(batch))
        assert port_many.level == port_loop.level == ref_many.level
        drew |= 0.0 < level < 1.0
    assert drew, "the level never left 1: no draw was exercised"
    # The three RNG streams stand at the same place.
    nxt = {port_many.rng.random(), port_loop.rng.random(),
           ref_many.rng.random()}
    assert len(nxt) == 1


@pytest.mark.parametrize("seed", [0, 7])
def test_check_get_capacity_many_equals_the_reference(seed):
    from doorman_tpu.admission import Admission as JAdmission
    from doorman_tpu_torch.admission import Admission

    many = Admission(controller=_controller(seed))
    band = Admission(controller=_controller(seed))
    ref = JAdmission(controller=_controller(seed, pkg="doorman_tpu"))
    for k, batch in enumerate(_batches(seed)):
        for adm in (many, band, ref):
            adm.controller._clock.t = 5.0 + k * 1.0
        got = many.check_get_capacity_many(batch)
        assert list(got) == [band.check_get_capacity_band(b)
                             for b in batch]
        assert list(got) == list(ref.check_get_capacity_many(batch))
    assert many.tallies == band.tallies == ref.tallies
