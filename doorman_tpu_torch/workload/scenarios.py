"""The named scenario library: one factory per scenario, an SLO-gated
verdict per run.

Each factory takes ``(scale, seed, ticks)`` and returns a WorkloadSpec
— `scale` multiplies the client population AND the configured capacity
together, so satisfaction targets are scale-invariant and the same
scenario smoke-tests in CI at scale 0.2 and soaks locally at scale 50.
The factory's docstring first line is the one-liner `--list-scenarios`
prints (the same convention sim.scenarios uses).

``flash_crowd_predictive`` is the head-to-head: it runs the SAME spec
twice — once with the seasonal forecaster feeding the AIMD controller,
once purely reactive — and emits a standing pair verdict requiring the
predictive run's stressed top-band satisfaction to be at least the
reactive run's. The flash crowd repeats on the forecaster's period, so
from the second cycle on the forecast leads the spike by one tick and
the controller multiplies down BEFORE the crowd lands instead of one
window after.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from doorman_tpu_torch.obs import slo as slo_mod
from doorman_tpu_torch.utils.backend import resolve_device
from doorman_tpu_torch.workload.harness import WorkloadRunner
from doorman_tpu_torch.workload.spec import GeneratorSpec, WorkloadSpec

__all__ = ["SCENARIOS", "run_scenario", "scenario_lines"]

G = GeneratorSpec.make


def _pop(scale: float, n: int) -> int:
    return max(1, int(round(n * scale)))


def diurnal(scale: float = 1.0, seed: int = 0,
            ticks: Optional[int] = None) -> WorkloadSpec:
    """Day/night arrival wave over a mixed-band population."""
    ticks = ticks or 48
    cap = 400.0 * scale
    return WorkloadSpec.make(
        "diurnal", ticks, seed=seed, capacity=cap,
        algorithm="PRIORITY_BANDS",
        base_clients=[(2, 20.0)] * _pop(scale, 3),
        generators=[
            G(
                "diurnal",
                # One "day": quiet, a morning ramp to the peak, an
                # evening decay. Periodic, so any tick count works.
                curve="0:1,12:6,24:10,36:4,48:1",
                period=48.0, jitter=0.2,
                bands=[[0, 2.0], [1, 1.0], [2, 1.0]],
                wants=8.0, lifetime_ticks=8,
                max_population=_pop(scale, 120),
            ),
        ],
        gates={
            "top_band_satisfaction": 0.95,
            "satisfaction": 0.5,
            "peak_population": _pop(scale, 3) + 3,
            "get_capacity_p99_ms": 250.0,
        },
    )


def flash_crowd(scale: float = 1.0, seed: int = 0,
                ticks: Optional[int] = None) -> WorkloadSpec:
    """Sudden low-band crowd against AIMD admission; top band rides."""
    ticks = ticks or 28
    crowd = list(range(8, 14))
    return WorkloadSpec.make(
        "flash_crowd", ticks, seed=seed, capacity=100.0 * scale,
        algorithm="PRIORITY_BANDS",
        admission={"max_rps": max(4.0, 16.0 * scale), "min_level": 0.05},
        base_clients=[(1, 10.0)] * _pop(scale, 6),
        generators=[
            G(
                "flash_crowd", at=8, duration=6,
                clients=_pop(scale, 24), band=0, wants=10.0,
            ),
        ],
        stress_ticks=crowd,
        gates={
            "top_band_satisfaction": 0.9,
            "stress_satisfaction": 0.9,
            "top_band_goodput": 0.95,
            "refresh_ok_ratio": 0.5,
        },
    )


def rolling_deploy(scale: float = 1.0, seed: int = 0,
                   ticks: Optional[int] = None) -> WorkloadSpec:
    """Serial server deploys: abdicate, drain, rejoin, reconverge."""
    ticks = ticks or 30
    return WorkloadSpec.make(
        "rolling_deploy", ticks, seed=seed, servers=2,
        capacity=200.0 * scale,
        base_clients=[(0, 10.0), (0, 20.0), (1, 30.0)]
        * _pop(scale, 1),
        generators=[
            G("rolling_deploy", at=6, down_ticks=3, gap_ticks=5),
        ],
        baseline_tick=4, heal_tick=17,
        gates={
            "reconverge_ticks": 6.0,
            "master_changes": 3.0,
            "refresh_ok_ratio": 0.7,
            "top_band_satisfaction": 0.8,
        },
    )


def multi_region(scale: float = 1.0, seed: int = 0,
                 ticks: Optional[int] = None) -> WorkloadSpec:
    """Clients spread across regions; WAN RTT rides the latency SLO."""
    ticks = ticks or 24
    return WorkloadSpec.make(
        "multi_region", ticks, seed=seed, capacity=300.0 * scale,
        base_clients=[(0, 10.0)] * _pop(scale, 8),
        generators=[
            G(
                "multi_region",
                regions=[["local", 2.0, 2.0], ["near", 40.0, 2.0],
                         ["far", 150.0, 1.0]],
            ),
            G(
                "diurnal", curve="0:2,12:4,24:2", period=24.0,
                jitter=0.1, bands=[[0, 1.0]], wants=5.0,
                lifetime_ticks=6, max_population=_pop(scale, 40),
                prefix="m",
            ),
        ],
        gates={
            "satisfaction": 0.9,
            "refresh_virtual_p99_ms": 170.0,
            "get_capacity_p99_ms": 250.0,
        },
    )


def elastic_preempt(scale: float = 1.0, seed: int = 0,
                    ticks: Optional[int] = None) -> WorkloadSpec:
    """Elastic jobs ride out preemption by a rigid crowd, then finish.

    The fractional-job model of arxiv 1106.4985: work accrues with
    whatever is granted; sustained starvation preempts and requeues."""
    ticks = ticks or 40
    jobs = _pop(scale, 6)
    return WorkloadSpec.make(
        "elastic_preempt", ticks, seed=seed,
        capacity=100.0 * scale, algorithm="PRIORITY_BANDS",
        base_clients=[(1, 15.0)] * _pop(scale, 2),
        generators=[
            G(
                "elastic", jobs=jobs, band=0, min_wants=4.0,
                max_wants=15.0, total_work=160.0,
                patience=2, requeue_ticks=3, start_tick=1,
            ),
            # The rigid interference: a higher-band crowd that grabs
            # most of the capacity mid-run, starving the elastic band.
            G(
                "flash_crowd", at=10, duration=8,
                clients=_pop(scale, 5), band=1, wants=18.0,
                prefix="rigid",
            ),
        ],
        gates={
            "completions": float(jobs),
            "preemptions": 1.0,
            "top_band_satisfaction": 0.85,
        },
    )


def flash_crowd_federated(scale: float = 1.0, seed: int = 0,
                          ticks: Optional[int] = None) -> WorkloadSpec:
    """Flash crowd against one shard of a federated straddling root."""
    ticks = ticks or 26
    return WorkloadSpec.make(
        "flash_crowd_federated", ticks, seed=seed, servers=2,
        capacity=200.0 * scale,
        federated={
            "straddle": ["r0"],
            "client_shards": [0, 0, 1, 1],
        },
        base_clients=[(0, 20.0), (1, 10.0), (0, 20.0), (1, 10.0)],
        generators=[
            G(
                "flash_crowd", at=8, duration=6,
                clients=_pop(scale, 10), band=0, wants=15.0,
            ),
        ],
        gates={
            "fed_capacity_violations": 0.0,
            "top_band_satisfaction": 0.9,
        },
    )


def diurnal_streaming(scale: float = 1.0, seed: int = 0,
                      ticks: Optional[int] = None) -> WorkloadSpec:
    """Diurnal churn with WatchCapacity stream clients riding along."""
    ticks = ticks or 30
    return WorkloadSpec.make(
        "diurnal_streaming", ticks, seed=seed, capacity=300.0 * scale,
        stream_clients=[(1, 20.0)] * _pop(scale, 3),
        base_clients=[(1, 10.0)] * _pop(scale, 2),
        generators=[
            G(
                "diurnal", curve="0:2,10:6,20:2", period=20.0,
                jitter=0.15, bands=[[0, 1.0]], wants=6.0,
                lifetime_ticks=5, max_population=_pop(scale, 50),
            ),
        ],
        gates={
            "stream_pushes": float(_pop(scale, 3)),
            "satisfaction": 0.9,
        },
    )


def diurnal_streaming_pooled(scale: float = 1.0, seed: int = 0,
                             ticks: Optional[int] = None
                             ) -> WorkloadSpec:
    """Diurnal streaming churn served through the frontend pool."""
    # The diurnal_streaming shape, but the WatchCapacity leg rides the
    # serving-plane pool: 2 listener workers over shared-memory push
    # rings, streams spread across 4 shards (stable client hash), the
    # tick-edge pump standing in for the workers' poll loops. The
    # frontend gates require the pool to have visibly carried the
    # stream traffic AND still be holding every stream at run end —
    # a silent fall-back to the in-process path fails the scenario.
    ticks = ticks or 30
    streams = _pop(scale, 4)
    return WorkloadSpec.make(
        "diurnal_streaming_pooled", ticks, seed=seed,
        capacity=300.0 * scale,
        stream_clients=[(1, 20.0)] * streams,
        base_clients=[(1, 10.0)] * _pop(scale, 2),
        frontend_workers=2, stream_shards=4,
        generators=[
            G(
                "diurnal", curve="0:2,10:6,20:2", period=20.0,
                jitter=0.15, bands=[[0, 1.0]], wants=6.0,
                lifetime_ticks=5, max_population=_pop(scale, 50),
            ),
        ],
        gates={
            "stream_pushes": float(streams),
            "satisfaction": 0.9,
            "frontend_frames": float(streams),
            "frontend_held": float(streams),
        },
    )


def flash_crowd_predictive(scale: float = 1.0, seed: int = 0,
                           ticks: Optional[int] = None) -> WorkloadSpec:
    """Seasonal forecaster primes AIMD before each repeating crowd."""
    period = 16
    ticks = ticks or (8 + 3 * period + 4)
    crowd_ticks = [
        t
        for cycle in (1, 2)  # cycles after the forecaster has seen one
        for t in range(8 + cycle * period, 8 + cycle * period + 4)
    ]
    return WorkloadSpec.make(
        "flash_crowd_predictive", ticks, seed=seed,
        capacity=100.0 * scale,
        # Tight budget + deep MD: one predicted-overload window is
        # enough to extinguish the bottom band (level 0.4 with two
        # bands -> band-0 admit probability 0).
        admission={"max_rps": max(4.0, 12.0 * scale), "min_level": 0.05,
                   "md_factor": 0.4},
        base_clients=[(1, 10.0)] * _pop(scale, 6),
        generators=[
            G(
                "flash_crowd", at=8, duration=4,
                clients=_pop(scale, 24), band=0, wants=10.0,
                period=period, repeats=3,
            ),
        ],
        # Slow level / fast season (both dyadic): the level must NOT
        # chase the spike, or the seasonal term never accumulates the
        # amplitude the pre-spike forecast needs.
        predictive={"period": period, "alpha": 0.25, "beta": 0.5},
        stress_ticks=crowd_ticks,
        gates={
            "top_band_satisfaction": 0.9,
            "stress_satisfaction": 0.85,
            "top_band_goodput": 0.95,
        },
    )


def _million_population(pop: int) -> list:
    """The compact (count, band, wants) base rows for a million-client
    scenario: 60/30/10 across three bands, exact total."""
    b0 = (pop * 6) // 10
    b1 = (pop * 3) // 10
    return [[b0, 0, 1.0], [b1, 1, 2.0], [pop - b0 - b1, 2, 4.0]]


# Million-client scenarios: refresh each resident row every
# MILLION_SPREAD ticks (due set per tick = population / spread), with
# leases sized to outlive a full wheel lap so nothing expires between
# refreshes.
MILLION_SPREAD = 50


def diurnal_million(scale: float = 1.0, seed: int = 0,
                    ticks: Optional[int] = None) -> WorkloadSpec:
    """Million-client diurnal wave on the array-backed vector engine."""
    ticks = ticks or 24
    pop = max(1, int(round(1_000_000 * scale)))
    return WorkloadSpec.make(
        "diurnal_million", ticks, seed=seed, capacity=float(pop),
        lease_length=4.0 * MILLION_SPREAD,
        population_engine="vector", refresh_spread=MILLION_SPREAD,
        native_store=True,
        base_population=_million_population(pop),
        generators=[
            # Modest churn rides on top of the parked million: the
            # arrival wave exercises bulk arrivals/departures without
            # dominating the resident population.
            G(
                "diurnal", curve="0:2,6:8,12:14,18:6,24:2",
                period=24.0, jitter=0.2,
                bands=[[0, 1.0], [1, 1.0]], wants=5.0,
                lifetime_ticks=6, max_population=_pop(scale, 200),
            ),
        ],
        gates={
            "peak_population": float(pop),
            "refresh_ok_ratio": 0.95,
        },
    )


def flash_crowd_million(scale: float = 1.0, seed: int = 0,
                        ticks: Optional[int] = None) -> WorkloadSpec:
    """Flash crowd over a parked million-client base; AIMD admission."""
    ticks = ticks or 20
    pop = max(1, int(round(1_000_000 * scale)))
    b1 = pop // 2
    # AIMD budget sized to the steady due rate (population / spread):
    # the crowd's extra arrivals push the window over it, so band 0
    # sheds while the top band rides the goodput floor.
    steady_rps = max(4.0, pop / MILLION_SPREAD)
    return WorkloadSpec.make(
        "flash_crowd_million", ticks, seed=seed, capacity=float(pop),
        algorithm="PRIORITY_BANDS",
        lease_length=4.0 * MILLION_SPREAD,
        population_engine="vector", refresh_spread=MILLION_SPREAD,
        native_store=True,
        admission={"max_rps": steady_rps, "min_level": 0.05},
        base_population=[[pop - b1, 0, 1.0], [b1, 1, 2.0]],
        generators=[
            G(
                "flash_crowd", at=6, duration=6,
                clients=_pop(scale, 500), band=0, wants=10.0,
            ),
        ],
        gates={
            "peak_population": float(pop),
            "top_band_goodput": 0.9,
        },
    )


def reshard_diurnal(scale: float = 1.0, seed: int = 0,
                    ticks: Optional[int] = None) -> WorkloadSpec:
    """Diurnal wave over an elastic fleet: the autoscale generator
    grows the active shard set 2→4 when the morning ramp starves
    satisfaction, and shrinks back 4→2 once the evening decay restores
    headroom — with the straddle capacity-sum and top-band leases
    pinned through both routing-epoch changes."""
    ticks = ticks or 48
    cap = 260.0 * scale
    # Straddling resources must decompose into compact per-shard
    # summaries, so the fleet runs the proportional default (the
    # reconciler rejects PRIORITY_BANDS straddles by design).
    return WorkloadSpec.make(
        "reshard_diurnal", ticks, seed=seed, servers=4,
        capacity=cap,
        federated={
            "fleet": True,
            "active": 2,
            "straddle": ["r0"],
            "client_shards": [0, 1],
        },
        base_clients=[(2, 30.0 * scale), (2, 30.0 * scale)],
        generators=[
            G(
                "diurnal",
                # Sharp day: quiet, a steep morning ramp that
                # overloads the pool, a fast evening decay so the
                # shrink leg fires well before the run ends.
                curve="0:1,10:10,22:12,30:2,48:1",
                period=48.0, jitter=0.2,
                bands=[[0, 2.0], [1, 1.0]],
                wants=8.0 * scale, lifetime_ticks=6,
                max_population=_pop(scale, 100),
            ),
            G(
                "autoscale", target=0.85, min_shards=2, max_shards=4,
                scale_step=2, hysteresis=3, cooldown=6,
                shrink_margin=0.05,
            ),
        ],
        gates={
            # Both legs of the 2→4→2 arc visibly happened...
            "epoch_changes": 2.0,
            # ...without ever over-admitting across the fleet...
            "fed_capacity_violations": 0.0,
            # ...while the resident leases ride through both
            # routing-epoch changes and refreshes keep landing.
            "top_band_satisfaction": 0.8,
            "refresh_ok_ratio": 0.9,
            "get_capacity_p99_ms": 250.0,
        },
    )


SCENARIOS: Dict[str, Callable[..., WorkloadSpec]] = {
    fn.__name__: fn
    for fn in (
        diurnal, flash_crowd, rolling_deploy, multi_region,
        elastic_preempt, flash_crowd_federated, diurnal_streaming,
        diurnal_streaming_pooled, flash_crowd_predictive,
        diurnal_million, flash_crowd_million, reshard_diurnal,
    )
}


def scenario_lines() -> list:
    """[(name, one-line doc), ...] — what --list-scenarios prints
    (the sim registry's convention, via its shared helper)."""
    from doorman_tpu_torch.sim.scenarios import registry_lines

    return registry_lines(SCENARIOS)


async def _run(spec: WorkloadSpec, forecaster=None, device="cuda"):
    runner = WorkloadRunner(spec, forecaster=forecaster, device=device)
    return await runner.run(), runner


def _warm_forecaster(spec: WorkloadSpec, history, device="cuda"):
    """A forecaster primed from a durable history, or None when the
    spec is not predictive / the history holds nothing to replay. The
    model is built exactly as the harness builds its cold one, then
    `warm_start` replays the recorded per-tick offered stream through
    `observe` — so the resulting state is bit-identical to having
    watched that stream live (the pin in
    tests/test_torch_workload_population.py)."""
    from doorman_tpu_torch.workload.forecast import SeasonalForecaster

    predictive = spec.predictive_config()
    if not predictive:
        return None
    bands = [int(b) for b in predictive.get("bands", [0, 1])]
    fc = SeasonalForecaster(
        series=len(bands),
        period=int(predictive["period"]),
        alpha=float(predictive.get("alpha", 0.5)),
        beta=float(predictive.get("beta", 0.25)),
        engine=str(predictive.get("engine", "auto")),
        device=device,
    )
    fed = fc.warm_start(
        history, field="offered", interval=float(spec.tick_interval)
    )
    return fc if fed else None


async def run_scenario_async(
    name: str, *, scale: float = 1.0, seed: int = 0,
    ticks: Optional[int] = None, history_dir: Optional[str] = None,
    device="cuda",
) -> dict:
    """Run one named scenario and return its verdict dict.

    ``device`` ("cuda" unless the caller asks for "cpu") is resolved
    before anything starts, so a run without a GPU raises at once; every
    server and forecaster of the run is built on it.

    ``flash_crowd_predictive`` runs twice — forecaster on, then the
    identical spec with the forecaster stripped — and the returned
    verdict is the predictive run's, extended with the reactive run's
    summary and the standing predictive-over-reactive pair verdict.
    """
    factory = SCENARIOS.get(name)
    if factory is None:
        raise ValueError(
            f"unknown scenario {name!r} (known: {sorted(SCENARIOS)})"
        )
    spec = factory(scale=scale, seed=seed, ticks=ticks)
    device = resolve_device(device)
    history = forecaster = None
    if history_dir:
        from doorman_tpu_torch.obs.history import HistoryStore

        # Loading the store replays any prior runs' segments; a
        # predictive spec warm-starts its forecaster from them.
        history = HistoryStore(
            history_dir, component=f"workload:{spec.name}"
        )
        forecaster = _warm_forecaster(spec, history, device=device)
    warm_ticks = forecaster.ticks_observed if forecaster else 0
    verdict, runner = await _run(
        spec, forecaster=forecaster, device=device
    )
    if history is not None:
        verdict["forecaster_warm_start"] = warm_ticks
        # Re-home this run's flight records as durable segments, so the
        # NEXT invocation starts where this one's traffic left off.
        try:
            for rec in runner.flightrec.snapshot():
                history.append(rec)
        finally:
            history.close()
    if spec.predictive_config():
        reactive_spec = spec.with_(
            predictive={}
        ).with_(name=f"{spec.name}_reactive")
        reactive, _ = await _run(reactive_spec, device=device)
        key = "top_band_satisfaction_stress"
        pair = slo_mod.predictive_goodput_verdict(
            float(verdict["summary"].get(key, 0.0)),
            float(reactive["summary"].get(key, 0.0)),
            name=f"workload:{spec.name}:predictive_over_reactive",
        )
        pair["delta_vs_prev"] = slo_mod.TrajectoryComparator(
        ).slo_delta(pair)
        verdict["slo"]["verdicts"].append(pair)
        verdict["slo"]["ok"] = verdict["slo"]["ok"] and (
            pair["status"] != "fail"
        )
        verdict["ok"] = verdict["slo"]["ok"]
        verdict["reactive"] = {
            "summary": reactive["summary"],
            "log_sha256": reactive["log_sha256"],
        }
    return verdict


def run_scenario(name: str, *, scale: float = 1.0, seed: int = 0,
                 ticks: Optional[int] = None,
                 history_dir: Optional[str] = None,
                 device="cuda") -> dict:
    import asyncio

    return asyncio.run(
        run_scenario_async(
            name, scale=scale, seed=seed, ticks=ticks,
            history_dir=history_dir, device=device,
        )
    )
