"""Composable load-shape generators for the workload harness.

Each generator is a small state machine stepped once per virtual tick
BEFORE the tick's refreshes (arrivals, departures, deploys), with an
optional `after_refresh` hook AFTER them (work accrual, preemption
detection). Generators move load exclusively through the harness's
mutators (`arrive`/`depart`/`set_wants`/`deploy`/`note`), and draw all
randomness from the harness's seeded RNG — so a scenario's event log
replays byte-for-byte.

Registry kinds:

  * ``diurnal``      — arrivals paced by a piecewise-linear rate curve
                       (loadtest.ratecurve), weighted band mix, seeded
                       lifetimes;
  * ``flash_crowd``  — a burst population arriving at once (optionally
                       repeating with a period, the predictive
                       scenario's seasonal signal) and leaving together;
  * ``rolling_deploy`` — takes each server down in sequence (graceful
                       abdication, re-campaign after `down_ticks`);
  * ``multi_region`` — assigns every client a region with a seeded RTT
                       that rides the virtual refresh-latency samples;
  * ``elastic``      — fractional/elastic jobs (arxiv 1106.4985): work
                       accrues with whatever capacity is granted,
                       sustained starvation below `min_wants` preempts
                       (depart + requeue), jobs complete at
                       `total_work`;
  * ``trace``        — replays a recorded arrival log (inline
                       ``events`` rows or a ``loadtest.storm --record``
                       JSONL file): real traffic shapes re-run against
                       the virtual-clock harness, deterministically;
  * ``reshard``      — a fixed routing-epoch schedule for fleet specs
                       ([[tick, shards], ...] applied through
                       harness.fleet_reshard);
  * ``autoscale``    — the SLO-driven elastic shard count: per-tick
                       satisfaction verdicts feed fleet.Autoscaler
                       (hysteresis + cool-down) and its decisions
                       become live reshards.
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional

from doorman_tpu_torch.loadtest.ratecurve import ArrivalSampler, RateCurve

__all__ = ["Generator", "GENERATORS", "build"]


class Generator:
    """Base: a no-op shape. Subclasses override setup/step hooks."""

    kind = "base"

    def __init__(self, params: dict):
        self.params = dict(params)

    async def setup(self, harness) -> None:
        pass

    async def step(self, tick: int, harness) -> None:
        pass

    async def after_refresh(self, tick: int, harness) -> None:
        pass

    def on_arrive(self, cid: str, harness) -> None:
        pass


class DiurnalArrivals(Generator):
    kind = "diurnal"

    def __init__(self, params: dict):
        super().__init__(params)
        p = self.params
        self.curve = RateCurve.parse(p["curve"])
        self.period = p.get("period")
        self.jitter = float(p.get("jitter", 0.0))
        # [[band, weight], ...] — the arrival band mix.
        self.bands = [
            (int(b), float(w)) for b, w in p.get("bands", [[0, 1.0]])
        ]
        self.wants = float(p.get("wants", 10.0))
        self.lifetime_ticks = int(p.get("lifetime_ticks", 10))
        self.max_population = int(p.get("max_population", 10_000))
        self.prefix = str(p.get("prefix", "d"))
        self._sampler: Optional[ArrivalSampler] = None
        self._serial = 0
        self._departures: Dict[int, List[str]] = {}
        self._alive = 0

    async def setup(self, harness) -> None:
        self._sampler = ArrivalSampler(
            self.curve, jitter=self.jitter, rng=harness.rng,
            period=self.period,
        )

    def _pick_band(self, rng: random.Random) -> int:
        total = sum(w for _, w in self.bands)
        roll = rng.random() * total
        acc = 0.0
        for band, weight in self.bands:
            acc += weight
            if roll < acc:
                return band
        return self.bands[-1][0]

    async def step(self, tick: int, harness) -> None:
        for cid in self._departures.pop(tick, []):
            await harness.depart(cid)
            self._alive -= 1
        t0 = tick * harness.tick_interval
        t1 = t0 + harness.tick_interval
        n = self._sampler.take(t0, t1)
        arrived = 0
        for _ in range(n):
            if self._alive >= self.max_population:
                break
            band = self._pick_band(harness.rng)
            cid = f"{self.prefix}{self._serial}"
            self._serial += 1
            await harness.arrive(cid, band, self.wants)
            life = max(
                1,
                int(self.lifetime_ticks
                    * (0.5 + harness.rng.random())),
            )
            self._departures.setdefault(tick + life, []).append(cid)
            self._alive += 1
            arrived += 1
        if arrived:
            harness.note(tick, "diurnal_arrive", arrived, self._alive)


class FlashCrowd(Generator):
    kind = "flash_crowd"

    def __init__(self, params: dict):
        super().__init__(params)
        p = self.params
        self.at = int(p["at"])
        self.duration = int(p.get("duration", 4))
        self.clients = int(p.get("clients", 20))
        self.band = int(p.get("band", 0))
        self.wants = float(p.get("wants", 10.0))
        self.period = p.get("period")
        self.repeats = int(p.get("repeats", 1))
        self.prefix = str(p.get("prefix", "fc"))
        self._crowd: List[str] = []
        self._cycle = 0

    def start_ticks(self) -> List[int]:
        if self.period is None:
            return [self.at]
        return [
            self.at + k * int(self.period) for k in range(self.repeats)
        ]

    async def step(self, tick: int, harness) -> None:
        if tick in self.start_ticks() and not self._crowd:
            for i in range(self.clients):
                cid = f"{self.prefix}{self._cycle}_{i}"
                await harness.arrive(cid, self.band, self.wants)
                self._crowd.append(cid)
            harness.note(tick, "crowd_start", self._cycle, self.clients)
            self._end = tick + self.duration
            self._cycle += 1
        elif self._crowd and tick >= self._end:
            crowd, self._crowd = self._crowd, []
            for cid in crowd:
                await harness.depart(cid)
            harness.note(tick, "crowd_end", self._cycle - 1, len(crowd))


class RollingDeploy(Generator):
    kind = "rolling_deploy"

    def __init__(self, params: dict):
        super().__init__(params)
        p = self.params
        self.at = int(p.get("at", 5))
        self.down_ticks = int(p.get("down_ticks", 3))
        self.gap_ticks = int(p.get("gap_ticks", 4))

    async def step(self, tick: int, harness) -> None:
        stride = self.down_ticks + self.gap_ticks
        for i in range(harness.spec.servers):
            if tick == self.at + i * stride:
                await harness.deploy(i, self.down_ticks)


class MultiRegionRtt(Generator):
    kind = "multi_region"

    def __init__(self, params: dict):
        super().__init__(params)
        # [[name, rtt_ms, weight], ...]
        self.regions = [
            (str(n), float(rtt), float(w))
            for n, rtt, w in self.params.get(
                "regions",
                [["local", 2.0, 1.0], ["near", 40.0, 1.0],
                 ["far", 150.0, 1.0]],
            )
        ]

    def _assign(self, cid: str, harness) -> None:
        total = sum(w for _, _, w in self.regions)
        roll = harness.rng.random() * total
        acc = 0.0
        for name, rtt_ms, weight in self.regions:
            acc += weight
            if roll < acc:
                break
        harness.client_meta.setdefault(cid, {}).update(
            region=name, rtt_ms=rtt_ms
        )

    async def setup(self, harness) -> None:
        for cid in harness.client_ids():
            self._assign(cid, harness)

    def on_arrive(self, cid: str, harness) -> None:
        self._assign(cid, harness)


class ElasticJobs(Generator):
    """Fractional/elastic jobs: each job wants up to `max_wants` but
    makes progress with ANY grant (work += grant * tick_interval). A
    grant below `min_wants` for `patience` consecutive ticks preempts
    the job — it releases its lease and requeues `requeue_ticks` later
    with its accrued work intact. A job completes (departs for good)
    at `total_work`."""

    kind = "elastic"

    def __init__(self, params: dict):
        super().__init__(params)
        p = self.params
        self.jobs = int(p.get("jobs", 8))
        self.band = int(p.get("band", 0))
        self.min_wants = float(p.get("min_wants", 5.0))
        self.max_wants = float(p.get("max_wants", 20.0))
        self.total_work = float(p.get("total_work", 200.0))
        self.patience = int(p.get("patience", 2))
        self.requeue_ticks = int(p.get("requeue_ticks", 3))
        self.start_tick = int(p.get("start_tick", 0))
        self.prefix = str(p.get("prefix", "e"))
        # cid -> {"work", "starve"}; requeues: tick -> [cid]
        self._state: Dict[str, Dict[str, float]] = {}
        self._running: List[str] = []
        self._requeue: Dict[int, List[str]] = {}

    async def step(self, tick: int, harness) -> None:
        if tick == self.start_tick:
            for i in range(self.jobs):
                cid = f"{self.prefix}{i}"
                self._state[cid] = {"work": 0.0, "starve": 0}
                await harness.arrive(cid, self.band, self.max_wants)
                self._running.append(cid)
            harness.note(tick, "elastic_start", self.jobs)
        for cid in self._requeue.pop(tick, []):
            await harness.arrive(cid, self.band, self.max_wants)
            self._state[cid]["starve"] = 0
            self._running.append(cid)
            harness.note(tick, "elastic_requeue", cid)

    async def after_refresh(self, tick: int, harness) -> None:
        for cid in list(self._running):
            st = self._state[cid]
            grant = harness.grant_of(cid)
            st["work"] += grant * harness.tick_interval
            if st["work"] >= self.total_work:
                self._running.remove(cid)
                await harness.depart(cid)
                harness.bump("completions")
                harness.note(
                    tick, "elastic_complete", cid,
                    round(st["work"], 6),
                )
                continue
            if grant < self.min_wants:
                st["starve"] += 1
                if st["starve"] >= self.patience:
                    self._running.remove(cid)
                    await harness.depart(cid)
                    harness.bump("preemptions")
                    self._requeue.setdefault(
                        tick + self.requeue_ticks, []
                    ).append(cid)
                    harness.note(
                        tick, "elastic_preempt", cid,
                        round(st["work"], 6),
                    )
            else:
                st["starve"] = 0


class TraceReplay(Generator):
    """Replay a recorded arrival trace against the harness.

    Events come inline (``events: [[tick, band, wants], ...]``) or
    from a JSONL ``path`` — one object per line with ``tick`` plus
    optional ``band``/``wants``, the format ``loadtest.storm --record``
    writes — so a storm captured against a real deployment re-runs as
    a deterministic scenario. Each event arrives one client at its
    tick; ``lifetime_ticks > 0`` departs it that many ticks later
    (0: it stays for the run). Draws no randomness: the trace IS the
    schedule."""

    kind = "trace"

    def __init__(self, params: dict):
        super().__init__(params)
        p = self.params
        self.events = p.get("events")
        self.path = str(p.get("path", ""))
        if self.events is None and not self.path:
            raise ValueError("trace generator needs events or path")
        self.lifetime_ticks = int(p.get("lifetime_ticks", 0))
        self.prefix = str(p.get("prefix", "tr"))
        self._by_tick: Dict[int, List[tuple]] = {}
        self._serial = 0
        self._departures: Dict[int, List[str]] = {}

    async def setup(self, harness) -> None:
        events = self.events
        if events is None:
            events = []
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    if isinstance(rec, dict):
                        events.append([
                            rec["tick"], rec.get("band", 0),
                            rec.get("wants", 10.0),
                        ])
                    else:
                        events.append(rec)
        self._by_tick = {}
        for t, band, wants in events:
            self._by_tick.setdefault(int(t), []).append(
                (int(band), float(wants))
            )

    async def step(self, tick: int, harness) -> None:
        for cid in self._departures.pop(tick, []):
            await harness.depart(cid)
        arrivals = self._by_tick.get(tick, [])
        for band, wants in arrivals:
            cid = f"{self.prefix}{self._serial}"
            self._serial += 1
            await harness.arrive(cid, band, wants)
            if self.lifetime_ticks > 0:
                self._departures.setdefault(
                    tick + self.lifetime_ticks, []
                ).append(cid)
        if arrivals:
            harness.note(tick, "trace_arrive", len(arrivals))


class ReshardSchedule(Generator):
    """A fixed routing-epoch schedule for fleet specs: ``schedule``
    rows of [tick, shards] applied in order through
    harness.fleet_reshard. Draws no randomness — the schedule IS the
    policy (the autoscale generator is the closed-loop variant)."""

    kind = "reshard"

    def __init__(self, params: dict):
        super().__init__(params)
        self.schedule = {
            int(t): int(m)
            for t, m in self.params.get("schedule", [])
        }
        if not self.schedule:
            raise ValueError("reshard generator needs a schedule")

    async def step(self, tick: int, harness) -> None:
        target = self.schedule.get(tick)
        if target is not None:
            harness.fleet_reshard(target)


class AutoscaleFleet(Generator):
    """SLO-driven elastic shard count. After each tick's refreshes the
    generator renders the tick's satisfaction as a min-kind verdict
    against ``target`` (observed < target fails; margin = observed -
    target) and feeds it to a fleet.Autoscaler — sustained failure
    grows the active set by ``scale_step``, sustained pass with at
    least ``shrink_margin`` headroom shrinks it, hysteresis and
    cool-down guard against flapping. Decisions apply immediately via
    harness.fleet_reshard, so the NEXT beat re-splits the straddle
    shares over the new active set. Deterministic: satisfaction is
    plan arithmetic and the autoscaler draws no randomness."""

    kind = "autoscale"

    def __init__(self, params: dict):
        super().__init__(params)
        p = self.params
        from doorman_tpu_torch.fleet import Autoscaler

        self.target = float(p.get("target", 0.9))
        self.scaler = Autoscaler(
            min_shards=int(p["min_shards"]),
            max_shards=int(p["max_shards"]),
            step=int(p.get("scale_step", 1)),
            hysteresis=int(p.get("hysteresis", 3)),
            cooldown=int(p.get("cooldown", 6)),
            shrink_margin=float(p.get("shrink_margin", 0.0)),
        )

    async def after_refresh(self, tick: int, harness) -> None:
        # _measure_bands runs after the generators' after_refresh, so
        # measure this tick's satisfaction directly (same arithmetic).
        if harness._vector is not None:
            wants_by, gets_by = harness._vector.measure_bands()
        else:
            wants_by = {}
            gets_by = {}
            for client in harness.clients.values():
                for res in client.resources.values():
                    band = int(res.priority)
                    wants_by[band] = wants_by.get(band, 0.0) + float(
                        res.wants
                    )
                    gets_by[band] = gets_by.get(band, 0.0) + min(
                        res.current_capacity(), float(res.wants)
                    )
        total_wants = sum(wants_by.values())
        if total_wants <= 0:
            return
        observed = sum(gets_by.values()) / total_wants
        verdict = {
            "slo": "autoscale:satisfaction",
            "status": "pass" if observed >= self.target else "fail",
            "margin": observed - self.target,
        }
        decided = self.scaler.observe(
            tick, [verdict], harness.federation.active
        )
        if decided is not None:
            harness.note(
                tick, "autoscale",
                self.scaler.decisions[-1]["reason"],
                harness.federation.active, decided,
            )
            harness.fleet_reshard(decided)


GENERATORS = {
    cls.kind: cls
    for cls in (
        DiurnalArrivals, FlashCrowd, RollingDeploy, MultiRegionRtt,
        ElasticJobs, TraceReplay, ReshardSchedule, AutoscaleFleet,
    )
}


def build(spec) -> List[Generator]:
    out = []
    for g in spec.generators:
        cls = GENERATORS.get(g.kind)
        if cls is None:
            raise ValueError(
                f"unknown generator kind {g.kind!r} "
                f"(known: {sorted(GENERATORS)})"
            )
        out.append(cls(g.as_params()))
    return out
