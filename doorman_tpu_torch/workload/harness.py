"""WorkloadRunner: drive a WorkloadSpec against the real stack on the
virtual clock and return an SLO-gated verdict (port of
doorman_tpu/workload/harness.py).

The topology is the chaos runner's, reused piece for piece (this is
the point: scenarios measure the REAL server, not a model of it): real
CapacityServer instances behind ChaosGrpcProxy loopback hops, the
stepped TTL-lock election, real Client instances refreshing leases —
every periodic loop driven explicitly in a fixed order per virtual
tick, so the same spec + seed replays the same event log
byte-for-byte. What the workload harness adds over chaos is the LOAD
side: a dynamic client population moved by the spec's generators
(arrivals, departures, deploys, elastic preemption), per-band
satisfaction accounting, and the SLO gate layer that turns a run into
a machine-readable pass/fail verdict.

Determinism contract (the byte-stable event-log acceptance):

  * the event log records only virtual-time facts — tick indices,
    client counts, rounded satisfaction/level/forecast values, master
    sets — never wall-clock durations;
  * wall-clock latencies (perf_counter around each refresh) feed ONLY
    the SLO sample streams, whose verdicts sit outside the log digest;
  * all randomness comes from the spec's seeded RNGs (FaultState.rng
    for decisions that reach the server — admission shed draws — and a
    separate measurement RNG for the virtual RTT jitter, so the
    measurement model cannot perturb admission's replay);
  * clients are stepped in insertion order, generators in spec order.

Predictive admission: with ``spec.predictive`` set, a
`forecast.SeasonalForecaster` observes the per-band offered rates each
tick and feeds the summed next-tick forecast to every server's AIMD
controller (`set_forecast`) — the controller then multiplies down at
the window boundary ENTERING a predicted spike instead of the one
after it. The flash_crowd_predictive scenario races this against the
identical reactive run.

Device: the runner takes `device` ("cuda" unless the caller asks for
"cpu"; `resolve_device` raises without a GPU) and hands it to every
CapacityServer it builds and to the forecaster it builds. The servers
run in immediate mode (no tick solve), so the device work on this path
is the stream matcher behind `push_streams` and the forecaster's step;
neither reaches the event log, which is why a card run's `log_sha256`
equals its CPU twin's.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import random
import time
from typing import Dict, List, Optional

import numpy as np

from doorman_tpu_torch.chaos.clock import ChaosClock
from doorman_tpu_torch.chaos.injectors import ChaosGrpcProxy, FaultState
from doorman_tpu_torch.chaos.invariants import InvariantChecker
from doorman_tpu_torch.chaos.runner import SteppedElection, _cancel_background
from doorman_tpu_torch.client.client import Client
from doorman_tpu_torch.obs import slo as slo_mod
from doorman_tpu_torch.obs import trace as trace_mod
from doorman_tpu_torch.obs.flightrec import FlightRecorder
from doorman_tpu_torch.server.config import parse_yaml_config
from doorman_tpu_torch.server.election import InMemoryKV, shard_lock_key
from doorman_tpu_torch.server.server import CapacityServer
from doorman_tpu_torch.utils.backend import resolve_device
from doorman_tpu_torch.workload import generators as gen_mod
from doorman_tpu_torch.workload.forecast import SeasonalForecaster
from doorman_tpu_torch.workload.spec import WorkloadSpec

LOCK = "/workload/master"

__all__ = ["WorkloadRunner", "run_spec"]


class WorkloadRunner:
    def __init__(self, spec: WorkloadSpec,
                 forecaster: Optional[SeasonalForecaster] = None,
                 device="cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        # A caller-supplied (typically history-warm-started, see
        # forecast.warm_start) forecaster to use instead of building a
        # cold one from the predictive config; its series count must
        # match the config's bands. Validated here, before run() has
        # started any server a failure would leak.
        self._preset_forecaster = forecaster
        if forecaster is not None:
            predictive = spec.predictive_config() or {}
            bands = predictive.get("bands", [0, 1])
            if forecaster.series != len(bands):
                raise ValueError(
                    f"preset forecaster has {forecaster.series} "
                    f"series, predictive config has {len(bands)} bands"
                )
        self.clock = ChaosClock()
        self.tick_interval = float(spec.tick_interval)
        # Fault-free switchboard: the workload harness injects load,
        # not faults — FaultState is here for its seeded RNG (the only
        # randomness that reaches server-side decisions) and the proxy
        # plumbing it shares with chaos.
        self.state = FaultState(spec.seed)
        self.rng = self.state.rng
        # Measurement-side RNG (virtual RTT jitter): separate stream so
        # the latency model cannot perturb admission's replay.
        self.meas_rng = random.Random(spec.seed ^ 0x5EED)
        self.servers: Dict[str, CapacityServer] = {}
        self.proxies: Dict[str, ChaosGrpcProxy] = {}
        self.elections: Dict[str, SteppedElection] = {}
        self._locks: Dict[str, str] = {}
        self.kv: Optional[InMemoryKV] = None
        self.federation = None
        self.clients: Dict[str, Client] = {}
        self.stream_clients: List[Client] = []
        # Array-backed population engine (spec.population_engine ==
        # "vector"): macro clients live as numpy rows, refreshed in
        # batched grouped passes instead of per-client RPCs. None keeps
        # the per-client reference path.
        self._vector = None
        if spec.population_engine == "vector":
            from doorman_tpu_torch.workload.population import VectorPopulation

            self._vector = VectorPopulation(self)
        elif spec.population_engine != "clients":
            raise ValueError(
                f"unknown population_engine "
                f"{spec.population_engine!r} "
                "(known: 'clients', 'vector')"
            )
        # Serving-plane pools (spec.frontend_workers > 0): one inline
        # frontend pool per server, pumped at the tick edge where a
        # real worker's poll loop would have woken.
        self.frontends: Dict[str, object] = {}
        self._frontend_frames = 0
        self._frontend_final: Dict[str, dict] = {}
        self.client_meta: Dict[str, dict] = {}
        self._client_shard: Dict[str, Optional[int]] = {}
        self.generators = gen_mod.build(spec)
        self.log: List[list] = []
        self.counters: Dict[str, int] = {}
        self.samples: Dict[str, List[float]] = {
            "get_capacity_wall_ms": [],
            "refresh_virtual_ms": [],
        }
        self._tick = 0
        self._offered_by_band: Dict[int, int] = {}
        self._down: Dict[str, int] = {}  # server name -> down until tick
        self._attach = ""
        self._admission_last: Dict[str, tuple] = {}
        self._last_band_row: Optional[list] = None
        self._last_forecast: Optional[float] = None
        self._fed_last_shares: Dict[str, list] = {}
        self._base_ids: List[str] = []
        self._baseline: Optional[Dict[str, float]] = None
        self._converged_at: Optional[int] = None
        self._last_masters: tuple = ()
        self._master_changes = 0
        self._refresh_attempts = 0
        self._refresh_ok = 0
        self._stream_pushes = 0
        self._fed_violations = 0
        self._peak_population = 0
        self._sat_rows: List[Dict[int, float]] = []
        self._sat_ticks: List[int] = []
        self.forecaster: Optional[SeasonalForecaster] = None
        self._forecast_bands: List[int] = []
        self.flightrec = FlightRecorder(
            capacity=spec.ticks + 8,
            component=f"workload:{spec.name}",
            clock=self.clock,
        )
        self.flight_dump: Optional[dict] = None

    # -- the mutator surface generators drive ---------------------------

    def client_ids(self) -> List[str]:
        if self._vector is not None:
            return self._vector.client_ids()
        return list(self.clients)

    def _population_count(self) -> int:
        if self._vector is not None:
            return self._vector.population()
        return len(self.clients)

    def note(self, tick: int, kind: str, *fields) -> None:
        """One deterministic event-log entry + a trace instant (the
        trace ring sits outside the log digest)."""
        self.log.append([tick, kind, *fields])
        trace_mod.default_tracer().instant(
            f"workload.{kind}", cat="workload", args={"tick": tick}
        )

    def bump(self, counter: str, by: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + by

    async def arrive(
        self, cid: str, band: int, wants: float,
        shard: Optional[int] = None,
    ) -> Optional[Client]:
        if self._vector is not None:
            self._vector.arrive(cid, int(band), float(wants), shard=shard)
            self._client_shard[cid] = shard
            self.client_meta.setdefault(cid, {})["band"] = int(band)
            for g in self.generators:
                g.on_arrive(cid, self)
            rtt_ms = self.client_meta.get(cid, {}).get("rtt_ms")
            if rtt_ms is not None:
                self._vector.set_rtt(cid, rtt_ms)
            return None
        if cid in self.clients:
            raise ValueError(f"client id {cid!r} already present")
        addr = self._attach
        if shard is not None:
            addr = self.proxies[f"s{int(shard)}"].address
        client = Client(
            addr, cid, minimum_refresh_interval=0.0, max_retries=0,
            clock=self.clock,
        )
        await client.resource(
            self.spec.resource, float(wants), priority=int(band)
        )
        self.clients[cid] = client
        self._client_shard[cid] = shard
        self.client_meta.setdefault(cid, {})["band"] = int(band)
        for g in self.generators:
            g.on_arrive(cid, self)
        return client

    async def depart(self, cid: str) -> None:
        if self._vector is not None:
            self.client_meta.pop(cid, None)
            await self._vector.depart(cid)
            return
        client = self.clients.pop(cid, None)
        if client is None:
            return
        self.client_meta.pop(cid, None)
        try:
            await client.close()
        except Exception:
            pass

    def grant_of(self, cid: str) -> float:
        if self._vector is not None:
            return self._vector.grant_of(cid)
        client = self.clients.get(cid)
        if client is None:
            return 0.0
        return sum(
            res.current_capacity() for res in client.resources.values()
        )

    def fleet_reshard(self, n_shards: int) -> None:
        """Publish a new routing epoch serving `n_shards` of the
        provisioned pool (fleet specs only). The generator owns the
        policy (fixed schedule or autoscaler); the harness just applies
        it, counts it, and logs the change deterministically."""
        if self.federation is None or not hasattr(
            self.federation, "reshard"
        ):
            raise ValueError(
                "fleet_reshard needs a fleet federated spec "
                '({"fleet": True, ...})'
            )
        change = self.federation.reshard(int(n_shards))
        self.bump("epoch_changes")
        self.note(
            self._tick, "fleet_epoch", change.epoch,
            change.n_from, change.n_to,
        )

    async def deploy(self, server_index: int, down_ticks: int) -> None:
        """Take one server down for a graceful rolling-deploy window:
        abdicate mastership, release its lock, and stay out of the
        campaign until the window ends (SteppedElection step's
        campaign=False leg)."""
        name = f"s{int(server_index)}"
        if name not in self.servers:
            return
        self._down[name] = self._tick + int(down_ticks)
        election = self.elections[name]
        if election.is_master:
            await election.abdicate()
            self.kv.expire(self._locks[name])
        self.note(self._tick, "deploy", name, int(down_ticks))

    # -- setup / teardown ----------------------------------------------

    def _config_yaml(self) -> str:
        s = self.spec
        safe_line = (
            f"  safe_capacity: {s.safe_capacity}\n"
            if s.safe_capacity is not None else ""
        )
        variant_part = (
            ", parameters: [{name: variant, value: "
            f"{s.algorithm_variant}" "}]"
            if s.algorithm_variant else ""
        )
        return (
            "resources:\n"
            f"- identifier_glob: \"*\"\n"
            f"  capacity: {s.capacity}\n"
            + safe_line
            + "  algorithm: {"
            + f"kind: {s.algorithm}, "
            + f"lease_length: {s.lease_length}, "
            + f"refresh_interval: {s.refresh_interval}, "
            + f"learning_mode_duration: {s.learning_mode_duration}"
            + variant_part
            + "}\n"
        )

    async def _setup(self) -> None:
        spec = self.spec
        self.kv = InMemoryKV(clock=self.clock)
        config = parse_yaml_config(self._config_yaml())
        fed = spec.federated_config()
        admission_kwargs = spec.admission_kwargs()
        for i in range(int(spec.servers)):
            name = f"s{i}"
            proxy = ChaosGrpcProxy(self.state, link=f"link:{name}")
            await proxy.start()
            lock = shard_lock_key(LOCK, i) if fed else LOCK
            self._locks[name] = lock
            election = SteppedElection(
                self.kv, lock, ttl=float(spec.election_ttl),
                clock=self.clock,
            )
            admission = None
            if admission_kwargs:
                from doorman_tpu_torch.admission import Admission

                a = dict(admission_kwargs)
                admission = Admission(
                    coalesce_window=float(a.pop("coalesce_window", 0.0)),
                    clock=self.clock,
                    rng=self.rng,
                    **a,
                )
            server = CapacityServer(
                proxy.address, election,
                mode="immediate",
                tick_interval=self.tick_interval,
                minimum_refresh_interval=0.0,
                clock=self.clock,
                admission=admission,
                native_store=bool(spec.native_store),
                stream_push=bool(spec.stream_clients),
                stream_shards=int(spec.stream_shards),
                shard=i if fed else None,
                device=self.device,
            )
            await server.start(0, host="127.0.0.1")
            await _cancel_background(server)
            proxy.backend = server
            await server.load_config(config)
            if spec.frontend_workers and spec.stream_clients:
                self.frontends[name] = server.attach_frontend(
                    int(spec.frontend_workers),
                    ring_bytes=int(spec.frontend_ring),
                )
            self.servers[name] = server
            self.proxies[name] = proxy
            self.elections[name] = election

        if fed and fed.get("fleet"):
            # Fleet runtime: all spec.servers are PROVISIONED shards,
            # the first `active` serve; generators move the boundary
            # live through harness.fleet_reshard (routing epochs).
            from doorman_tpu_torch.fleet import FleetController

            self.federation = FleetController(
                {
                    i: self.servers[f"s{i}"]
                    for i in range(int(spec.servers))
                },
                straddle=tuple(fed.get("straddle", (spec.resource,))),
                overrides=fed.get("overrides"),
                active=fed.get("active"),
                addrs={
                    i: self.proxies[f"s{i}"].address
                    for i in range(int(spec.servers))
                },
                share_ttl=float(fed.get("share_ttl", 2.0)),
                clock=self.clock,
            )
        elif fed:
            from doorman_tpu_torch.federation import FederatedRoots, ShardRouter

            router = ShardRouter(
                int(spec.servers),
                straddle=tuple(fed.get("straddle", (spec.resource,))),
                overrides=fed.get("overrides"),
            )
            self.federation = FederatedRoots(
                router,
                {
                    i: self.servers[f"s{i}"]
                    for i in range(router.n_shards)
                },
                share_ttl=float(fed.get("share_ttl", 2.0)),
                clock=self.clock,
            )

        self._attach = self.proxies["s0"].address
        client_shards = (fed or {}).get("client_shards") or []
        for i, (band, wants) in enumerate(spec.base_clients):
            shard = (
                int(client_shards[i])
                if i < len(client_shards) and client_shards[i] is not None
                else None
            )
            cid = f"c{i}"
            await self.arrive(cid, int(band), float(wants), shard=shard)
            self._base_ids.append(cid)
        # Compact base_population rows continue the c-numbering. The
        # vector engine appends each block as one array extension (its
        # deadline wheel staggers the initial lease establishment); the
        # per-client engine expands to real clients one by one.
        serial = len(spec.base_clients)
        for count, band, wants in spec.base_population:
            ids = [f"c{serial + k}" for k in range(int(count))]
            serial += int(count)
            if self._vector is not None:
                self._vector.bulk_arrive(ids, int(band), float(wants))
                for cid in ids:
                    self.client_meta.setdefault(cid, {})["band"] = int(
                        band
                    )
                    for g in self.generators:
                        g.on_arrive(cid, self)
                    rtt_ms = self.client_meta[cid].get("rtt_ms")
                    if rtt_ms is not None:
                        self._vector.set_rtt(cid, rtt_ms)
            else:
                for cid in ids:
                    await self.arrive(cid, int(band), float(wants))
            self._base_ids.extend(ids)
        for i, (band, wants) in enumerate(spec.stream_clients):
            client = Client(
                self._attach, f"w{i}", minimum_refresh_interval=0.0,
                max_retries=0, clock=self.clock, stream=True,
                retry_rng=random.Random(spec.seed * 1000 + i),
            )
            await client.resource(
                spec.resource, float(wants), priority=int(band)
            )
            self.stream_clients.append(client)

        predictive = spec.predictive_config()
        if predictive:
            if not admission_kwargs or "max_rps" not in admission_kwargs:
                raise ValueError(
                    "predictive admission needs an admission config "
                    "with max_rps (the budget the forecast scales "
                    "against)"
                )
            self._forecast_bands = [
                int(b) for b in predictive.get("bands", [0, 1])
            ]
            if self._preset_forecaster is not None:
                if self._preset_forecaster.series != len(
                    self._forecast_bands
                ):
                    raise ValueError(
                        f"preset forecaster has "
                        f"{self._preset_forecaster.series} series, "
                        f"predictive config has "
                        f"{len(self._forecast_bands)} bands"
                    )
                self.forecaster = self._preset_forecaster
            else:
                self.forecaster = SeasonalForecaster(
                    series=len(self._forecast_bands),
                    period=int(predictive["period"]),
                    alpha=float(predictive.get("alpha", 0.5)),
                    beta=float(predictive.get("beta", 0.25)),
                    engine=str(predictive.get("engine", "auto")),
                    device=self.device,
                )
        for g in self.generators:
            await g.setup(self)

    async def _teardown(self) -> None:
        # Snapshot the pools' final shape BEFORE stopping anything:
        # WorkerCore.status() reads its ring's control words, and
        # server.stop() releases the ring buffers.
        self._frontend_final = {
            name: pool.status()
            for name, pool in sorted(self.frontends.items())
        }
        for client in list(self.clients.values()) + self.stream_clients:
            try:
                await client.close()
            except Exception:
                pass
        for proxy in self.proxies.values():
            await proxy.stop()
        for server in self.servers.values():
            try:
                await server.stop()
            except Exception:
                pass

    # -- per-tick beats -------------------------------------------------

    async def _step_elections(self, tick: int) -> None:
        for name, election in self.elections.items():
            down = self._down.get(name, 0) > tick
            await election.step(campaign=not down)
        masters = tuple(sorted(
            n for n, srv in self.servers.items() if srv.is_master
        ))
        if masters != self._last_masters:
            self._master_changes += 1
            self._last_masters = masters
            self.note(tick, "master", list(masters))

    async def _refresh_clients(self, tick: int) -> None:
        if self._vector is not None:
            self._vector.step_refresh(tick)
            return
        offered: Dict[int, int] = {}
        for cid, client in list(self.clients.items()):
            band = max(
                (res.priority for res in client.resources.values()),
                default=0,
            )
            offered[band] = offered.get(band, 0) + 1
            self._refresh_attempts += 1
            t0 = time.perf_counter()
            ok = await client.refresh_once()
            wall_ms = (time.perf_counter() - t0) * 1000.0
            self.samples["get_capacity_wall_ms"].append(wall_ms)
            meta = self.client_meta.get(cid, {})
            rtt_ms = meta.get("rtt_ms")
            if rtt_ms is not None:
                # Virtual refresh latency: one modeled WAN round trip
                # with +/-10% seeded jitter on top of a 1 ms service
                # floor. Measurement-only (SLO samples, not the log).
                self.samples["refresh_virtual_ms"].append(
                    1.0 + rtt_ms * (
                        0.9 + 0.2 * self.meas_rng.random()
                    )
                )
            if ok:
                self._refresh_ok += 1
        self._offered_by_band = offered

    async def _drive_streams(self, tick: int) -> None:
        if not self.stream_clients:
            return
        for server in self.servers.values():
            server.push_streams()
        for name, pool in self.frontends.items():
            stats = pool.pump_all()
            self._frontend_frames += stats["frames"]
            if stats["lapped"] or stats["corrupt"] or stats["stalled"]:
                self.log.append([
                    tick, "frontend_pump", name, stats["frames"],
                    stats["lapped"], stats["corrupt"], stats["stalled"],
                ])
        for client in self.stream_clients:
            out = await client.stream_step(drain_timeout=0.05)
            self._stream_pushes += out["pushes"]
            if out["events"] or out["pushes"]:
                self.log.append([
                    tick, "stream", client.id,
                    ",".join(out["events"]) or "push",
                    out["pushes"],
                ])

    def _drive_federation(self, tick: int) -> None:
        if self.federation is None:
            return
        installed = self.federation.reconcile_once()
        for rid, shares in sorted(installed.items()):
            rounded = [
                [shard, round(value, 6)]
                for shard, value in sorted(shares.items())
            ]
            if self._fed_last_shares.get(rid) != rounded:
                self._fed_last_shares[rid] = rounded
                self.log.append([tick, "straddle", rid, rounded])

    def _check_federation(self, tick: int,
                          checker: InvariantChecker) -> None:
        if self.federation is None:
            return
        violations = checker.check_federation(
            tick, self.servers, self.federation.straddle_capacities()
        )
        for v in violations:
            self._fed_violations += 1
            self.log.append([tick] + v.as_log())

    def _measure_bands(self, tick: int) -> Dict[int, float]:
        if self._vector is not None:
            wants_by, gets_by = self._vector.measure_bands()
        else:
            wants_by = {}
            gets_by = {}
            for client in self.clients.values():
                for res in client.resources.values():
                    band = int(res.priority)
                    wants_by[band] = wants_by.get(band, 0.0) + float(
                        res.wants
                    )
                    gets_by[band] = gets_by.get(band, 0.0) + min(
                        res.current_capacity(), float(res.wants)
                    )
        sat = {
            band: (gets_by[band] / wants_by[band])
            for band in wants_by if wants_by[band] > 0
        }
        row = [
            [band, round(wants_by[band], 6), round(gets_by[band], 6)]
            for band in sorted(wants_by)
        ]
        if row != self._last_band_row:
            self._last_band_row = row
            self.log.append([tick, "band", row])
        if sat:
            self._sat_rows.append(sat)
            self._sat_ticks.append(tick)
        return sat

    def _log_admission(self, tick: int) -> None:
        for name, server in self.servers.items():
            adm = getattr(server, "_admission", None)
            if adm is None:
                continue
            admitted = shed = 0
            for (method, _band), counts in adm.tallies.items():
                if method == "GetCapacity":
                    admitted += counts["admitted"]
                    shed += counts["shed"]
            last = self._admission_last.get(name, (0, 0))
            if (admitted, shed) != last:
                self._admission_last[name] = (admitted, shed)
                self.log.append([
                    tick, "admission", name,
                    admitted - last[0], shed - last[1],
                    round(adm.controller.level, 6),
                ])

    def _feed_forecast(self, tick: int) -> None:
        if self.forecaster is None:
            return
        rates = np.asarray(
            [
                self._offered_by_band.get(b, 0) / self.tick_interval
                for b in self._forecast_bands
            ],
            np.float32,
        )
        forecast = self.forecaster.observe(rates)
        total = float(np.sum(forecast))
        for server in self.servers.values():
            adm = getattr(server, "_admission", None)
            if adm is not None:
                adm.controller.set_forecast(total)
        rounded = round(total, 3)
        if rounded != self._last_forecast:
            self._last_forecast = rounded
            self.log.append([tick, "forecast", rounded])

    def _flight_record(self, tick: int,
                       sat: Dict[int, float]) -> None:
        rec: dict = {
            "t": self.clock(),
            "tick": tick,
            "masters": list(self._last_masters),
            "satisfaction": {
                str(b): round(v, 6) for b, v in sorted(sat.items())
            },
        }
        rec["population"] = self._population_count()
        rec["offered"] = sum(self._offered_by_band.values())
        if self.federation is not None and hasattr(
            self.federation, "epoch"
        ):
            # The fleet's routing state on the black box: an operator
            # lines a grant wiggle up with the epoch that caused it.
            rec["fleet_epoch"] = self.federation.epoch
            rec["fleet_active"] = self.federation.active
        if self.frontends:
            rec["frontend_held"] = sum(
                pool.held() for pool in self.frontends.values()
            )
        for name, server in sorted(self.servers.items()):
            adm = getattr(server, "_admission", None)
            if adm is not None:
                rec["admission_level"] = round(
                    adm.controller.level, 6
                )
                break
        if self._last_forecast is not None:
            rec["forecast_rps"] = self._last_forecast
        self.flightrec.record(**rec)

    # -- reconvergence --------------------------------------------------

    def _snapshot(self) -> Dict[str, float]:
        if self._vector is not None:
            return self._vector.snapshot(self._base_ids)
        out = {}
        for cid in self._base_ids:
            client = self.clients.get(cid)
            if client is None:
                continue
            for rid, res in client.resources.items():
                out[f"{cid}/{rid}"] = res.current_capacity()
        return out

    @staticmethod
    def _matches(a: Dict[str, float], b: Dict[str, float]) -> bool:
        return a.keys() == b.keys() and all(
            abs(a[k] - b[k]) <= 1e-9 for k in a
        )

    def _track_reconvergence(self, tick: int) -> None:
        spec = self.spec
        if spec.baseline_tick is None or spec.heal_tick is None:
            return
        if tick == spec.baseline_tick:
            self._baseline = self._snapshot()
        if (
            self._baseline is not None
            and self._converged_at is None
            and tick >= spec.heal_tick
            and self._matches(self._snapshot(), self._baseline)
        ):
            self._converged_at = tick
            self.note(tick, "converged", tick - spec.heal_tick)

    # -- the drive ------------------------------------------------------

    async def run(self) -> dict:
        spec = self.spec
        await self._setup()
        checker = InvariantChecker(
            self.clock, lease_length=float(spec.lease_length)
        )
        try:
            with trace_mod.default_tracer().span(
                "workload.scenario", cat="workload",
                args={"scenario": spec.name, "seed": spec.seed},
            ):
                for tick in range(spec.ticks):
                    self._tick = tick
                    self.state.begin_tick(tick)
                    for g in self.generators:
                        await g.step(tick, self)
                    self._peak_population = max(
                        self._peak_population, self._population_count()
                    )
                    await self._step_elections(tick)
                    self._drive_federation(tick)
                    await self._refresh_clients(tick)
                    await self._drive_streams(tick)
                    for g in self.generators:
                        await g.after_refresh(tick, self)
                    sat = self._measure_bands(tick)
                    self._log_admission(tick)
                    self._check_federation(tick, checker)
                    self._track_reconvergence(tick)
                    self._feed_forecast(tick)
                    self._flight_record(tick, sat)
                    self.clock.advance(self.tick_interval)
        finally:
            await self._teardown()
        return self._verdict()

    # -- verdict --------------------------------------------------------

    def _scalars(self) -> Dict[str, float]:
        spec = self.spec
        top_series: List[float] = []
        all_series: List[float] = []
        stress_series: List[float] = []
        stress = set(int(t) for t in spec.stress_ticks)
        for tick, sat in zip(self._sat_ticks, self._sat_rows):
            top = max(sat)
            top_series.append(sat[top])
            all_series.extend(sat.values())
            if tick in stress:
                stress_series.append(sat[top])
        scalars: Dict[str, float] = {
            "peak_population": float(self._peak_population),
            "master_changes": float(self._master_changes),
            "stream_pushes": float(self._stream_pushes),
            "fed_capacity_violations": float(self._fed_violations),
            "completions": float(self.counters.get("completions", 0)),
            "preemptions": float(self.counters.get("preemptions", 0)),
            "epoch_changes": float(
                self.counters.get("epoch_changes", 0)
            ),
        }
        if self.frontends or self._frontend_final:
            scalars["frontend_frames"] = float(self._frontend_frames)
            scalars["frontend_held"] = float(sum(
                st.get("held", 0)
                for st in self._frontend_final.values()
            ))
        if self._refresh_attempts:
            scalars["refresh_ok_ratio"] = (
                self._refresh_ok / self._refresh_attempts
            )
        if top_series:
            scalars["top_band_satisfaction"] = sum(top_series) / len(
                top_series
            )
        if all_series:
            scalars["satisfaction_overall"] = sum(all_series) / len(
                all_series
            )
        if stress_series:
            scalars["top_band_satisfaction_stress"] = sum(
                stress_series
            ) / len(stress_series)
        if self._converged_at is not None and spec.heal_tick is not None:
            scalars["reconverge_ticks"] = float(
                self._converged_at - spec.heal_tick
            )
        return scalars

    def _band_tallies(self) -> Dict[int, Dict[str, int]]:
        tallies: Dict[int, Dict[str, int]] = {}
        for server in self.servers.values():
            adm = getattr(server, "_admission", None)
            if adm is None:
                continue
            for (method, band), counts in adm.tallies.items():
                if method != "GetCapacity":
                    continue
                entry = tallies.setdefault(
                    int(band),
                    {"admitted": 0, "shed": 0, "fast_fail": 0},
                )
                for key in entry:
                    entry[key] += counts.get(key, 0)
        return tallies

    def _verdict(self) -> dict:
        spec = self.spec
        scalars = self._scalars()
        specs = slo_mod.workload_slos(
            spec.gate_targets(), name_prefix=f"workload:{spec.name}"
        )
        verdicts = slo_mod.SloEngine(specs).evaluate(
            slo_mod.SloInputs(
                scalars=scalars,
                samples=self.samples,
                band_tallies=self._band_tallies(),
            )
        )
        for v in verdicts:
            if (
                v["slo"].endswith(":reconverge_ticks")
                and v["status"] == "no_data"
                and spec.heal_tick is not None
            ):
                # Never reconverged is a hard fail, not missing data.
                v["status"] = "fail"
                v["detail"] = {"note": "no reconvergence within the run"}
        comparator = slo_mod.TrajectoryComparator()
        for v in verdicts:
            v["delta_vs_prev"] = comparator.slo_delta(v)
        ok = all(v["status"] != "fail" for v in verdicts)
        if not ok and self.flight_dump is None:
            failed = next(
                v["slo"] for v in verdicts if v["status"] == "fail"
            )
            self.flight_dump = self.flightrec.dump(f"slo:{failed}")
        log_bytes = json.dumps(
            self.log, sort_keys=True, separators=(",", ":")
        ).encode()
        summary = {
            key: (round(value, 6) if isinstance(value, float) else value)
            for key, value in sorted(scalars.items())
        }
        if self.forecaster is not None:
            summary["forecaster"] = self.forecaster.status()
        return {
            "scenario": spec.name,
            "seed": spec.seed,
            "ok": ok,
            "ticks": spec.ticks,
            "tick_interval": self.tick_interval,
            "summary": summary,
            "frontend": self._frontend_final or None,
            "slo": {"ok": ok, "verdicts": verdicts},
            "flightrec_dump": self.flight_dump,
            "event_log": self.log,
            "log_sha256": hashlib.sha256(log_bytes).hexdigest(),
        }


def run_spec(spec: WorkloadSpec, device="cuda") -> dict:
    """Synchronous convenience: drive one spec, return the verdict."""
    return asyncio.run(WorkloadRunner(spec, device=device).run())
