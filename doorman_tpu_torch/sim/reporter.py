"""Simulation reporter: samples per-client and per-master state every 5s,
writes a CSV at the end, and computes the utilization/convergence summary
quoted for the reference in doc/design.md:773-799 (capability parity with
reference simulation/reporter.py)."""

from __future__ import annotations

import csv
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

from doorman_tpu_torch.sim.core import Sim

log = logging.getLogger("doorman_tpu_torch.sim")

REPORT_INTERVAL = 5.0


@dataclass
class Sample:
    time: float
    sum_wants: float
    sum_has: float
    capacity: float
    clients_with_lease: int


class Reporter:
    def __init__(self, sim: Sim, warmup: float = 90.0):
        self.sim = sim
        self.resource_id: Optional[str] = None
        self.filename: Optional[str] = None
        self.samples: List[Sample] = []
        # Ignore the learning/convergence phase when averaging utilization
        # (the reference quotes post-learning averages).
        self.warmup = warmup
        sim.scheduler.add_finalizer(self.finalize)

    def schedule(self, resource_id: str) -> None:
        self.resource_id = resource_id
        self.sim.scheduler.add_relative(REPORT_INTERVAL, self._tick)

    def set_filename(self, name: str) -> None:
        self.filename = name

    def _tick(self) -> None:
        self.sim.scheduler.add_relative(REPORT_INTERVAL, self._tick)
        rid = self.resource_id
        sum_wants = 0.0
        sum_has = 0.0
        holders = 0
        for client in self.sim.clients:
            state = client.resources.get(rid)
            if state is None:
                continue
            sum_wants += state["wants"]
            if state["has"] is not None:
                sum_has += state["has"].capacity
                holders += 1
        capacity = 0.0
        for job in self.sim.server_jobs:
            master = job.get_master()
            if master is None or master.level != 0:
                continue
            res = master.resources.get(rid)
            if res is not None:
                capacity = res.template.capacity
        self.samples.append(
            Sample(
                self.sim.clock.get_time(), sum_wants, sum_has, capacity, holders
            )
        )

    def summary(self) -> Dict[str, float]:
        """Post-warmup averages: utilization = handed-out / capacity among
        samples where demand exceeded capacity; overage tracks shortfall
        events (handed out > capacity)."""
        post = [
            s for s in self.samples
            if s.time >= self.warmup and s.capacity > 0
        ]
        if not post:
            return {"utilization": 0.0, "samples": 0, "overage_events": 0,
                    "max_overage": 0.0, "avg_overage": 0.0}
        overloaded = [s for s in post if s.sum_wants >= s.capacity]
        basis = overloaded or post
        utilization = sum(
            min(s.sum_has, s.capacity) / s.capacity for s in basis
        ) / len(basis)
        over = [s for s in post if s.sum_has > s.capacity * 1.001]
        # Shortfall statistics quoted by the reference design doc
        # (count / max / average overage, design.md:795-799; reference
        # reporter.py:136-263 computes them from the same samples).
        return {
            "utilization": utilization,
            "samples": len(post),
            "overage_events": len(over),
            "max_overage": max((s.sum_has for s in over), default=0.0),
            "avg_overage": (
                sum(s.sum_has for s in over) / len(over) if over else 0.0
            ),
        }

    def finalize(self) -> None:
        if self.filename:
            path = f"{self.filename}.csv"
            with open(path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(
                    ["time", "sum_wants", "sum_has", "capacity", "holders"]
                )
                for s in self.samples:
                    w.writerow(
                        [s.time, s.sum_wants, s.sum_has, s.capacity,
                         s.clients_with_lease]
                    )
            w2 = csv.writer(open(path, "a", newline=""))
            w2.writerow([])
            for c in self.sim.varz.counters():
                w2.writerow(["counter", c.name, c.value])
            for g in self.sim.varz.gauges():
                w2.writerow(
                    ["gauge", g.name, g.value, g.min_value, g.max_value,
                     g.average]
                )
            log.info("report written to %s", path)
