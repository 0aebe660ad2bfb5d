"""RPC admission control: coalescing, overload shedding, deadlines
(port of doorman_tpu/admission; host code only).

The serving front door for the 1M-client north star. Three cooperating
parts, wired into CapacityServer via the ``admission=`` kwarg:

  * `coalesce.Coalescer` — parks concurrent GetCapacity futures into a
    grid-aligned micro-batch window and resolves each window with one
    grouped, byte-identical-to-per-request decision pass;
  * `controller.AimdController` — per-priority-band admit
    probabilities from an AIMD level fed by arrival rate, RPC latency,
    queue depth, and tick lag (lowest bands shed first, the top band
    never while lower bands exist);
  * `policy` / `deadline` — the shed matrix (GetCapacity only — never
    ReleaseCapacity, GetServerCapacity, or Discovery), the
    RESOURCE_EXHAUSTED + ``doorman-retry-after`` trailing-metadata
    contract, and fast-fail for requests whose gRPC deadline cannot
    cover the expected admission latency.

See doc/admission.md for the controller math and the operator story.
"""

from __future__ import annotations

import random
from typing import Dict, Optional

from doorman_tpu_torch.admission.coalesce import Coalescer
from doorman_tpu_torch.admission.controller import AimdController
from doorman_tpu_torch.admission.deadline import DecisionLatency, fast_fail_reason
from doorman_tpu_torch.admission.ramp import EstablishmentRamp
from doorman_tpu_torch.admission.policy import (
    RETRY_AFTER_KEY,
    SHED_MATRIX,
    Shed,
    sheddable,
)
from doorman_tpu_torch.obs import metrics as metrics_mod

__all__ = [
    "Admission",
    "AimdController",
    "Coalescer",
    "DecisionLatency",
    "EstablishmentRamp",
    "RETRY_AFTER_KEY",
    "SHED_MATRIX",
    "Shed",
    "sheddable",
]

_OCCUPANCY_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


class Admission:
    """Facade the server wires through: one Admission per server.

    Construct with controller knobs, then `bind(server)` (done by
    CapacityServer.__init__) attaches the server's clock and builds the
    coalescer. `rng` seeds the controller's admit draws — the chaos
    runner passes its plan-seeded RNG so storms replay deterministically.
    """

    def __init__(
        self,
        *,
        coalesce_window: float = 0.0,
        controller: Optional[AimdController] = None,
        clock=None,
        rng: Optional[random.Random] = None,
        **controller_kwargs,
    ):
        self.coalesce_window = float(coalesce_window)
        self.controller = controller
        self._clock = clock
        self._rng = rng
        self._controller_kwargs = controller_kwargs
        self.latency = DecisionLatency()
        self.coalescer: Optional[Coalescer] = None
        self._server = None
        # (method, band) -> {"admitted": n, "shed": n, "fast_fail": n}.
        # Plain dict (not the prometheus counters) so the chaos
        # invariants read exact deterministic integers.
        self.tallies: Dict = {}
        # Frontend pool attribution: worker index -> the same tally
        # shape, absorbed from listener-worker heartbeats (real pool)
        # or stamped at establishment (inline pool). The gate itself
        # runs HERE either way — these never double-count into
        # `tallies`, they say which listener the traffic arrived
        # through (/debug/frontend).
        self.worker_tallies: Dict[int, Dict] = {}

        reg = metrics_mod.default_registry()
        self._requests = reg.counter(
            "doorman_admission_requests",
            "Admission decisions by method, priority band, and outcome "
            "(admitted / shed / fast_fail; pass_through for never-shed "
            "methods).",
            labels=("method", "band", "outcome"),
        )
        self._coalesced = reg.counter(
            "doorman_admission_coalesced_requests",
            "GetCapacity requests resolved in a shared coalescing "
            "window (occupancy > 1), by priority band.",
            labels=("band",),
        )
        self._occupancy = reg.histogram(
            "doorman_admission_window_occupancy",
            "Requests resolved per coalescing window.",
            buckets=_OCCUPANCY_BUCKETS,
        )
        self._decision = reg.histogram(
            "doorman_admission_decision_seconds",
            "Grouped decision-pass latency per coalescing window.",
        )
        self._level_gauge = reg.gauge(
            "doorman_admission_level",
            "Current AIMD admit level, by server.",
            labels=("server",),
        )

    # -- wiring ----------------------------------------------------------

    def bind(self, server) -> "Admission":
        self._server = server
        if self.controller is None:
            self.controller = AimdController(
                clock=self._clock or server._clock,
                rng=self._rng,
                **self._controller_kwargs,
            )
        self.coalescer = Coalescer(
            server, window=self.coalesce_window, on_window=self._on_window
        )
        return self

    def _on_window(self, occupancy: int, seconds: float) -> None:
        self.latency.observe(seconds)
        self.controller.observe_queue(float(occupancy))
        self._occupancy.observe(float(occupancy))
        self._decision.observe(seconds)

    # -- bookkeeping -----------------------------------------------------

    def _tally(self, method: str, band: int, outcome: str) -> None:
        entry = self.tallies.setdefault(
            (method, band), {"admitted": 0, "shed": 0, "fast_fail": 0}
        )
        entry[outcome] += 1
        self._requests.inc(method, str(band), outcome)

    # -- the decision ----------------------------------------------------

    def check_get_capacity(self, request, context) -> Optional[Shed]:
        """None to admit; a Shed to refuse with RESOURCE_EXHAUSTED +
        retry-after. The request's band is its most important resource
        line — a bulk refresh carrying ANY high-band resource is kept
        (shedding it would starve the high band along with the low)."""
        band = max((rr.priority for rr in request.resource), default=0)
        reason = fast_fail_reason(
            context, self.coalesce_window, self.latency
        )
        if reason is not None:
            self._tally("GetCapacity", band, "fast_fail")
            return Shed(
                reason=reason,
                retry_after=self.controller.retry_after(band),
                band=band,
                kind="deadline",
            )
        admitted, retry_after = self.controller.admit(band)
        if admitted:
            self._tally("GetCapacity", band, "admitted")
            return None
        self._tally("GetCapacity", band, "shed")
        return Shed(
            reason=(
                f"overload: band {band} shed at admit level "
                f"{self.controller.level:.3f}; retry after "
                f"{retry_after:.3f}s"
            ),
            retry_after=retry_after,
            band=band,
            kind="overload",
        )

    def check_get_capacity_band(self, band: int) -> bool:
        """One driver-side gate decision for a single-resource refresh
        of this band. Identical controller draw and tally sequence to
        `check_get_capacity` with no RPC context (so no deadline
        fast-fail — the vector population drives the server in-process
        with no per-request deadline, same as the loopback harness
        clients whose deadlines never bind)."""
        admitted, _ = self.controller.admit(band)
        self._tally(
            "GetCapacity", band, "admitted" if admitted else "shed"
        )
        return admitted

    def check_get_capacity_many(self, priorities):
        """Vectorized gate for a batch of single-resource refreshes
        (bands = priorities, in input order): one `admit_many` pass,
        bulk tallies. Returns the boolean admitted mask. Draw-order and
        tally-count identical to calling `check_get_capacity` once per
        request in the same order (the deterministic-tally contract the
        chaos invariants and the workload `_log_admission` rows read).
        """
        import numpy as np  # deferred: keep the module import-light

        prio = np.asarray(priorities, dtype=np.int64)
        admitted = self.controller.admit_many(prio)
        for outcome, mask in (("admitted", admitted), ("shed", ~admitted)):
            if not mask.any():
                continue
            bands, counts = np.unique(prio[mask], return_counts=True)
            for band, k in zip(bands.tolist(), counts.tolist()):
                entry = self.tallies.setdefault(
                    ("GetCapacity", int(band)),
                    {"admitted": 0, "shed": 0, "fast_fail": 0},
                )
                entry[outcome] += int(k)
                self._requests.inc(
                    "GetCapacity", str(int(band)), outcome, by=float(k)
                )
        return admitted

    def check_watch(self, request) -> Optional[Shed]:
        """Admission gate for WatchCapacity stream ESTABLISHMENT: the
        same AIMD band-ordered shed as a refresh (lowest bands
        extinguish first, the top band never while lower bands exist).
        No deadline fast-fail — a stream has no per-RPC deadline to
        protect. The per-band stream cap is enforced by the server's
        StreamRegistry (it owns the live counts) AFTER this gate, so a
        capped band still consumes an admit draw — establishment
        attempts are offered load like any other."""
        band = max((rr.priority for rr in request.resource), default=0)
        admitted, retry_after = self.controller.admit(band)
        if admitted:
            self._tally("WatchCapacity", band, "admitted")
            return None
        self._tally("WatchCapacity", band, "shed")
        return Shed(
            reason=(
                f"overload: stream establishment for band {band} shed "
                f"at admit level {self.controller.level:.3f}; retry "
                f"after {retry_after:.3f}s"
            ),
            retry_after=retry_after,
            band=band,
            kind="overload",
        )

    def absorb_worker_tallies(self, worker: int, tallies: Dict) -> None:
        """Merge one frontend worker's tally DELTAS (keys
        "method/band", counts since its last report) into the per-worker
        attribution table."""
        slot = self.worker_tallies.setdefault(int(worker), {})
        for key, counts in tallies.items():
            dst = slot.setdefault(
                key, {"admitted": 0, "shed": 0, "fast_fail": 0}
            )
            for outcome, n in counts.items():
                dst[outcome] = dst.get(outcome, 0) + int(n)

    def note_pass_through(self, method: str, band: int = 0) -> None:
        """Tally a never-shed method (the shed matrix's 'never' rows);
        these do not consume controller admit draws — they are load the
        controller cannot refuse, visible in the counters either way."""
        self._tally(method, band, "admitted")

    async def serve_get_capacity(self, request):
        """Resolve an ADMITTED GetCapacity through the coalescer."""
        return await self.coalescer.submit(request)

    def observe_rpc(self, seconds: float) -> None:
        self.controller.observe_rpc(seconds)
        if self._server is not None:
            self._level_gauge.set(self.controller.level, self._server.id)

    # -- introspection ---------------------------------------------------

    def status(self) -> dict:
        tallies = {
            f"{method}/{band}": dict(v)
            for (method, band), v in sorted(self.tallies.items())
        }
        return {
            "controller": self.controller.status()
            if self.controller is not None
            else None,
            "coalescer": self.coalescer.status()
            if self.coalescer is not None
            else None,
            "expected_latency_s": round(
                self.coalesce_window + self.latency.value, 6
            ),
            "tallies": tallies,
            "worker_tallies": {
                str(w): dict(v)
                for w, v in sorted(self.worker_tallies.items())
            },
        }
