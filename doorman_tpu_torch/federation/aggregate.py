"""The federated intermediate: subtree aggregation as a device tick
(port of doorman_tpu/federation/aggregate.py).

An intermediate server's upstream beat is an aggregation: sum every
(child, resource) want into per-band per-resource totals, send ONE
GetServerCapacity per owning root shard, and redistribute the granted
lease downstream (the local solve does the redistribution — parent
grants re-template local capacity exactly as in the single-root tree).
The summation runs as a device-backed tick on the engine seam:

`AggregationTickAdapter` keeps the (child x resource) wants/weights
tables resident on a torch device and follows the tick-engine
dispatch/collect surface (solver/engine.py: the same phase vocabulary,
the same PhaseRecorder streams) — dispatch scatters the dirty rows in
place (`index_copy_`) and enqueues the band-masked summation
("aggregate" in PHASES: a [B, R, K] band mask, one masked sum over K),
collect lands the two [B, R] totals with one device->host copy.
`FederatedIntermediate` is a CapacityServer whose updater fans the
resulting per-resource aggregates out to the per-shard masters resolved
through ShardDiscovery.

The summation is torch ops on the device, as the reference's is jnp
outside any Pallas kernel. On a CUDA device it runs on the card or
raises; `device="cpu"` runs the same ops on the host.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from doorman_tpu_torch.client.connection import Connection
from doorman_tpu_torch.obs import trace as trace_mod
from doorman_tpu_torch.obs.phases import PhaseRecorder
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.server import config as config_mod
from doorman_tpu_torch.server.server import (
    DEFAULT_PRIORITY,
    CapacityServer,
    default_resource_template,
)
from doorman_tpu_torch.solver.engine import PHASES, ceil_to, place
from doorman_tpu_torch.utils import dispatch as dispatch_mod
from doorman_tpu_torch.utils.backend import resolve_device
from doorman_tpu_torch.utils.backoff import (
    MAX_BACKOFF,
    MIN_BACKOFF,
    VERY_LONG_TIME,
    backoff,
)

log = logging.getLogger(__name__)

# Child-slot padding granularity (multiple-of, not power-of-two: the
# host<->device link prices bytes — solver/engine.ceil_to's argument).
SLOT_PAD = 64
ROW_PAD = 16


@dataclass
class AggHandle:
    """One in-flight aggregation tick."""

    out: object  # device [2, B, R]: wants-sums and weight-sums
    bands: Tuple[int, ...]
    row_ids: Tuple[str, ...]
    n_real: int
    dispatched_at: float = 0.0
    collected: bool = False


def band_sums(
    wants: torch.Tensor,
    weights: torch.Tensor,
    bands: torch.Tensor,
    band_vals: torch.Tensor,
) -> torch.Tensor:
    """[2, B, R]: per band value, the sums over K of the wants and the
    weights of the slots in that band. Padding slots carry band -1 and
    no band value is negative, so they fall out of every mask; padded
    rows sum to 0. B is tiny (wire priorities in use), so the [B, R, K]
    mask is materialised and reduced in one pass per table."""
    mask = bands.unsqueeze(0) == band_vals.view(-1, 1, 1)
    zero = torch.zeros((), dtype=wants.dtype, device=wants.device)
    wants_sum = torch.where(mask, wants.unsqueeze(0), zero).sum(dim=2)
    weight_sum = torch.where(mask, weights.unsqueeze(0), zero).sum(dim=2)
    return torch.stack((wants_sum, weight_sum))


class AggregationTickAdapter:
    """(child x resource) wants table + band-masked device summation
    behind the tick-engine dispatch/collect surface."""

    component = "federation"

    def __init__(
        self,
        *,
        dtype=np.float64,
        device="cuda",
        clock: Callable[[], float] = time.time,
    ):
        self._dtype = np.dtype(dtype)
        self._device = resolve_device(device)
        self._clock = clock
        self.ticks = 0
        self.idle_ticks = 0
        self.last_tick_seconds = 0.0
        self.phase_s: Dict[str, float] = {name: 0.0 for name in PHASES}
        # Host mirrors; device tables rebuilt when the (rows, slots,
        # bands) layout moves, scattered into when only values do.
        self._rows: Dict[str, int] = {}  # resource id -> row index
        self._row_ids: List[str] = []
        self._wants_h: Optional[np.ndarray] = None  # [R_pad, K_pad]
        self._weights_h: Optional[np.ndarray] = None
        self._bands_h: Optional[np.ndarray] = None  # int32 band per slot
        self._wants_d: Optional[torch.Tensor] = None
        self._weights_d: Optional[torch.Tensor] = None
        self._bands_d: Optional[torch.Tensor] = None
        self._band_vals: Tuple[int, ...] = ()
        self._band_vals_d: Optional[torch.Tensor] = None
        self._dirty: set = set()
        self._layout_dirty = True
        # Rows staged while the layout is dirty (written at the rebuild).
        self._staged: Dict[str, tuple] = {}

    @property
    def device(self) -> torch.device:
        return self._device

    # -- staging -------------------------------------------------------

    def update(
        self,
        resource_id: str,
        wants: Sequence[float],
        weights: Sequence[float],
        bands: Sequence[int],
    ) -> None:
        """Stage one resource's current child rows (from the store's
        bulk drain); the row uploads on the next dispatch. Rows wider
        than the current slot pad trigger a layout rebuild."""
        wants = np.asarray(wants, self._dtype)
        weights = np.asarray(weights, self._dtype)
        bands = np.asarray(bands, np.int32)
        row = self._rows.get(resource_id)
        if row is None:
            row = len(self._row_ids)
            self._rows[resource_id] = row
            self._row_ids.append(resource_id)
            self._layout_dirty = True
        k_pad = 0 if self._wants_h is None else self._wants_h.shape[1]
        if len(wants) > k_pad:
            self._layout_dirty = True
        new_bands = set(int(b) for b in np.unique(bands)) - set(
            self._band_vals
        )
        if new_bands:
            self._band_vals = tuple(
                sorted(set(self._band_vals) | new_bands)
            )
            self._layout_dirty = True
        if self._layout_dirty:
            self._staged[resource_id] = (wants, weights, bands)
            return
        self._write_row(row, wants, weights, bands)
        self._dirty.add(row)

    def _write_row(self, row, wants, weights, bands) -> None:
        k = len(wants)
        self._wants_h[row, :] = 0.0
        self._weights_h[row, :] = 0.0
        self._bands_h[row, :] = -1
        self._wants_h[row, :k] = wants
        self._weights_h[row, :k] = weights
        self._bands_h[row, :k] = bands

    def _rebuild(self, ph: PhaseRecorder) -> None:
        widths = [len(w) for (w, _s, _b) in self._staged.values()]
        if self._wants_h is not None:
            widths.append(self._wants_h.shape[1])
        k_pad = ceil_to(max(widths, default=1), SLOT_PAD)
        r_pad = ceil_to(max(len(self._row_ids), 1), ROW_PAD)
        old_wants, old_weights, old_bands = (
            self._wants_h, self._weights_h, self._bands_h,
        )
        self._wants_h = np.zeros((r_pad, k_pad), self._dtype)
        self._weights_h = np.zeros((r_pad, k_pad), self._dtype)
        self._bands_h = np.full((r_pad, k_pad), -1, np.int32)
        if old_wants is not None:
            r, k = old_wants.shape
            self._wants_h[:r, :k] = old_wants
            self._weights_h[:r, :k] = old_weights
            self._bands_h[:r, :k] = old_bands
        for rid, (wants, weights, bands) in self._staged.items():
            self._write_row(self._rows[rid], wants, weights, bands)
        self._staged = {}
        # Whole-table upload: rebuilds are rare (layout growth only).
        self._wants_d = place(self._wants_h, self._device)
        self._weights_d = place(self._weights_h, self._device)
        self._bands_d = place(self._bands_h, self._device)
        self._band_vals_d = place(
            np.asarray(self._band_vals, np.int32), self._device
        )
        self._dirty.clear()
        self._layout_dirty = False
        ph.lap("rebuild")

    # -- the tick surface ----------------------------------------------

    def dispatch(self, *_args, **_kwargs) -> AggHandle:
        now = self._clock()
        ph = PhaseRecorder(self.component, self.phase_s)
        if self._layout_dirty:
            self._rebuild(ph)
        dirty = sorted(self._dirty)
        self._dirty.clear()
        ph.lap("drain")
        if self._wants_h is None:
            self.idle_ticks += 1
            return AggHandle(
                out=None, bands=(), row_ids=(), n_real=0,
                dispatched_at=now,
            )
        if not dirty:
            # No movement: scatter a shaped no-op (row 0 rewrites its
            # own values).
            dirty = [0]
        idx = np.asarray(dirty, np.int64)
        # Pad the dirty batch to a multiple of ROW_PAD, as the
        # reference does to bound its jit cache; the pad repeats the
        # last row, and a duplicate-index copy of identical values is
        # idempotent.
        pad_n = ceil_to(len(idx), ROW_PAD)
        if pad_n != len(idx):
            idx = np.concatenate(
                [idx, np.full(pad_n - len(idx), idx[-1], np.int64)]
            )
        w_rows = self._wants_h[idx]
        s_rows = self._weights_h[idx]
        b_rows = self._bands_h[idx]
        ph.lap("pack")
        idx_d = place(idx, self._device)
        w_d = place(w_rows, self._device)
        s_d = place(s_rows, self._device)
        b_d = place(b_rows, self._device)
        ph.lap("upload")
        self._wants_d.index_copy_(0, idx_d, w_d)
        self._weights_d.index_copy_(0, idx_d, s_d)
        self._bands_d.index_copy_(0, idx_d, b_d)
        out = band_sums(
            self._wants_d, self._weights_d, self._bands_d, self._band_vals_d
        )
        dispatch_mod.count_dispatch()  # the scatters + the masked sums
        ph.lap("aggregate")
        return AggHandle(
            out=out,
            bands=self._band_vals,
            row_ids=tuple(self._row_ids),
            n_real=len(self._row_ids),
            dispatched_at=now,
        )

    def collect(
        self, handle: AggHandle
    ) -> Dict[str, List[Tuple[int, float, int]]]:
        """Land one tick's [band, resource] totals as
        {resource_id: [(priority, wants, num_clients), ...]} — the
        store.band_aggregates contract, computed on the device."""
        if handle.collected:
            return {}
        handle.collected = True
        if handle.out is None:
            self.ticks += 1
            self.last_tick_seconds = self._clock() - handle.dispatched_at
            return {}
        ph = PhaseRecorder(self.component, self.phase_s)
        dispatch_mod.count_host_sync()
        sums = handle.out.cpu().numpy().astype(np.float64)
        wants_sum, weight_sum = sums[0], sums[1]
        ph.lap("download")
        out: Dict[str, List[Tuple[int, float, int]]] = {}
        nonzero = np.nonzero(wants_sum[:, : handle.n_real])
        for b, r in zip(*nonzero):
            out.setdefault(handle.row_ids[r], []).append(
                (
                    int(handle.bands[b]),
                    float(wants_sum[b, r]),
                    int(round(weight_sum[b, r])),
                )
            )
        for bands in out.values():
            bands.sort()
        ph.lap("apply")
        self.ticks += 1
        self.last_tick_seconds = self._clock() - handle.dispatched_at
        return out

    def step(self, *_args, **_kwargs):
        return self.collect(self.dispatch())


class FederatedIntermediate(CapacityServer):
    """An intermediate whose parent is a FEDERATION: upstream demand is
    aggregated on the device and fanned out per owning root shard, with
    per-shard masters resolved through the discovery cache. Local
    serving (clients, downstream servers, streams) is the ordinary
    CapacityServer. The aggregation runs on `agg_device`, by default the
    server's own device. Shards are dialed without TLS, as the port's
    single-parent updater dials its parent."""

    def __init__(
        self,
        server_id: str,
        election,
        *,
        router,
        discovery,
        agg_dtype=np.float64,
        agg_device=None,
        **kwargs,
    ):
        # Any truthy parent_addr arms the intermediate role (default
        # template + updater loop); the federated updater never dials
        # it — every upstream hop goes through the router + discovery.
        super().__init__(
            server_id, election, parent_addr="federated:", **kwargs
        )
        self.router = router
        self.discovery = discovery
        self._agg = AggregationTickAdapter(
            dtype=agg_dtype,
            device=self.device if agg_device is None else agg_device,
            clock=self._clock,
        )
        self._shard_conns: Dict[int, Connection] = {}

    @property
    def aggregator(self) -> AggregationTickAdapter:
        return self._agg

    async def _shard_connection(self, shard: int) -> Connection:
        conn = self._shard_conns.get(shard)
        if conn is None:
            addr = await self.discovery.master(shard)
            conn = Connection(
                addr,
                minimum_refresh_interval=self.minimum_refresh_interval,
                max_retries=0,
            )
            conn.on_redirect = (
                lambda addr, s=shard: self.discovery.note_master(s, addr)
            )
            self._shard_conns[shard] = conn
        return conn

    async def stop(self) -> None:
        for conn in self._shard_conns.values():
            try:
                await conn.close()
            except Exception:
                pass
        self._shard_conns.clear()
        await super().stop()

    def _aggregate_demand(self) -> Dict[str, list]:
        """One device aggregation tick over every local resource with
        demand: stage each store's bulk-drained rows and land the
        per-band totals. The summation is the device's; Python only
        assembles the staged rows (one bulk dump_rows per store — a C
        call on the native engine)."""
        with trace_mod.default_tracer().span(
            "federation.aggregate", cat="federation",
            args={"server": self.id, "resources": len(self.resources)},
        ):
            for rid, res in self.resources.items():
                if res.store.sum_wants <= 0:
                    continue
                res.store.clean()
                rows = res.store.dump_rows()
                self._agg.update(
                    rid,
                    [r[4] for r in rows],  # wants
                    [max(float(r[5]), 1.0) for r in rows],  # subclients
                    [r[6] for r in rows],  # priority
                )
            return self._agg.step()

    def _build_shard_requests(
        self,
    ) -> Dict[int, pb.GetServerCapacityRequest]:
        """Per-shard upstream requests from the device-landed
        aggregates (the federated analog of
        _build_server_capacity_request)."""
        aggregates = self._aggregate_demand()
        requests: Dict[int, pb.GetServerCapacityRequest] = {}

        def request_for(shard: int) -> pb.GetServerCapacityRequest:
            req = requests.get(shard)
            if req is None:
                req = pb.GetServerCapacityRequest(server_id=self.id)
                requests[shard] = req
            return req

        for resource_id, bands in sorted(aggregates.items()):
            res = self.resources.get(resource_id)
            if res is None:
                continue
            req = request_for(self.router.shard_of(resource_id))
            rr = req.resource.add()
            rr.resource_id = resource_id
            if res.parent_expiry is not None and res.capacity > 0:
                rr.has.capacity = res.capacity
                rr.has.expiry_time = int(res.parent_expiry)
            for priority, wants, num_clients in bands:
                if wants <= 0:
                    continue
                band = rr.wants.add()
                band.priority = priority
                band.num_clients = max(int(num_clients), 1)
                band.wants = wants
        if not requests:
            # Probe request to the home tier so at least one link stays
            # warm (the single-parent probe, shard-routed).
            req = request_for(0)
            rr = req.resource.add()
            rr.resource_id = "*"
            band = rr.wants.add()
            band.priority = DEFAULT_PRIORITY
            band.num_clients = 1
            band.wants = 0.0
        return requests

    async def _perform_parent_requests(self, retry_number: int):
        """One federated upstream exchange: fan the per-shard requests
        out, merge every shard's grants into one template load. A shard
        that fails keeps its resources on their previous (expiring)
        parent lease — the blast radius of one root shard is its own
        resources, never the subtree."""
        requests = self._build_shard_requests()
        responses = []
        failures = 0
        for shard in sorted(requests):
            request = requests[shard]
            try:
                conn = await self._shard_connection(shard)
                with trace_mod.default_tracer().span(
                    "server.parent_refresh", cat="server",
                    args={"server": self.id, "shard": shard},
                ):
                    out = await conn.execute(
                        lambda stub, req=request: stub.GetServerCapacity(
                            req, metadata=trace_mod.grpc_metadata()
                        )
                    )
                responses.append(out)
                self.fed_stats["upstream_rpcs"] += 1
            except Exception:
                failures += 1
                log.exception(
                    "%s: GetServerCapacity to shard %d failed",
                    self.id, shard,
                )
                # Next exchange re-resolves this shard's master.
                self.discovery.invalidate(shard)
                self._shard_conns.pop(shard, None)
        if failures and not responses:
            return (
                backoff(MIN_BACKOFF, MAX_BACKOFF, retry_number),
                retry_number + 1,
            )

        interval = VERY_LONG_TIME
        templates: List[pb.ResourceTemplate] = []
        expiry_times: Dict[str, float] = {}
        for out in responses:
            for presponse in out.response:
                if presponse.resource_id not in self.resources:
                    if presponse.resource_id != "*":
                        log.error(
                            "%s: response for unknown resource %r",
                            self.id, presponse.resource_id,
                        )
                    continue
                expiry_times[presponse.resource_id] = float(
                    presponse.gets.expiry_time
                )
                tpl = pb.ResourceTemplate(
                    identifier_glob=presponse.resource_id,
                    capacity=presponse.gets.capacity,
                    safe_capacity=presponse.safe_capacity,
                )
                tpl.algorithm.CopyFrom(presponse.algorithm)
                templates.append(tpl)
                interval = min(
                    interval, float(presponse.gets.refresh_interval)
                )
        templates.append(default_resource_template())
        try:
            await self.load_config(
                pb.ResourceRepository(resources=templates), expiry_times
            )
        except config_mod.ConfigError:
            log.exception(
                "%s: loading shard-derived config failed", self.id
            )
            return (
                backoff(MIN_BACKOFF, MAX_BACKOFF, retry_number),
                retry_number + 1,
            )
        if (
            interval < self.minimum_refresh_interval
            or interval == VERY_LONG_TIME
        ):
            interval = self.minimum_refresh_interval
        return interval, (retry_number + 1 if failures else 0)
