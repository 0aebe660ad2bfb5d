"""Micro-batching front-end for GetCapacity (port of
doorman_tpu/admission/coalesce.py).

Concurrent GetCapacity RPCs park their futures into a grid-aligned
window (every window is anchored to the coalescer's start, so requests
arriving together resolve together instead of each starting its own
timer) and the whole window resolves with ONE grouped decision pass.
The pass groups parked work per resource and replays each resource's
requests in arrival order, so it is BYTE-IDENTICAL to running the same
stream through the per-request handler path:

  * `_decide` for different resources touches disjoint stores — only
    the per-resource order matters, and that is preserved;
  * `safe_capacity()` reads only its own resource's store and is
    computed immediately after each decide, exactly where the
    per-request path computes it.

tests/test_torch_admission.py pins this parity (responses and stores,
Python and native engines, mixed bands and `has`-carrying refreshes),
and the responses byte-equal to the reference's.

Threading: the grouped pass leaves the event loop only when that is
safe — the native engine's mutex guards concurrent RPC writes, but the
persistence journal is documented loop-only (persist/__init__.py), so
the executor is used iff the server runs the native store WITHOUT
persistence. Python stores (and persisting servers) run the pass on the
loop: still one scheduling point for the whole window, which is the
actual win — O(windows) loop wakeups instead of O(requests).

``window <= 0`` disables parking: submit() runs a one-request batch
inline through the same grouped pass (same code path, same counters),
which keeps the chaos runner's stepped schedule synchronous.
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import time
from typing import Callable, List, Optional, Tuple

from doorman_tpu_torch.algorithms import Request
from doorman_tpu_torch.obs import trace as trace_mod
from doorman_tpu_torch.proto import doorman_pb2 as pb

log = logging.getLogger(__name__)

__all__ = ["Coalescer", "decide_grouped", "decide_grouped_arrays"]

# Wire algorithm kinds the array pass carries. PROPORTIONAL_SHARE's
# variants (topup/logutil) resolve to different lane ids in
# `Resource._decide_kind`, so they fall out of this set automatically;
# PRIORITY_BANDS / FAIR_SHARE walk the store per request and stay on
# the sequential path.
_ARRAY_KINDS = frozenset((
    int(pb.Algorithm.NO_ALGORITHM),
    int(pb.Algorithm.STATIC),
    int(pb.Algorithm.PROPORTIONAL_SHARE),
))


def decide_grouped_arrays(
    server,
    resource_id: str,
    cids,
    has,
    wants,
    priorities,
    *,
    old_has,
    old_wants,
    new_mask,
    cid_handles=None,
    expected_count=None,
):
    """Array form of `decide_grouped` for one resource's batch of
    single-resource requests in arrival order: compute every grant in a
    vectorized pass, commit them in one bulk store write, and return
    ``(grants, expiry, refresh_interval, safe, fast_rows)`` float/int
    arrays in input order — or None when this resource can't take the
    array path (unsupported algorithm lane, learning mode, persistence
    journaling per decide, or a store the caller's mirrors don't fully
    describe via ``expected_count``).

    Exactness argument (the vector population's parity pin): the
    sequential pass evolves only the store's running aggregates between
    rows — ``sum_wants``/``sum_has`` by per-row ``+= delta`` and
    ``count`` by new-client subclients. np.cumsum accumulates strictly
    left-to-right, so seeding it with the aggregate's starting value
    reproduces the identical sequence of float additions; each row's
    grant formula is then evaluated with the scalar algorithm's exact
    operation order. The one circularity — PROPORTIONAL_SHARE's free
    clamp reads ``sum_has`` which depends on earlier grants — is
    resolved by hypothesis: assume no row clamps (the steady state),
    check ``grant <= free`` elementwise, and on the first violating row
    commit only the exact prefix before it, finishing the remainder
    through the sequential `decide_grouped` (so clamped ticks are
    slower, never wrong).

    ``old_has``/``old_wants``/``new_mask`` are the caller's per-row
    mirrors of the store rows (exact, because every value they hold
    came out of this same decide path); ``expected_count`` is the
    caller's live-lease count — a mismatch with ``store.count`` means a
    foreign writer shares the store and the array pass stands down.
    Preconditions the CALLER owns: server is master, no lease in the
    store is expired (a sequential decide would sweep it), and every
    row's client already holds a lease iff ``new_mask`` says so.
    """
    import numpy as np  # deferred: the RPC path never pays the import

    res = server.get_or_create_resource(resource_id)
    if (
        res._decide_kind not in _ARRAY_KINDS
        or res.in_learning_mode
        or server._persist is not None
    ):
        return None
    store = res.store
    if expected_count is not None and store.count != expected_count:
        return None

    n = len(wants)
    w = np.ascontiguousarray(wants, np.float64)
    prio = np.ascontiguousarray(priorities, np.int64)
    old_h = np.ascontiguousarray(old_has, np.float64)
    old_w = np.ascontiguousarray(old_wants, np.float64)
    new = np.ascontiguousarray(new_mask, bool)
    cap = res.capacity
    length = res._lease_length
    interval = res._refresh_interval
    now = server._clock()

    kind = res._decide_kind
    if kind == int(pb.Algorithm.NO_ALGORITHM):
        grants = w.copy()
        fast_rows = n
    elif kind == int(pb.Algorithm.STATIC):
        # STATIC's capacity is per client, not a shared pool: no
        # cross-row state at all.
        grants = np.minimum(cap, w)
        fast_rows = n
    else:  # PROPORTIONAL_SHARE (scalar.proportional_share)
        # sum_wants as row i reads it: the starting aggregate plus the
        # earlier rows' (wants - old.wants) deltas, accumulated in the
        # same left-to-right order assign() applies them.
        sw_before = np.cumsum(
            np.concatenate(([store.sum_wants], (w - old_w)[:-1]))
        )
        all_wants = (sw_before - old_w) + w
        with np.errstate(divide="ignore", invalid="ignore"):
            # Both branches evaluate everywhere; the overload quotient
            # is garbage (and discarded) on underloaded rows.
            grants = np.where(
                all_wants < cap, w, w * (cap / all_wants)
            )
        # sum_has as row i reads it, under the no-clamp hypothesis.
        sh_before = np.cumsum(
            np.concatenate(([store.sum_has], (grants - old_h)[:-1]))
        )
        free = np.maximum(cap - (sh_before - old_h), 0.0)
        ok = grants <= free
        fast_rows = n if bool(ok.all()) else int(np.argmax(~ok))
        grants = grants[:fast_rows]

    name_of = None
    if cids is None:
        # Names are recoverable from the engine's interning table; the
        # fast path never materializes them.
        name_of = server._store_engine.client_name

    if fast_rows:
        bulk_handles = getattr(store, "bulk_assign_handles", None)
        if cid_handles is not None and bulk_handles is not None:
            bulk_handles(
                cid_handles[:fast_rows], length, interval,
                grants, w[:fast_rows], priority=prio[:fast_rows],
            )
        else:
            names = (
                cids[:fast_rows] if cids is not None
                else [name_of(int(h)) for h in cid_handles[:fast_rows]]
            )
            store.bulk_assign(
                names, length, interval, grants, w[:fast_rows],
                priority=prio[:fast_rows],
            )

    out_grants = np.empty(n, np.float64)
    out_expiry = np.empty(n, np.float64)
    out_safe = np.empty(n, np.float64)
    out_refresh = np.full(n, interval, np.float64)
    out_grants[:fast_rows] = grants
    out_expiry[:fast_rows] = now + length

    # safe_capacity immediately after each row's assign (where the
    # per-request path computes it): configured value, or capacity over
    # the subclient count — which moves only when a NEW client lands.
    if res.template.HasField("safe_capacity"):
        out_safe[:] = res.template.safe_capacity
    else:
        count_after = store.count  # already includes every bulk row
        if fast_rows:
            # Rewind to the count each row observed: start minus the
            # rows after it.
            new_cum = np.cumsum(new[:fast_rows].astype(np.int64))
            start = count_after - (
                int(new_cum[-1]) if fast_rows else 0
            )
            counts = np.maximum(start + new_cum, 1)
            out_safe[:fast_rows] = res.template.capacity / counts

    if fast_rows < n:
        work = []
        for i in range(fast_rows, n):
            name = (
                cids[i] if cids is not None
                else name_of(int(cid_handles[i]))
            )
            work.append((resource_id, Request(
                name, float(has[i]), float(w[i]), 1,
                priority=int(prio[i]),
            )))
        for j, (lease, _res, safe) in enumerate(
            decide_grouped(server, work)
        ):
            i = fast_rows + j
            out_grants[i] = lease.has
            out_expiry[i] = lease.expiry
            out_refresh[i] = lease.refresh_interval
            out_safe[i] = safe

    return out_grants, out_expiry, out_refresh, out_safe, fast_rows


def decide_grouped(server, work: List[Tuple[str, Request]]) -> List[tuple]:
    """The grouped per-resource decision pass, shared by the coalescer's
    window resolution and the stream fanout's per-shard tick-edge pass.

    `work` is (resource_id, Request) pairs; returns
    `(lease, resource, safe_capacity)` per pair IN INPUT ORDER, decided
    grouped by resource with each resource's requests replayed in
    arrival order — byte-identical to running the same stream through
    the per-request path (see the module docstring's parity argument:
    different resources touch disjoint stores, and safe_capacity is
    computed immediately after each decide, exactly where the
    per-request path computes it)."""
    slots: List[tuple] = [None] * len(work)  # type: ignore[list-item]
    groups: dict = {}
    for i, (resource_id, request) in enumerate(work):
        groups.setdefault(resource_id, []).append((i, request))
    for resource_id, entries in groups.items():
        for i, request in entries:
            lease, res = server._decide(resource_id, request)
            slots[i] = (lease, res, res.safe_capacity())
    return slots


class Coalescer:
    def __init__(
        self,
        server,
        *,
        window: float,
        on_window: Optional[Callable[[int, float], None]] = None,
    ):
        """`server` is the owning CapacityServer; `on_window(occupancy,
        seconds)` fires after each resolved window (metrics hook)."""
        self.server = server
        self.window = float(window)
        self._on_window = on_window
        self._pending: List[Tuple[pb.GetCapacityRequest, asyncio.Future]] = []
        self._flush_handle = None
        # Wall clock by design (all marks in this class): the window grid
        # paces a real event loop. Chaos keeps determinism by running
        # window <= 0 (inline submit), so this timing never fires there.
        self._anchor = time.monotonic()  # doorman: allow[seeded-determinism]
        self.flushes = 0
        self.coalesced_requests = 0  # requests that shared a window
        self.max_occupancy = 0

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    async def submit(
        self, request: pb.GetCapacityRequest
    ) -> pb.GetCapacityResponse:
        if self.window <= 0:
            return (await self._resolve([(request, None)]))[0]
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((request, fut))
        if self._flush_handle is None:
            # Grid alignment: fire at the next window boundary since
            # the anchor, not `window` after THIS arrival — late
            # arrivals in a window ride the same flush.
            elapsed = time.monotonic() - self._anchor  # doorman: allow[seeded-determinism]
            delay = self.window - (elapsed % self.window)
            self._flush_handle = loop.call_later(delay, self._flush)
        return await fut

    def _flush(self) -> None:
        self._flush_handle = None
        batch, self._pending = self._pending, []
        if batch:
            asyncio.ensure_future(self._resolve_parked(batch))

    async def _resolve_parked(self, batch) -> None:
        try:
            outs = await self._resolve(batch)
        except Exception as e:
            log.exception("coalesced decision pass failed")
            for _, fut in batch:
                if fut is not None and not fut.done():
                    fut.set_exception(e)
            return
        for (_, fut), out in zip(batch, outs):
            if fut is not None and not fut.done():
                fut.set_result(out)

    async def _resolve(self, batch) -> List[pb.GetCapacityResponse]:
        server = self.server
        start = time.monotonic()  # doorman: allow[seeded-determinism]
        n = len(batch)
        with trace_mod.default_tracer().span(
            "admission.window", cat="admission",
            args={
                "server": server.id, "occupancy": n,
                "resources": len(
                    {rr.resource_id for req, _ in batch
                     for rr in req.resource}
                ),
            },
        ):
            if not server.is_master:
                # A flip while parked: every parked request gets the
                # redirect it would have gotten from the handler.
                outs = []
                for _ in batch:
                    out = pb.GetCapacityResponse()
                    out.mastership.CopyFrom(server._mastership())
                    outs.append(out)
            else:
                # Resources are created ON the loop before any executor
                # hop, so the grouped pass never races get-or-create
                # against other handlers.
                for req, _ in batch:
                    for rr in req.resource:
                        server.get_or_create_resource(rr.resource_id)
                if server._native_store and server._persist is None:
                    ctx = contextvars.copy_context()
                    outs = await asyncio.get_running_loop().run_in_executor(
                        None, ctx.run, self._decide_batch, batch
                    )
                else:
                    outs = self._decide_batch(batch)
        seconds = time.monotonic() - start  # doorman: allow[seeded-determinism]
        self.flushes += 1
        self.max_occupancy = max(self.max_occupancy, n)
        if n > 1:
            self.coalesced_requests += n
        if self._on_window is not None:
            self._on_window(n, seconds)
        return outs

    def _decide_batch(self, batch) -> List[pb.GetCapacityResponse]:
        """The grouped decision pass (see module docstring for the
        parity argument). May run on the loop or in the executor."""
        server = self.server
        work: List[Tuple[str, Request]] = []
        for req, _ in batch:
            for rr in req.resource:
                has = rr.has.capacity if rr.HasField("has") else 0.0
                work.append((
                    rr.resource_id,
                    Request(req.client_id, has, rr.wants, 1,
                            priority=rr.priority),
                ))
        try:
            decided = decide_grouped(server, work)
        except BaseException:
            # A partially-applied window leaves the fused staging cache
            # unable to prove freshness for rows already written (their
            # dirty flags would be consumed against a pre-write pack);
            # drop the whole cache — the clean fallback is the
            # round-trip pack.
            server._fused_invalidate()
            raise
        # Admission-fused staging: the grouped writes just landed, so
        # pack the touched rows NOW — in this RPC window, overlapped
        # with whatever tick is in flight — instead of at the next
        # tick's dispatch (no-op unless the server attached staging).
        server._fused_stage({resource_id for resource_id, _ in work})
        outs = []
        cursor = 0
        for req, _ in batch:
            out = pb.GetCapacityResponse()
            for rr in req.resource:
                lease, _res, safe = decided[cursor]
                cursor += 1
                resp = out.response.add()
                resp.resource_id = rr.resource_id
                resp.gets.expiry_time = int(lease.expiry)
                resp.gets.refresh_interval = int(lease.refresh_interval)
                resp.gets.capacity = lease.has
                resp.safe_capacity = safe
            outs.append(out)
        return outs

    def status(self) -> dict:
        return {
            "window_s": self.window,
            "queue_depth": self.queue_depth,
            "flushes": self.flushes,
            "coalesced_requests": self.coalesced_requests,
            "max_occupancy": self.max_occupancy,
        }
