"""Native (C++) host-runtime components, bound over ctypes.

The device owns the allocation solve; the runtime around it — lease
bookkeeping on every request, the row pack on every tick — is the
host-side hot path. `store.cc` implements that path as a single Engine
holding all of a server's resources; this module builds it with g++ at
first use into the package's `_build/` directory and wraps it in
`NativeLeaseStore`, a drop-in for the Python `LeaseStore`.

The port's batch server requires this engine: `native_available()` is
False only when the toolchain or the build is unavailable, and the
server then refuses to start rather than serving from another store.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Iterator, List, Tuple

import numpy as np

from doorman_tpu_torch.core.lease import Lease, ZERO_LEASE
from doorman_tpu_torch.core.store import ClientLeaseStatus, ResourceLeaseStatus

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "store.cc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_LIB = _BUILD / "_store.so"

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_load_failed = False

_F64P = ctypes.POINTER(ctypes.c_double)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _build() -> None:
    # Build into a temp file then rename: atomic under concurrent pytest
    # workers.
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        suffix=".so", dir=str(_LIB.parent), prefix="_store_build_"
    )
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
             str(_SRC), "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    lib.dm_engine_new.restype = ctypes.c_void_p
    lib.dm_engine_free.argtypes = [ctypes.c_void_p]
    lib.dm_resource.restype = ctypes.c_int32
    lib.dm_resource.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dm_client.restype = ctypes.c_int64
    lib.dm_client.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dm_assign.restype = ctypes.c_int32
    lib.dm_assign.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int32,
        ctypes.c_int64,
    ]
    lib.dm_bulk_assign.restype = ctypes.c_int64
    lib.dm_bulk_assign.argtypes = [
        ctypes.c_void_p, _I32P, _I64P, _F64P, _F64P, _F64P, _F64P, _I32P,
        _I64P, ctypes.c_int64,
    ]
    lib.dm_regrant.restype = ctypes.c_int32
    lib.dm_regrant.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                               ctypes.c_int64, ctypes.c_double]
    lib.dm_release.restype = ctypes.c_int32
    lib.dm_release.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                               ctypes.c_int64]
    lib.dm_clean.restype = ctypes.c_int64
    lib.dm_clean.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                             ctypes.c_double]
    lib.dm_sums.argtypes = [ctypes.c_void_p, ctypes.c_int32, _F64P]
    lib.dm_get.restype = ctypes.c_int32
    lib.dm_get.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                           _F64P]
    lib.dm_dump.restype = ctypes.c_int64
    lib.dm_dump.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, _I64P, _F64P, _F64P, _F64P, _F64P,
        _I32P, _I64P, ctypes.c_int64,
    ]
    lib.dm_total_leases.restype = ctypes.c_int64
    lib.dm_total_leases.argtypes = [ctypes.c_void_p]
    lib.dm_max_leases.restype = ctypes.c_int64
    lib.dm_max_leases.argtypes = [ctypes.c_void_p]
    lib.dm_pack.restype = ctypes.c_int64
    lib.dm_pack.argtypes = [
        ctypes.c_void_p, _I32P, ctypes.c_int32, _I32P, _I64P, _F64P, _F64P,
        _F64P, _I64P, ctypes.c_int64,
    ]
    lib.dm_apply.restype = ctypes.c_int64
    lib.dm_apply.argtypes = [
        ctypes.c_void_p, _I32P, ctypes.c_int32, _I32P, _I64P, _F64P,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.dm_clean_all.restype = ctypes.c_int64
    lib.dm_clean_all.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.dm_drain_dirty2.restype = ctypes.c_int64
    lib.dm_drain_dirty2.argtypes = [ctypes.c_void_p, _I32P, u8p,
                                    ctypes.c_int64]
    lib.dm_pack_rows.argtypes = [
        ctypes.c_void_p, _I32P, ctypes.c_int64, ctypes.c_int64,
        _F64P, _F64P, _F64P, u8p, _I32P, u64p,
    ]
    lib.dm_apply_dense.restype = ctypes.c_int64
    lib.dm_apply_dense.argtypes = [
        ctypes.c_void_p, _I32P, ctypes.c_int64, ctypes.c_int64,
        _F64P, u8p, u64p,
    ]
    lib.dm_band_aggregates.restype = ctypes.c_int64
    lib.dm_band_aggregates.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, _I64P, _F64P, _I64P,
        ctypes.c_int64,
    ]
    lib.dm_bulk_refresh.restype = ctypes.c_int64
    lib.dm_bulk_refresh.argtypes = [
        ctypes.c_void_p, _I32P, _I64P, _F64P, _F64P, _F64P,
        ctypes.c_int64,
    ]
    lib.dm_chunk_config.argtypes = [
        ctypes.c_void_p, _I32P, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.dm_drain_slots.restype = ctypes.c_int64
    lib.dm_drain_slots.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, _I64P, u8p, ctypes.c_int64,
    ]
    lib.dm_dirty_slot_rids.restype = ctypes.c_int64
    lib.dm_dirty_slot_rids.argtypes = [ctypes.c_void_p, _I32P,
                                       ctypes.c_int64]
    lib.dm_pack_slots.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, _I64P, ctypes.c_int64,
        _F64P, _F64P, _F64P, u8p,
    ]
    lib.dm_pack_chunks.argtypes = [
        ctypes.c_void_p, _I32P, _I32P, ctypes.c_int64, ctypes.c_int64,
        _F64P, _F64P, _F64P, u8p, _I32P, u64p,
    ]
    lib.dm_apply_chunks.restype = ctypes.c_int64
    lib.dm_apply_chunks.argtypes = [
        ctypes.c_void_p, _I32P, _I32P, ctypes.c_int64, ctypes.c_int64,
        _F64P, u8p, u64p,
    ]
    lib.dm_chunk_versions.argtypes = [
        ctypes.c_void_p, _I32P, _I32P, ctypes.c_int64, u64p,
    ]
    lib.dm_peek.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                            ctypes.c_int64, _F64P]
    lib.dm_decide.restype = ctypes.c_int32
    lib.dm_decide.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int32, ctypes.c_int64,
        _F64P,
    ]
    lib.dm_refresh_grant.restype = ctypes.c_int32
    lib.dm_refresh_grant.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int32, ctypes.c_int64,
        _F64P,
    ]


def _load() -> "ctypes.CDLL | None":
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            if (not _LIB.exists()
                    or _LIB.stat().st_mtime < _SRC.stat().st_mtime):
                _build()
            try:
                lib = ctypes.CDLL(str(_LIB))
            except OSError:
                # A stale or foreign-platform .so; rebuild once and retry.
                _build()
                lib = ctypes.CDLL(str(_LIB))
            _declare(lib)
            _lib = lib
        except Exception:
            log.exception("native store engine unavailable")
            _load_failed = True
        return _lib


def native_available() -> bool:
    return _load() is not None


class StoreEngine:
    """One engine per server: every resource's leases in native memory.

    `store(resource_id)` hands out `NativeLeaseStore` views; `pack_rows`
    packs resources as dense rows for the resident solver.
    """

    def __init__(self, clock: Callable[[], float] = time.time):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native store engine unavailable (g++ build failed?); "
                "check native_available() before constructing"
            )
        self._lib = lib
        self._ptr = ctypes.c_void_p(lib.dm_engine_new())
        self._clock = clock
        self._client_names: List[str] = []
        self._client_handles: dict[str, int] = {}

    def __del__(self):
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr and getattr(self, "_lib", None) is not None:
            self._lib.dm_engine_free(ptr)

    def client_handle(self, client_id: str) -> int:
        h = self._client_handles.get(client_id)
        if h is None:
            h = self._lib.dm_client(self._ptr, client_id.encode())
            self._client_handles[client_id] = h
            if h != len(self._client_names):
                # Cross-language invariant: the C side hands out handles
                # densely in registration order, which is what lets
                # client_name() index a plain list. Must survive python -O.
                raise RuntimeError(
                    f"native client handle {h} out of sync with name table "
                    f"size {len(self._client_names)}"
                )
            self._client_names.append(client_id)
        return h

    def client_name(self, handle: int) -> str:
        return self._client_names[handle]

    def store(self, resource_id: str) -> "NativeLeaseStore":
        rid = self._lib.dm_resource(self._ptr, resource_id.encode())
        return NativeLeaseStore(self, resource_id, rid)

    @property
    def total_leases(self) -> int:
        return self._lib.dm_total_leases(self._ptr)

    @property
    def max_leases(self) -> int:
        """Largest per-resource lease count (one O(R) C call)."""
        return self._lib.dm_max_leases(self._ptr)

    def pack(self, order: List["NativeLeaseStore"]) -> Tuple[
        np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
        np.ndarray,
    ]:
        """Resource-major edge dump following `order`: returns
        (ridx, cid, wants, has, subclients, priority) with ridx the
        position of the edge's resource in `order` — the solver's
        segment id."""
        cap = self._lib.dm_total_leases(self._ptr)
        ridx = np.empty(cap, np.int32)
        cid = np.empty(cap, np.int64)
        wants = np.empty(cap, np.float64)
        has = np.empty(cap, np.float64)
        sub = np.empty(cap, np.float64)
        prio = np.empty(cap, np.int64)
        handles = np.asarray([s._rid for s in order], np.int32)
        n = self._lib.dm_pack(
            self._ptr,
            handles.ctypes.data_as(_I32P), len(order),
            ridx.ctypes.data_as(_I32P), cid.ctypes.data_as(_I64P),
            wants.ctypes.data_as(_F64P), has.ctypes.data_as(_F64P),
            sub.ctypes.data_as(_F64P), prio.ctypes.data_as(_I64P), cap,
        )
        return ridx[:n], cid[:n], wants[:n], has[:n], sub[:n], prio[:n]

    def apply(
        self,
        order_rids: np.ndarray,  # [n_seg] engine rids; -1 skips a segment
        ridx: np.ndarray,  # [E] segment per edge
        cid: np.ndarray,  # [E]
        gets: np.ndarray,  # [E]
        keep_has: "np.ndarray | None" = None,  # [n_seg] bool
    ) -> np.ndarray:
        """Bulk grant write-back (grants ONLY — expiry/refresh are
        client-driven, see dm_apply); returns a bool mask of edges
        applied (False: client released or resource gone mid-solve).
        Segments flagged in keep_has leave has untouched (learning)."""
        order_rids = np.ascontiguousarray(order_rids, np.int32)
        ridx = np.ascontiguousarray(ridx, np.int32)
        cid = np.ascontiguousarray(cid, np.int64)
        gets = np.ascontiguousarray(gets, np.float64)
        if keep_has is None:
            keep_has = np.zeros(len(order_rids), np.uint8)
        keep_has = np.ascontiguousarray(keep_has, np.uint8)
        applied = np.zeros(len(ridx), np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        self._lib.dm_apply(
            self._ptr,
            order_rids.ctypes.data_as(_I32P), len(order_rids),
            ridx.ctypes.data_as(_I32P), cid.ctypes.data_as(_I64P),
            gets.ctypes.data_as(_F64P), len(ridx),
            keep_has.ctypes.data_as(u8p),
            applied.ctypes.data_as(u8p),
        )
        return applied.astype(bool)

    def bulk_assign(
        self,
        rids: np.ndarray,  # [n] engine resource handles per lease
        cids: np.ndarray,  # [n] client handles
        expiry: np.ndarray,  # [n] absolute expiry stamps
        refresh: np.ndarray,  # [n]
        has: np.ndarray,  # [n]
        wants: np.ndarray,  # [n]
        subclients: np.ndarray,  # [n]
        priority: "np.ndarray | None" = None,  # [n]
    ) -> int:
        """Bulk lease upsert in one C call (snapshot load / bench
        population); returns the number assigned."""
        n = len(rids)
        rids = np.ascontiguousarray(rids, np.int32)
        cids = np.ascontiguousarray(cids, np.int64)
        expiry = np.ascontiguousarray(expiry, np.float64)
        refresh = np.ascontiguousarray(refresh, np.float64)
        has = np.ascontiguousarray(has, np.float64)
        wants = np.ascontiguousarray(wants, np.float64)
        subclients = np.ascontiguousarray(subclients, np.int32)
        if priority is None:
            priority = np.zeros(n, np.int64)
        priority = np.ascontiguousarray(priority, np.int64)
        return int(
            self._lib.dm_bulk_assign(
                self._ptr,
                rids.ctypes.data_as(_I32P), cids.ctypes.data_as(_I64P),
                expiry.ctypes.data_as(_F64P), refresh.ctypes.data_as(_F64P),
                has.ctypes.data_as(_F64P), wants.ctypes.data_as(_F64P),
                subclients.ctypes.data_as(_I32P),
                priority.ctypes.data_as(_I64P), n,
            )
        )

    def bulk_refresh(
        self,
        rids: np.ndarray,  # [n] engine resource handles
        cids: np.ndarray,  # [n] client handles
        expiry: np.ndarray,  # [n]
        refresh: np.ndarray,  # [n]
        wants: np.ndarray,  # [n]
    ) -> int:
        """Bulk demand refresh preserving each lease's current
        has/subclients/priority (a client refresh's store effect);
        returns the number refreshed."""
        rids = np.ascontiguousarray(rids, np.int32)
        cids = np.ascontiguousarray(cids, np.int64)
        expiry = np.ascontiguousarray(expiry, np.float64)
        refresh = np.ascontiguousarray(refresh, np.float64)
        wants = np.ascontiguousarray(wants, np.float64)
        return int(
            self._lib.dm_bulk_refresh(
                self._ptr, rids.ctypes.data_as(_I32P),
                cids.ctypes.data_as(_I64P),
                expiry.ctypes.data_as(_F64P),
                refresh.ctypes.data_as(_F64P),
                wants.ctypes.data_as(_F64P), len(rids),
            )
        )

    def clean_all(self, now: "float | None" = None) -> int:
        """Engine-wide expiry sweep in one C call; returns removals."""
        if now is None:
            now = self._clock()
        return int(self._lib.dm_clean_all(self._ptr, now))

    def drain_dirty2(self) -> Tuple[np.ndarray, np.ndarray]:
        """Resources whose solver-visible inputs changed since the last
        drain (engine rids, int32), plus a parallel uint8 array flagging
        rows that changed beyond wants (membership / has / subclients /
        priority) — those need a full re-upload; unflagged rows changed
        only in wants and ship just the wants lane. Clears both flags."""
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rid_chunks, full_chunks = [], []
        while True:
            buf = np.empty(4096, np.int32)
            full = np.empty(4096, np.uint8)
            n = int(
                self._lib.dm_drain_dirty2(
                    self._ptr, buf.ctypes.data_as(_I32P),
                    full.ctypes.data_as(u8p), len(buf)
                )
            )
            rid_chunks.append(buf[:n])
            full_chunks.append(full[:n])
            if n < len(buf):
                break
        if len(rid_chunks) > 1:
            return np.concatenate(rid_chunks), np.concatenate(full_chunks)
        return rid_chunks[0], full_chunks[0]

    def pack_rows(self, rids: np.ndarray, K: int):
        """Dense [n, K] row pack of the given resources: returns
        (wants, has, subclients, active, counts, versions). counts may
        exceed K — the caller detects bucket overflow."""
        rids = np.ascontiguousarray(rids, np.int32)
        n = len(rids)
        wants = np.empty((n, K), np.float64)
        has = np.empty((n, K), np.float64)
        sub = np.empty((n, K), np.float64)
        act = np.empty((n, K), np.uint8)
        counts = np.empty(n, np.int32)
        versions = np.empty(n, np.uint64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        self._lib.dm_pack_rows(
            self._ptr, rids.ctypes.data_as(_I32P), n, K,
            wants.ctypes.data_as(_F64P), has.ctypes.data_as(_F64P),
            sub.ctypes.data_as(_F64P), act.ctypes.data_as(u8p),
            counts.ctypes.data_as(_I32P), versions.ctypes.data_as(u64p),
        )
        return wants, has, sub, act, counts, versions

    def apply_dense(
        self,
        rids: np.ndarray,  # [n] engine resource handles
        grants: np.ndarray,  # [n, K] in upload-time slot order
        keep_has: np.ndarray,  # [n] uint8
        expected_versions: np.ndarray,  # [n] uint64
    ) -> int:
        """Dense grant write-back (grants ONLY — expiry/refresh are
        client-driven, see dm_apply_dense); rows whose membership epoch
        moved since upload are skipped (they re-solve next tick).
        Returns the number of rows applied."""
        rids = np.ascontiguousarray(rids, np.int32)
        grants = np.ascontiguousarray(grants, np.float64)
        keep_has = np.ascontiguousarray(keep_has, np.uint8)
        expected_versions = np.ascontiguousarray(
            expected_versions, np.uint64
        )
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        return int(
            self._lib.dm_apply_dense(
                self._ptr, rids.ctypes.data_as(_I32P), len(rids),
                grants.shape[1], grants.ctypes.data_as(_F64P),
                keep_has.ctypes.data_as(u8p),
                expected_versions.ctypes.data_as(u64p),
            )
        )


    # -- wide-resource (chunked) tracking -----------------------------

    def chunk_config(self, rids: np.ndarray, W: int) -> None:
        """Install the chunk-tracked resource set (width W slots per
        device row). Clears all prior chunk state; the caller repacks
        every tracked chunk right after (rebuild)."""
        rids = np.ascontiguousarray(rids, np.int32)
        self._lib.dm_chunk_config(
            self._ptr, rids.ctypes.data_as(_I32P), len(rids), W
        )

    def dirty_slot_rids(self) -> np.ndarray:
        """Tracked rids that currently have dirty slots. The C call is a
        non-consuming COPY (unlike drain_slots), so a full buffer means
        retry bigger, not page."""
        cap = 1024
        while True:
            buf = np.empty(cap, np.int32)
            n = int(self._lib.dm_dirty_slot_rids(
                self._ptr, buf.ctypes.data_as(_I32P), cap
            ))
            if n < cap:
                return buf[:n].copy()
            cap *= 2

    def drain_slots(self, rid: int) -> Tuple[np.ndarray, np.ndarray]:
        """One tracked resource's dirty slots since the last drain:
        (slots int64, level uint8 — 1 wants-only, 2 full). Clears them."""
        u8p = ctypes.POINTER(ctypes.c_uint8)
        slot_chunks, lvl_chunks = [], []
        while True:
            slots = np.empty(65536, np.int64)
            lvl = np.empty(65536, np.uint8)
            n = int(self._lib.dm_drain_slots(
                self._ptr, rid, slots.ctypes.data_as(_I64P),
                lvl.ctypes.data_as(u8p), len(slots)
            ))
            slot_chunks.append(slots[:n])
            lvl_chunks.append(lvl[:n])
            if n < len(slots):
                break
        if len(slot_chunks) > 1:
            return np.concatenate(slot_chunks), np.concatenate(lvl_chunks)
        return slot_chunks[0], lvl_chunks[0]

    def pack_slots(self, rid: int, slots: np.ndarray):
        """Gather the given slots' (wants, has, subclients, active);
        slots beyond the lease count read as inactive zeros."""
        slots = np.ascontiguousarray(slots, np.int64)
        n = len(slots)
        wants = np.empty(n, np.float64)
        has = np.empty(n, np.float64)
        sub = np.empty(n, np.float64)
        act = np.empty(n, np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        self._lib.dm_pack_slots(
            self._ptr, rid, slots.ctypes.data_as(_I64P), n,
            wants.ctypes.data_as(_F64P), has.ctypes.data_as(_F64P),
            sub.ctypes.data_as(_F64P), act.ctypes.data_as(u8p),
        )
        return wants, has, sub, act

    def pack_chunks(self, rids: np.ndarray, chunks: np.ndarray, W: int):
        """Pack n chunks as [n, W] rows: returns (wants, has, sub,
        active, filled, versions) with versions the per-chunk membership
        epochs at pack time."""
        rids = np.ascontiguousarray(rids, np.int32)
        chunks = np.ascontiguousarray(chunks, np.int32)
        n = len(rids)
        wants = np.empty((n, W), np.float64)
        has = np.empty((n, W), np.float64)
        sub = np.empty((n, W), np.float64)
        act = np.empty((n, W), np.uint8)
        filled = np.empty(n, np.int32)
        versions = np.empty(n, np.uint64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        self._lib.dm_pack_chunks(
            self._ptr, rids.ctypes.data_as(_I32P),
            chunks.ctypes.data_as(_I32P), n, W,
            wants.ctypes.data_as(_F64P), has.ctypes.data_as(_F64P),
            sub.ctypes.data_as(_F64P), act.ctypes.data_as(u8p),
            filled.ctypes.data_as(_I32P), versions.ctypes.data_as(u64p),
        )
        return wants, has, sub, act, filled, versions

    def chunk_versions(
        self, rids: np.ndarray, chunks: np.ndarray
    ) -> np.ndarray:
        """Current membership versions of the given chunks. Read AFTER
        a slot drain and BEFORE the pack (see dm_chunk_versions for why
        that ordering keeps apply mismatches in the safe direction)."""
        rids = np.ascontiguousarray(rids, np.int32)
        chunks = np.ascontiguousarray(chunks, np.int32)
        out = np.empty(len(rids), np.uint64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        self._lib.dm_chunk_versions(
            self._ptr, rids.ctypes.data_as(_I32P),
            chunks.ctypes.data_as(_I32P), len(rids),
            out.ctypes.data_as(u64p),
        )
        return out

    def apply_chunks(
        self,
        rids: np.ndarray,  # [n]
        chunks: np.ndarray,  # [n]
        grants: np.ndarray,  # [n, W] in upload-time slot order
        keep_has: np.ndarray,  # [n] uint8
        expected_versions: np.ndarray,  # [n] uint64
    ) -> int:
        """Chunk-granular grant write-back (grants only; see
        dm_apply_chunks); chunks whose membership version moved since
        upload are skipped. Returns chunks applied."""
        rids = np.ascontiguousarray(rids, np.int32)
        chunks = np.ascontiguousarray(chunks, np.int32)
        grants = np.ascontiguousarray(grants, np.float64)
        keep_has = np.ascontiguousarray(keep_has, np.uint8)
        expected_versions = np.ascontiguousarray(
            expected_versions, np.uint64
        )
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        return int(
            self._lib.dm_apply_chunks(
                self._ptr, rids.ctypes.data_as(_I32P),
                chunks.ctypes.data_as(_I32P), len(rids),
                grants.shape[1], grants.ctypes.data_as(_F64P),
                keep_has.ctypes.data_as(u8p),
                expected_versions.ctypes.data_as(u64p),
            )
        )

class NativeLeaseStore:
    """Drop-in for core.store.LeaseStore, backed by a StoreEngine.

    Same interface and semantics (cites store.py; ultimately reference
    store.go:68-213); construct via StoreEngine.store().
    """

    def __init__(self, engine: StoreEngine, resource_id: str, rid: int):
        self.id = resource_id
        self._engine = engine
        self._lib = engine._lib
        self._ptr = engine._ptr
        self._rid = rid
        self._clock = engine._clock
        # Request-path scratch with the ctypes pointers prebuilt ONCE:
        # numpy's data_as() + ctypes.cast() cost ~5us per call — more
        # than the C call itself. ONLY the request paths (decide_fast /
        # peek / refresh_grant) may use shared scratch: they run
        # exclusively on the event loop (RPC handlers and the
        # single-threaded sim). Every other accessor allocates per
        # call, because the tick executor thread reads stores
        # concurrently with handlers (len/sums in the solvers' rebuild
        # checks, get in grant-map rebuilds) and a shared buffer would
        # tear.
        self._peek_buf = np.empty(10, np.float64)
        self._peek_ptr = self._peek_buf.ctypes.data_as(_F64P)

    def _sums(self) -> np.ndarray:
        out = np.empty(4, np.float64)
        self._lib.dm_sums(self._ptr, self._rid, out.ctypes.data_as(_F64P))
        return out

    def __len__(self) -> int:
        return int(self._sums()[3])

    @property
    def count(self) -> int:
        return int(self._sums()[2])

    @property
    def sum_has(self) -> float:
        return float(self._sums()[0])

    @property
    def sum_wants(self) -> float:
        return float(self._sums()[1])

    def get(self, client: str) -> Lease:
        # Per-call scratch: get() is also reached from the tick
        # executor (grant-map rebuilds), concurrent with handlers.
        out = np.empty(6, np.float64)
        ok = self._lib.dm_get(
            self._ptr, self._rid, self._engine.client_handle(client),
            out.ctypes.data_as(_F64P),
        )
        if not ok:
            return ZERO_LEASE
        e, r, h, w, s, p = out
        return Lease(expiry=e, refresh_interval=r, has=h, wants=w,
                     subclients=int(s), priority=int(p))

    def peek(self, client: str):
        """(found, lease, sum_has, sum_wants, count) in ONE locked C
        call — the scalar algorithms' whole read set (see
        algorithms.scalar._peek); absent clients report (False,
        ZERO_LEASE, ...) with the aggregates still filled."""
        self._lib.dm_peek(
            self._ptr, self._rid, self._engine.client_handle(client),
            self._peek_ptr,
        )
        out = self._peek_buf
        if out[0] == 0.0:
            return False, ZERO_LEASE, out[7], out[8], int(out[9])
        lease = Lease(
            expiry=out[1], refresh_interval=out[2], has=out[3],
            wants=out[4], subclients=int(out[5]), priority=int(out[6]),
        )
        return True, lease, out[7], out[8], int(out[9])

    # dm_decide's LEARN code; 0-4 are AlgoKind lane values (5 is
    # PRIORITY_BANDS, which never routes to C).
    DECIDE_LEARN = 6
    _DECIDE_KINDS = frozenset((0, 1, 2, 3, 4, 6))

    def decide_fast(
        self,
        kind: int,
        capacity: float,
        lease_length: float,
        refresh_interval: float,
        has: float,
        wants: float,
        subclients: int,
        priority: int,
        client: str,
    ):
        """The whole immediate-mode decide (sweep + algorithm + upsert)
        in one locked C call; grants are bit-identical to the scalar
        Python oracle (see dm_decide). Returns (Lease, confused,
        old_has), or None for kinds the C side does not carry (the
        caller then runs the Python algorithm)."""
        if kind not in self._DECIDE_KINDS:
            return None
        now = self._clock()
        ok = self._lib.dm_decide(
            self._ptr, self._rid, self._engine.client_handle(client),
            kind, capacity, now, lease_length, refresh_interval,
            has, wants, subclients, priority, self._peek_ptr,
        )
        if not ok:
            return None
        out = self._peek_buf
        lease = Lease(
            expiry=now + lease_length, refresh_interval=refresh_interval,
            has=float(out[0]), wants=wants, subclients=subclients,
            priority=priority,
        )
        return lease, out[1] != 0.0, float(out[2])

    def refresh_grant(
        self,
        client: str,
        lease_length: float,
        refresh_interval: float,
        wants: float,
        subclients: int,
        priority: int,
    ) -> "Lease | None":
        """Batch-mode request path in one locked C call: record new
        demand + fresh expiry, PRESERVE the granted has (the tick
        recomputes; see dm_refresh_grant). Returns the refreshed lease,
        or None when the client holds no lease (the caller then runs
        the decide path, which admits new clients)."""
        expiry = self._clock() + lease_length
        ok = self._lib.dm_refresh_grant(
            self._ptr, self._rid, self._engine.client_handle(client),
            expiry, refresh_interval, wants, subclients, priority,
            self._peek_ptr,  # event-loop-only scratch, like decide_fast
        )
        if not ok:
            return None
        return Lease(
            expiry=expiry, refresh_interval=refresh_interval,
            has=float(self._peek_buf[0]), wants=wants,
            subclients=subclients, priority=priority,
        )

    def has_client(self, client: str) -> bool:
        out = np.empty(6, np.float64)
        return bool(self._lib.dm_get(
            self._ptr, self._rid, self._engine.client_handle(client),
            out.ctypes.data_as(_F64P),
        ))

    def subclients(self, client: str) -> int:
        return self.get(client).subclients

    def assign(
        self,
        client: str,
        lease_length: float,
        refresh_interval: float,
        has: float,
        wants: float,
        subclients: int,
        priority: int = 0,
    ) -> Lease:
        expiry = self._clock() + lease_length
        self._lib.dm_assign(
            self._ptr, self._rid, self._engine.client_handle(client),
            expiry, refresh_interval, has, wants, subclients, priority,
        )
        return Lease(expiry=expiry, refresh_interval=refresh_interval,
                     has=has, wants=wants, subclients=subclients,
                     priority=priority)

    def bulk_assign(
        self,
        clients,
        lease_length: float,
        refresh_interval: float,
        has,
        wants,
        subclients=None,
        priority=None,
    ) -> None:
        """Same contract as core.store.LeaseStore.bulk_assign — an
        assign() per row in input order (dm_bulk_assign runs the same
        per-row upsert, so the running-aggregate accumulation order is
        identical) — in one C call after interning the client names."""
        handles = np.fromiter(
            (self._engine.client_handle(c) for c in clients),
            np.int64, count=len(clients),
        )
        self.bulk_assign_handles(
            handles, lease_length, refresh_interval, has, wants,
            subclients, priority,
        )

    def bulk_assign_handles(
        self,
        cid_handles,
        lease_length: float,
        refresh_interval: float,
        has,
        wants,
        subclients=None,
        priority=None,
    ) -> None:
        """bulk_assign for callers that already hold engine client
        handles (the vector population caches them per server), so a
        steady-state grouped commit is one C call with zero per-row
        Python work."""
        n = len(cid_handles)
        self._engine.bulk_assign(
            np.full(n, self._rid, np.int32),
            np.ascontiguousarray(cid_handles, np.int64),
            np.full(n, self._clock() + lease_length, np.float64),
            np.full(n, refresh_interval, np.float64),
            has,
            wants,
            np.ones(n, np.int32) if subclients is None else subclients,
            priority,
        )

    def regrant(self, client: str, has: float) -> None:
        """Update only the granted capacity of an existing lease (see
        core.store.LeaseStore.regrant); expiry/refresh stay put and the
        row is NOT dirtied — a delivery write-back is the solver's own
        output, so it must not trigger a re-upload next tick."""
        self._lib.dm_regrant(
            self._ptr, self._rid, self._engine.client_handle(client), has
        )

    def release(self, client: str) -> None:
        self._lib.dm_release(
            self._ptr, self._rid, self._engine.client_handle(client)
        )

    def clean(self) -> int:
        return self._lib.dm_clean(self._ptr, self._rid, self._clock())

    def _dump(self):
        n = len(self)
        cids = np.empty(n, np.int64)
        expiry = np.empty(n, np.float64)
        refresh = np.empty(n, np.float64)
        has = np.empty(n, np.float64)
        wants = np.empty(n, np.float64)
        sub = np.empty(n, np.int32)
        prio = np.empty(n, np.int64)
        n = self._lib.dm_dump(
            self._ptr, self._rid, cids.ctypes.data_as(_I64P),
            expiry.ctypes.data_as(_F64P), refresh.ctypes.data_as(_F64P),
            has.ctypes.data_as(_F64P), wants.ctypes.data_as(_F64P),
            sub.ctypes.data_as(_I32P), prio.ctypes.data_as(_I64P), n,
        )
        return (cids[:n], expiry[:n], refresh[:n], has[:n], wants[:n],
                sub[:n], prio[:n])

    def restore(self, client: str, lease: Lease) -> None:
        """Insert a lease verbatim (absolute expiry preserved) — the
        persistence restore path; see core.store.LeaseStore.restore.
        Bulk restores go through StoreEngine.bulk_assign instead."""
        self._lib.dm_assign(
            self._ptr, self._rid, self._engine.client_handle(client),
            lease.expiry, lease.refresh_interval, lease.has, lease.wants,
            lease.subclients, lease.priority,
        )

    def dump_rows(self) -> "list[tuple[str, float, float, float, float, int, int]]":
        """Drain API for snapshotting (see core.store.LeaseStore
        .dump_rows): one bulk C call, then name resolution through the
        engine's interning table."""
        cids, expiry, refresh, has, wants, sub, prio = self._dump()
        name = self._engine.client_name
        return [
            (name(int(cids[i])), float(expiry[i]), float(refresh[i]),
             float(has[i]), float(wants[i]), int(sub[i]), int(prio[i]))
            for i in range(len(cids))
        ]

    def items(self) -> Iterator[Tuple[str, Lease]]:
        cids, expiry, refresh, has, wants, sub, prio = self._dump()
        name = self._engine.client_name
        for i in range(len(cids)):
            yield name(int(cids[i])), Lease(
                expiry=float(expiry[i]),
                refresh_interval=float(refresh[i]),
                has=float(has[i]),
                wants=float(wants[i]),
                subclients=int(sub[i]),
                priority=int(prio[i]),
            )

    def map(self, fn: Callable[[str, Lease], None]) -> None:
        for client, lease in self.items():
            fn(client, lease)

    def band_aggregates(self) -> "list[tuple[int, float, int]]":
        """(priority, wants-sum, subclient-count) per distinct priority,
        ascending — one C call, no per-lease Python objects (the
        intermediate server's upstream pack at 1M leases must not walk
        the store on the event loop)."""
        cap = max(len(self), 1)
        prio = np.empty(cap, np.int64)
        wants = np.empty(cap, np.float64)
        num = np.empty(cap, np.int64)
        n = self._lib.dm_band_aggregates(
            self._ptr, self._rid, prio.ctypes.data_as(_I64P),
            wants.ctypes.data_as(_F64P), num.ctypes.data_as(_I64P), cap,
        )
        return [
            (int(prio[i]), float(wants[i]), int(num[i])) for i in range(n)
        ]

    def lease_status(self) -> ResourceLeaseStatus:
        sums = self._sums()
        return ResourceLeaseStatus(
            id=self.id,
            sum_has=float(sums[0]),
            sum_wants=float(sums[1]),
            leases=[
                ClientLeaseStatus(client_id=c, lease=l)
                for c, l in self.items()
            ],
        )
