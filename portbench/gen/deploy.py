"""A deployment: its resource ids, the server's config document and the
population of leases, as a layout (portbench/layouts/<layout>.py,
named by the configuration's `layout`) builds it from the seed.

`populate` is a frozen copy of chip_smoke.py's `_populate` (commit
37ca06e), read from the deployment instead of module constants; it is
the one call here into the port (the native store's `client_handle` and
`bulk_assign`).
"""

from __future__ import annotations

import importlib
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Deployment:
    """Every lease of one deployment, resource-major: resource r holds
    clients `c{r}.{c}` for c < clients."""

    ids: List[str]
    capacity: np.ndarray  # [R] float64, the matched template's
    kind: np.ndarray  # [R] AlgoKind wire values (doorman.proto)
    clients: int
    wants: np.ndarray  # [R, clients] float64, the population's demand
    subclients: np.ndarray  # [R, clients] int32
    priority: np.ndarray  # [R, clients] int64 wire priorities
    document: str  # the config the server loads (YAML; here JSON)
    lease_length: float
    refresh_interval: float

    @property
    def n(self) -> int:
        return len(self.ids)


def layout(cfg: dict):
    """The module of the configuration's layout (layouts/<layout>.py):
    `build(cfg, mix, seed) -> Deployment`, `check(cell, dep, sent,
    grants) -> (numbers, control numbers)`, `work(dep, wants) -> (bytes,
    operations)` of one tick's K1 solve."""
    return importlib.import_module(f"portbench.layouts.{cfg['layout']}")


def populate(server, dep: Deployment, now: Optional[float] = None):
    """chip_smoke `_populate`: every lease through the engine's bulk
    upsert (the snapshot-load path), has 0. Returns the engine resource
    handles [R] and client handles [R, clients]."""
    res = [server.get_or_create_resource(r) for r in dep.ids]
    engine = server._store_engine
    C = dep.clients
    rid = np.asarray([r.store._rid for r in res], np.int32)
    cids = np.fromiter(
        (engine.client_handle(f"c{i}.{c}")
         for i in range(dep.n) for c in range(C)),
        np.int64, count=dep.n * C,
    )
    n = dep.n * C
    now = time.time() if now is None else now
    engine.bulk_assign(
        np.repeat(rid, C), cids, np.full(n, now + dep.lease_length),
        np.full(n, dep.refresh_interval), np.zeros(n), dep.wants.ravel(),
        dep.subclients.ravel(), dep.priority.ravel(),
    )
    return res, rid, cids.reshape(dep.n, C)
