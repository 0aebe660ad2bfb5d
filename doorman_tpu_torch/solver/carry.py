"""State carried across from another solver: numpy tables -> port tensors.

`tables_from_numpy` turns a resident solver's dense tables and per-row
config columns — given as numpy arrays, e.g. the JAX package's
ResidentDenseSolver tables fetched with jax.device_get — into the port's
DenseBatch (and previous-grants table) on a given device, so two solvers
can be started from, or compared on, the very same state.
"""

from __future__ import annotations

import numpy as np
import torch

from doorman_tpu_torch.solver.dense import DenseBatch
from doorman_tpu_torch.utils.backend import resolve_device


def tables_from_numpy(
    wants: np.ndarray,  # [R, K]
    has: np.ndarray,  # [R, K]
    sub: np.ndarray,  # [R, K]
    act: np.ndarray,  # [R, K] bool
    cap: np.ndarray,  # [R]
    kind: np.ndarray,  # [R] int
    learn: np.ndarray,  # [R] bool
    statc: np.ndarray,  # [R]
    prev: "np.ndarray | None" = None,  # [R, K] previous delivered grants
    *,
    device="cuda",
    dtype: torch.dtype = torch.float64,
    prev_dtype: "torch.dtype | None" = None,
) -> "tuple[DenseBatch, torch.Tensor | None]":
    """(batch, prev) as contiguous tensors on `device`: the float tables
    and columns in `dtype`, kind as int32, the masks as bool, prev in
    `prev_dtype` (default `dtype`)."""
    dev = resolve_device(device)

    def f(a, dt=dtype):
        return torch.from_numpy(np.array(a)).to(dev, dt).contiguous()

    batch = DenseBatch(
        wants=f(wants),
        has=f(has),
        subclients=f(sub),
        active=f(np.asarray(act, bool), torch.bool),
        capacity=f(cap),
        algo_kind=f(np.asarray(kind, np.int32), torch.int32),
        learning=f(np.asarray(learn, bool), torch.bool),
        static_capacity=f(statc),
    )
    prev_t = (
        f(np.asarray(prev, np.float64), prev_dtype or dtype)
        if prev is not None else None
    )
    return batch, prev_t
