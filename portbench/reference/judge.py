"""The comparison that decides `correct`: the program's grants, read back
from its store after the window, against the reference's, each number
beside its limit.

Numbers:

  grant_gap  the widest |grant - reference| of any lease, over the
             larger of its row's capacity and largest wants (the port's
             F32 parity scale: the proportional share's grant is capped
             by the free capacity, a difference of sums on the scale of
             the capacity, so a float32 tick rounds it on that scale).
  leases_off leases missing from the store, doubled, or holding other
             wants than the benchmark sent (exact: limit 0).

`grant_gap` takes any [R, K] grants, so the control is the same call with
the reference itself computed in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import vector


def _t(x, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(x)).to(device=device,
                                                       dtype=dtype)


def lane_reference(kind, capacity, wants, subclients, *, dtype=torch.float64,
                   device="cpu", block=4096):
    """[R, K] float64 reference grants, worked out in `dtype`, in blocks
    of rows: for the chained proportional share, the fixed point its
    ticks settle on with the demand held still."""
    out = np.empty(wants.shape, np.float64)
    for s in range(0, len(kind), block):
        e = min(s + block, len(kind))
        w = _t(wants[s:e], dtype, device)
        g = vector.lane_targets(
            _t(kind[s:e], torch.long, device), _t(capacity[s:e], dtype, device),
            w, _t(subclients[s:e], dtype, device), torch.ones_like(
                w, dtype=torch.bool))
        out[s:e] = g.double().cpu().numpy()
    return out


def grant_gap(grants, reference, wants, capacity) -> float:
    """Widest relative gap of the grants (see the module doc); a grant
    that is no number reads as infinite."""
    if grants.size == 0:
        return 0.0
    scale = np.maximum(capacity, np.max(wants, axis=1))
    scale = np.where(scale > 0, scale, 1.0)[:, None]
    gap = np.abs(grants - reference) / scale
    gap = np.where(np.isnan(gap), np.inf, gap)
    return float(gap.max())


def read_store(engine, stores, handle_to_lease, n_leases):
    """(wants, has, found) [n_leases] float64 / int of every lease, read
    back from the native store in one pack call."""
    _ridx, cid, wants, has, _sub, _prio = engine.pack(stores)
    lease = handle_to_lease[cid]
    w = np.full(n_leases, np.nan)
    h = np.full(n_leases, np.nan)
    found = np.zeros(n_leases, np.int64)
    np.add.at(found, lease, 1)
    w[lease] = wants
    h[lease] = has
    return w, h, found


def leases_off(found, stored_wants, sent_wants) -> int:
    """Leases missing, doubled, or holding other wants than were sent."""
    bad = (found != 1) | (stored_wants != sent_wants)
    return int(bad.sum())
