"""The benchmark's reference: the grants a correct master holds, worked
out row by row from the demand the benchmark generated, in plain
PyTorch over whole [R, K] tables.

Each function is the vectorised form of one frozen oracle in
reference/oracles.py (the tests hold them to each other). `dtype` sets
the precision of every step: float64 is the reference, and a lower one
(bfloat16) is the control that the comparison has to catch. Nothing here
imports the port.

Proportional share chains each tick's grants on the last tick's; with
the demand held still it settles, in two ticks, on one fixed point,
which `lane_targets` returns for its rows: the proportional share of the
demand.
"""

from __future__ import annotations

import torch

NONE, STATIC, PROP, FAIR = 0, 1, 2, 3


def _tiny(dtype):
    return torch.finfo(dtype).tiny


def waterfill_exact(cap, wants, weights, active):
    """Weighted max-min grants at the exact water level (oracles
    `waterfill_level` / `fair_share_waterfill`) for every row: rows whose
    demand fits get their wants."""
    dt = wants.dtype
    inf = torch.tensor(float("inf"), dtype=dt, device=wants.device)
    w = torch.where(active, wants, 0)
    s = torch.where(active, weights, 0)
    tiny = torch.tensor(1e-300 if dt == torch.float64 else _tiny(dt),
                        dtype=dt, device=wants.device)
    ratio = torch.where(active & (s > 0), w / torch.maximum(s, tiny), inf)
    ratio = torch.where(active & (s <= 0) & (w > 0), inf, ratio)
    order = torch.argsort(ratio, dim=1, stable=True)
    r = torch.gather(ratio, 1, order)
    ws = torch.gather(w, 1, order)
    ss = torch.gather(s, 1, order)
    zero = torch.zeros_like(ws[:, :1])
    cw = torch.cumsum(torch.cat([zero, ws[:, :-1]], 1), 1)
    cs = torch.cumsum(torch.cat([zero, ss[:, :-1]], 1), 1)
    total_w = ss.sum(1, keepdim=True)
    rem = cap[:, None] - cw
    remw = total_w - cs
    level = rem / torch.where(remw > 0, remw, 1)
    stop_weight = remw <= 0
    stop_level = (remw > 0) & (level <= r)
    stop = stop_weight | stop_level
    # Largest finite ratio among the clients saturated before k.
    finite = torch.where(torch.isfinite(r), r, 0)
    last = torch.cat([zero, torch.cummax(finite, 1).values[:, :-1]], 1)
    K = w.shape[1]
    idx = torch.where(stop.any(1), stop.int().argmax(1),
                      torch.full_like(stop[:, 0], K, dtype=torch.long))
    idx_c = idx.clamp(max=K - 1)[:, None]
    at_level = torch.gather(level, 1, idx_c)[:, 0]
    at_last = torch.gather(last, 1, idx_c)[:, 0]
    at_weight = torch.gather(stop_weight.int(), 1, idx_c)[:, 0].bool()
    lvl = torch.where(at_weight, at_last, at_level)
    # No stop inside the row: the remainder over the remaining weight.
    end_rem = cap - ws.sum(1)
    end_w = total_w[:, 0] - ss.sum(1)
    end_last = torch.where(torch.isfinite(r), r, 0).max(1).values
    end_lvl = torch.where(end_w > 0, end_rem / torch.where(end_w > 0, end_w, 1),
                          end_last)
    lvl = torch.where(idx >= K, end_lvl, lvl)
    fits = w.sum(1) <= cap
    gets = torch.minimum(w, lvl[:, None] * s)
    return torch.where(fits[:, None], w, torch.where(active, gets, 0))


def lane_targets(kind, capacity, wants, subclients, active):
    """[R, K] grants of rows of the upstream wire kinds: for NO_ALGORITHM,
    STATIC and FAIR_SHARE the tick's own result (a function of the
    demand alone); for PROPORTIONAL_SHARE the fixed point its chained
    ticks settle on. Rows of other kinds come back 0."""
    dt = wants.dtype
    w = torch.where(active, wants, 0)
    sub = torch.where(active, subclients, 0)
    cap = capacity
    W = w.sum(1)
    out = torch.zeros_like(w)

    def put(mask, value):
        nonlocal out
        out = torch.where(mask[:, None], value, out)

    put(kind == NONE, w)
    put(kind == STATIC, torch.minimum(cap[:, None], w))
    prop = torch.where((W < cap)[:, None], w, w * (cap / W.clamp_min(
        _tiny(dt)))[:, None])
    put(kind == PROP, prop)
    put(kind == FAIR, waterfill_exact(cap, w, sub, active))
    return torch.where(active, out, 0)
