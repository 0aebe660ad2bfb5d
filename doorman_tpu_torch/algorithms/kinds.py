"""Algorithm lane identifiers, shared by the host-side core and the device
kernels. Kept free of jax imports so host-only paths (config validation,
per-request serving) never pay the JAX startup cost."""

from __future__ import annotations

import enum


class AlgoKind(enum.IntEnum):
    """Per-resource algorithm lane. Values 0-3 match the wire enum
    (doorman_tpu_torch.proto Algorithm.Kind); the extra lanes are internal."""

    NO_ALGORITHM = 0
    STATIC = 1
    PROPORTIONAL_SHARE = 2
    FAIR_SHARE = 3
    # The Go-style "equal share + proportional top-up" variant
    # (reference algorithm.go:213-292) in snapshot form.
    PROPORTIONAL_TOPUP = 4
    # Priority-banded weighted max-min with capacity groups (wire kind
    # PRIORITY_BANDS = 4 maps here; the solve_lanes kernels do not carry
    # this lane — BatchSolver routes it to solver.priority instead).
    PRIORITY_BANDS = 5
    # 6 is reserved: the native store engine uses it as DECIDE_LEARN on
    # its per-request decide wire (native/__init__.py), and an AlgoKind
    # aliasing it would silently take the learn path there.
    #
    # The fairness portfolio (selected by `variant` config parameters on
    # the wire FAIR_SHARE / PROPORTIONAL_SHARE kinds; doc/algorithms.md
    # "The fairness portfolio"):
    # Client-granular (unweighted) max-min water-filling, solved by the
    # fast-converging direct fill iteration of arxiv 2310.09699 instead
    # of FAIR_SHARE's bisection (wire FAIR_SHARE + variant=maxmin).
    MAX_MIN_FAIR = 7
    # Balanced fairness (arxiv 1711.02880): insensitive
    # subclient-proportional shares with the recursive cap-peeling
    # formula unrolled to a fixed bound (wire FAIR_SHARE +
    # variant=balanced).
    BALANCED_FAIRNESS = 8
    # Weighted proportional fairness (Kelly log-utility, arxiv
    # 1404.2266): the dual fixpoint on the water level (wire
    # PROPORTIONAL_SHARE + variant=logutil).
    PROPORTIONAL_FAIRNESS = 9
