"""Scalar (per-request) allocation algorithms.

These are the sequential oracles: exact reimplementations of the reference
semantics used (a) by the server between batched ticks, and (b) as the parity
reference for the batched TPU kernels in `doorman_tpu_torch.solver`.
"""

from doorman_tpu_torch.algorithms.kinds import AlgoKind  # noqa: F401
from doorman_tpu_torch.algorithms.scalar import (  # noqa: F401
    Request,
    balanced_fairness,
    get_algorithm,
    get_parameter,
    learn,
    max_min_fair,
    no_algorithm,
    proportional_fairness,
    proportional_share,
    proportional_topup,
    static,
    fair_share,
)
