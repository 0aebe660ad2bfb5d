"""Rate limiters that convert capacity leases into admission control
(port of doorman_tpu/ratelimiter)."""

from doorman_tpu_torch.ratelimiter.qps import QPSRateLimiter, new_qps  # noqa: F401
from doorman_tpu_torch.ratelimiter.adaptive import (  # noqa: F401
    AdaptiveQPSRateLimiter,
    new_adaptive_qps,
)
