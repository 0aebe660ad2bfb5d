"""Host-side core: leases, lease stores, resources, snapshots."""

from doorman_tpu_torch.core.lease import Lease, ZERO_LEASE  # noqa: F401
from doorman_tpu_torch.core.store import LeaseStore  # noqa: F401
