"""Discrete-event simulation harness (port of doorman_tpu/sim; host
only, no device).

Capability parity with the reference's `simulation/` tree (scheduler,
server/client models, server jobs with election mishaps, scenarios 1-7,
varz + CSV reporter), redesigned: no module-level singletons — a `Sim`
context owns the clock, scheduler, metrics, and config — and the server
model is built on the framework's own LeaseStore/algorithm semantics
instead of a third implementation.

Used as a deterministic regression suite (scenarios assert convergence and
utilization) and as a load model for the batched solver.
"""

from doorman_tpu_torch.sim.core import Sim, SimClock, Scheduler  # noqa: F401
from doorman_tpu_torch.sim.varz import Counter, Gauge, Varz  # noqa: F401
