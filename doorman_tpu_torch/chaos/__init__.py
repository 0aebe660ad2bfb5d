"""Deterministic fault injection and invariant checking.

See doc/chaos.md. The pieces:

  plan.py       FaultPlan / FaultEvent — the seeded, replayable artifact
  clock.py      ChaosClock — virtual time every component shares
  injectors.py  shims at the etcd / lease-KV / gRPC / solver seams
  invariants.py per-tick checkers (capacity, single-master, lag-never-
                lead, reconvergence)
  runner.py     drives the real stack through a plan, emits a verdict
  plans.py      shipped scenarios (master flap, etcd brownout, device
                tunnel outage, intermediate partition)

Port of doorman_tpu/chaos/__init__.py: a copy apart from import paths.
"""

from doorman_tpu_torch.chaos.clock import ChaosClock
from doorman_tpu_torch.chaos.injectors import (
    ChaosEtcdGateway,
    ChaosGrpcProxy,
    ChaosLeaseKV,
    FaultInjected,
    FaultState,
    PortInjector,
    SolverInjector,
    backend_probe_argv,
)
from doorman_tpu_torch.chaos.invariants import InvariantChecker, Violation
from doorman_tpu_torch.chaos.plan import FaultEvent, FaultPlan
from doorman_tpu_torch.chaos.plans import PLANS, get_plan
from doorman_tpu_torch.chaos.runner import ChaosRunner, SteppedElection, run_plan

__all__ = [
    "ChaosClock",
    "ChaosEtcdGateway",
    "ChaosGrpcProxy",
    "ChaosLeaseKV",
    "ChaosRunner",
    "FaultEvent",
    "FaultInjected",
    "FaultPlan",
    "FaultState",
    "InvariantChecker",
    "PLANS",
    "PortInjector",
    "SolverInjector",
    "SteppedElection",
    "Violation",
    "backend_probe_argv",
    "get_plan",
    "run_plan",
]
