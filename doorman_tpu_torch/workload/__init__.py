"""Trace-driven workload harness (port of doorman_tpu/workload):
closed-loop scenarios over the real server on the virtual ChaosClock,
gated by machine-readable SLO verdicts.

The package composes the substrate the repo already has — ChaosClock,
the chaos runner's stepped loopback topology, the SLO engine, the
flight recorder, the rate-curve driver — into *named scenarios* that
measure user-visible outcomes (per-band satisfaction, goodput under
shedding, reconvergence after disturbances) instead of tick wall-time:

  * `spec`       — the declarative WorkloadSpec (population, band mix,
                   generators, gates);
  * `generators` — composable load shapes: diurnal curves, flash
                   crowds, rolling deploys, multi-region RTTs, elastic
                   jobs with preemption;
  * `forecast`   — the device-batched seasonal demand forecaster (numpy
                   host oracle, bit-identity pinned) behind the
                   predictive-admission scenario;
  * `population` — the array-backed vector engine for million-client
                   populations;
  * `harness`    — WorkloadRunner: drives the topology tick by tick and
                   returns a verdict with a byte-stable event log;
  * `scenarios`  — the named scenario library and its registry.

Run one: ``python -m doorman_tpu_torch.cmd.workload --scenario flash_crowd``
(``--device cpu`` without a GPU). See doc/workload.md.
"""

from __future__ import annotations

__all__ = ["run_scenario", "SCENARIOS", "WorkloadSpec", "WorkloadRunner"]


def __getattr__(name):
    # Lazy re-exports: importing the package must not pull grpc/torch.
    if name in ("run_scenario", "SCENARIOS"):
        from doorman_tpu_torch.workload import scenarios

        return getattr(scenarios, name)
    if name == "WorkloadSpec":
        from doorman_tpu_torch.workload.spec import WorkloadSpec

        return WorkloadSpec
    if name == "WorkloadRunner":
        from doorman_tpu_torch.workload.harness import WorkloadRunner

        return WorkloadRunner
    raise AttributeError(name)
