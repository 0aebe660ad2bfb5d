"""Fleet runtime: the federation made deployable (port of
doorman_tpu/fleet; host code over the port's CapacityServers).

The federation's FederatedRoots proves the POP reconcile beat
in-process with a fixed shard count. This package is the production shape of the same
loops:

  * `epoch`      — routing epochs: versioned ShardRouter maps so the
                   shard count can change while clients are live.
  * `controller` — FleetController: the in-process fleet runtime
                   (active set, live reshard N→M, the reconcile beat
                   with drain-via-freeze), interface-compatible with
                   FederatedRoots so every harness drives it unchanged.
  * `beat`       — the wire codec (ShardSummary <-> GetServerCapacity
                   band aggregates) and BeatCore, the transport-free
                   reconcile state the RPC beat service runs on.
  * `autoscale`  — hysteresis + cool-down shard-count controller over
                   SLO verdicts.
  * `rpc`        — the gRPC beat service + per-shard reporter loop.
  * `supervisor` — spawn/monitor real `cmd.server` shard processes.
"""

from doorman_tpu_torch.fleet.autoscale import Autoscaler
from doorman_tpu_torch.fleet.beat import (
    BeatCore,
    decode_summary,
    encode_summary,
    parse_shard_server_id,
    shard_server_id,
)
from doorman_tpu_torch.fleet.controller import FleetController
from doorman_tpu_torch.fleet.epoch import EpochChange, EpochRouter

__all__ = [
    "Autoscaler",
    "BeatCore",
    "EpochChange",
    "EpochRouter",
    "FleetController",
    "decode_summary",
    "encode_summary",
    "parse_shard_server_id",
    "shard_server_id",
]
