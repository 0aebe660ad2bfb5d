"""FleetSupervisor: real CapacityServer shard processes under one roof.

Spawns each shard as `python -m doorman_tpu_torch.cmd.server` (the actual
binary, not a test double) with the fleet's wiring flags: per-shard
identity (--shard i/N — election lock suffix + persist namespace, so a
later M-shard restart finds shard k's journal under the same
namespace), the shared config file, and the beat reporter
(--fleet-beat) pointed at the head. Readiness is probed with the
ordinary Discovery RPC; liveness by waitpid. Scale-out spawns a new
process; scale-in terminates one and lets the share-freeze drain do
the rest — the supervisor never copies state between shards, because
the lease machinery makes that unnecessary.

Port of doorman_tpu/fleet/supervisor.py. Where the reference pins each
child to JAX's CPU platform, the port passes its own `--device`: "cuda"
by default (a shard in batch mode ticks on the card), "cpu" only when
the caller asks. `mode` and `native_store` ride the command line too,
so a fleet of batch-mode, native-store shards runs its resident K1/K2
ticks on the card. Each child's import path starts
at this checkout, whatever the caller's working directory.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import grpc

from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto.grpc_api import CapacityStub

log = logging.getLogger(__name__)

__all__ = ["FleetSupervisor", "ShardProcess", "free_port"]

# The directory holding the package, for the children's import path.
_PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


def free_port() -> int:
    """An OS-granted free TCP port (bind-then-close; the tiny reuse
    race is acceptable for loopback smokes and dev fleets)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class ShardProcess:
    index: int
    port: int
    proc: subprocess.Popen
    log_path: Optional[str] = None
    started_at: float = field(default_factory=time.time)

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None


class FleetSupervisor:
    def __init__(
        self,
        config_path: str,
        *,
        beat_addr: str = "",
        straddle: Sequence[str] = (),
        report_interval: float = 2.0,
        persist: str = "",
        mode: str = "immediate",
        native_store: bool = False,
        device: str = "cuda",
        minimum_refresh_interval: float = 0.0,
        log_dir: Optional[str] = None,
        extra_args: Sequence[str] = (),
        env: Optional[Dict[str, str]] = None,
    ):
        self.config_path = config_path
        self.beat_addr = beat_addr
        self.straddle = tuple(straddle)
        self.report_interval = float(report_interval)
        self.persist = persist
        self.mode = mode
        self.native_store = bool(native_store)
        self.device = device
        self.minimum_refresh_interval = float(minimum_refresh_interval)
        self.log_dir = log_dir
        self.extra_args = tuple(extra_args)
        self.env = dict(env) if env is not None else None
        self.shards: Dict[int, ShardProcess] = {}

    # -- lifecycle ----------------------------------------------------

    def spawn(self, index: int, n_shards: int) -> ShardProcess:
        """Start shard `index` of an `n_shards` fleet. Idempotent per
        live index (respawns a dead one in place)."""
        existing = self.shards.get(index)
        if existing is not None and existing.alive:
            return existing
        port = free_port()
        argv = [
            sys.executable, "-m", "doorman_tpu_torch.cmd.server",
            "--host", "127.0.0.1",
            "--port", str(port),
            "--debug-port", "-1",
            "--config", f"file:{self.config_path}",
            "--mode", self.mode,
            "--shard", f"{index}/{max(n_shards, index + 1)}",
            "--minimum-refresh-interval",
            str(self.minimum_refresh_interval),
            "--device", self.device,
        ]
        if self.native_store:
            argv.append("--native-store")
        if self.beat_addr:
            argv += [
                "--fleet-beat", self.beat_addr,
                "--fleet-report-interval", str(self.report_interval),
            ]
            if self.straddle:
                argv += ["--fleet-straddle", ",".join(self.straddle)]
        if self.persist:
            argv += ["--persist", self.persist]
        argv += list(self.extra_args)
        stdout = subprocess.DEVNULL
        log_path = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            log_path = os.path.join(self.log_dir, f"shard{index}.log")
            stdout = open(log_path, "ab")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p
        )
        if self.env:
            env.update(self.env)
        proc = subprocess.Popen(
            argv, stdout=stdout, stderr=subprocess.STDOUT, env=env,
            stdin=subprocess.DEVNULL,
        )
        if stdout is not subprocess.DEVNULL:
            stdout.close()
        sp = ShardProcess(index=index, port=port, proc=proc,
                          log_path=log_path)
        self.shards[index] = sp
        log.info("spawned shard %d pid %d on %s",
                 index, proc.pid, sp.addr)
        return sp

    async def wait_ready(
        self, index: int, *, timeout: float = 30.0
    ) -> ShardProcess:
        """Poll Discovery until the shard answers as master (trivial
        election deployments answer immediately once configured)."""
        sp = self.shards[index]
        # Bring-up of a real child process: the poll deadline is
        # wall-clock by design, outside any seeded replay.
        deadline = time.monotonic() + timeout  # doorman: allow[seeded-determinism]
        last: Optional[Exception] = None
        while time.monotonic() < deadline:  # doorman: allow[seeded-determinism]
            if not sp.alive:
                raise RuntimeError(
                    f"shard {index} exited rc={sp.proc.returncode} "
                    f"during bring-up (log: {sp.log_path})"
                )
            try:
                async with grpc.aio.insecure_channel(sp.addr) as ch:
                    out = await CapacityStub(ch).Discovery(
                        pb.DiscoveryRequest(), timeout=2.0
                    )
                if out.is_master:
                    return sp
            except Exception as e:
                last = e
            await asyncio.sleep(0.2)
        raise TimeoutError(
            f"shard {index} not ready within {timeout}s "
            f"(last error: {last!r}, log: {sp.log_path})"
        )

    def stop(self, index: int, *, grace: float = 5.0) -> None:
        """Scale-in: SIGTERM the shard and reap it. Its straddle share
        freezes at the head and drains through expiry + lease length —
        that IS the drain procedure (doc/operations.md)."""
        sp = self.shards.get(index)
        if sp is None:
            return
        if sp.alive:
            sp.proc.send_signal(signal.SIGTERM)
            try:
                sp.proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                sp.proc.kill()
                sp.proc.wait(timeout=grace)
        log.info("stopped shard %d rc=%s", index, sp.proc.returncode)

    def stop_all(self) -> None:
        for index in sorted(self.shards, reverse=True):
            self.stop(index)

    # -- observation --------------------------------------------------

    def addrs(self) -> Dict[int, str]:
        return {i: sp.addr for i, sp in self.shards.items() if sp.alive}

    def status(self) -> dict:
        return {
            "config": self.config_path,
            "beat": self.beat_addr,
            "mode": self.mode,
            "native_store": self.native_store,
            "device": self.device,
            "shards": {
                i: {
                    "addr": sp.addr,
                    "pid": sp.proc.pid,
                    "alive": sp.alive,
                    "rc": sp.proc.returncode,
                    "log": sp.log_path,
                }
                for i, sp in sorted(self.shards.items())
            },
        }
