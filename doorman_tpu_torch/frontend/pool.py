"""The two frontend pools: inline (deterministic, same-process) and
real (SO_REUSEPORT worker processes).

`InlineFrontendPool` runs one WorkerCore per worker INSIDE the tick
process over in-memory rings, delivering ring frames into the original
Subscription queues — the existing WatchCapacity handler loop serves
pooled streams unchanged, and the ring is genuinely in the path (every
pooled push crosses writer framing, the ring bytes, reader validation,
and the pump before a client sees it). This is the form the tier-1
byte-parity pin, the chaos worker_crash/ring_stall arcs, and the
`diurnal_streaming_pooled` workload scenario drive on the virtual
clock: no processes, no wall time, byte-stable results.

`FrontendPool` is the real thing for cmd/server, chip_smoke.py and
cmd/frontend_smoke: shared-memory rings, worker processes, a reaper that
turns a dead worker into registry.drop_worker (reset-to-redirect, shard
reassignment) plus an optional respawn, and SIGTERM drain. Each worker
is a fresh interpreter (`python -c`, run_worker's command line), never a
fork: a forked child of a CUDA process cannot use it, and unlike a
multiprocessing spawn child it does not re-import the parent's main
module, which for the server binary imports torch. So the workers never
import torch nor touch the card. (The reference spawns them with
multiprocessing's spawn context.) A cert/key pair rides each worker's
command line as file paths, and the worker reads them itself, so a
respawn after a cert rotation picks the new pair up.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

from doorman_tpu_torch.frontend.control import FrontendControl
from doorman_tpu_torch.frontend.publisher import RingPublisher
from doorman_tpu_torch.frontend.ring import Ring
from doorman_tpu_torch.frontend.worker import WorkerCore
from doorman_tpu_torch.proto import doorman_stream_pb2 as spb

log = logging.getLogger(__name__)

__all__ = ["FrontendPool", "InlineFrontendPool"]

# A worker process's program: worker.main over its command line.
_WORKER_MAIN = (
    "import sys; from doorman_tpu_torch.frontend.worker import main; "
    "sys.exit(main(sys.argv[1:]))"
)
# The directory holding the package, for the workers' import path.
_PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])
# Numbers the real pools of a process, so two of them (a TLS pool beside
# a plaintext one) never share a ring name.
_POOL_SEQ = itertools.count()


class _WorkerProcess:
    """A listener worker's OS process, with the multiprocessing.Process
    surface the reaper and the drain use."""

    def __init__(self, popen: subprocess.Popen):
        self._popen = popen

    @property
    def pid(self) -> int:
        return self._popen.pid

    @property
    def exitcode(self) -> Optional[int]:
        return self._popen.poll()

    def is_alive(self) -> bool:
        return self._popen.poll() is None

    def kill(self) -> None:
        if self.is_alive():
            self._popen.kill()

    def terminate(self) -> None:
        if self.is_alive():
            self._popen.terminate()

    def join(self, timeout: Optional[float] = None) -> None:
        try:
            self._popen.wait(timeout)
        except subprocess.TimeoutExpired:
            pass


class InlineFrontendPool:
    """N worker cores over in-memory rings, driven explicitly:
    `pump_all()` after each push edge (tests/chaos/workload call it
    where a real worker's pump loop would have woken)."""

    def __init__(self, server, workers: int, *,
                 ring_bytes: int = 1 << 20):
        self.server = server
        self.workers = int(workers)
        self.ring_bytes = int(ring_bytes)
        self.publisher = RingPublisher(self.workers,
                                       ring_bytes=self.ring_bytes)
        registry = server._streams
        if registry is None:
            raise ValueError("frontend pool needs stream push enabled")
        self._registry = registry
        registry.attach_publisher(self.publisher)
        registry.on_pooled_subscribe = self._on_subscribe
        self.cores: Dict[int, WorkerCore] = {}
        self._stalled: set = set()
        self.crashes = 0
        self.restores = 0
        for w in range(self.workers):
            self.cores[w] = self._make_core(w)

    def _make_core(self, w: int) -> WorkerCore:
        return WorkerCore(
            w, self.publisher.rings[w],
            deliver=self._deliver,
            terminal=self._terminal,
            on_stall=self._reset,
            tick_interval=float(
                getattr(self.server, "tick_interval", 1.0) or 1.0
            ),
        )

    # -- worker-core callbacks (handle == the Subscription) ------------

    def _deliver(self, stream_id: int, sub, payload: bytes) -> None:
        if sub.terminated:
            return
        try:
            sub.queue.put_nowait(payload)
        except asyncio.QueueFull:
            # The slow-consumer contract, applied at the pump instead
            # of the shard: reset-to-redirect, client resumes.
            self._reset(stream_id, sub, "slow_consumer")

    def _terminal(self, stream_id: int, sub, payload: bytes) -> None:
        # Inline workers share the handler's process: the terminal is
        # delivered as the parsed MESSAGE object (the handler ends the
        # stream on any non-bytes item) — the real worker sends the
        # bytes and ends the gRPC stream itself.
        msg = spb.WatchCapacityResponse.FromString(payload)
        while True:
            try:
                sub.queue.put_nowait(msg)
                return
            except asyncio.QueueFull:
                try:
                    sub.queue.get_nowait()
                except asyncio.QueueEmpty:  # pragma: no cover - racy only
                    pass

    def _reset(self, stream_id: int, sub, reason: str) -> None:
        """A worker-side reset (stall, desync, slow consumer): the
        worker no longer serves this stream, so the terminal redirect
        is delivered locally — clear the pin first, then the registry's
        reset takes the local-queue path (the same shape as a real
        worker ending the gRPC stream)."""
        if not sub.terminated:
            sub.worker = None
            self._registry.reset(sub)

    def _on_subscribe(self, sub) -> None:
        core = self.cores.get(sub.worker)
        if core is not None:
            core.register(sub.stream_id, sub, self.server._clock())

    # -- driving -------------------------------------------------------

    def pump_all(self) -> dict:
        """One pump pass across live, unstalled workers — call after
        each push edge (where a real worker's poll loop would wake).
        Returns merged pump stats."""
        now = self.server._clock()
        out = {"frames": 0, "lapped": 0, "corrupt": 0, "stalled": 0}
        for w, core in sorted(self.cores.items()):
            if w in self._stalled:
                continue
            res = core.pump(now)
            out["frames"] += res["frames"]
            out["lapped"] += 1 if res["lapped"] else 0
            out["corrupt"] += res["corrupt"]
            out["stalled"] += core.check_deadlines(now)
        return out

    # -- faults (the chaos surface) ------------------------------------

    def crash(self, worker: int) -> int:
        """Kill one worker: its streams end with redirects (never a
        silent lapse), its shards reassign to survivors. Returns the
        number of streams dropped."""
        self.crashes += 1
        self.cores.pop(worker, None)
        self._stalled.discard(worker)
        return self._registry.drop_worker(
            worker, self.server._mastership()
        )

    def restore(self, worker: int) -> None:
        """Restart one worker: a FRESH core whose reader starts at the
        ring's current write position — a restarted worker never
        replays frames (resume rides the push-seq contract)."""
        self.restores += 1
        self.publisher.revive(worker)
        self.cores[worker] = self._make_core(worker)

    def stall(self, worker: int) -> None:
        """Freeze one worker's pump (the ring_stall fault): frames
        accumulate unread; a long enough stall laps the reader and the
        resume pump resets every held stream loudly."""
        self._stalled.add(worker)

    def unstall(self, worker: int) -> None:
        self._stalled.discard(worker)

    # -- introspection -------------------------------------------------

    def held(self) -> int:
        return sum(core.held() for core in self.cores.values())

    def status(self) -> dict:
        return {
            "mode": "inline",
            "workers": self.workers,
            "live": sorted(self.cores),
            "stalled": sorted(self._stalled),
            "held": self.held(),
            "crashes": self.crashes,
            "restores": self.restores,
            "publisher": self.publisher.status(),
            "per_worker": [
                core.status() for _, core in sorted(self.cores.items())
            ],
        }

    def close(self) -> None:
        self._registry.on_pooled_subscribe = None
        self._registry.publisher = None
        self.publisher.close()


class FrontendPool:
    """Real listener-worker processes over shared-memory rings.

    Construct BEFORE server.start() (the control surface registers on
    the backend gRPC server at start), then `await start(public_addr,
    backend_addr)` once the backend is bound. The reaper watches the
    worker processes: a death becomes registry.drop_worker — the dead
    worker's streams reset to redirects, its shards reassign — and a
    fresh worker on the same ring (fresh reader cursor: no replay)."""

    def __init__(self, server, workers: int, *,
                 ring_bytes: int = 1 << 22,
                 tick_interval: float = 1.0,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None):
        if bool(tls_cert) != bool(tls_key):
            raise ValueError("tls_cert and tls_key must both be set")
        self.server = server
        self.workers = int(workers)
        self.ring_bytes = int(ring_bytes)
        self.tick_interval = float(tick_interval)
        # TLS terminates at the workers (the listener edge).
        self.tls_cert = tls_cert
        self.tls_key = tls_key
        registry = server._streams
        if registry is None:
            raise ValueError("frontend pool needs stream push enabled")
        self._registry = registry
        pool = next(_POOL_SEQ)
        self._ring_names = [
            f"doorman-fe-{os.getpid()}-{pool}-{w}"
            for w in range(self.workers)
        ]
        self.rings: List[Ring] = [
            Ring.shared(name, self.ring_bytes, create=True)
            for name in self._ring_names
        ]
        self.publisher = RingPublisher(
            self.workers, ring_bytes=self.ring_bytes, rings=self.rings
        )
        registry.attach_publisher(self.publisher)
        self.control = FrontendControl(server)
        # server.start() registers this on the backend gRPC server.
        server._frontend_control = self.control
        server._frontend = self
        self._procs: Dict[int, _WorkerProcess] = {}
        self._reaper: Optional[asyncio.Task] = None
        self._draining = False
        self.public_addr = ""
        self.backend_addr = ""

    async def start(self, public_addr: str, backend_addr: str) -> None:
        self.public_addr = public_addr
        self.backend_addr = backend_addr
        for w in range(self.workers):
            self._spawn(w)
        self._reaper = asyncio.get_running_loop().create_task(
            self._reap_loop()
        )
        log.info(
            "frontend pool: %d workers on %s (backend %s, ring %d MiB "
            "x %d)", self.workers, public_addr, backend_addr,
            self.ring_bytes >> 20, self.workers,
        )

    def _spawn(self, w: int) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p
        )
        popen = subprocess.Popen(
            [sys.executable, "-c", _WORKER_MAIN,
             "--index", str(w), "--public", self.public_addr,
             "--backend", self.backend_addr,
             "--ring", self._ring_names[w],
             "--ring-bytes", str(self.ring_bytes),
             "--tick-interval", repr(self.tick_interval),
             *(["--tls-cert", self.tls_cert, "--tls-key", self.tls_key]
               if self.tls_cert else [])],
            env=env, stdin=subprocess.DEVNULL,
        )
        self._procs[w] = _WorkerProcess(popen)

    async def _reap_loop(self) -> None:
        while True:
            await asyncio.sleep(0.5)
            if self._draining:
                return
            for w, proc in list(self._procs.items()):
                if proc.is_alive():
                    continue
                log.warning(
                    "frontend worker %d died (exit %s)", w,
                    proc.exitcode,
                )
                dropped = self._registry.drop_worker(
                    w, self.server._mastership()
                )
                log.info(
                    "worker %d: %d stream(s) redirected to survivors",
                    w, dropped,
                )
                del self._procs[w]
                if not self._draining:
                    self.publisher.revive(w)
                    self._spawn(w)

    def kill_worker(self, w: int) -> None:
        """Hard-kill one worker (the CI smoke's crash injection)."""
        proc = self._procs.get(w)
        if proc is not None:
            proc.kill()

    async def drain(self, grace: float = 10.0) -> None:
        """Graceful drain: SIGTERM every worker (they stop accepting,
        end held streams, finish in-flight forwards) and join."""
        self._draining = True
        for proc in self._procs.values():
            if proc.is_alive():
                proc.terminate()
        deadline = asyncio.get_running_loop().time() + grace
        for proc in self._procs.values():
            remaining = deadline - asyncio.get_running_loop().time()
            await asyncio.get_running_loop().run_in_executor(
                None, proc.join, max(remaining, 0.1)
            )
            if proc.is_alive():
                proc.kill()

    async def stop(self) -> None:
        if self._reaper is not None:
            self._reaper.cancel()
            self._reaper = None
        if not self._draining:
            await self.drain(grace=5.0)
        self._registry.publisher = None
        self.publisher.close()
        self.publisher.unlink()

    def status(self) -> dict:
        return {
            "mode": "processes",
            "workers": self.workers,
            "live": sorted(
                w for w, p in self._procs.items() if p.is_alive()
            ),
            "public_addr": self.public_addr,
            "backend_addr": self.backend_addr,
            "ring_bytes": self.ring_bytes,
            "publisher": self.publisher.status(),
            "control": self.control.status(),
        }
