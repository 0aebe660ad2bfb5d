"""Loadtest target: counts requests and reports observed QPS.

Capability parity with reference doc/loadtest/docker/target/target.go: a
trivial request sink whose request rate is the measured quantity of the
loadtest. The wire protocol is newline-delimited "ping\n" over TCP (one
reply line per request) — no proto needed for a sink whose only job is
counting. Observed QPS is exported as a gauge on the shared metrics
registry and logged every report interval.

Run:  python -m doorman_tpu_torch.loadtest.target --port 16000

Port of doorman_tpu/loadtest/target.py: a copy apart from import paths.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import time
from typing import Optional

from doorman_tpu_torch.obs.metrics import Registry, default_registry

log = logging.getLogger("doorman.loadtest.target")

REPORT_INTERVAL = 5.0


class Target:
    """Counting TCP sink."""

    def __init__(self, registry: Optional[Registry] = None):
        self.requests = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._report_task: Optional[asyncio.Task] = None
        registry = registry or default_registry()
        self._qps_gauge = registry.gauge(
            "doorman_loadtest_target_qps",
            "Observed requests/second at the loadtest target.",
        )
        self._total = registry.counter(
            "doorman_loadtest_target_requests_total",
            "Total requests received by the loadtest target.",
        )
        self.port: Optional[int] = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                self.requests += 1
                self._total.inc()
                writer.write(b"ok\n")
                await writer.drain()
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    async def _report_loop(self) -> None:
        last_count, last_time = self.requests, time.monotonic()
        while True:
            await asyncio.sleep(REPORT_INTERVAL)
            now = time.monotonic()
            qps = (self.requests - last_count) / (now - last_time)
            self._qps_gauge.set(qps)
            log.info("observed %.1f qps (%d total)", qps, self.requests)
            last_count, last_time = self.requests, now

    async def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        self._server = await asyncio.start_server(self._handle, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._report_task = asyncio.create_task(self._report_loop())
        return self.port

    async def stop(self) -> None:
        if self._report_task is not None:
            self._report_task.cancel()
            try:
                await self._report_task
            except asyncio.CancelledError:
                pass
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()


async def ping(host: str, port: int):
    """Open one connection to a target; returns an async callable issuing
    one request per call, and a closer."""
    reader, writer = await asyncio.open_connection(host, port)

    async def call() -> None:
        writer.write(b"ping\n")
        await writer.drain()
        await reader.readline()

    async def close() -> None:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass

    return call, close


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="loadtest-target")
    p.add_argument("--port", type=int, default=16000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--metrics-port", type=int, default=-1,
                   help="serve /metrics (and /debug pages) on this port; "
                        "-1 disables")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    async def run():
        target = Target()
        port = await target.start(args.port, args.host)
        log.info("target listening on %s:%d", args.host, port)
        if args.metrics_port >= 0:
            from doorman_tpu_torch.obs.debug import DebugServer

            # Bind the debug pages to the same interface as the serving
            # socket — don't expose them more broadly than the target.
            debug = DebugServer(host=args.host, port=args.metrics_port)
            log.info("metrics on port %d", debug.start())
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
