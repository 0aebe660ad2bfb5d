"""Loadtest workers: recipe-scheduled, doorman-limited load generators.

Capability parity with reference doc/loadtest/docker/client/doorman_client.go
(doc/loadtest/README.md:118-148): each worker claims capacity for a shared
resource from a doorman server, converts the granted capacity to request
rate through the QPS rate limiter, and fires requests at the target. The
worker's *wants* follows its recipe schedule (go/client/recipe), so demand
shapes (sine waves, random walks, ramps) drive the allocation dynamics the
loadtest observes.

Run:  python -m doorman_tpu_torch.loadtest.worker \
          --server localhost:15000 --target localhost:16000 \
          --resource fair --recipes "10x100+sin(200)" \
          --recipe-interval 60 --recipe-reset 1800

Port of doorman_tpu/loadtest/worker.py: a copy apart from import paths.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import time

from doorman_tpu_torch.client import Client
from doorman_tpu_torch.loadtest.recipe import parse_recipes
from doorman_tpu_torch.loadtest.target import ping
from doorman_tpu_torch.ratelimiter import new_qps
from doorman_tpu_torch.utils import flagenv

log = logging.getLogger("doorman.loadtest.worker")


async def run_worker(
    index: int,
    state,
    server_addr: str,
    client_id: str,
    resource_id: str,
    target_addr: str,
    stats: dict,
    minimum_refresh_interval: float = 5.0,
    poll_interval: float = 1.0,
) -> None:
    """One worker: its own doorman client (like each reference loadtest
    pod), leasing capacity for the recipe's current QPS and issuing
    rate-limited requests to the target."""
    host, _, port = target_addr.rpartition(":")
    call, close_conn = await ping(host, int(port))
    client = await Client.connect(
        server_addr, client_id,
        minimum_refresh_interval=minimum_refresh_interval,
    )
    res = await client.resource(
        resource_id, wants=max(state.current_qps, 1.0)
    )
    limiter = new_qps(res)
    stats.setdefault("requests", 0)
    try:
        next_poll = time.monotonic()
        while True:
            if state.interval_expired():
                log.info(
                    "worker %d: qps %.1f -> %.1f",
                    index, state.old_qps, state.current_qps,
                )
                await res.ask(max(state.current_qps, 1.0))
            try:
                await limiter.wait(timeout=poll_interval)
            except asyncio.TimeoutError:
                continue
            await call()
            stats["requests"] += 1
            now = time.monotonic()
            if now >= next_poll:
                next_poll = now + poll_interval
                await asyncio.sleep(0)  # let refresh tasks breathe
    finally:
        await limiter.close()
        await client.close()
        await close_conn()


async def run_loadtest(args: argparse.Namespace) -> None:
    workers = parse_recipes(
        args.recipes,
        interval=args.recipe_interval,
        reset=args.recipe_reset,
    )
    prefix = args.client_id or "loadtest"
    stats: dict = {}
    tasks = [
        asyncio.create_task(
            run_worker(
                i, w, args.server, f"{prefix}-{i}",
                args.resource if args.shared_resource
                else f"{args.resource}-{i}",
                args.target, stats,
                minimum_refresh_interval=args.minimum_refresh_interval,
            )
        )
        for i, w in enumerate(workers)
    ]
    log.info("%d workers started", len(tasks))

    async def report():
        last, last_t = 0, time.monotonic()
        while True:
            await asyncio.sleep(5)
            now = time.monotonic()
            total = stats.get("requests", 0)
            log.info(
                "sent %.1f qps (%d total)",
                (total - last) / (now - last_t), total,
            )
            last, last_t = total, now

    reporter = asyncio.create_task(report())
    try:
        if args.duration > 0:
            await asyncio.sleep(args.duration)
        else:
            await asyncio.Event().wait()
    finally:
        reporter.cancel()
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="loadtest-worker")
    p.add_argument("--server", default="localhost:15000",
                   help="doorman server address")
    p.add_argument("--target", default="localhost:16000",
                   help="loadtest target address")
    p.add_argument("--resource", default="loadtest",
                   help="resource id to claim capacity for")
    p.add_argument("--shared-resource", action="store_true", default=True,
                   help="all workers share one resource id")
    p.add_argument("--client-id", default="")
    p.add_argument("--recipes", default="1x10+constant_increase(0)",
                   help='e.g. "10x100+sin(200),5x50+random_change(20)"')
    p.add_argument("--recipe-interval", type=float, default=60.0)
    p.add_argument("--recipe-reset", type=float, default=1800.0)
    p.add_argument("--minimum-refresh-interval", type=float, default=5.0)
    p.add_argument("--duration", type=float, default=0.0,
                   help="stop after this many seconds (0: run forever)")
    return p


def main(argv=None) -> None:
    parser = make_parser()
    flagenv.populate(parser)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    try:
        asyncio.run(run_loadtest(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
