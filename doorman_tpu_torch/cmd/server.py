"""The doorman server binary, PyTorch port: batch mode on the native store.

    python -m doorman_tpu_torch.cmd.server --config file:cfg.yml \\
        --mode batch --native-store [--device cuda] [--solver-dtype f32]

Loads the YAML config once (file: source), runs the trivial election,
serves the Capacity gRPC service and ticks the resident solve on
`--device` (default cuda; a machine without a GPU must pass
--device cpu). Flags not listed here — etcd election and config,
persistence, admission, stream push, the frontend pool, TLS, the debug
pages — are not ported yet.
"""

from __future__ import annotations

import argparse
import asyncio
import logging

from doorman_tpu_torch.server import config as config_mod
from doorman_tpu_torch.server.election import TrivialElection
from doorman_tpu_torch.server.server import CapacityServer

log = logging.getLogger("doorman.server")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="doorman-server",
        description="doorman capacity server (PyTorch/CUDA port)",
    )
    p.add_argument("--port", type=int, default=15000,
                   help="port to bind the gRPC service to")
    p.add_argument("--host", default="[::]", help="address to bind")
    p.add_argument("--server-id", default="",
                   help="this server's id (default: host:port)")
    p.add_argument("--config", required=True,
                   help='config source: "file:<path>"')
    p.add_argument("--mode", choices=("batch",), default="batch",
                   help="allocation mode (the port runs the per-tick "
                        "batched device solve)")
    p.add_argument("--native-store", action="store_true", default=True,
                   help="back lease stores with the C++ engine (always "
                        "on in the port)")
    p.add_argument("--device", default="cuda",
                   help="device of the batch tick: cuda (default) or cpu")
    p.add_argument("--tick-interval", type=float, default=1.0,
                   help="seconds between device solves")
    p.add_argument("--solver-dtype", choices=("f32", "f64"), default="f64",
                   help="batch solve precision; both run the CUDA kernels")
    p.add_argument("--scoped-solve", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="solve only the dirty rows plus the not-yet-"
                        "converged frontier each tick (byte-identical to "
                        "the full solve); --no-scoped-solve solves the "
                        "full table every tick")
    p.add_argument("--tick-pipeline-depth", type=int, default=3,
                   help="resident ticks kept in flight: tick N's delivery "
                        "download overlaps the staging and solve of the "
                        "ticks after it")
    p.add_argument("--log-level", default="info",
                   help="debug/info/warning/error")
    return p


def read_config(source: str):
    if not source.startswith("file:"):
        raise SystemExit(f'--config wants "file:<path>", got {source!r}')
    with open(source[len("file:"):]) as f:
        return config_mod.parse_yaml_config(f.read())


async def serve(args: argparse.Namespace, on_started=None) -> None:
    """Run the server until cancelled. `on_started(server)` fires once the
    gRPC listener is bound."""
    repo = read_config(args.config)
    server = CapacityServer(
        args.server_id or f"{args.host}:{args.port}",
        TrivialElection(),
        mode=args.mode,
        tick_interval=args.tick_interval,
        native_store=True,
        solver_dtype=args.solver_dtype,
        scoped_solve=args.scoped_solve,
        tick_pipeline_depth=args.tick_pipeline_depth,
        device=args.device,
    )
    port = await server.start(args.port, host=args.host)
    log.info("serving gRPC on %s:%d (tick device %s)", args.host, port,
             server.device)
    await server.load_config(repo)
    log.info("config loaded (%d templates)", len(repo.resources))
    if on_started is not None:
        on_started(server)
    try:
        await asyncio.Event().wait()
    finally:
        await server.stop()


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    try:
        asyncio.run(serve(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
