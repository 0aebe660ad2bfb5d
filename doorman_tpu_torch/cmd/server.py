"""The doorman server binary, PyTorch port.

    python -m doorman_tpu_torch.cmd.server --config file:cfg.yml \\
        [--mode immediate|batch] [--native-store] [--no-fused-tick] \\
        [--device cuda] [--solver-dtype f32] \\
        [--stream-push [--max-streams-per-band N] [--stream-shards N]] \\
        [--minimum-refresh-interval S]
    python -m doorman_tpu_torch.cmd.server --parent HOST:PORT [...]

Loads the YAML config once (file: source), runs the trivial election
and serves the Capacity gRPC service. `--parent` makes the server an
intermediate of the capacity tree: it leases its capacity from that
server and configures itself from the grants, so it needs no --config
(a root does). The defaults are the reference's:
`--mode immediate` (each request answered by its resource's scalar
algorithm, no device work) on the Python lease store. `--mode batch`
ticks the batched solve on `--device` (default cuda; a machine without
a GPU must pass --device cpu, which every mode checks); `--native-store`
backs the stores with the C++ engine and its device-resident tick, whose
`--no-fused-tick` round-trip variant is kept for baselines and triage.
`--stream-push` serves WatchCapacity: lease deltas pushed at tick edges.
Flags not listed here — etcd election and config, persistence,
admission, the frontend pool, federation, TLS (the server's own and
--parent-tls / --parent-tls-ca), the debug pages — are not ported yet.
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
    p.add_argument("--parent", default="",
                   help="parent server address; empty means root")
    p.add_argument("--config", default="",
                   help='config source: "file:<path>" (a root needs '
                        "one; an intermediate configures itself from its "
                        "parent's grants)")
    p.add_argument("--mode", choices=("immediate", "batch"),
                   default="immediate",
                   help="allocation mode: per-request scalar or per-tick "
                        "batched device solve")
    p.add_argument("--native-store", action="store_true",
                   help="back lease stores with the C++ engine (an error "
                        "if it cannot be built)")
    p.add_argument("--device", default="cuda",
                   help="device of the batch tick: cuda (default) or cpu")
    p.add_argument("--tick-interval", type=float, default=1.0,
                   help="seconds between device solves")
    p.add_argument("--solver-dtype", choices=("f32", "f64"), default="f64",
                   help="batch solve precision; both run the CUDA kernels")
    p.add_argument("--fused-tick", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="batch mode, native store: run the resident tick "
                        "as one staged upload, one solve window and one "
                        "download (byte-identical; --no-fused-tick keeps "
                        "the round-trip tick, a placement per staged block "
                        "and a full-table solve every tick, for baselines "
                        "and triage)")
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
    p.add_argument("--stream-push", action="store_true",
                   help="serve WatchCapacity: clients hold one stream "
                        "and lease deltas are pushed at tick edges "
                        "instead of answering per-interval polls; off "
                        "leaves WatchCapacity UNIMPLEMENTED and "
                        "stream-mode clients fall back to polling")
    p.add_argument("--max-streams-per-band", type=int, default=0,
                   help="stream push: cap on open WatchCapacity "
                        "streams PER priority band — establishment "
                        "past it sheds with RESOURCE_EXHAUSTED + "
                        "retry-after so fanout cannot starve the "
                        "tick; 0 = unlimited")
    p.add_argument("--stream-shards", type=int, default=1,
                   help="stream push: partition subscribers across "
                        "this many fanout shards (stable client-id "
                        "hash), each owning its subs/queues/refresh "
                        "wheel; on the native store the tick-edge "
                        "decide+serialize passes fan to worker threads. "
                        "1 = the unsharded path")
    p.add_argument("--minimum-refresh-interval", type=float, default=5.0,
                   help="floor for client refresh intervals (the "
                        "streams' silent-refresh cadence)")
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
    if not (args.config or args.parent):
        raise SystemExit("a root server needs --config")
    repo = read_config(args.config) if args.config else None
    server = CapacityServer(
        args.server_id or f"{args.host}:{args.port}",
        TrivialElection(),
        parent_addr=args.parent,
        mode=args.mode,
        tick_interval=args.tick_interval,
        native_store=args.native_store,
        solver_dtype=args.solver_dtype,
        fused_tick=args.fused_tick,
        scoped_solve=args.scoped_solve,
        tick_pipeline_depth=args.tick_pipeline_depth,
        minimum_refresh_interval=args.minimum_refresh_interval,
        stream_push=args.stream_push,
        max_streams_per_band=args.max_streams_per_band,
        stream_shards=args.stream_shards,
        device=args.device,
    )
    port = await server.start(args.port, host=args.host)
    log.info("serving gRPC on %s:%d (%s mode, %s store, tick device %s)",
             args.host, port, server.mode,
             "native" if args.native_store else "Python", server.device)
    if repo is not None:
        await server.load_config(repo)
        log.info("config loaded (%d templates)", len(repo.resources))
    else:
        log.info("intermediate of %s: configured from its grants",
                 args.parent)
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
