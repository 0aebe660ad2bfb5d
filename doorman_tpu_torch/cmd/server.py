"""The doorman server binary, PyTorch port.

    python -m doorman_tpu_torch.cmd.server --config file:cfg.yml|etcd:KEY \\
        [--etcd-endpoints H:P,...] [--master-election-lock KEY \\
         [--master-delay S]] [--persist file:DIR|etcd:PREFIX \\
         [--snapshot-interval S]] \\
        [--mode immediate|batch] [--native-store] [--no-fused-tick] \\
        [--device cuda] [--solver-dtype f32] \\
        [--stream-push [--max-streams-per-band N] [--stream-shards N]] \\
        [--admission [--coalesce-window S] [--admission-max-rps R] \\
         [--fuse-admission]] \\
        [--frontend-workers N [--frontend-ring-bytes B]] \\
        [--minimum-refresh-interval S] [--debug-port N] [--shard i/N] \\
        [--profile-dir DIR [--profile-ticks N]] [--trace [--trace-buffer N]] \\
        [--flightrec-buffer N] [--flightrec-dir DIR] \\
        [--history-dir DIR [--history-buffer N]] [--audit-sample K] [--detect]
    python -m doorman_tpu_torch.cmd.server --parent HOST:PORT [...]

Loads the YAML config from a file (re-read on SIGHUP) or an etcd key
(watched), keeps the last good config when a new version fails to load,
runs the trivial election or, with --master-election-lock, an etcd TTL
lock election (--master-delay is the lock's TTL), and serves the
Capacity gRPC service. `--persist` keeps the lease state durable
(snapshots every --snapshot-interval seconds plus a journal, in a
directory or under an etcd prefix), so a new master restores it and
skips or shortens learning mode. `--parent` makes the server an
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
`--shard i/N` makes the server root shard i of a federation of N: the
election lock gets the suffix /shard<i>, `--persist` is namespaced under
shard<i>, and the shard index rides status() and every flight record.
`--admission` puts the RPC admission front-end before GetCapacity and
WatchCapacity: coalesced GetCapacity windows of `--coalesce-window`
seconds, AIMD shedding by priority band (`--admission-max-rps` is the
hard offered-load budget) with the doorman-retry-after trailer, and
deadline fast-fail; `--fuse-admission` (batch mode, with --admission and
--native-store) lets each window pre-pack the rows it wrote into the
resident tick's staging. `--frontend-workers N` (with --stream-push)
serves the public port from N SO_REUSEPORT listener worker processes
over per-worker push rings of `--frontend-ring-bytes`, the tick process
moving to a loopback backend port.
The debug pages (/debug/status, /metrics, /debug/traces, /debug/flightrec,
...) listen on `--debug-port` (15050; 0 picks one, -1 disables);
`--profile-dir` writes a torch.profiler Chrome trace of the first
`--profile-ticks` batch ticks; the other observability flags are the
reference's. Flags not listed here — the fleet (--fleet-beat,
--fleet-straddle, --fleet-report-interval), TLS (the server's own,
--frontend-tls-cert / --frontend-tls-key and --parent-tls /
--parent-tls-ca) — are not ported yet.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys

from doorman_tpu_torch.obs.debug import DebugServer, add_status_part
from doorman_tpu_torch.obs.metrics import (
    Registry,
    default_registry,
    instrument_server,
)
from doorman_tpu_torch.obs.trace import default_tracer
from doorman_tpu_torch.server import config as config_mod
from doorman_tpu_torch.server import sources
from doorman_tpu_torch.server.election import (
    EtcdKV,
    KVElection,
    TrivialElection,
    shard_lock_key,
)
from doorman_tpu_torch.server.server import CapacityServer

log = logging.getLogger("doorman.server")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="doorman-server",
        description="doorman capacity server (PyTorch/CUDA port)",
    )
    p.add_argument("--port", type=int, default=15000,
                   help="port to bind the gRPC service to")
    p.add_argument("--debug-port", type=int, default=15050,
                   help="port for the debug HTTP pages "
                        "(0 picks one, -1 disables)")
    p.add_argument("--host", default="[::]", help="address to bind")
    p.add_argument("--server-id", default="",
                   help="this server's id (default: host:port)")
    p.add_argument("--parent", default="",
                   help="parent server address; empty means root")
    p.add_argument("--config", default="",
                   help='config source: "file:<path>" or "etcd:<key>" '
                        "(a root needs one; an intermediate configures "
                        "itself from its parent's grants)")
    p.add_argument("--etcd-endpoints", default="",
                   help="comma-separated etcd endpoints")
    p.add_argument("--master-election-lock", default="",
                   help="etcd key for master election (empty: no election)")
    p.add_argument("--master-delay", type=float, default=10.0,
                   help="master lease TTL in seconds")
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
    p.add_argument("--shard", default="",
                   help="federated root shard identity as 'i/N' (shard "
                        "i of N): suffixes the election lock with "
                        "/shard<i> (per-shard mastership), namespaces "
                        "--persist under shard<i> (per-shard "
                        "journal/snapshot, warm takeover stays "
                        "per-shard), and stamps the shard index on "
                        "status pages and flight-recorder records. "
                        "Every candidate of one shard passes the SAME "
                        "value; clients route with the same N")
    p.add_argument("--admission", action="store_true",
                   help="enable the RPC admission front-end: coalesced "
                        "GetCapacity decisions, AIMD overload shedding "
                        "by priority band (lowest bands first; never "
                        "ReleaseCapacity/GetServerCapacity), and "
                        "deadline fast-fail; shed responses carry a "
                        "doorman-retry-after hint")
    p.add_argument("--coalesce-window", type=float, default=0.005,
                   help="admission: seconds per micro-batch window — "
                        "concurrent GetCapacity RPCs in a window "
                        "resolve with one grouped decision pass "
                        "(byte-identical to per-request; 0 disables "
                        "coalescing but keeps shedding)")
    p.add_argument("--admission-max-rps", type=float, default=0.0,
                   help="admission: hard offered-load budget in "
                        "requests/second — arrivals past it shed "
                        "within the window; 0 leaves overload "
                        "detection to the latency/queue/tick-lag "
                        "signals alone")
    p.add_argument("--fuse-admission", action="store_true",
                   help="admission + batch mode: fuse the coalescer's "
                        "micro-batch windows into the resident "
                        "solver's dirty-row staging — each window "
                        "pre-packs the rows it wrote, moving the "
                        "store pack off the tick's critical path "
                        "(byte-identical to the unfused tick; needs "
                        "--admission and --native-store)")
    p.add_argument("--frontend-workers", type=int, default=0,
                   help="serving-plane scale-out: run this many "
                        "SO_REUSEPORT listener worker PROCESSES on "
                        "--port and move the gRPC backend to an "
                        "ephemeral loopback port — workers hold the "
                        "WatchCapacity streams (pushes fan out over "
                        "per-worker shared-memory rings, zero "
                        "re-encode) and forward unary RPCs to the tick "
                        "process; a dead worker's streams reset to "
                        "redirects and it respawns with a fresh ring "
                        "cursor. Needs --stream-push; 0 keeps the "
                        "single-process server")
    p.add_argument("--frontend-ring-bytes", type=int, default=1 << 22,
                   help="per-worker push-ring capacity in bytes; size "
                        "to hold a few ticks of push traffic — a "
                        "worker that falls a full ring behind laps and "
                        "resets its streams loudly")
    p.add_argument("--minimum-refresh-interval", type=float, default=5.0,
                   help="floor for client refresh intervals (the "
                        "streams' silent-refresh cadence)")
    p.add_argument("--profile-dir", default="",
                   help="batch mode: write a torch.profiler Chrome trace "
                        "(CPU ops, CUDA kernels and copies) of the first "
                        "--profile-ticks ticks to this directory")
    p.add_argument("--profile-ticks", type=int, default=8)
    p.add_argument("--trace", action="store_true",
                   help="enable the span tracer: client/server/solver "
                        "spans land in a ring buffer served at "
                        "/debug/traces (?format=chrome for Perfetto)")
    p.add_argument("--trace-buffer", type=int, default=65536,
                   help="span ring-buffer capacity (with --trace)")
    p.add_argument("--flightrec-buffer", type=int, default=512,
                   help="per-tick flight-recorder ring capacity: each "
                        "tick records phase laps, solve mode, dispatch "
                        "counts, mastership epoch and a store digest; "
                        "auto-dumped on an unhandled tick exception and "
                        "served at /debug/flightrec (0 disables)")
    p.add_argument("--flightrec-dir", default="",
                   help="directory for flight-recorder auto-dumps "
                        "(JSON + Chrome-trace overlay per dump); "
                        "defaults to $DOORMAN_FLIGHTREC_DIR, empty "
                        "keeps dumps in-memory only")
    p.add_argument("--history-dir", default="",
                   help="durable flight-record history: per-tick "
                        "records append to checksummed segment files "
                        "in this directory (torn-tail tolerant) and "
                        "are replayed at startup, so SLO windows and "
                        "trajectory deltas span restarts; served at "
                        "/debug/history and queryable offline with "
                        "python -m doorman_tpu_torch.cmd.obs (empty "
                        "disables)")
    p.add_argument("--history-buffer", type=int, default=4096,
                   help="history raw-ring capacity (decimated tiers "
                        "extend past it at bounded memory)")
    p.add_argument("--audit-sample", type=int, default=0,
                   help="shadow-oracle audit: every K ticks (and on "
                        "every solve_mode transition) replay each "
                        "store's staged inputs through the numpy host "
                        "oracles off the hot path and compare grants "
                        "bit-exactly (few-ulp for iterative lanes); a "
                        "two-strike-confirmed divergence raises the "
                        "doorman_audit_divergence counter, a flight-"
                        "recorder error + auto-dump, and a standing "
                        "failing SLO gate (0 disables)")
    p.add_argument("--detect", action="store_true",
                   help="online anomaly detection over the per-tick "
                        "record streams (tick wall ms, dispatch "
                        "accounting, scoped rows) with EWMA + MAD "
                        "robust z-scores; detections land as "
                        "detect.anomaly trace instants, chrome-overlay "
                        "tracks and an SLO verdict")
    p.add_argument("--persist", default="",
                   help="durable lease-state snapshots + journal for "
                        "warm master takeover: 'file:<dir>' (shared "
                        "storage for cross-machine takeover) or "
                        "'etcd:<key-prefix>' (chunked keys via "
                        "--etcd-endpoints); empty disables (cold "
                        "wipe-and-relearn takeovers)")
    p.add_argument("--snapshot-interval", type=float, default=30.0,
                   help="seconds between full state snapshots (journal "
                        "deltas cover the gaps)")
    p.add_argument("--log-level", default="info",
                   help="debug/info/warning/error")
    return p


def parse_shard(spec: str):
    """The shard index of an '--shard i/N' value (None when empty). N is
    the deployment's shard count, checked here; routing uses the same N
    client-side through federation.ShardRouter. A malformed value exits
    with status 2, as the reference."""
    if not spec:
        return None
    try:
        shard_str, _, count_str = spec.partition("/")
        shard, shard_count = int(shard_str), int(count_str)
        if not 0 <= shard < shard_count:
            raise ValueError
    except ValueError:
        log.error("--shard wants 'i/N' with 0 <= i < N, got %r", spec)
        raise SystemExit(2)
    log.info("federated root shard %d of %d", shard, shard_count)
    return shard


async def serve(args: argparse.Namespace, on_started=None) -> None:
    """Run the server until cancelled. `on_started(server, debug_server)`
    fires once the gRPC (and debug, if enabled) listeners are bound and
    the first config has loaded — tests and embedders use it to learn
    the ephemeral ports."""
    if not (args.config or args.parent):
        raise SystemExit("a root server needs --config")
    etcd_endpoints = [
        e.strip() for e in args.etcd_endpoints.split(",") if e.strip()
    ]
    shard = parse_shard(args.shard)
    source = None
    if args.config:
        # Root servers load config from a source and hot-reload it
        # (doorman_server.go:204-221); a bad prefix fails startup here.
        # Intermediates self-configure from parent grants instead
        # (server.go:276-311).
        source = sources.parse_source(
            args.config,
            etcd_endpoints=etcd_endpoints,
            loop=asyncio.get_running_loop(),
        )
    if args.master_election_lock:
        lock = args.master_election_lock
        if shard is not None:
            # Per-shard mastership: shard k's candidates campaign for
            # <lock>/shard<k> — N concurrent masters off one etcd
            # namespace, and one shard's failover never disturbs the
            # others (election.shard_lock_key).
            lock = shard_lock_key(lock, shard)
        election = KVElection(
            EtcdKV(etcd_endpoints),
            lock,
            ttl=args.master_delay,
        )
    else:
        election = TrivialElection()

    persist = None
    if args.persist:
        from doorman_tpu_torch.persist import PersistManager, parse_backend

        persist = PersistManager(
            parse_backend(
                args.persist,
                etcd_endpoints=etcd_endpoints,
                # Per-shard durability namespace: warm takeover restores
                # exactly this shard's slice, never a sibling's.
                namespace=f"shard{shard}" if shard is not None else "",
            ),
            snapshot_interval=args.snapshot_interval,
            flush_interval=min(args.tick_interval, 1.0),
        )
        log.info("persistence enabled: %s (snapshot every %.1fs)",
                 args.persist, args.snapshot_interval)

    admission = None
    if args.admission:
        from doorman_tpu_torch.admission import Admission

        admission = Admission(
            coalesce_window=args.coalesce_window,
            max_rps=args.admission_max_rps or None,
        )
        log.info(
            "admission control enabled (coalesce window %.3fs, "
            "max rps %s)", args.coalesce_window,
            args.admission_max_rps or "unbounded",
        )
    if args.fuse_admission and admission is None:
        # Loud, not fatal: the server-side guard ignores fusion without
        # a coalescing write path, and a silently-ignored perf flag is
        # an operator trap.
        log.warning(
            "--fuse-admission has no effect without --admission "
            "(the coalescer's windows are the tracked write path)"
        )
    if args.fuse_admission and not args.native_store:
        # The staging cache lives in the native store's resident solver.
        log.warning(
            "--fuse-admission has no effect without --native-store "
            "(the staging cache feeds the native store's resident tick)"
        )
    if args.frontend_workers > 0 and not args.stream_push:
        log.error("--frontend-workers needs --stream-push (the "
                  "workers exist to hold WatchCapacity streams)")
        raise SystemExit(2)

    server = CapacityServer(
        args.server_id or f"{args.host}:{args.port}",
        election,
        parent_addr=args.parent,
        mode=args.mode,
        tick_interval=args.tick_interval,
        native_store=args.native_store,
        solver_dtype=args.solver_dtype,
        persist=persist,
        fused_tick=args.fused_tick,
        scoped_solve=args.scoped_solve,
        tick_pipeline_depth=args.tick_pipeline_depth,
        minimum_refresh_interval=args.minimum_refresh_interval,
        stream_push=args.stream_push,
        max_streams_per_band=args.max_streams_per_band,
        stream_shards=args.stream_shards,
        profile_dir=args.profile_dir or None,
        profile_ticks=args.profile_ticks,
        flightrec_capacity=args.flightrec_buffer,
        flightrec_dir=args.flightrec_dir or None,
        history_dir=args.history_dir or None,
        history_capacity=args.history_buffer,
        audit_sample=args.audit_sample,
        detect=args.detect,
        shard=shard,
        admission=admission,
        fuse_admission=args.fuse_admission,
        device=args.device,
    )
    if args.history_dir:
        log.info("durable history in %s (run %d, replayed %d records)",
                 args.history_dir, server.history.run,
                 len(server.history.records()))
    if args.audit_sample:
        log.info("shadow-oracle audit every %d ticks", args.audit_sample)
    frontend = None
    if args.frontend_workers > 0:
        # Construct BEFORE start(): the pool's control surface
        # (Establish/Drop/Heartbeat) registers on the backend gRPC
        # server at start().
        frontend = server.attach_frontend(
            args.frontend_workers,
            ring_bytes=args.frontend_ring_bytes,
            inline=False,
            ramp_window=args.coalesce_window if args.admission else 0.0,
        )
        # The tick process retreats to an ephemeral loopback backend;
        # the workers own the public port via SO_REUSEPORT.
        backend_port = await server.start(0, host="127.0.0.1")
        await frontend.start(
            f"{args.host}:{args.port}", f"127.0.0.1:{backend_port}",
        )
        log.info("serving gRPC on %s:%d via %d frontend workers "
                 "(backend 127.0.0.1:%d)", args.host, args.port,
                 args.frontend_workers, backend_port)
    else:
        port = await server.start(args.port, host=args.host)
        log.info("serving gRPC on %s:%d (%s mode, %s store, tick device "
                 "%s)", args.host, port, server.mode,
                 "native" if args.native_store else "Python",
                 server.device)
    if args.trace:
        default_tracer().enable(capacity=args.trace_buffer)
        log.info("span tracer enabled (ring %d); see /debug/traces",
                 args.trace_buffer)
    debug = None
    if args.debug_port >= 0:
        # A fresh registry per serve() call: repeated serves in one
        # process must not accumulate collectors for dead servers; the
        # process-global default registry (tick-phase histograms) is
        # re-exported at scrape time so /metrics stays one surface.
        registry = instrument_server(server, Registry())
        registry.add_collector(default_registry().metrics)
        debug = DebugServer(port=args.debug_port, registry=registry)
        debug.add_server(server, asyncio.get_running_loop())
        add_status_part(
            "flags",
            lambda: "<pre>" + "\n".join(sys.argv[1:]) + "</pre>",
        )
        debug.start()
        log.info("debug pages on :%d", debug.port)
    config_task = None
    if source is not None:

        async def reload_loop():
            while True:
                try:
                    data = await source()
                    repo = config_mod.parse_yaml_config(data.decode())
                    await server.load_config(repo)
                    log.info("config loaded (%d templates)",
                             len(repo.resources))
                except asyncio.CancelledError:
                    raise
                except Exception:
                    # A bad or unreadable config version must not kill the
                    # reload task; keep serving the last good config.
                    log.exception("config load failed; keeping previous")
                    await asyncio.sleep(1.0)

        config_task = asyncio.create_task(reload_loop())
    else:
        log.info("intermediate of %s: configured from its grants",
                 args.parent)
    try:
        await server.wait_until_configured()
        log.info("configured; serving")
        if on_started is not None:
            on_started(server, debug)
        await asyncio.Event().wait()
    finally:
        if config_task is not None:
            config_task.cancel()
        if debug is not None:
            debug.stop()
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
