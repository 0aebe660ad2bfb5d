"""The fleet head binary: real shard processes under the RPC beat.

    python -m doorman_tpu_torch.cmd.fleet --smoke [--mode batch \\
        --native-store] [--device cuda|cpu] [--out verdict.json]

`python -m doorman_tpu_torch.cmd.fleet` supervises N `cmd.server` shard
processes (fleet/supervisor.py), serves the reconcile-beat gRPC head
(fleet/rpc.py) they report to, and owns live resharding: `--smoke`
runs the CI arc — bring up 2 shards, drive client load over loopback
gRPC, verify the beat reconciles the straddling capacity, reshard
LIVE to 3 shards, and assert the fed_capacity_sum invariant
(Σ reported shard grants ≤ configured capacity) on every beat round
of the whole run, handoff included.

Serve mode (no --smoke) runs the same machinery open-ended and logs
fleet status; scale with SIGHUP-less simplicity — restart with a new
--shards, per-shard persist namespaces make the M≠N restart warm
(doc/operations.md has the runbook).

Exit 0 on success. On smoke failure: diagnostics + head status to
stderr, shard logs retained in --log-dir for CI artifact upload,
exit 1.

Port of doorman_tpu/cmd/fleet.py. The shards are the port's server
binary: `--mode` and `--native-store` pass through to each of them,
and `--device` ("cuda" by default, "cpu" only when asked) is their tick
device, so
`--smoke --mode batch --native-store` ticks every shard's resident
K1/K2 solve on the card. The smoke's verdict also carries, from each
shard's log, the tick device it served on and the ticks it ran.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import re
import sys
import tempfile
import time

import grpc

log = logging.getLogger("doorman.fleet")

CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 120
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 3,
              refresh_interval: 1, learning_mode_duration: 0}
"""

EPS = 1e-6
# The shards' batch tick: a few ticks a beat round, so a batch-mode
# smoke converges within its rounds.
SHARD_TICK_INTERVAL = 0.25


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="doorman-fleet",
        description="fleet head: shard supervisor + RPC reconcile beat",
    )
    p.add_argument("--shards", type=int, default=2,
                   help="initial active shard count")
    p.add_argument("--straddle", default="r0",
                   help="comma-separated straddling resource ids")
    p.add_argument("--config", default="",
                   help="YAML resource config served to every shard "
                        "(default: a built-in 120-capacity "
                        "PROPORTIONAL_SHARE repo)")
    p.add_argument("--share-ttl", type=float, default=2.0,
                   help="straddle share lease ttl installed by the "
                        "beat (a small multiple of the report "
                        "interval)")
    p.add_argument("--report-interval", type=float, default=0.5,
                   help="shard beat report cadence")
    p.add_argument("--persist", default="",
                   help="persist backend shared by the shards "
                        "('file:<dir>'); per-shard namespaces ride "
                        "--shard, so M≠N restarts stay warm")
    p.add_argument("--log-dir", default="",
                   help="directory for per-shard process logs "
                        "(default: a temp dir; CI uploads it on "
                        "failure)")
    p.add_argument("--smoke", action="store_true",
                   help="run the CI arc: 2 shards, loopback beat, "
                        "live reshard 2->3, fed_capacity_sum asserted "
                        "every beat round; exit 0/1")
    p.add_argument("--reshard-to", type=int, default=3,
                   help="smoke: shard count after the live reshard")
    p.add_argument("--rounds", type=int, default=8,
                   help="smoke: beat rounds to hold before AND after "
                        "the reshard")
    p.add_argument("--timeout", type=float, default=180.0,
                   help="smoke: overall wall-clock budget in seconds")
    p.add_argument("--out", default="",
                   help="smoke: write the JSON verdict here")
    p.add_argument("--mode", choices=("immediate", "batch"),
                   default="immediate",
                   help="the shards' allocation mode (cmd.server --mode)")
    p.add_argument("--native-store", action="store_true",
                   help="back the shards' lease stores with the C++ "
                        "engine and its device-resident tick")
    p.add_argument("--device", default="cuda",
                   help="the shards' tick device: cuda (default) or cpu")
    p.add_argument("--log-level", default="info")
    return p


def _supervisor(args, config_path, beat_port, straddle, log_dir):
    from doorman_tpu_torch.fleet.supervisor import FleetSupervisor

    return FleetSupervisor(
        config_path,
        beat_addr=f"127.0.0.1:{beat_port}",
        straddle=straddle,
        report_interval=args.report_interval,
        persist=args.persist,
        mode=args.mode,
        native_store=args.native_store,
        device=args.device,
        log_dir=log_dir,
        extra_args=["--tick-interval", str(SHARD_TICK_INTERVAL)],
    )


_DEVICE_LINE = re.compile(r"tick device (\S+?),")
_STOP_LINE = re.compile(r"stopped after (\d+) ticks")


def shard_logs(sup) -> dict:
    """{shard: {"device", "ticks"}} read from each stopped shard's log:
    the tick device of its startup line and the ticks of its shutdown
    line (None where a line is missing)."""
    out = {}
    for i, sp in sorted(sup.shards.items()):
        device = ticks = None
        if sp.log_path and os.path.exists(sp.log_path):
            with open(sp.log_path, errors="replace") as f:
                text = f.read()
            m = _DEVICE_LINE.search(text)
            device = m.group(1) if m else None
            m = _STOP_LINE.search(text)
            ticks = int(m.group(1)) if m else None
        out[str(i)] = {"device": device, "ticks": ticks,
                       "rc": sp.proc.returncode}
    return out


def _write_config(args) -> str:
    if args.config:
        return args.config
    fd, path = tempfile.mkstemp(prefix="doorman-fleet-", suffix=".yaml")
    with os.fdopen(fd, "w") as f:
        f.write(CONFIG)
    return path


def _template_fn(config_path: str):
    """BeatCore's template source: the SAME config file the shards
    serve — one copy of truth for capacity/lane/lease_length."""
    from doorman_tpu_torch.core.resource import algo_kind_for
    from doorman_tpu_torch.server import config as config_mod

    with open(config_path) as f:
        repo = config_mod.parse_yaml_config(f.read())

    def template(rid: str):
        tpl = config_mod.find_template(repo, rid)
        if tpl is None:
            return None
        return (
            float(tpl.capacity),
            algo_kind_for(tpl),
            float(tpl.algorithm.lease_length),
        )

    return template


class _LoadClient:
    """A minimal refresh loop: claim `wants` of one resource against
    one shard over plain gRPC, reporting `has` back like a real client
    (the smoke wants live stores on the shards, not fakes)."""

    def __init__(self, addr: str, client_id: str, rid: str, wants: float):
        from doorman_tpu_torch.proto.grpc_api import CapacityStub

        self.addr = addr
        self.client_id = client_id
        self.rid = rid
        self.wants = float(wants)
        self.has = 0.0
        self.refreshes = 0
        self._channel = grpc.aio.insecure_channel(addr)
        self._stub = CapacityStub(self._channel)

    async def refresh(self) -> float:
        from doorman_tpu_torch.proto import doorman_pb2 as pb

        req = pb.GetCapacityRequest(client_id=self.client_id)
        rr = req.resource.add()
        rr.resource_id = self.rid
        rr.wants = self.wants
        rr.has.capacity = self.has
        resp = await self._stub.GetCapacity(req, timeout=5.0)
        for r in resp.response:
            if r.resource_id == self.rid:
                self.has = r.gets.capacity
        self.refreshes += 1
        return self.has

    async def close(self) -> None:
        await self._channel.close()


async def _smoke(args) -> int:
    from doorman_tpu_torch.fleet.beat import BeatCore
    from doorman_tpu_torch.fleet.rpc import serve_beat

    deadline = time.monotonic() + args.timeout
    straddle = [r.strip() for r in args.straddle.split(",") if r.strip()]
    config_path = _write_config(args)
    log_dir = args.log_dir or tempfile.mkdtemp(prefix="doorman-fleet-logs-")
    core = BeatCore(
        _template_fn(config_path),
        expected=range(args.shards),
        share_ttl=args.share_ttl,
        stale_after=3.0 * args.report_interval,
    )
    beat_server, beat_port = await serve_beat(core)
    sup = _supervisor(args, config_path, beat_port, straddle, log_dir)
    verdict = {
        "smoke": "fleet",
        "mode": args.mode,
        "native_store": args.native_store,
        "device": args.device,
        "shards": args.shards,
        "reshard_to": args.reshard_to,
        "straddle": straddle,
        "rounds": [],
        "ok": False,
    }
    clients = []
    rid = straddle[0]
    capacity = core._template(rid)[0]

    def check_round(phase: str) -> None:
        sums = core.has_sums()
        total = sums.get(rid, 0.0)
        verdict["rounds"].append(
            {"phase": phase, "has_sum": round(total, 6),
             "reports": core.reports}
        )
        if total > capacity + EPS:
            raise AssertionError(
                f"fed_capacity_sum violated in {phase}: "
                f"{total} > {capacity}"
            )

    try:
        for i in range(args.shards):
            sup.spawn(i, args.shards)
        for i in range(args.shards):
            await sup.wait_ready(
                i, timeout=max(deadline - time.monotonic(), 1.0)
            )
        # Two clients on shard 0, one on shard 1 — underloaded, so the
        # steady state is wants-granted and byte-stable.
        addrs = sup.addrs()
        clients = [
            _LoadClient(addrs[0], "c-a", rid, 30.0),
            _LoadClient(addrs[0], "c-b", rid, 15.0),
            _LoadClient(addrs[1], "c-c", rid, 20.0),
        ]

        async def drive_round(phase: str) -> None:
            for c in clients:
                await c.refresh()
            await asyncio.sleep(args.report_interval)
            check_round(phase)
            if time.monotonic() > deadline:
                raise TimeoutError("smoke exceeded --timeout")

        for _ in range(args.rounds):
            await drive_round("pre")
        pre = {c.client_id: c.has for c in clients}
        if any(abs(c.has - c.wants) > EPS for c in clients):
            raise AssertionError(
                f"underloaded steady state not reached: "
                f"{[(c.client_id, c.has, c.wants) for c in clients]}"
            )

        # LIVE reshard 2 -> 3: spawn the new shard, widen the beat's
        # expected set, keep the invariant every round of the handoff.
        log.info("live reshard %d -> %d", args.shards, args.reshard_to)
        for i in range(args.shards, args.reshard_to):
            sup.spawn(i, args.reshard_to)
        for i in range(args.shards, args.reshard_to):
            await sup.wait_ready(
                i, timeout=max(deadline - time.monotonic(), 1.0)
            )
        core.set_expected(range(args.reshard_to))
        addrs = sup.addrs()
        new_client = _LoadClient(addrs[args.reshard_to - 1], "c-new",
                                 rid, 10.0)
        clients.append(new_client)
        for _ in range(args.rounds):
            await drive_round("handoff")
        # Healthy clients' grants are unchanged bytes; the new shard
        # joined the straddle (its client is being served and its
        # share is installed at the head).
        for c in clients[:3]:
            if c.has != pre[c.client_id]:
                raise AssertionError(
                    f"healthy client {c.client_id} grant moved: "
                    f"{pre[c.client_id]} -> {c.has}"
                )
        if abs(new_client.has - new_client.wants) > EPS:
            raise AssertionError(
                f"new shard's client not converged: "
                f"{new_client.has} != {new_client.wants}"
            )
        shares = core.status()["resources"][rid]["reconciler"]["shares"]
        if args.reshard_to - 1 not in shares:
            raise AssertionError(
                f"new shard has no installed share: {shares}"
            )
        verdict["ok"] = True
        verdict["pre_grants"] = {k: round(v, 6) for k, v in pre.items()}
        verdict["shares"] = {
            str(s): round(v["value"], 6) for s, v in shares.items()
        }
        log.info("fleet smoke OK: %d beat rounds, shares %s",
                 len(verdict["rounds"]), verdict["shares"])
        return 0
    except Exception as e:
        verdict["error"] = repr(e)
        verdict["head_status"] = core.status()
        verdict["supervisor"] = sup.status()
        print(f"fleet smoke FAILED: {e!r}", file=sys.stderr)
        print(json.dumps(verdict["supervisor"], indent=2),
              file=sys.stderr)
        print(f"shard logs in {log_dir}", file=sys.stderr)
        return 1
    finally:
        for c in clients:
            try:
                await c.close()
            except Exception:
                pass
        sup.stop_all()
        verdict["shard_logs"] = shard_logs(sup)
        await beat_server.stop(grace=1.0)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(verdict, f, indent=2, sort_keys=True)


async def _serve(args) -> int:
    from doorman_tpu_torch.fleet.beat import BeatCore
    from doorman_tpu_torch.fleet.rpc import serve_beat

    straddle = [r.strip() for r in args.straddle.split(",") if r.strip()]
    config_path = _write_config(args)
    core = BeatCore(
        _template_fn(config_path),
        expected=range(args.shards),
        share_ttl=args.share_ttl,
    )
    beat_server, beat_port = await serve_beat(core)
    sup = _supervisor(args, config_path, beat_port, straddle,
                      args.log_dir or None)
    try:
        for i in range(args.shards):
            sup.spawn(i, args.shards)
        for i in range(args.shards):
            await sup.wait_ready(i)
        log.info("fleet up: %d shards, beat on :%d",
                 args.shards, beat_port)
        while True:
            await asyncio.sleep(10.0)
            log.info("fleet status: %s",
                     json.dumps(core.has_sums(), sort_keys=True))
    finally:
        sup.stop_all()
        await beat_server.stop(grace=1.0)
    return 0


def main(argv=None) -> None:
    parser = make_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    if args.smoke:
        raise SystemExit(asyncio.run(_smoke(args)))
    try:
        raise SystemExit(asyncio.run(_serve(args)))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
