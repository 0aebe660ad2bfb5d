"""Chaos CLI: run a fault plan against the real stack and print the
verdict.

    python -m doorman_tpu_torch.cmd.chaos --plan master_flap
    python -m doorman_tpu_torch.cmd.chaos --plan /path/to/plan.json
    python -m doorman_tpu_torch.cmd.chaos --list
    python -m doorman_tpu_torch.cmd.chaos --save-plan master_flap plan.json

Exit code 0 when every invariant held and the allocation reconverged
within the plan's budget; 1 otherwise. The verdict (JSON, one object)
goes to stdout — the event_log and log_sha256 in it are the replay
contract: rerunning the same plan file reproduces them byte-for-byte.

`--device` is the device every server of the run ticks on: cuda
unless the caller asks for cpu. The tick device and each batch server's
applied ticks go to stderr, so the verdict on stdout stays the replay
contract.

Port of doorman_tpu/cmd/chaos.py: a copy apart from import paths and
`--device`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

from doorman_tpu_torch.chaos.plan import FaultPlan
from doorman_tpu_torch.chaos.plans import PLANS, get_plan
from doorman_tpu_torch.chaos.runner import ChaosRunner
from doorman_tpu_torch.utils import flagenv


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="doorman-chaos",
        description="run a doorman-tpu chaos fault plan",
    )
    p.add_argument("--plan", default="",
                   help="shipped plan name or path to a plan JSON file")
    p.add_argument("--list", action="store_true",
                   help="list shipped plans and exit")
    p.add_argument("--save-plan", nargs=2, metavar=("NAME", "PATH"),
                   default=None,
                   help="write a shipped plan's JSON to PATH and exit")
    p.add_argument("--out", default="",
                   help="also write the verdict JSON to this path")
    p.add_argument("--trace", default="",
                   help="write the run's virtual-time event log as a "
                        "Chrome trace (open in Perfetto) to this path")
    p.add_argument("--flightrec", default="",
                   help="write the run's flight-recorder dump (the "
                        "violation-triggered dump when one fired, else "
                        "an on-demand dump of the full ring) to this "
                        "path, plus a Chrome-trace overlay beside it")
    p.add_argument("--history-dir", default="",
                   help="persist the run's per-tick history records as "
                        "durable segments here (queryable afterwards "
                        "with `python -m doorman_tpu_torch.cmd.obs`; CI "
                        "uploads these as failure artifacts)")
    p.add_argument("--device", default="cuda",
                   help="device of the servers' batch ticks: cuda "
                        "(default) or cpu")
    return p


def load_plan(spec: str) -> FaultPlan:
    if os.path.exists(spec):
        return FaultPlan.load(spec)
    return get_plan(spec)


async def run(args: argparse.Namespace) -> int:
    if args.list:
        for name in sorted(PLANS):
            print(name)
        return 0
    if args.save_plan is not None:
        name, path = args.save_plan
        get_plan(name).save(path)
        print(f"wrote {name} to {path}")
        return 0
    if not args.plan:
        print("--plan is required (or --list / --save-plan)",
              file=sys.stderr)
        return 2
    plan = load_plan(args.plan)
    runner = ChaosRunner(plan, device=args.device)
    verdict = await runner.run()
    text = json.dumps(verdict, indent=1)
    print(text)
    ticks = {
        name: server._ticks_done
        for name, server in sorted(runner.servers.items())
        if server.mode == "batch"
    }
    print(f"plan {plan.name}: tick device {runner.device}, batch ticks "
          f"{json.dumps(ticks, sort_keys=True)}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if args.flightrec:
        dump = verdict.get("flightrec_dump") or runner.flightrec.view(
            "on_demand"
        )
        with open(args.flightrec, "w") as f:
            json.dump(dump, f, indent=1, sort_keys=True)
            f.write("\n")
        overlay_path = args.flightrec + ".trace.json"
        with open(overlay_path, "w") as f:
            f.write(runner.flightrec.chrome_overlay(dump["records"]))
        print(
            f"wrote flight-recorder dump to {args.flightrec} "
            f"(overlay: {overlay_path})",
            file=sys.stderr,
        )
    if args.history_dir:
        # Re-home the runner's in-memory history as durable segments:
        # each record re-stamps its hseq/run in the target store, so a
        # directory accumulating several runs keeps them distinguishable
        # (cmd.obs `delta` compares across them).
        from doorman_tpu_torch.obs.history import HistoryStore

        os.makedirs(args.history_dir, exist_ok=True)
        store = HistoryStore(
            args.history_dir,
            ring=plan.total_ticks + 8,
            component=f"chaos:{plan.name}",
        )
        try:
            for rec in runner.history.records():
                store.append(rec)
        finally:
            store.close()
        print(f"wrote history segments to {args.history_dir}",
              file=sys.stderr)
    if args.trace:
        from doorman_tpu_torch.chaos.trace_export import write_chrome_trace

        write_chrome_trace(verdict, args.trace)
        print(f"wrote Chrome trace to {args.trace}", file=sys.stderr)
    return 0 if verdict["ok"] else 1


def main(argv=None) -> None:
    parser = make_parser()
    flagenv.populate(parser)
    args = parser.parse_args(argv)
    raise SystemExit(asyncio.run(run(args)))


if __name__ == "__main__":
    main()
