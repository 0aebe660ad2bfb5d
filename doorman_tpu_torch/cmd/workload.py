"""Workload CLI: run a named scenario against the real stack on the
virtual clock and print the SLO verdict.

    python -m doorman_tpu_torch.cmd.workload --scenario flash_crowd
    python -m doorman_tpu_torch.cmd.workload --scenario diurnal --scale 0.5
    python -m doorman_tpu_torch.cmd.workload --list-scenarios
    python -m doorman_tpu_torch.cmd.workload --scenario rolling_deploy \\
        --out verdict.json --flightrec dump.json

Exit code 0 when every gate passed; 1 otherwise. The verdict (JSON,
one object) goes to stdout — its event_log and log_sha256 are the
replay contract: the same scenario + seed + scale reproduces them
byte-for-byte.

`--device` is the device every server and forecaster of the run is
built on: cuda unless the caller asks for cpu (without a GPU, cuda
raises). The device goes to stderr, so the verdict on stdout stays the
replay contract.

Port of doorman_tpu/cmd/workload.py: a copy apart from import paths and
`--device`.
"""

from __future__ import annotations

import argparse
import json
import sys

from doorman_tpu_torch.utils import flagenv
from doorman_tpu_torch.utils.backend import resolve_device
from doorman_tpu_torch.workload import scenarios as scen_mod


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="doorman-workload",
        description="run a doorman-tpu workload scenario",
    )
    p.add_argument("--scenario", default="",
                   help="scenario name (see --list-scenarios)")
    p.add_argument("--list-scenarios", action="store_true",
                   help="list scenarios with one-line docs and exit")
    p.add_argument("--scale", type=float, default=1.0,
                   help="population/capacity multiplier (default 1.0)")
    p.add_argument("--seed", type=int, default=0,
                   help="replay seed (default 0)")
    p.add_argument("--ticks", type=int, default=0,
                   help="override the scenario's tick count (0: keep)")
    p.add_argument("--out", default="",
                   help="also write the verdict JSON to this path")
    p.add_argument("--flightrec", default="",
                   help="write the run's flight-recorder dump (the "
                        "gate-failure dump when one fired, else "
                        "nothing) to this path")
    p.add_argument("--history-dir", default="",
                   help="durable per-tick history directory: prior "
                        "runs' records warm-start a predictive "
                        "scenario's forecaster (bit-identical to "
                        "having observed them live), and this run's "
                        "records are appended for the next one")
    p.add_argument("--device", default="cuda",
                   help="device of the servers and the forecaster: "
                        "cuda (default; raises without a GPU) or cpu")
    return p


def run(args: argparse.Namespace) -> int:
    if args.list_scenarios:
        for name, doc in scen_mod.scenario_lines():
            print(f"{name:24s} {doc}")
        return 0
    if not args.scenario:
        print("--scenario is required (or --list-scenarios)",
              file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    print(f"scenario {args.scenario}: tick device {device}",
          file=sys.stderr)
    verdict = scen_mod.run_scenario(
        args.scenario, scale=args.scale, seed=args.seed,
        ticks=args.ticks or None,
        history_dir=args.history_dir or None,
        device=device,
    )
    if args.history_dir:
        print(
            f"forecaster warm-started from "
            f"{verdict.get('forecaster_warm_start', 0)} recorded "
            f"ticks; appended this run to {args.history_dir}",
            file=sys.stderr,
        )
    text = json.dumps(verdict, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if args.flightrec and verdict.get("flightrec_dump"):
        with open(args.flightrec, "w") as f:
            json.dump(verdict["flightrec_dump"], f, indent=1,
                      sort_keys=True)
            f.write("\n")
        print(f"wrote flight-recorder dump to {args.flightrec}",
              file=sys.stderr)
    return 0 if verdict["ok"] else 1


def main(argv=None) -> None:
    parser = make_parser()
    flagenv.populate(parser)
    raise SystemExit(run(parser.parse_args(argv)))


if __name__ == "__main__":
    main()
