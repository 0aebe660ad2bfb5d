"""CLI: python -m doorman_tpu_torch.sim <scenario|all> [--run-for S] [--seed N]
[--csv]. `all` runs scenarios 1-7 sequentially (one JSON summary line
each), the counterpart of the reference's run_all_scenarios.sh."""

from __future__ import annotations

import argparse
import json
import logging


def main() -> None:
    parser = argparse.ArgumentParser(description="doorman-tpu simulation")
    from doorman_tpu_torch.sim.scenarios import SCENARIOS

    parser.add_argument(
        "scenario", nargs="?", default=None,
        choices=sorted(SCENARIOS) + ["all"],
    )
    parser.add_argument("--list-scenarios", action="store_true",
                        help="list scenarios with one-line docs and exit")
    parser.add_argument("--run-for", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--csv", action="store_true", help="write CSV report")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args()

    if args.list_scenarios:
        from doorman_tpu_torch.sim.scenarios import registry_lines

        for name, doc in registry_lines(SCENARIOS):
            print(f"{name:12s} {doc}")
        return
    if args.scenario is None:
        parser.error("a scenario is required (or --list-scenarios)")

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(message)s",
    )

    from doorman_tpu_torch.sim.scenarios import run_scenario

    scenarios = list("1234567") if args.scenario == "all" else [args.scenario]
    for scenario in scenarios:
        sim, reporter = run_scenario(
            scenario, args.run_for, args.seed, write_csv=args.csv
        )
        summary = reporter.summary()
        summary["scenario"] = scenario
        summary["simulated_seconds"] = sim.clock.get_time()
        print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
