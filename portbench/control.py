"""The readings that set the limits of `correct`: for each seed, the
program's numbers (a sound run's: the lower reading) and, on the first
`--control-seeds` of them, the same numbers with the reference itself
computed in bfloat16 put in the program's place (the control: the upper
reading). The benchmark's own runs never run this.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 \\
        --seconds 5 [--control-seeds 3]

runs every seed in one process, one line of JSON a seed, then a line
with the largest program reading and the smallest control reading of
each number.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    lower, upper = {}, {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               t0=t0, device=args.device,
                               control=i < args.control_seeds)
        program = {k: v["value"] for k, v in out["check"].items()}
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "program": program, "control": out.get("control"),
                          "metrics": out["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        for k, v in program.items():
            if isinstance(v, (int, float)):
                lower[k] = max(lower.get(k, v), v)
        for k, v in (out.get("control") or {}).items():
            upper[k] = min(upper.get(k, v), v)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
