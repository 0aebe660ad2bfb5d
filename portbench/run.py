"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is the result (JSON); the numbers
that decided `correct` end standard error, each beside its limit.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench import harness

    sys.exit(harness.main(t0=T0))
