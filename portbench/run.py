#!/usr/bin/env python3
"""Run one benchmark cell from the root of a checkout:

    python3 portbench/run.py --workload masked_k64.train --seed 7 --seconds 10 --trace 0

The last line of standard output is the cell's JSON result; the numbers
compared against the plain reference, each beside its limit, are the last
lines of standard error.  Exits non-zero, with no result, when no CUDA card
is present or the run fails.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# One host thread for the libraries' CPU work: the passes and iterations are
# launched from one thread, and idle worker threads only take its cores.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], STARTED))
