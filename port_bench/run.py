"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, and
with ``--trace 1`` ``breakdown``); the numbers that decide ``correct`` are
the last lines of standard error. ``port_bench/harness.py`` has the rest.
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host's small numpy and torch operations
# gain nothing from a pool of threads, and an idle pool's spinning is noise
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")

# the checkout's root, not this folder, heads the import path: the harness's
# module names (data, trace) must not shadow those of the standard library
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from port_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
