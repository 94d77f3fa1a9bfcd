"""The benchmark's command: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON object, the last line of standard output,
and each number the check compared beside its limit as the last lines of
standard error. Exits non-zero, with no result, where no card (or fewer
cards than the cell asks for) is visible, or where the process loaded JAX
or the JAX package. See ``harness/main.py``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# few host threads, set before numpy and torch start their pools (main.HOST_THREADS)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "4")

# the checkout's root: the program, and this folder as the package ``benchmark``
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
