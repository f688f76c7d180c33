"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cells, their configurations, traffic
mixes and metrics are named in ``BENCHMARK.json``; ``bench/harness.py``
runs them.  The last line of standard output is the result as one JSON
object; the numbers that decide ``correct`` are the last lines of
standard error.  Needs a CUDA device (exit 2 without one).
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root (for ``bench``) and ``src`` (for ``repro_torch``)
# in place of this script's own directory
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
