"""Run one cell of the benchmark and print its result as the last line of
standard output:

    python3 lbmbench/run.py --workload urban5.prod --seed 7 --seconds 30 --trace 0
"""

import os
import sys
import time

_T = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from lbmbench import harness  # noqa: E402

if __name__ == "__main__":
    now, age = time.perf_counter(), harness.process_age_s()
    harness.cache_env()
    sys.exit(harness.main(sys.argv[1:], started=_T if age is None else now - age))
