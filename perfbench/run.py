"""Run one cell of BENCHMARK.json once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (one JSON object); the
numbers that decided ``correct`` are the last lines of standard error.
Needs as many CUDA cards as the cell asks for, and exits non-zero without
a result otherwise.  See perfbench/harness.py."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from perfbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
