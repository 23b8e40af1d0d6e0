"""Run one cell of the benchmark: see ``perfbench/harness.py``.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""
import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from perfbench.harness import main

    sys.exit(main(sys.argv[1:], _T0))
