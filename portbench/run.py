"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout with the cell's cards visible. The cells,
metrics and bounds are in ``BENCHMARK.json``; ``harness.py`` says what a run
does and prints.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
