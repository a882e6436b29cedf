"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks for.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
