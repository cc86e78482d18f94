"""One run of one benchmark cell of zvdb_tpu_torch on the GPU:

    python3 zvbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result's JSON line; the numbers that
decide `correct` are the last lines of standard error, each beside its limit.
Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits with 2. The control that `correct` must reject (the plain
reference in the program's place, one precision below the configuration's)
runs from `calibrate.py`, never from here.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from zvbench import harness

    return harness.cli(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
