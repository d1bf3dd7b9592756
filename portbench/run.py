"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Without a CUDA card (or with fewer than the cell asks for) it exits non-zero
and prints no result.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared with
the reference beside its limit (also the last lines of standard error).
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="the cell: a file workloads/<cell>.json")
    p.add_argument("--seed", type=int, required=True, help="makes the inputs and picks the proofs checked")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: the per-layer metrics")
    return p.parse_args(argv)


if __name__ == "__main__":
    from portbench.core import harness

    sys.exit(harness.main(parse(), T0))
