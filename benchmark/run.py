"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload convnet_gp.gram_card --seed 7 \\
        --seconds 10 --trace 0

Needs as many CUDA cards as the cell asks for, and refuses to run
otherwise (exit 2, no result).  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` the ``breakdown``, and last ``checks``,
each number compared beside its limit, which also end standard error).
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, leads the import path: nothing
# here is imported by a bare top-level name
sys.path[0] = ROOT


def main(argv=None) -> int:
    from benchmark import harness
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    return harness.main(a.workload, a.seed, a.seconds, bool(a.trace))


if __name__ == "__main__":
    sys.exit(main())
