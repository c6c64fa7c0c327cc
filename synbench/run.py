#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 synbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--rehearse]

from the root of a checkout that holds ``src/repro_torch``.  See
``synbench/core/harness.py`` for what the line holds.
"""
import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from synbench.core import harness
    return harness.main(sys.argv[1:] if argv is None else argv, T_PROCESS,
                        ROOT)


if __name__ == "__main__":
    sys.exit(main())
