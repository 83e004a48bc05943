#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print one JSON line.

    python benchmark/run.py --workload vcm.s0.512 --seed 7 --seconds 30 \\
        --trace 0

Run from the root of a checkout that holds ``BENCHMARK.json``, the
``benchmark/`` folder and the port (``smallvcm_tpu_torch``), on a machine
with as many CUDA cards as the cell asks for. Exits non-zero, printing no
result, without them. README.md beside this file says more.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
