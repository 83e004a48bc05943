"""The benchmark's own tests: on the CPU at tiny sizes, except those marked
``cuda``, which decide inside the test whether there is a card. Run from
the repository's root: ``python -m pytest benchmark/tests``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Square resolution of each cell on the CPU: its configuration at a size
# a test run can hold (x4 needs a path count divisible by its ranks).
TINY = {"vcm.s0.512": 12, "pt.s0.512": 12, "vcm.s0.1024.x4": 16}
SEED = 2 ** 31 + 977  # larger than 32 signed bits hold


def tiny_context(name: str, fault=None, seconds: float = 0.5,
                 seed: int = SEED):
    from benchmark.harness import env, spec
    from benchmark.harness.context import Context

    cell = spec.cell_spec(spec.load_benchmark(env.ROOT), name)
    cell.config["resolution"] = [TINY[name]] * 2
    return Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                   device="cpu", start_epoch=env.process_start_epoch(),
                   fault=fault)


@pytest.fixture
def restore_faults():
    from benchmark.tests import faults

    yield faults
    faults.restore()
