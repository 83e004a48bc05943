"""Nothing the harness runs imports JAX or the JAX package, and the
reference imports nothing of the port either; top-level module names are
compared whole, since the port's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import env

BENCH_DIR = env.ROOT / "benchmark"
REFERENCE = BENCH_DIR / "reference"


def _imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_top_level_names_are_compared_whole():
    assert env.forbidden_modules({"smallvcm_tpu_torch.render": 1,
                                  "smallvcm_tpu_torchx": 1}) == []
    assert env.forbidden_modules({"smallvcm_tpu.render": 1, "jax": 1,
                                  "jaxlib.xla": 1, "flax": 1}) == [
        "flax", "jax", "jaxlib.xla", "smallvcm_tpu.render"]


@pytest.mark.parametrize("path", sorted(
    p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_source_of_the_harness_names_jax(path):
    assert not _imported_tops(path) & set(env.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(REFERENCE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_reference_imports_nothing_of_the_program(path):
    tops = _imported_tops(path)
    assert not tops & (set(env.FORBIDDEN) | {"smallvcm_tpu_torch"})
    assert tops <= {"torch", "numpy", "__future__", "typing", "dataclasses",
                    "struct", "contextlib", "weakref"}


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, "
         f"{str(env.ROOT)!r}); {code}; print(sorted({{m.split('.')[0] "
         "for m in sys.modules}))"],
        capture_output=True, text=True, check=True, timeout=300).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_the_reference_loads_no_program_module():
    tops = _loaded_after("import benchmark.reference.compute")
    assert not tops & {"jax", "jaxlib", "flax", "smallvcm_tpu",
                       "smallvcm_tpu_torch"}


def test_a_run_loads_no_jax_module():
    """Every module of the harness and the drivers, and a whole run of a
    cell on the CPU: no top-level name of JAX or the JAX package."""
    tops = _loaded_after(
        "from benchmark.tests.conftest import tiny_context; "
        "from benchmark.harness import main; import benchmark.control; "
        "import benchmark.drivers.sharded_blocks; "
        "main.run_cell(tiny_context('vcm.s0.512'))")
    assert "smallvcm_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "smallvcm_tpu"}


def test_a_rank_that_loads_jax_refuses_the_run(capsys):
    """Four gloo ranks, of which rank 1 loads a module named ``jax`` after
    its set-up: the run names it, prints no line and exits non-zero."""
    from benchmark.harness import main
    from benchmark.tests.conftest import tiny_context

    code = main.run_and_print(tiny_context(
        "vcm.s0.1024.x4", fault="benchmark.tests.faults:jax_in_rank_1"))
    out, err = capsys.readouterr()
    assert code != 0
    assert out.strip() == ""
    assert "loaded: jax" in err
