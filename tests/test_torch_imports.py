"""The port stands alone: it imports without JAX and never hides the device.

A fresh interpreter imports every module of ``smallvcm_tpu_torch`` and
must end with no ``jax`` in ``sys.modules``. Asking for a CUDA device
where there is none raises instead of rendering on the CPU.
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import smallvcm_tpu_torch
from smallvcm_tpu_torch import cli
from smallvcm_tpu_torch.ops import _cuda

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        smallvcm_tpu_torch.__path__, prefix="smallvcm_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _all_modules()
    assert {"smallvcm_tpu_torch.ops.merge", "smallvcm_tpu_torch.ops.sweep",
            "smallvcm_tpu_torch.algorithms.vcm", "smallvcm_tpu_torch.cli",
            "smallvcm_tpu_torch.convert", "smallvcm_tpu_torch.ops.hashgrid",
            "smallvcm_tpu_torch.algorithms.eyelight",
            "smallvcm_tpu_torch.algorithms.pathtracer",
            "smallvcm_tpu_torch.checkpoint", "smallvcm_tpu_torch.diff",
            "smallvcm_tpu_torch.report",
            "smallvcm_tpu_torch.io.html", "smallvcm_tpu_torch.device",
            "smallvcm_tpu_torch.io.native_codec",
            "smallvcm_tpu_torch.isolate",
            "smallvcm_tpu_torch.parallel.comm",
            "smallvcm_tpu_torch.parallel.multihost",
            "smallvcm_tpu_torch.parallel.sharding"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib', 'smallvcm_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-i", "1", "--resolution", "8", "8"])
    assert cli.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_build_on_the_card_by_default():
    """load_cornell_box, scene_from_numpy and params_from_numpy default to
    "cuda" and, without a card, raise instead of building on the CPU."""
    import inspect
    from types import SimpleNamespace

    from smallvcm_tpu_torch import convert
    from smallvcm_tpu_torch.scene import scene as S

    for fn in (S.load_cornell_box, convert.scene_from_numpy,
               convert.params_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    scene = S.load_cornell_box((8, 8), S.SCENE_CONFIGS[0], device="cpu")
    assert scene.device == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.load_cornell_box((8, 8), S.SCENE_CONFIGS[0])
    params = SimpleNamespace()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.scene_from_numpy(params)


def test_kernel_sources_present_and_build_is_keyed_by_source():
    names = {p.name for p in _cuda.CSRC_DIR.glob("*.cu")}
    assert names == {"merge_cells.cu", "intersect_sweep.cu",
                     "trace_stamp.cu"}
    for p in _cuda.CSRC_DIR.glob("*.cu"):
        text = p.read_text()
        # Each source names the TPU kernel it replaces, or says it
        # replaces none (the stage clocks' stamp, which the TPU has not).
        replaces = ("replaces no tpu kernel" if p.name == "trace_stamp.cu"
                    else "replaces the tpu kernel")
        assert replaces in text.lower()
        assert "cudaGetLastError" in text
    path = _cuda.library_path()
    assert path.parent.parent == _cuda.BUILD_DIR
    assert path.parent.name == _cuda.source_digest()
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS


def test_dense_sweep_is_never_chosen_for_a_card():
    """trace_backend 'xla' names the kernel's plain reference: on a CUDA
    device it raises instead of standing in for the kernel."""
    from types import SimpleNamespace

    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    card = SimpleNamespace(device=torch.device("cuda", 0))
    cpu = SimpleNamespace(device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not run on a CUDA device"):
        R.check_backends(card, R.RenderConfig(trace_backend="xla"))
    R.check_backends(cpu, R.RenderConfig(trace_backend="xla"))
    for be in ("auto", "pallas"):
        R.check_backends(card, R.RenderConfig(trace_backend=be,
                                              merge_backend="xla"))
    with pytest.raises(ValueError, match="trace_backend"):
        R.check_backends(cpu, R.RenderConfig(trace_backend="mosaic"))
    with pytest.raises(ValueError, match="merge_backend"):
        R.render_single_iteration(
            load_cornell_box((8, 8), SCENE_CONFIGS[0], device="cpu"),
            R.RenderConfig(resolution=(8, 8), merge_backend="mosaic"), 0)


def test_port_scripts_import_without_jax():
    """The card's machine has no JAX: the parity, scaling and profiler-cost
    scripts, the bench, the smoke test and the matrix criterion it reads import none of
    it, nor anything of the JAX package."""
    code = (
        "import contextlib, importlib, importlib.util, io, sys\n"
        "sys.path.insert(0, '.')\n"
        "for name, path in (('torch_parity', 'scripts/torch_parity.py'),\n"
        "                   ('torch_scaling', 'scripts/torch_scaling.py'),\n"
        "                   ('torch_profile_cost',\n"
        "                    'scripts/torch_profile_cost.py'),\n"
        "                   ('bench_torch', 'bench_torch.py')):\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        "        try:\n"
        "            mod.main(['--help'])\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, e.code\n"
        "importlib.import_module('chip_smoke')\n"
        "importlib.import_module('tests.test_torch_matrix')\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', "
        "'smallvcm_tpu') or k.startswith(('jax.', 'jaxlib', "
        "'smallvcm_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
