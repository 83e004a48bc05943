"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ``ctypes``: one
``nvcc`` per source under ``csrc/``, all started together, compiles it for
``sm_90a``, and one more links the objects into one shared library. The
build happens at first use, into
``smallvcm_tpu_torch/_build/<hash>/`` (listed in .gitignore), keyed by a
hash of the sources and flags, so a checkout builds from its own sources
and a changed source never loads a stale library.

Every C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :func:`check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from .. import trace

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libsvcm_kernels.so"

# -fmad=false: no a*b+c contraction, so the sweep rounds exactly as its
# plain PyTorch version (one IEEE op per torch op); -Xptxas -v records
# each kernel's registers and shared memory in build.log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C signatures of the entry points: name -> argtypes (restype is int).
SIGNATURES = {
    # scene block (host), n_tri, n_sph, ox, oy, oz, dx, dy, dz, dist, prim,
    # n_rays, stream
    "svcm_intersect_sweep": (_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _P),
    # scene block (host), n_tri, n_sph, px, py, pz, n_point, dx, dy, dz,
    # dist, active, out, n_rays, lanes a thread, stream
    "svcm_occluded_sweep": (_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                            _P, _I, _I, _P),
    # qpos, qtab, ranges, ppos, ptab, out, n_q (rows), n_live, r2,
    # vc_weight (the last three device pointers), max_path_length,
    # min_path_length, ppm, stream
    "svcm_merge_cells": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                         _I, _P),
    # times, lanes, row, iteration (or NULL), count (or NULL), base, rows,
    # slots, slot, stream
    "svcm_trace_stamp": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _P),
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / source_digest() / LIB_NAME


def _run_all(cmds):
    """Run the commands concurrently -> [(cmd, returncode, output)]."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs)]


def build() -> Path:
    """Compile csrc/*.cu into the hash-keyed library unless it exists."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    tmp = so.with_suffix(f".{tag}.tmp")
    cu = [p for p in _sources() if p.suffix == ".cu"]
    objs = [so.parent / f"{p.stem}.{tag}.o" for p in cu]
    results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                        for p, o in zip(cu, objs)])
    if all(rc == 0 for _, rc, _ in results):
        results += _run_all([[nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)]])
    log = "".join(" ".join(c) + "\n" + out for c, _, out in results)
    (so.parent / "build.log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    if any(rc != 0 for _, rc, _ in results):
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process, in
    the span ``cuda.library_load`` (``how``: "built" or "loaded")."""
    how = "loaded" if library_path().exists() else "built"
    with trace.span("cuda.library_load", how=how):
        lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def require(cond: bool, msg: str) -> None:
    """Wrapper-side input validation (kept when python runs with -O)."""
    if not cond:
        raise ValueError(msg)
