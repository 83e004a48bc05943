"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ``ctypes``: one
``nvcc`` per source under ``csrc/``, all started together, compiles it for
``sm_90a``, and one more links the objects into one shared library. The
build happens at first use, into
``smallvcm_tpu_torch/_build/<hash>/`` (listed in .gitignore), keyed by a
hash of the sources and flags, so a checkout builds from its own sources
and a changed source never loads a stale library. One process builds at a
time (a file lock beside the library): the ranks of a group started
together wait for the first one's build instead of each compiling every
source.

Every C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :func:`check` raises when it is not 0.
The per-lane kernels' wrappers (``ops/bsdf.py``, ``ops/lights.py``) share
the helpers at the end: the dispatch rule, the lane grid and the backward
through the plain chain.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

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
_U = ctypes.c_uint32

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
    # out, path ids, n, n_slots, seed word, stream word, stream word's
    # device int64 (or NULL), generator, stream
    "svcm_uniform_slots": (_P, _P, _I, _I, _U, _U, _P, _I, _P),
    # op, operand triples (pointer, row stride, column stride), operands,
    # output pointers, outputs, material planes' (pointer, stride) pairs,
    # material rows,
    # rows, columns, mat_id is int64, fix_is_light, stream
    "svcm_bsdf": (_I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P),
    # op, operand triples, operands, output pointers, outputs, the light
    # table's (pointer, stride) pairs, lights, the scene sphere's five
    # device pointers, rows, columns, id is int64, stream
    "svcm_lights": (_I, _P, _I, _P, _I, _P, _I, _P, _I, _I, _P),
    # photon planes (16 pointers), photon slots, query planes, query
    # slots, radius, tile partials, tile live bases, the sort's 8 buffers,
    # digit counts, digit totals, photon rows, query rows, params, n_p,
    # n_q, stream
    "svcm_merge_sort": (_P, _L, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P),
    # photon planes, slots, columns, rows, sorted slot indices, sorted
    # keys, photon_cap, ppos, ptab; query planes, slots, columns, rows,
    # sorted slot indices, query_cap, qpos, qtab, ranges, q_path; n_paths,
    # material planes' (pointer, stride) pairs, material rows, params, n_p,
    # n_q, stream
    "svcm_merge_bake": (_P, _L, _L, _P, _P, _P, _I, _P, _P, _P, _L, _L, _P,
                        _P, _I, _P, _P, _P, _P, _L, _P, _I, _P, _P, _P, _P),
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
    """Compile csrc/*.cu into the hash-keyed library unless it exists,
    holding the build directory's lock (a process that waited for it finds
    the library built)."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            _compile(so)
    return so


def _compile(so: Path) -> None:
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


def leaves(*operands):
    """The tensors (and other leaves) of nested tuples and lists, in
    order."""
    for o in operands:
        if isinstance(o, (tuple, list)):
            yield from leaves(*o)
        else:
            yield o


def on_card(*operands) -> bool:
    """Whether any operand is a CUDA tensor: a per-lane op then takes its
    kernel, which refuses operands on other devices."""
    return any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in leaves(*operands))


def lane_grid(name: str, planes):
    """The operands' broadcast shape (at most two dimensions), as a
    ``[rows, n]`` lane grid, and each operand's (pointer, row stride,
    column stride) over it, for a per-lane kernel that reads every
    operand through its strides (a stride 0 where it broadcasts)."""
    shape = torch.broadcast_shapes(*(t.shape for t in planes))
    require(len(shape) <= 2, f"{name}: operands of {len(shape)} dimensions")
    rows, n = (1, 1) if not shape else (
        (1, shape[0]) if len(shape) == 1 else tuple(shape))
    require(rows * n < 2 ** 31, f"{name}: too many lanes")
    ins = []
    for t in planes:
        st = t.expand(shape).stride()
        rs, cs = (0, 0) if not st else (
            (0, st[0]) if len(st) == 1 else st)
        ins += [t.data_ptr(), rs, cs]
    return shape, rows, n, (ctypes.c_longlong * len(ins))(*ins)


def plain_backward(saved, needs, plain, g_outs):
    """A kernel's backward through its plain chain: ``plain`` run again
    under grad mode on fresh leaves of the ``saved`` operands (those in
    ``needs`` requiring grad) and differentiated against ``g_outs`` ->
    each operand's gradient, None where it needs none."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(k) for t, k in zip(saved, needs)]
        outs = plain(ins)
        pairs = [(o, g) for o, g in zip(outs, g_outs)
                 if g is not None and o.requires_grad]
        live = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], live, [g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(live))
    return [next(grads) if t.requires_grad else None for t in ins]
