"""ctypes loader for the native C++ image codec (native/codec.cpp).

Port of ``smallvcm_tpu/io/native_codec.py``: the host-side BMP/HDR/PFM/PPM
encoders of the reference (framebuffer.hxx:106-251) as one small C
library. g++ builds it at first use into ``smallvcm_tpu_torch/_build/``
(listed in .gitignore), keyed by a hash of the source, so a changed source
never loads a stale library; the build writes a temporary file and renames
it, so processes that build at once do not clash. Where no compiler or
library is available, or with ``SMALLVCM_TPU_NO_NATIVE=1``, the numpy
writers of io/framebuffer.py write the same bytes. Host code only: no
device kernel is involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "codec.cpp"
_BUILD_DIR = _SRC.parent.parent / "_build"
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libsvcmcodec-{digest}.so"


def _build(lib: Path) -> bool:
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        return False
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-o", str(tmp),
                        str(_SRC)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, lib)
        return True
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return False


def load():
    """Return the loaded library, or None (the numpy writers are used)."""
    global _lib, _tried
    if os.environ.get("SMALLVCM_TPU_NO_NATIVE"):
        return None
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib_path = library_path()
        if not lib_path.exists() and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        cp = ctypes.c_char_p
        fp = ctypes.POINTER(ctypes.c_float)
        ci = ctypes.c_int
        cf = ctypes.c_float
        lib.svcm_save_bmp.argtypes = [cp, fp, ci, ci, cf]
        lib.svcm_save_hdr.argtypes = [cp, fp, ci, ci]
        lib.svcm_save_pfm.argtypes = [cp, fp, ci, ci]
        lib.svcm_save_ppm.argtypes = [cp, fp, ci, ci, cf]
        for f in (lib.svcm_save_bmp, lib.svcm_save_hdr,
                  lib.svcm_save_pfm, lib.svcm_save_ppm):
            f.restype = ctypes.c_int
        _lib = lib
    return _lib


def _call(fn, img: np.ndarray, filename: str, *extra) -> bool:
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"image must be [H, W, 3], not {img.shape}")
    res_y, res_x, _ = img.shape
    ptr = img.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    return fn(os.fsencode(filename), ptr, res_x, res_y, *extra) == 0


def save_bmp(img: np.ndarray, filename: str, gamma: float) -> bool:
    lib = load()
    return lib is not None and _call(
        lib.svcm_save_bmp, img, filename, ctypes.c_float(gamma)
    )


def save_hdr(img: np.ndarray, filename: str) -> bool:
    lib = load()
    return lib is not None and _call(lib.svcm_save_hdr, img, filename)


def save_pfm(img: np.ndarray, filename: str) -> bool:
    lib = load()
    return lib is not None and _call(lib.svcm_save_pfm, img, filename)


def save_ppm(img: np.ndarray, filename: str, gamma: float) -> bool:
    lib = load()
    return lib is not None and _call(
        lib.svcm_save_ppm, img, filename, ctypes.c_float(gamma)
    )
