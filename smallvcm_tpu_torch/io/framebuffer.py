"""Accumulation framebuffer planes + PPM/PFM/BMP/HDR writers.

Port of ``smallvcm_tpu/io/framebuffer.py``. Device side, the framebuffer is
a V3 of ``[resY, resX]`` f32 planes. The file writers try the native C++
codec first (io/native_codec.py, as the JAX writers do) and otherwise run
the JAX package's numpy writers, carried over; both write the byte formats
of the reference (framebuffer.hxx:106-251), i.e. PPM, binary PFM,
bottom-up 24bpp BMP with gamma, and Radiance RGBE HDR, byte for byte alike.

Determinism: every scatter-add here goes through
:func:`deterministic_index_add`. On the CPU ``index_add_`` accumulates in
source order, which is the JAX package's sorted (key, iota) order; on
CUDA it runs under ``torch.use_deterministic_algorithms``, whose
``index_add_`` sorts the indices and sums without atomics, so a render is
bitwise repeatable on the card.
"""

from __future__ import annotations

import contextlib
import struct

import numpy as np
import torch

from ..core.vec3 import V3
from . import native_codec


@contextlib.contextmanager
def _deterministic():
    """Scoped ``torch.use_deterministic_algorithms(True)``."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def deterministic_index_add(n_rows: int, index, rows):
    """``zeros(n_rows, C).index_add_(0, index, rows)`` with a repeatable
    summation order on every device (rows [M, C], index [M] in
    [0, n_rows]); rows whose index is the sentinel ``n_rows`` add nothing.

    No host read: a sentinel row becomes a +0.0 row at index ``j %
    n_rows`` (its own position j), so every output row gets a few of them
    and none is hot (the deterministic CUDA ``index_add_`` sums each
    index's rows serially, and the sentinel can hold most of the rows).
    The bits are those of dropping the sentinel rows: each output row
    still sums its live rows in source order (the CPU ``index_add_`` runs
    in source order, the deterministic CUDA one sorts the indices
    stably), and adding +0.0 leaves every float but -0.0 as it is, while a
    sum that starts at +0.0 is never -0.0."""
    m = index.shape[0]
    dead = index >= n_rows
    spread = torch.remainder(
        torch.arange(m, dtype=index.dtype, device=index.device), n_rows)
    index = torch.where(dead, spread, index)
    rows = torch.where(dead[:, None], 0.0, rows)
    out = torch.zeros((n_rows, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    if rows.device.type == "cpu":
        return out.index_add_(0, index, rows)
    with _deterministic():
        return out.index_add_(0, index, rows)


def add_color(fb, sx, sy, color):
    """Batched AddColor: floor the raster position, drop out-of-bounds
    (framebuffer.hxx:43-57). fb is a V3 of [resY, resX] planes; sx/sy are
    float raster coords [N], color a V3 of [N]."""
    res_y, res_x = fb.x.shape
    x = torch.floor(sx).long()
    y = torch.floor(sy).long()
    ok = (sx >= 0) & (sy >= 0) & (x < res_x) & (y < res_y)
    p = res_x * res_y
    key = torch.where(ok, y * res_x + x, p)
    buf = deterministic_index_add(p, key, color.to_array())
    return V3(*(plane + buf[:, c].reshape(res_y, res_x)
                for c, plane in enumerate(fb)))


def add_color_at_pix(fb, pix, color):
    """Own-pixel accumulate for camera sub-paths.

    Camera-path contributions always land on the path's own pixel
    (floor(x + jitter) == x for jitter in [0, 1)), and each path owns a
    distinct pixel, so this is a gather-add-put with unique indices: no
    accumulation order to fix.
    """
    def upd(plane, c):
        flat = plane.reshape(-1).clone()
        flat[pix] = flat[pix] + c
        return flat.reshape(plane.shape)

    return V3(upd(fb.x, color.x), upd(fb.y, color.y), upd(fb.z, color.z))


def splat_colors(fb, pix1d, color):
    """Scattered splat of [L, N] contributions -> fb planes, one 3-wide
    deterministic scatter-add.

    ``pix1d``: integer [L, N] flat pixel index per splat; dead splats carry
    the sentinel ``res_x * res_y`` and add nothing (no host read: see
    :func:`deterministic_index_add`). Light-tracer camera
    connections land on arbitrary pixels, so the per-bounce splats are
    deferred and flushed here once per iteration.
    """
    res_y, res_x = fb.x.shape
    p = res_x * res_y
    rows = torch.stack([color.x.reshape(-1), color.y.reshape(-1),
                        color.z.reshape(-1)], dim=1)
    buf = deterministic_index_add(p, pix1d.reshape(-1).long(), rows)
    return V3(
        fb.x + buf[:, 0].reshape(res_y, res_x),
        fb.y + buf[:, 1].reshape(res_y, res_x),
        fb.z + buf[:, 2].reshape(res_y, res_x),
    )


def new_fb_planes(res_x: int, res_y: int, device="cpu"):
    """Device-side accumulation planes (V3 of [resY, resX])."""
    z = torch.zeros((res_y, res_x), dtype=torch.float32, device=device)
    return V3(z, z, z)


def total_luminance(fb: torch.Tensor) -> torch.Tensor:
    """framebuffer.hxx:89-102 (fb = [resY, resX, 3] tensor)."""
    return torch.sum(
        0.212671 * fb[..., 0] + 0.715160 * fb[..., 1] + 0.072169 * fb[..., 2]
    )


def _np(fb) -> np.ndarray:
    if isinstance(fb, torch.Tensor):
        return fb.detach().to("cpu", torch.float32).numpy()
    return np.asarray(fb, np.float32)


def _gamma255(x: np.ndarray, gamma: float) -> np.ndarray:
    """pow(x, 1/gamma) * 255 as native/codec.cpp computes it: 1/gamma in
    f32, the power in f64 rounded once to f32, the product in f32 (so the
    two writers' bytes agree; numpy's f32 power and C's powf do not)."""
    inv_g = np.float32(1.0) / np.float32(gamma)
    return (np.power(x.astype(np.float64), np.float64(inv_g))
            .astype(np.float32) * np.float32(255.0))


def save_ppm(fb, filename: str, gamma: float = 1.0) -> None:
    img = _np(fb)
    if native_codec.save_ppm(img, filename, gamma):
        return
    res_y, res_x, _ = img.shape
    with np.errstate(invalid="ignore"):   # negative -> NaN -> 0, as in C
        quant = np.clip(_gamma255(img, gamma).astype(np.int32), 0, 255)
    with open(filename, "w") as f:
        f.write(f"P3\n{res_x} {res_y}\n255\n")
        for y in range(res_y):
            row = " ".join(
                f"{quant[y, x, 0]} {quant[y, x, 1]} {quant[y, x, 2]}"
                for x in range(res_x)
            )
            f.write(row + " \n")


def save_pfm(fb, filename: str) -> None:
    img = _np(fb)
    if native_codec.save_pfm(img, filename):
        return
    res_y, res_x, _ = img.shape
    with open(filename, "wb") as f:
        f.write(f"PF\n{res_x} {res_y}\n-1\n".encode())
        f.write(img.tobytes())


def save_bmp(fb, filename: str, gamma: float = 1.0) -> None:
    """24bpp bottom-up BMP, byte-identical layout to framebuffer.hxx:170-215."""
    img = _np(fb)
    if native_codec.save_bmp(img, filename, gamma):
        return
    res_y, res_x, _ = img.shape
    header = struct.pack(
        "<IIIIii hh IIIIII".replace(" ", ""),
        54 + res_x * res_y * 3,  # file size
        0,                       # reserved
        54,                      # data offset
        40,                      # header size
        res_x,
        res_y,
        1,                       # color planes
        24,                      # bpp
        0,                       # compression
        res_x * res_y * 3,       # image size
        2953, 2953, 0, 0,
    )
    # bottom-up rows, BGR order
    g = _gamma255(np.maximum(img, 0.0), gamma)
    bgr = np.clip(g[::-1, :, ::-1], 0.0, 255.0).astype(np.uint8)
    with open(filename, "wb") as f:
        f.write(b"BM")
        f.write(header)
        f.write(bgr.tobytes())


def save_hdr(fb, filename: str) -> None:
    """Radiance RGBE (framebuffer.hxx:219-251, non-RLE scanlines)."""
    img = _np(fb)
    if native_codec.save_hdr(img, filename):
        return
    res_y, res_x, _ = img.shape
    v = img.max(axis=2)
    mant, exp = np.frexp(v)
    scale = np.where(v >= 1e-32, mant * 256.0 / np.where(v == 0, 1.0, v), 0.0)
    rgbe = np.zeros((res_y, res_x, 4), np.uint8)
    rgbe[..., 0] = (img[..., 0] * scale).astype(np.uint8)
    rgbe[..., 1] = (img[..., 1] * scale).astype(np.uint8)
    rgbe[..., 2] = (img[..., 2] * scale).astype(np.uint8)
    rgbe[..., 3] = np.where(v >= 1e-32, exp + 128, 0).astype(np.uint8)
    with open(filename, "wb") as f:
        f.write(b"#?RADIANCE\n# SmallVCM\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {res_y} +X {res_x}\n".encode())
        f.write(rgbe.tobytes())


def save_image(fb, filename: str) -> None:
    """Dispatch by extension like smallvcm.cxx:313-320 (gamma 2.2 for bmp)."""
    if filename.endswith(".bmp"):
        save_bmp(fb, filename, gamma=2.2)
    elif filename.endswith(".hdr"):
        save_hdr(fb, filename)
    elif filename.endswith(".pfm"):
        save_pfm(fb, filename)
    elif filename.endswith(".ppm"):
        save_ppm(fb, filename, gamma=2.2)
    else:
        save_bmp(fb, filename + ".bmp", gamma=2.2)


def load_hdr(filename: str) -> np.ndarray:
    """Read a flat (non-RLE) Radiance RGBE file as written by save_hdr or the
    reference -> float32 [resY, resX, 3]."""
    with open(filename, "rb") as f:
        data = f.read()
    # The header ends at the blank line; the resolution line follows.
    pos = data.find(b"\n\n") + 2
    eol = data.find(b"\n", pos)
    parts = data[pos:eol].decode().split()
    if pos < 2 or len(parts) != 4 or parts[0] != "-Y" or parts[2] != "+X":
        raise ValueError(f"{filename}: not a flat -Y/+X RGBE file")
    res_y, res_x = int(parts[1]), int(parts[3])
    rgbe = np.frombuffer(
        data, np.uint8, count=res_y * res_x * 4, offset=eol + 1
    ).reshape(res_y, res_x, 4).astype(np.float32)
    exp = np.ldexp(1.0, rgbe[..., 3].astype(np.int32) - 136)  # 2^(e-128)/256
    # Radiance's (r + 0.5) * 2^(e-136): the encoder truncates mantissas, so
    # the half quantum makes the decode unbiased. Without it a decoded image
    # reads ~0.2-0.5% darker than the one rendered (PARITY.md, energy audit).
    img = ((rgbe[..., :3] + 0.5) * exp[..., None]).astype(np.float32)
    img[rgbe[..., 3] == 0] = 0.0
    return img


def load_bmp(filename: str) -> np.ndarray:
    """Read a 24bpp BMP written by either renderer -> float [resY,resX,3] in [0,1]."""
    with open(filename, "rb") as f:
        data = f.read()
    assert data[:2] == b"BM"
    data_offset = struct.unpack_from("<I", data, 10)[0]
    width = struct.unpack_from("<i", data, 18)[0]
    height = struct.unpack_from("<i", data, 22)[0]
    bpp = struct.unpack_from("<H", data, 28)[0]
    assert bpp == 24
    row_bytes = width * 3  # SmallVCM writes unpadded rows (width multiple of 4)
    arr = np.frombuffer(
        data, np.uint8, count=height * row_bytes, offset=data_offset
    ).reshape(height, width, 3)
    return arr[::-1, :, ::-1].astype(np.float32) / 255.0
