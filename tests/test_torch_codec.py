"""The port's native image codec (native/codec.cpp through
io/native_codec.py) writes the numpy writers' bytes.

Image: tests/test_io.py::TestNativeCodec's hard image (negatives, zeros,
values above 1, tiny values). Each format's native bytes must equal the
port's numpy writers' bytes (``SMALLVCM_TPU_NO_NATIVE=1``) and the JAX
package's numpy writers' bytes. The gamma-quantised formats are also
checked on 512x512 images against the port's numpy writers.
"""

import numpy as np
import pytest

from smallvcm_tpu.io import framebuffer as jfb
from smallvcm_tpu_torch.io import framebuffer as fb
from smallvcm_tpu_torch.io import native_codec

FORMATS = [("bmp", dict(gamma=2.2)), ("hdr", {}), ("pfm", {}),
           ("ppm", dict(gamma=2.2))]


@pytest.fixture
def hard_img():
    g = np.random.default_rng(7)
    img = (g.uniform(size=(17, 23, 3)) * 2.0 - 0.2).astype(np.float32)
    img[0, 0] = 0.0
    img[1, 1] = [1e-38, 5e-33, 1e20]
    return img


@pytest.fixture(autouse=True)
def _need_native():
    if native_codec.load() is None:
        pytest.skip("native codec unavailable (no g++)")


@pytest.mark.parametrize("fmt,kw", FORMATS, ids=[f for f, _ in FORMATS])
def test_native_bytes_equal_numpy_bytes(hard_img, tmp_path, monkeypatch,
                                        fmt, kw):
    img = hard_img if fmt in ("bmp", "pfm") else np.abs(hard_img)
    native, port, jax_np = (tmp_path / f"{k}.{fmt}"
                            for k in ("native", "port", "jax"))
    assert getattr(native_codec, f"save_{fmt}")(img, str(native),
                                                *kw.values())
    monkeypatch.setenv("SMALLVCM_TPU_NO_NATIVE", "1")
    getattr(fb, f"save_{fmt}")(img, str(port), **kw)
    getattr(jfb, f"save_{fmt}")(img, str(jax_np), **kw)
    assert native.read_bytes() == port.read_bytes() == jax_np.read_bytes()


@pytest.mark.parametrize("fmt", ["bmp", "ppm"])
def test_native_bytes_equal_numpy_bytes_at_full_size(tmp_path, monkeypatch,
                                                     fmt):
    """2.4M gamma-quantised values of 512x512 random images: a float powf
    against numpy's f32 power moved an 8-bit step on a few in a million
    (both now take the power in f64, rounded once)."""
    g = np.random.default_rng(3)
    img = (g.uniform(size=(3, 512, 512, 3)) * 1.5).astype(np.float32)
    for k, frame in enumerate(img):
        assert getattr(native_codec, f"save_{fmt}")(
            frame, str(tmp_path / f"n{k}.{fmt}"), 2.2)
    monkeypatch.setenv("SMALLVCM_TPU_NO_NATIVE", "1")
    for k, frame in enumerate(img):
        getattr(fb, f"save_{fmt}")(frame, str(tmp_path / f"p{k}.{fmt}"),
                                   gamma=2.2)
        assert (tmp_path / f"n{k}.{fmt}").read_bytes() == \
            (tmp_path / f"p{k}.{fmt}").read_bytes()


def test_writers_take_the_native_codec(hard_img, tmp_path, monkeypatch):
    """save_image goes through the library when it loads."""
    calls = []
    real = native_codec.save_bmp
    monkeypatch.setattr(native_codec, "save_bmp",
                        lambda *a: calls.append(a) or real(*a))
    fb.save_image(hard_img, str(tmp_path / "a.bmp"))
    assert len(calls) == 1
    assert (tmp_path / "a.bmp").stat().st_size == 54 + 17 * 23 * 3


def test_library_builds_into_the_build_directory():
    path = native_codec.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "smallvcm_tpu_torch"
    src = native_codec._SRC
    assert src.parent.name == "native" and "smallvcm_tpu_torch" in src.parts
    assert not list(src.parent.glob("*.so"))
