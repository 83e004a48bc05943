"""The port's RGBE reader and the parity script's statistic.

``smallvcm_tpu_torch.io.framebuffer.load_hdr`` against the JAX package's
``load_hdr`` on files written by either package's ``save_hdr``; the round
trip within half an RGBE quantum; and ``scripts/torch_parity.py``'s
PARITY.md parser, z statistic and gate on synthetic numbers.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

from smallvcm_tpu.io import framebuffer as jfb
from smallvcm_tpu_torch.io import framebuffer as tfb

ROOT = Path(__file__).resolve().parent.parent


def _image(seed=7, shape=(24, 40)):
    """Radiance over many octaves, with exact zeros, sub-1e-32 pixels and
    one dark channel next to a bright one."""
    rs = np.random.RandomState(seed)
    img = np.exp(rs.uniform(-12.0, 6.0, shape + (3,))).astype(np.float32)
    img[0, :5] = 0.0
    img[1, :3] = 1e-35
    img[2, 0] = (100.0, 1e-4, 0.0)
    return img


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_hdr_matches_jax_reader(tmp_path, writer):
    path = str(tmp_path / "x.hdr")
    (jfb if writer == "jax" else tfb).save_hdr(_image(), path)
    got, want = tfb.load_hdr(path), jfb.load_hdr(path)
    assert got.dtype == np.float32 and got.shape == (24, 40, 3)
    np.testing.assert_array_equal(got, want)   # JAX's is float64: values


def test_load_hdr_round_trip_within_half_a_quantum(tmp_path):
    img = _image(seed=3)
    path = str(tmp_path / "x.hdr")
    tfb.save_hdr(img, path)
    back = tfb.load_hdr(path)
    # One quantum: 2^(e - 136) with e = frexp exponent of the pixel's max
    # channel + 128 (the shared exponent); the decode adds half of it.
    _, e = np.frexp(img.max(axis=2))
    half = np.ldexp(0.5, e - 8)[..., None]
    stored = img.max(axis=2, keepdims=True) >= 1e-32   # else written as 0
    assert np.all(np.where(stored, np.abs(back - img) <= half, back == 0.0))
    assert not stored[1, :3].any() and np.all(back[0, :5] == 0.0)
    assert back[2, 0, 0] == pytest.approx(100.0, abs=0.25)


def test_load_hdr_refuses_other_layouts(tmp_path):
    path = tmp_path / "x.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+X 4 -Y 4\n"
                     + bytes(64))
    with pytest.raises(ValueError, match="RGBE"):
        tfb.load_hdr(str(path))


def _parity_script():
    spec = importlib.util.spec_from_file_location(
        "torch_parity", ROOT / "scripts" / "torch_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_parity_parser_reads_parity_md():
    P = _parity_script()
    table = P.parse_parity((ROOT / "PARITY.md").read_text())
    assert len(table) == 28
    assert set(table) == {(s, a) for s in range(4)
                          for a in ("el", "pt", "lt", "ppm", "bpm", "bpt",
                                    "vcm")}
    assert table[(0, "vcm")] == dict(ours=0.10759, ref=0.10758)
    assert table[(3, "bpm")] == dict(ours=0.12817, ref=0.12838)
    # Only tables with scene/algorithm columns count: the 1024^2 table's
    # "mean (ours)" column is not a row.
    text = ("| res | mean (ours) | mean (ref) |\n|---|---|---|\n"
            "| 1024 | 0.1 | 0.2 |\n\n| scene | algorithm | mean (ours) | "
            "mean (ref) |\n|---|---|---|---|\n| 2 (point) | pt | 0.5 | "
            "0.49 |\n")
    assert P.parse_parity(text) == {(2, "pt"): dict(ours=0.5, ref=0.49)}
    with pytest.raises(ValueError):
        P.parse_parity("no table here\n")


def test_parity_z_and_gate_on_synthetic_means():
    P = _parity_script()
    rs = np.random.RandomState(0)
    means = 0.1 + 0.002 * rs.standard_normal(32)
    se = means.std(ddof=1) / math.sqrt(32)
    got_se, z = P.z_score(means.mean(), means, 0.1)
    assert got_se == pytest.approx(se, rel=1e-12)
    assert z == pytest.approx((means.mean() - 0.1) / (math.sqrt(2) * se),
                              rel=1e-12)
    assert abs(z) < 4 and P.passes("vcm", means.mean(), 0.1, z)
    # A bias of 6 standard errors of the difference fails.
    biased = means.mean() + 6 * math.sqrt(2) * se
    _, zb = P.z_score(biased, means, 0.1)
    assert zb > 4 and not P.passes("vcm", biased, 0.1, zb)
    # el is gated on its relative error, whatever its z.
    flat = np.full(8, 0.52)
    flat[0] = 0.5201
    _, ze = P.z_score(0.5203, flat, 0.52085)
    assert abs(ze) > 4 and P.passes("el", 0.5203, 0.52085, ze)
    assert not P.passes("el", 0.52085 * 1.006, 0.52085, 0.0)
    with pytest.raises(ValueError):
        P.z_score(0.1, [0.1], 0.1)
