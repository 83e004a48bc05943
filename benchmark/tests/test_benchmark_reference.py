"""The plain reference against the port on the CPU at a tiny size: the
same images from the same seed and iterations."""

import torch

from benchmark.reference import compute as ref
from benchmark.tests.conftest import SEED, tiny_context


def _port_image(config, it):
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.scene.scene import load_cornell_box

    from benchmark.drivers._progressive import render_config

    scene = load_cornell_box(tuple(config["resolution"]),
                             config["scene_mask"], device="cpu")
    cfg = render_config(R, config, SEED & 0xFFFFFFFF)
    return R.render_single_iteration(scene, cfg, it)


def test_vcm_iteration_equals_the_port():
    config = tiny_context("vcm.s0.512").config
    want = _port_image(config, 3)
    got = ref.block_sum(config, SEED & 0xFFFFFFFF, 3, 1, "cpu")
    assert float(want.abs().sum()) > 0
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_pt_block_equals_the_port():
    config = tiny_context("pt.s0.512").config
    want = sum(_port_image(config, it) for it in (5, 6))
    got = ref.block_sum(config, SEED & 0xFFFFFFFF, 5, 2, "cpu")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_bfloat16_control_differs():
    config = tiny_context("vcm.s0.512").config
    f32 = ref.block_sum(config, 7, 0, 2, "cpu")
    bf16 = ref.block_sum(config, 7, 0, 2, "cpu", dtype=torch.bfloat16)
    assert not torch.equal(f32, bf16)
