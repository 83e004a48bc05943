"""Port VCM gradients against ``jax.grad`` of the JAX package's
``diff.render_params`` (8x8, max path length 6), with the bound stated in
test_torch_diff.py. A file of its own: the JAX gradient program of VCM
takes most of a minute to compile on the CPU.
"""

from .test_torch_diff import gradients_match_jax


def test_vcm_gradients_match_jax():
    gradients_match_jax("vcm", 8)
