"""PyTorch port vs the JAX package: the TEA generator (``--rng tea``).

Bit-exact, like the Threefry checks in test_torch_core.py: every render
comparison under ``--rng tea`` rests on the same random bits.
"""

import numpy as np
import pytest
import torch

from smallvcm_tpu.core import rng as jrng
from smallvcm_tpu_torch.core import rng as trng

from .test_torch_core import t

torch.set_num_threads(2)


def test_tea6_words_bit_exact():
    r = np.random.default_rng(11)
    k0, k1, c0, c1 = (r.integers(0, 2 ** 32, 4096, dtype=np.uint64)
                      .astype(np.uint32) for _ in range(4))
    k0[:4] = c0[4:8] = k1[8:12] = c1[12:16] = 0          # zero words
    k0[16:20] = c0[16:20] = 0xFFFFFFFF                   # wrapping sums
    w0, w1 = jrng.tea6(k0, k1, c0, c1)
    g0, g1 = trng.tea6(*(t(a, np.int64) for a in (k0, k1, c0, c1)))
    np.testing.assert_array_equal(g0.numpy(), np.asarray(w0).astype(np.int64))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(w1).astype(np.int64))


@pytest.mark.parametrize("seed,iteration,stage,bounce", [
    (1234, 0, jrng.STAGE_CAMERA_JITTER, 0),
    (7, 99, jrng.STAGE_LIGHT_WALK, 5),
    (2 ** 32 + 3, 8388607, jrng.STAGE_CAMERA_NEE, 63),
])
@pytest.mark.parametrize("n_slots", [2, 5])
def test_uniform_slots_tea_bit_exact(seed, iteration, stage, bounce,
                                     n_slots):
    ids = np.random.default_rng(seed % 31).integers(
        0, 2 ** 32, size=2048, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jrng.uniform_slots(
        seed, jrng.make_stream(iteration, stage, bounce), ids, n_slots,
        "tea"))
    got = trng.uniform_slots(
        seed, trng.make_stream(iteration, stage, bounce), t(ids, np.int64),
        n_slots, generator="tea").numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # A different generator gives different bits.
    other = trng.uniform_slots(
        seed, trng.make_stream(iteration, stage, bounce), t(ids, np.int64),
        n_slots).numpy()
    assert (other != got).mean() > 0.99
