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


# -- the dispatch: CPU tensors take the plain path, CUDA ones the kernel ----


def _no_library():
    raise AssertionError("the kernels' library was loaded")


@pytest.mark.parametrize("generator", ["threefry", "tea"])
def test_uniform_slots_on_cpu_never_loads_the_kernels_library(
        monkeypatch, generator):
    """CPU path ids run the plain version: no library, no launch, and the
    plain version's bits (a stream as an int or a 0-dim tensor)."""
    from smallvcm_tpu_torch.ops import _cuda

    monkeypatch.setattr(_cuda, "load_library", _no_library)
    launches = trng.uniform_slots_kernel.launches
    ids = torch.arange(300, dtype=torch.int64) * 7919
    stream = trng.make_stream(5, trng.STAGE_LIGHT_WALK, 2)
    for s in (stream, torch.tensor(stream, dtype=torch.int64)):
        got = trng.uniform_slots(1234, s, ids, 3, generator)
        want = trng._uniform_slots_plain(1234, stream, ids, 3, generator)
        assert got.shape == (300, 3) and torch.equal(got, want)
    assert trng.uniform_slots_kernel.launches == launches


_IDS = torch.arange(16, dtype=torch.int64)


@pytest.mark.parametrize("fn,args,match", [
    (trng.uniform_slots, (1234, 9, _IDS.float(), 2), "integer"),
    (trng.uniform_slots, (1234, 9, _IDS > 3, 2), "integer"),
    (trng.uniform_slots, (1234, 9, _IDS, 0), "n_slots"),
    (trng.uniform_slots, (1234, 9, _IDS, 2, "philox"), "generator"),
    (trng.uniform_slots_kernel, (1234, 9, _IDS, 2), "CUDA"),
], ids=["float_ids", "bool_ids", "no_slots", "unknown_generator",
        "kernel_on_cpu"])
def test_uniform_slots_checks_reject_before_any_launch(monkeypatch, fn,
                                                       args, match):
    from smallvcm_tpu_torch.ops import _cuda

    monkeypatch.setattr(_cuda, "load_library", _no_library)
    launches = trng.uniform_slots_kernel.launches
    with pytest.raises(ValueError, match=match):
        fn(*args)
    assert trng.uniform_slots_kernel.launches == launches


@pytest.mark.parametrize("generator", ["threefry", "tea"])
@pytest.mark.parametrize("seed", [1234, 2 ** 32 + 3])
def test_plain_path_takes_ids_mod_2_32_as_jax_does(generator, seed):
    """The plain version the kernel is held to, on the ids the kernel's
    card tests use (0, 2**32 - 1, and ids above 2**32, taken mod 2**32):
    JAX's bits, for 1-5 slots."""
    wide = np.array([0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5, 2 ** 40 + 17,
                     2 ** 62 + 3], np.int64)
    ids = np.concatenate([wide, np.random.default_rng(3).integers(
        0, 2 ** 33, 500, dtype=np.int64)])
    stream = trng.make_stream(77, trng.STAGE_CAMERA_WALK, 4)
    for n_slots in range(1, 6):
        want = np.asarray(jrng.uniform_slots(
            seed, stream, ids.astype(np.uint32), n_slots, generator))
        got = trng._uniform_slots_plain(seed, stream, torch.from_numpy(ids),
                                        n_slots, generator)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("alg,calls", [
    ("pt", {2: 1, 3: 10, 4: 10}),
    ("vcm", {2: 1, 3: 10, 4: 19, 5: 1}),
])
def test_dispatch_split_counts_one_launch_a_uniform_slots_call(alg, calls):
    """scripts/torch_dispatch_split.py: an iteration's uniform_slots calls
    by their slots (pt 21, VCM 31: the kernel's launches an iteration on a
    card), and the RNG's share with the kernel (one launch a call, and
    make_stream's scalars) against its int64 chain."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / \
        "torch_dispatch_split.py"
    spec = importlib.util.spec_from_file_location("torch_dispatch_split",
                                                  path)
    split = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(split)
    kernel = split.main(["--alg", alg, "--res", "4"])
    plain = split.main(["--alg", alg, "--res", "4", "--plain-rng"])
    n = sum(calls.values())
    for r in (kernel, plain):
        assert r["uniform_slots_calls_by_slots"] == calls
    rng_kernel = kernel["by_module"]["core/rng.py"]
    rng_plain = plain["by_module"]["core/rng.py"]
    scalars = rng_kernel - n  # make_stream's ops, the same both ways
    assert 0 <= scalars <= 4 * n and rng_plain > 100 * n
    assert plain["total"] - kernel["total"] == rng_plain - rng_kernel
    # The script's patches are undone.
    assert trng._uniform_slots_plain.__name__ == "_uniform_slots_plain"
