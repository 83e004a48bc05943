"""Counter-based RNG, bit-exact with ``smallvcm_tpu/core/rng.py``.

Every random number is a pure function of

    (base_seed, iteration, stream, global_path_id, slot)

so the port draws the same bits as the JAX package for the same seed, and
any partition of the paths reproduces the same streams. torch's uint32
arithmetic is partial, so the 32-bit words live in int64 tensors and every
wrapping operation is masked with ``& 0xFFFFFFFF``.

The iteration, and with it the stream id and the key words, may be a
Python int or a 0-dim int64 tensor (as the JAX package's traced
``make_stream`` takes a traced iteration): a stage captured once as a CUDA
graph (graphs.py) reads its iteration from a device buffer, so no stream
id is frozen into the capture. Both forms give the same bits.

:func:`uniform_slots` on CUDA path ids is one launch of a hand-written
kernel (``csrc/rng_slots.cu``) with the same bits; on CPU tensors it runs
the plain version (:func:`_uniform_slots_plain`), which the JAX package's
tests hold and which the kernel's tests hold the kernel to.
"""

from __future__ import annotations

import torch

from ..ops import _cuda

_MASK = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)


def _u32(x):
    """Python int or tensor -> int64 tensor/int holding a uint32 value."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return int(x) & _MASK


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, over int64 tensors holding uint32 words.

    Arguments are Python ints or int64 tensors (broadcastable). Returns two
    int64 tensors of the broadcast shape with values in [0, 2**32).
    """
    k0, k1 = _u32(k0), _u32(k1)
    x0 = (_u32(c0) + k0) & _MASK
    x1 = (_u32(c1) + k1) & _MASK

    ks2 = k0 ^ k1 ^ 0x1BD11BDA
    keys = (k0, k1, ks2)

    for block in range(5):
        rots = _ROTATIONS[(block % 2) * 4: (block % 2) * 4 + 4]
        for r in rots:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        # Key injection after each 4-round block.
        inj = block + 1
        x0 = (x0 + keys[inj % 3]) & _MASK
        x1 = (x1 + keys[(inj + 1) % 3] + inj) & _MASK
    return x0, x1


def tea6(k0, k1, c0, c1):
    """Six-round Tiny Encryption Algorithm hash in counter mode.

    The reference's LEGACY_RNG mixing function (rng.hxx:90-122) with the
    two key words and two counter words folded into the initial state, as
    ``smallvcm_tpu/core/rng.py::tea6`` does. Arguments are Python ints or
    int64 tensors holding uint32 words; each sum is reduced mod 2**32 once
    at the end of its round (addition and xor commute with the mask, and
    the unmasked intermediates stay below 2**38).
    """
    v0 = (_u32(k0) + _u32(c0)) & _MASK
    v1 = _u32(k1) ^ _u32(c1)
    s = 0
    for _ in range(6):
        s = (s + 0x9E3779B9) & _MASK
        v0 = (v0 + (((v1 << 4) + 0xA341316C) ^ (v1 + s)
                    ^ ((v1 >> 5) + 0xC8013EA4))) & _MASK
        v1 = (v1 + (((v0 << 4) + 0xAD90777D) ^ (v0 + s)
                    ^ ((v0 >> 5) + 0x7E95761E))) & _MASK
    return v0, v1


# In the order of csrc/rng_slots.cu's generator codes (0, 1).
_GENERATORS = {"threefry": threefry2x32, "tea": tea6}


def _to_unit_float(bits):
    """uint32 (in int64) -> float32 in [0, 1) using the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def uniform_slots(seed: int, stream, path_ids, n_slots: int,
                  generator: str = "threefry"):
    """Generate ``[..., n_slots]`` uniforms in [0, 1) for each path.

    seed:      python int (base seed, reference default 1234)
    stream:    python int or 0-dim int64 tensor identifying (iteration,
               stage, bounce)
    path_ids:  integer tensor [...] of *global* path indices
    n_slots:   number of random values per path
    generator: "threefry" (default) or "tea" — the reference's LEGACY_RNG
               mixing function in counter mode (its `old_rng` build flavor)

    CUDA path ids launch :func:`uniform_slots_kernel`, CPU ones run
    :func:`_uniform_slots_plain`: the same bits either way.
    """
    if isinstance(path_ids, torch.Tensor) and path_ids.is_cuda:
        return uniform_slots_kernel(seed, stream, path_ids, n_slots,
                                    generator)
    _check_args("uniform_slots", path_ids, n_slots, generator)
    return _uniform_slots_plain(seed, stream, path_ids, n_slots, generator)


def _check_args(name: str, path_ids, n_slots: int, generator: str) -> None:
    req = _cuda.require
    req(generator in _GENERATORS, f"{name}: unknown generator {generator!r}")
    req(n_slots >= 1, f"{name}: n_slots >= 1")
    req(isinstance(path_ids, torch.Tensor)
        and not path_ids.dtype.is_floating_point
        and not path_ids.dtype.is_complex and path_ids.dtype != torch.bool,
        f"{name}: path ids are an integer tensor")


def _uniform_slots_plain(seed: int, stream, path_ids, n_slots: int,
                         generator: str = "threefry"):
    """:func:`uniform_slots` as int64 tensor arithmetic (any device)."""
    bits2x32 = _GENERATORS[generator]
    path_ids = _u32(path_ids)
    k0 = seed & _MASK
    k1 = _u32(stream)
    out = []
    for pair in range((n_slots + 1) // 2):
        b0, b1 = bits2x32(k0, k1, path_ids, pair)
        out.append(_to_unit_float(b0))
        out.append(_to_unit_float(b1))
    return torch.stack(out[:n_slots], dim=-1)


def uniform_slots_kernel(seed: int, stream, path_ids, n_slots: int,
                         generator: str = "threefry"):
    """Launch ``csrc/rng_slots.cu`` -> [..., n_slots] float32 on the path
    ids' card, bit for bit :func:`_uniform_slots_plain`. A stream tensor
    on the card is read by the kernel when it runs (a graph's replay
    reads its own iteration's stream)."""
    _check_args("uniform_slots_kernel", path_ids, n_slots, generator)
    req = _cuda.require
    dev = path_ids.device
    req(dev.type == "cuda", "uniform_slots_kernel needs CUDA path ids")
    req(path_ids.dtype == torch.int64, "uniform_slots_kernel: int64 path ids")
    req(path_ids.is_contiguous(), "uniform_slots_kernel: contiguous path ids")
    n = path_ids.numel()
    req(n * n_slots < 2 ** 31, "uniform_slots_kernel: too many slots")
    word, word_ptr = stream, None
    if isinstance(stream, torch.Tensor):
        req(stream.numel() == 1 and stream.dtype == torch.int64
            and stream.device == dev,
            "uniform_slots_kernel: the stream is a 0-dim int64 tensor on "
            "the path ids' card")
        word, word_ptr = 0, stream.data_ptr()
    out = torch.empty((*path_ids.shape, n_slots), dtype=torch.float32,
                      device=dev)
    if n == 0:
        return out
    lib = _cuda.load_library()
    status = lib.svcm_uniform_slots(
        out.data_ptr(), path_ids.data_ptr(), n, n_slots, int(seed) & _MASK,
        int(word) & _MASK, word_ptr, tuple(_GENERATORS).index(generator),
        torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(status, "svcm_uniform_slots")
    uniform_slots_kernel.launches += 1
    return out


# Kernel launches on the device: graphs.py takes a capture's increment back
# and adds it at every replay (as ops/sweep.py's sweep_kernel.launches).
uniform_slots_kernel.launches = 0


def make_stream(iteration, stage: int, bounce: int = 0):
    """Pack (iteration, stage, bounce) into one 32-bit stream id: a Python
    int for an int iteration, a 0-dim int64 tensor for a tensor one.

    stage < 8, bounce < 64 — plenty for max path length and pipeline stages.
    """
    if not isinstance(iteration, torch.Tensor):
        iteration = int(iteration)
    return (iteration * 512 + (stage * 64 + bounce)) & _MASK


# Stage codes (documentation + uniqueness).
STAGE_CAMERA_JITTER = 0
STAGE_LIGHT_EMIT = 1
STAGE_LIGHT_WALK = 2  # + bounce
STAGE_CAMERA_WALK = 3  # + bounce
STAGE_CAMERA_NEE = 4  # + bounce
