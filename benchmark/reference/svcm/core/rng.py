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
"""

from __future__ import annotations

import torch

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
    """
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
