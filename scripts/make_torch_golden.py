"""Render the golden VCM image that the PyTorch/CUDA port is held against.

Renders full VCM with the JAX package on the CPU (scene 0, 32x32,
2 iterations, the flags in CONFIG) through
``vcm.render_block_with_stats`` with the unrolled camera loop and the XLA
merge, and writes ``tests/data/torch_golden_vcm_s0_32.npz`` holding the
averaged image and the config. ``tests/test_torch_slice.py`` checks the
port against it on the CPU, and ``chip_smoke.py`` on the GPU; neither
needs JAX for that.

    JAX_PLATFORMS=cpu python scripts/make_torch_golden.py
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "data" / "torch_golden_vcm_s0_32.npz"

CONFIG = dict(
    algorithm="vcm", scene_id=0, resolution=[32, 32], iterations=2,
    base_seed=1234, max_path_length=10, min_path_length=0,
    radius_factor=0.003, radius_alpha=0.75,
)


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from smallvcm_tpu.algorithms import vcm
    from smallvcm_tpu.scene.scene import SCENE_CONFIGS, load_cornell_box

    c = CONFIG
    res_x, res_y = c["resolution"]
    scene = load_cornell_box((res_x, res_y), SCENE_CONFIGS[c["scene_id"]])
    acc, _rays, ovf, _stats, _lum = vcm.render_block_with_stats(
        scene, 0, res_x, res_y, block=c["iterations"],
        base_seed=c["base_seed"], max_path_length=c["max_path_length"],
        min_path_length=c["min_path_length"],
        radius_factor=c["radius_factor"], radius_alpha=c["radius_alpha"],
        # Generous static merge caps: the XLA merge must not overflow.
        pair_factor=64.0, photon_factor=4.0, query_factor=4.0,
        merge_backend="xla", camera_unroll="on",
    )
    if int(ovf) != 0:
        raise RuntimeError(f"merge caps overflowed ({int(ovf)})")
    image = np.asarray(acc, np.float32) / c["iterations"]
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, image=image, config=json.dumps(c))
    print(f"wrote {OUT} mean={image.mean():.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
