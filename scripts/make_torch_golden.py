"""Render the golden images and gradients the PyTorch/CUDA port is held against.

Renders with the JAX package on the CPU and writes, under ``tests/data/``:

* ``torch_golden_vcm_s0_32.npz``: full VCM (scene 0, 32x32, 2 iterations)
  through ``vcm.render_block_with_stats`` with the unrolled camera loop and
  the XLA merge;
* ``torch_golden_el_s0_32.npz`` and ``torch_golden_pt_s0_32.npz``: eye
  light and path tracing, same scene, size and iterations;
* ``torch_golden_grad_s1_32.npz``: ``diff.loss_and_grad`` of pt and bpm on
  scene 1 at 32x32 (one iteration, max path length 6, target 0.2
  everywhere, generous merge caps), every parameter leaf's gradient;
* ``torch_golden_matrix_32.npz``: every scene of ``SCENE_CONFIGS`` times
  every algorithm of ``ALGORITHMS`` (32x32, 2 iterations, seed 1234, the
  CLI's defaults) through ``smallvcm_tpu.render.render``, so the merge is
  JAX's XLA merge and ppm is resolved as the CLI resolves it; arrays
  ``s{scene}_{alg}`` and JSON configs ``s{scene}_{alg}_config``;
* ``torch_golden_bench_32.json``: bench.py's own count call
  (``vcm.render_block_with_stats`` at iteration 1, one iteration, the XLA
  merge, ``RenderConfig``'s merge caps) on scene 0 at 32x32: the ray count,
  the merge stats (candidate pairs, live photons, live queries) and the
  overflow flag, which must be 0 (an overflowing cap drops pairs).

Each file holds its config as JSON. ``tests/test_torch_slice.py``,
``tests/test_torch_simple.py``, ``tests/test_torch_matrix.py`` and
``tests/test_torch_bench.py`` check the port against them on the CPU, and
``chip_smoke.py`` checks images and gradients on the GPU; neither needs
JAX for that.

    JAX_PLATFORMS=cpu python scripts/make_torch_golden.py [vcm] [el] [pt] \
        [grad] [matrix] [bench]

With names, only those files are rewritten (default: all six; the matrix
takes about three minutes).
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"

CONFIG = dict(
    algorithm="vcm", scene_id=0, resolution=[32, 32], iterations=2,
    base_seed=1234, max_path_length=10, min_path_length=0,
    radius_factor=0.003, radius_alpha=0.75,
)
# Generous static merge caps: the XLA merge must not overflow.
CAPS = dict(pair_factor=64.0, photon_factor=4.0, query_factor=4.0)
GRAD_CONFIG = dict(
    algorithms=["pt", "bpm"], scene_id=1, resolution=[32, 32],
    iteration=0, n_iterations=1, base_seed=1234, max_path_length=6,
    target=0.2,
)


def golden_path(algorithm: str) -> Path:
    return DATA / f"torch_golden_{algorithm}_s0_32.npz"


GRAD_GOLDEN = DATA / "torch_golden_grad_s1_32.npz"
MATRIX_GOLDEN = DATA / "torch_golden_matrix_32.npz"
MATRIX_CONFIG = dict(resolution=[32, 32], iterations=2, base_seed=1234)
BENCH_GOLDEN = DATA / "torch_golden_bench_32.json"
BENCH_CONFIG = dict(algorithm="vcm", scene_id=0, resolution=[32, 32],
                    iteration=1, merge_backend="xla")


def _save(path: Path, **arrays) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}")


def main(argv=None) -> int:
    which = set(sys.argv[1:] if argv is None else argv) or {
        "vcm", "el", "pt", "grad", "matrix", "bench"}
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from smallvcm_tpu import diff
    from smallvcm_tpu.algorithms import eyelight, pathtracer, vcm
    from smallvcm_tpu.scene.scene import SCENE_CONFIGS, load_cornell_box

    c = CONFIG
    res_x, res_y = c["resolution"]
    scene = load_cornell_box((res_x, res_y), SCENE_CONFIGS[c["scene_id"]])
    if "vcm" in which:
        acc, _rays, ovf, _stats, _lum = vcm.render_block_with_stats(
            scene, 0, res_x, res_y, block=c["iterations"],
            base_seed=c["base_seed"], max_path_length=c["max_path_length"],
            min_path_length=c["min_path_length"],
            radius_factor=c["radius_factor"], radius_alpha=c["radius_alpha"],
            merge_backend="xla", camera_unroll="on", **CAPS,
        )
        if int(ovf) != 0:
            raise RuntimeError(f"merge caps overflowed ({int(ovf)})")
        image = np.asarray(acc, np.float32) / c["iterations"]
        _save(golden_path("vcm"), image=image, config=json.dumps(c))

    for alg in ("el", "pt"):
        if alg not in which:
            continue
        cfg = dict(c, algorithm=alg)
        acc = sum(
            np.asarray(
                eyelight.render_iteration(scene, i, res_x, res_y,
                                          c["base_seed"])
                if alg == "el" else
                pathtracer.render_iteration(
                    scene, i, res_x, res_y, c["base_seed"],
                    c["max_path_length"], c["min_path_length"]),
                np.float32)
            for i in range(c["iterations"]))
        image = (acc / c["iterations"]).astype(np.float32)
        _save(golden_path(alg), image=image, config=json.dumps(cfg))

    if "matrix" in which:
        _save(MATRIX_GOLDEN, **_render_matrix())
    if "bench" in which:
        BENCH_GOLDEN.write_text(json.dumps(_bench_counts(), indent=1) + "\n")
        print(f"wrote {BENCH_GOLDEN}")
    if "grad" not in which:
        return 0
    g = GRAD_CONFIG
    res_x, res_y = g["resolution"]
    scene = load_cornell_box((res_x, res_y), SCENE_CONFIGS[g["scene_id"]])
    params = diff.extract_params(scene)
    target = jnp.full((res_y, res_x, 3), g["target"], jnp.float32)
    out = {"config": json.dumps(g)}
    for alg in g["algorithms"]:
        if alg != "pt":
            _, _, ovf, _ = vcm.render_iteration_with_stats(
                scene, g["iteration"], res_x, res_y, g["base_seed"],
                g["max_path_length"], use_vc=False, use_vm=True, **CAPS)
            if int(ovf) != 0:
                raise RuntimeError(f"{alg}: merge caps overflowed")
        kw = {} if alg == "pt" else CAPS
        loss, grad = diff.loss_and_grad(
            scene, params, target, g["iteration"], alg, res_x, res_y,
            n_iterations=g["n_iterations"], base_seed=g["base_seed"],
            max_path_length=g["max_path_length"], **kw)
        out[f"{alg}_loss"] = np.float32(loss)
        leaves = jax.tree_util.tree_leaves(grad)
        out[f"{alg}_grad"] = np.concatenate(
            [np.asarray(x, np.float32).ravel() for x in leaves])
    _save(GRAD_GOLDEN, **out)
    return 0


def _render_matrix() -> dict:
    """Every (scene, algorithm) pair at MATRIX_CONFIG through the JAX
    package's ``render`` with its default RenderConfig otherwise."""
    from smallvcm_tpu.render import (ALGORITHMS, RenderConfig, render,
                                     resolve_algorithm)
    from smallvcm_tpu.scene.scene import SCENE_CONFIGS, load_cornell_box

    m = MATRIX_CONFIG
    res = tuple(m["resolution"])
    out = {}
    for scene_id, config in enumerate(SCENE_CONFIGS):
        scene = load_cornell_box(res, config)
        for alg in ALGORITHMS:
            cfg = RenderConfig(algorithm=alg, iterations=m["iterations"],
                               resolution=res, base_seed=m["base_seed"])
            image, _, done = render(scene, cfg)
            if done != m["iterations"]:
                raise RuntimeError(f"s{scene_id} {alg}: {done} iterations")
            key = f"s{scene_id}_{alg}"
            out[key] = np.asarray(image, np.float32)
            out[key + "_config"] = json.dumps(dict(
                m, scene_id=scene_id, algorithm=alg,
                resolved=resolve_algorithm(scene, alg),
                max_path_length=cfg.max_path_length,
                min_path_length=cfg.min_path_length,
                radius_factor=cfg.radius_factor,
                radius_alpha=cfg.radius_alpha))
            print(f"{key}: mean {out[key].mean():.6f}", flush=True)
    return out


def _bench_counts() -> dict:
    """bench.py's ray and pair count (bench.py:103-111) at BENCH_CONFIG."""
    from smallvcm_tpu import render as R
    from smallvcm_tpu.algorithms import vcm
    from smallvcm_tpu.scene.scene import SCENE_CONFIGS, load_cornell_box

    b = BENCH_CONFIG
    res_x, res_y = b["resolution"]
    scene = load_cornell_box((res_x, res_y), SCENE_CONFIGS[b["scene_id"]])
    cfg = R.RenderConfig(algorithm=b["algorithm"], resolution=(res_x, res_y))
    chunks = max(1, int(-(-int(cfg.pair_factor * res_x * res_y)
                          // (16 << 20))))
    _acc, rays, ovf, stats, _lum = vcm.render_block_with_stats(
        scene, b["iteration"], res_x, res_y, 1,
        pair_factor=cfg.pair_factor, photon_factor=cfg.photon_factor,
        query_factor=cfg.query_factor, merge_chunks=chunks,
        merge_backend=b["merge_backend"],
    )
    if int(ovf) != 0:
        raise RuntimeError(f"bench counts: merge caps overflowed ({int(ovf)})")
    pairs, photons, queries = (int(x) for x in np.asarray(stats))
    return dict(config=dict(b, pair_factor=cfg.pair_factor,
                            photon_factor=cfg.photon_factor,
                            query_factor=cfg.query_factor,
                            merge_chunks=chunks),
                rays=int(rays), candidate_pairs=pairs, live_photons=photons,
                live_queries=queries, overflow=int(ovf))


if __name__ == "__main__":
    sys.exit(main())
