"""Checkpoint/resume for progressive rendering.

Port of ``smallvcm_tpu/checkpoint.py``. The whole inter-iteration state is
(accumulated framebuffer, iteration count, base seed) — renderer.hxx:49-55,
vertexcm.hxx:294-299 — and iteration i reads only its index (radius
schedule and RNG streams), so a resumed run is bitwise equal to an
uninterrupted one. The npz fields (``accum_fb``, ``iterations_done``,
``base_seed``, ``meta`` as JSON) are the JAX package's, so a checkpoint
written by either package loads in the other.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


def save_checkpoint(path: str, accum_fb, iterations_done: int,
                    base_seed: int, meta: dict | None = None) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(accum_fb, torch.Tensor):
        accum_fb = accum_fb.detach().cpu().numpy()
    np.savez_compressed(
        p,
        accum_fb=np.asarray(accum_fb, np.float32),
        iterations_done=iterations_done,
        base_seed=base_seed,
        meta=json.dumps(meta or {}),
    )


def load_checkpoint(path: str):
    """Returns (accum_fb tensor on the CPU, iterations_done, base_seed,
    meta)."""
    with np.load(path, allow_pickle=False) as z:
        return (
            torch.from_numpy(np.array(z["accum_fb"], np.float32)),
            int(z["iterations_done"]),
            int(z["base_seed"]),
            json.loads(str(z["meta"])),
        )


def _meta(cfg) -> dict:
    return dict(
        algorithm=cfg.algorithm,
        resolution=list(cfg.resolution),
        radius_factor=cfg.radius_factor,
        radius_alpha=cfg.radius_alpha,
        max_path_length=cfg.max_path_length,
        min_path_length=cfg.min_path_length,
    )


def render_resumable(scene, cfg, checkpoint_path: str | None = None,
                     checkpoint_every: int = 0, verbose: bool = False):
    """Progressive render with optional periodic checkpointing.

    Returns (mean image, seconds, iterations, rays) as ``render.render``
    does. If ``checkpoint_path`` exists, resumes from it: iterations
    continue at the saved index, so the result equals an uninterrupted
    run. With ``cfg.max_time > 0`` the time budget takes precedence over
    ``cfg.iterations`` (smallvcm.cxx semantics) and applies to THIS
    invocation. The checkpoint is written after every block (render.py)
    that ends ``checkpoint_every`` or more iterations after the last one
    saved; the block schedule under ``-i`` depends only on the iterations
    done, and blocks add their iterations to the running image one by one,
    so a resumed run stays bit for bit the uninterrupted one. With
    ``cfg.group`` every rank resumes from the same file and only the
    coordinator (rank 0) writes it: every rank holds the same image.
    """
    from .parallel.multihost import is_coordinator
    from .render import render

    accum = None
    start_iter = 0

    if checkpoint_path and Path(checkpoint_path).exists():
        accum, start_iter, seed, meta = load_checkpoint(checkpoint_path)
        if seed != cfg.base_seed:
            raise ValueError(
                f"checkpoint seed mismatch: saved {seed}, "
                f"config {cfg.base_seed}"
            )
        saved_alg = meta.get("algorithm")
        if saved_alg is not None and saved_alg != cfg.algorithm:
            raise ValueError(
                f"checkpoint algorithm mismatch: saved {saved_alg!r}, "
                f"config {cfg.algorithm!r}"
            )
        for field in ("resolution", "radius_factor", "radius_alpha",
                      "max_path_length", "min_path_length"):
            saved = meta.get(field)
            now = getattr(cfg, field)
            if saved is not None and tuple(np.atleast_1d(saved)) != \
                    tuple(np.atleast_1d(now)):
                raise ValueError(
                    f"checkpoint {field} mismatch: saved {saved}, "
                    f"config {now}"
                )

    last_saved = start_iter

    def block_cb(acc, done):
        nonlocal last_saved
        if not checkpoint_every or not checkpoint_path \
                or not is_coordinator():
            return
        if done - last_saved >= checkpoint_every:
            save_checkpoint(checkpoint_path, acc, done, cfg.base_seed,
                            _meta(cfg))
            last_saved = done

    return render(scene, cfg, verbose=verbose, accum=accum,
                  start_iter=start_iter, block_cb=block_cb)
