"""--report mode: all 4 scenes x 7 algorithms -> BMPs + index.html.

Port of ``smallvcm_tpu/report.py`` (FullReport, smallvcm.cxx:156-263):
renders every combination, saves gamma-2.2 BMPs with the reference's
default filenames, and emits the thumbnail matrix with the good/poor
border colours and the 4-way PPM/BPM/BPT/VCM split per scene.

Every combination renders in this process, one after another, through the
CLI's render (``cli.render_one``) on the ``--device`` the report was given,
with the report's flags; ``--devices``, ``--isolate`` and ``--checkpoint``
are ignored, as the JAX package's report ignores them. Each combination
has the device to itself: the previous one's scene, image and CUDA graphs
are released (the graphs through their finalizers, graphs.py) and the
allocator's cache emptied before the next starts, so ``-t`` budgets compare
like with like. Results (elapsed/iterations) persist in
``report_state.json`` and ``index.html`` is rewritten after every
combination, so a killed run resumes where it left off and always leaves a
viewable report behind. A combination that raises is reported and the
others still render; the run exits non-zero at the end. It is never
retried, nor rendered on another backend or the CPU, which would hide a
kernel failure. A CUDA fault that poisons the context fails every
combination after it as well: the state file keeps what finished, and a
re-run in a fresh process resumes from there.
"""

from __future__ import annotations

import gc
import json
import os
import time
from pathlib import Path

import torch

from . import cli
from .device import resolve_device
from .io.html import (GOOD_ALGORITHMS, GREEN, NONE, POOR_ALGORITHMS, RED,
                      HtmlWriter)
from .render import ALGORITHM_NAMES, ALGORITHMS
from .scene.scene import SCENE_CONFIGS, get_scene_name

STATE_FILE = "report_state.json"


def _effective_settings(args) -> dict:
    """The render settings a completed combo must have been produced
    with for resume to skip it. Stored in every state record; a --report
    re-run with different settings re-renders instead of silently reusing
    stale images."""
    return {
        "resolution": list(args.resolution),
        "seed": args.seed,
        "iterations": args.iterations,
        "max_time": args.max_time,
        "max_path_length": args.max_path_length,
        "min_path_length": args.min_path_length,
        "radius_factor": args.radius_factor,
        "radius_alpha": args.radius_alpha,
        "rng_kind": args.rng_kind,
        "merge_backend": args.merge_backend,
        "trace_backend": args.trace_backend,
        "device": args.device,
    }


def _load_state() -> dict:
    try:
        return json.loads(Path(STATE_FILE).read_text())
    except (OSError, ValueError):
        return {}


def _save_state(state: dict) -> None:
    Path(STATE_FILE).write_text(json.dumps(state, indent=1))


def _write_html(results: dict, args) -> None:
    """(Re)build index.html from every completed combination so far."""
    html = HtmlWriter("index.html")
    split_acronyms = ["PPM", "BPM", "BPT", "VCM"]
    resolution = tuple(args.resolution)

    for scene_id, scene_config in enumerate(SCENE_CONFIGS):
        scene_name, _ = get_scene_name(scene_config)
        html.add_scene(scene_name)
        split_files = ["", "", "", ""]
        split_borders = [NONE] * 4
        for alg in ALGORITHMS:
            filename = cli.build_default_filename(scene_config, alg)
            rec = results.get(filename)
            if rec is None:
                continue
            border = NONE
            if alg in POOR_ALGORITHMS[scene_id]:
                border = RED
            if alg in GOOD_ALGORITHMS[scene_id]:
                border = GREEN
            html.add_rendering(
                ALGORITHM_NAMES[alg], filename, rec["elapsed"], border,
                f"<br/>Iterations: {rec['iters']}",
            )
            if alg in ("ppm", "bpm", "bpt", "vcm"):
                idx = ("ppm", "bpm", "bpt", "vcm").index(alg)
                split_files[idx] = filename
                split_borders[idx] = border
        html.add_four_way_split(
            split_files, split_acronyms, split_borders, resolution[0]
        )
    html.close()


def _release(device: torch.device) -> None:
    """Free what the last combination left: its scene, image and graphs
    (their finalizers run once the scene's tensors die), and the device
    memory the allocator kept cached for them."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def full_report(args) -> None:
    state = _load_state()
    start = time.time()
    settings = _effective_settings(args)
    device = resolve_device(args.device)
    failed = []
    for scene_id, config in enumerate(SCENE_CONFIGS):
        print(f"Scene: {get_scene_name(config)[0]}")
        for alg in ALGORITHMS:
            filename = cli.build_default_filename(config, alg)
            rec = state.get(filename)
            if rec is not None and os.path.exists(filename) \
                    and rec.get("settings") == settings:
                print(f"Running {ALGORITHM_NAMES[alg]}... "
                      f"already done ({rec['elapsed']:.2f} s)", flush=True)
                continue
            print(f"Running {ALGORITHM_NAMES[alg]}... ", end="", flush=True)
            try:
                elapsed, iters = cli.render_one(args, scene_id, alg,
                                                filename, device)
            except Exception as e:
                # Keep going: every other combo still renders and the HTML
                # stays viewable; a re-run renders only the failures.
                print(f"FAILED ({type(e).__name__}: {e})", flush=True)
                failed.append(filename)
                continue
            finally:
                _release(device)
            print(f"done in {elapsed:.2f} s")
            state[filename] = {"elapsed": elapsed, "iters": iters,
                               "scene": scene_id, "alg": alg,
                               "settings": settings}
            _save_state(state)
            _write_html(state, args)

    _write_html(state, args)
    print(f"Whole run took {time.time() - start:.2f} s")
    if failed:
        print(f"INCOMPLETE: {len(failed)} combination(s) failed "
              f"({', '.join(failed)}); re-run --report to retry them.")
        raise SystemExit(1)
