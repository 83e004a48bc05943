"""--report mode: all 4 scenes x 7 algorithms -> BMPs + index.html.

Port of ``smallvcm_tpu/report.py`` (FullReport, smallvcm.cxx:156-263):
renders every combination, saves gamma-2.2 BMPs with the reference's
default filenames, and emits the thumbnail matrix with the good/poor
border colours and the 4-way PPM/BPM/BPT/VCM split per scene.

Every combination renders in its own subprocess through the port's CLI, on
the ``--device`` the report was given; with ``-i`` up to ``REPORT_JOBS`` of
them at once, with ``-t`` one at a time. Results (elapsed/iterations)
persist in ``report_state.json`` and ``index.html`` is rewritten after
every combination, so a killed run resumes where it left off and always
leaves a viewable report behind. A combination that fails is reported and
the run exits non-zero at the end; it is never retried with another
backend, which would hide a kernel failure.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .io.html import (GOOD_ALGORITHMS, GREEN, NONE, POOR_ALGORITHMS, RED,
                      HtmlWriter)
from .render import ALGORITHM_NAMES, ALGORITHMS
from .scene.scene import SCENE_CONFIGS, get_scene_name

# The CLI's "done in 1.23 s (4 iterations, 5678 rays)" line.
_DONE_RE = re.compile(r"done in ([0-9.]+) s \((\d+) iterations?[,)]")

STATE_FILE = "report_state.json"

# Combinations rendered at once when the budget is an iteration count.
REPORT_JOBS = 4


def _render_combo(scene_id: int, alg: str, filename: str, args):
    """Render one (scene, algorithm) via the CLI in a subprocess.

    Returns (elapsed_seconds, iterations); raises RuntimeError when the
    subprocess fails or writes no image."""
    # The report typically runs with cwd set to the OUTPUT directory;
    # make the package importable in the child regardless.
    env = dict(os.environ)
    pkg_root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = (
        pkg_root + os.pathsep + env["PYTHONPATH"]
        if env.get("PYTHONPATH") else pkg_root
    )
    cmd = [
        sys.executable, "-m", "smallvcm_tpu_torch.cli",
        "-s", str(scene_id), "-a", alg, "-o", filename,
        "--resolution", str(args.resolution[0]), str(args.resolution[1]),
        "--seed", str(args.seed),
        "--max-path-length", str(args.max_path_length),
        "--min-path-length", str(args.min_path_length),
        "--radius-factor", str(args.radius_factor),
        "--radius-alpha", str(args.radius_alpha),
        "--device", args.device,
        # One process per combination: the report runs several at once.
        "--devices", "1",
    ]
    if args.max_time > 0:
        cmd += ["-t", str(args.max_time)]
    else:
        cmd += ["-i", str(args.iterations)]

    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    m = _DONE_RE.search(proc.stdout or "")
    if proc.returncode == 0 and m and os.path.exists(filename):
        return float(m.group(1)), int(m.group(2))
    raise RuntimeError(
        f"report combo scene {scene_id} alg {alg} failed "
        f"(rc={proc.returncode}): {(proc.stderr or '').strip()[-400:]}"
    )


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
    from .cli import build_default_filename

    html = HtmlWriter("index.html")
    split_acronyms = ["PPM", "BPM", "BPT", "VCM"]
    resolution = tuple(args.resolution)

    for scene_id, scene_config in enumerate(SCENE_CONFIGS):
        scene_name, _ = get_scene_name(scene_config)
        html.add_scene(scene_name)
        split_files = ["", "", "", ""]
        split_borders = [NONE] * 4
        for alg in ALGORITHMS:
            filename = build_default_filename(scene_config, alg)
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


def full_report(args) -> None:
    from .cli import build_default_filename

    state = _load_state()
    start = time.time()
    settings = _effective_settings(args)
    combos = [(scene_id, alg, build_default_filename(config, alg))
              for scene_id, config in enumerate(SCENE_CONFIGS)
              for alg in ALGORITHMS]
    todo = [c for c in combos
            if not (c[2] in state and os.path.exists(c[2])
                    and state[c[2]].get("settings") == settings)]
    # Each subprocess spends most of its life importing torch and loading
    # CUDA modules, not rendering. With an iteration count the images do
    # not depend on what else runs, so REPORT_JOBS combinations run at
    # once; under a time budget (-t) each has the device to itself, as
    # the reference's equal-time comparison needs.
    failed = []
    with ThreadPoolExecutor(1 if args.max_time > 0 else REPORT_JOBS) as pool:
        running = {c: pool.submit(_render_combo, *c, args) for c in todo}
        for scene_id, alg, filename in combos:
            if alg == ALGORITHMS[0]:
                print(f"Scene: {get_scene_name(SCENE_CONFIGS[scene_id])[0]}")
            if (scene_id, alg, filename) not in running:
                print(f"Running {ALGORITHM_NAMES[alg]}... "
                      f"already done ({state[filename]['elapsed']:.2f} s)",
                      flush=True)
                continue
            print(f"Running {ALGORITHM_NAMES[alg]}... ", end="", flush=True)
            try:
                elapsed, iters = running[scene_id, alg, filename].result()
            except RuntimeError as e:
                # Keep going: every other combo still renders and the HTML
                # stays viewable; a re-run retries only the failures.
                print(f"FAILED ({e})", flush=True)
                failed.append(filename)
                continue
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
