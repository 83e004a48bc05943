#!/usr/bin/env python3
"""Parity of the PyTorch/CUDA port against the reference renderer's means.

The counterpart of ``scripts/parity_tpu.py`` for ``smallvcm_tpu_torch``.
The reference binary is not in the repository, so every (scene, algorithm)
pair is held against the image means that PARITY.md recorded for it: the
"mean (ref)" column (the reference's HDR, 512x512, 32 iterations) and,
ungated, the "mean (ours)" column (the JAX package's render at the same
seed and count, which says whether PARITY.md is stale).

Each pair renders at 512x512 with ``--iters`` iterations (default 32,
PARITY.md's count), all in one process on ``--device`` (default the card).
The image is round-tripped through ``save_hdr`` -> ``load_hdr`` before its
mean is taken, as the reference's image was (PARITY.md's energy audit:
comparing raw floats with a decoded RGBE image fakes a ~0.1% deficit).

Statistic: z = (m_port - m_ref) / (sqrt(2) * se), where se is the standard
error of the port's per-iteration image means; sqrt(2) because the
reference's mean carries the same count's noise. Gate: |z| <= 4 on the
stochastic rows, and the deterministic eye-light (el) rows within 0.5% of
the reference. Writes a markdown table (``--out``, default PARITY_TORCH.md)
with the card's name and power limit, and exits 1 when a row fails the
gate. Imports nothing of JAX or of the JAX package.

    python scripts/torch_parity.py [--scenes 0 1 2 3] [--algs el pt ...]
        [--iters 32] [--out PARITY_TORCH.md] [--device cuda]
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PARITY_MD = ROOT / "PARITY.md"
RES = 512
Z_MAX = 4.0
EL_RTOL = 0.005


def parse_parity(text: str) -> dict:
    """PARITY.md's 512x512 table -> {(scene, alg): {"ours": m, "ref": m}}.

    Reads every markdown table whose header has "scene", "algorithm",
    "mean (ours)" and "mean (ref)" columns; a scene cell starts with its
    number ("3 (glossy small spheres + ...)")."""
    rows = {}
    cols = None
    for line in text.splitlines():
        if not line.startswith("|"):
            cols = None
            continue
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if cols is None:
            names = {c: i for i, c in enumerate(cells)}
            need = ("scene", "algorithm", "mean (ours)", "mean (ref)")
            cols = [names[c] for c in need] if all(c in names for c in need) \
                else []
            continue
        if not cols or set(cells[0]) <= set("-: "):
            continue
        scene, alg, ours, ref = (cells[i] for i in cols)
        rows[(int(scene.split()[0]), alg)] = dict(ours=float(ours),
                                                  ref=float(ref))
    if not rows:
        raise ValueError("no scene/algorithm table with mean (ours) and "
                         "mean (ref) columns")
    return rows


def z_score(mean: float, iteration_means, ref: float):
    """(se, z) of an image mean against a reference mean of the same
    iteration count: se is the standard error of the per-iteration image
    means, z = (mean - ref) / (sqrt(2) * se)."""
    m = np.asarray(iteration_means, np.float64)
    if m.size < 2:
        raise ValueError("z needs at least two iterations")
    se = float(m.std(ddof=1) / math.sqrt(m.size))
    z = (mean - ref) / (math.sqrt(2.0) * se) if se > 0 else \
        (0.0 if mean == ref else math.copysign(math.inf, mean - ref))
    return se, z


def passes(alg: str, mean: float, ref: float, z: float) -> bool:
    """The gate: el within EL_RTOL of the reference, others |z| <= Z_MAX."""
    if alg == "el":
        return abs(mean / ref - 1.0) <= EL_RTOL
    return abs(z) <= Z_MAX


def card_line(device) -> str:
    """nvidia-smi's name and power limit of the card, or the CPU's name."""
    if device.type != "cuda":
        return "cpu (no card; not a device measurement)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def render_pair(scene, alg: str, iters: int, tmp: str) -> dict:
    """Render one pair -> image mean after the RGBE round trip, the
    per-iteration image means and seconds a iteration."""
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.io.framebuffer import load_hdr, save_hdr

    sums = [0.0]

    def record(accum, done):
        sums.append(float(accum.double().sum()))

    cfg = R.RenderConfig(algorithm=alg, iterations=iters,
                         resolution=(RES, RES))
    img, secs, done, _ = R.render(scene, cfg, block_cb=record)
    save_hdr(img, f"{tmp}/port.hdr")
    decoded = load_hdr(f"{tmp}/port.hdr")
    n = img.numel()
    return dict(mean=float(decoded.mean(dtype=np.float64)),
                raw_mean=float(img.double().mean()),
                iteration_means=np.diff(sums) / n,
                runs_as=R.resolve_algorithm(scene, alg),
                s_per_iteration=secs / done)


def write_table(path: Path, rows: list, card: str, iters: int) -> None:
    lines = [
        "# PARITY_TORCH — the PyTorch/CUDA port vs the reference's means",
        "",
        f"Card: {card}. Written by `scripts/torch_parity.py` "
        f"({RES}x{RES}, {iters} iterations a pair, seed 1234, one "
        "process). `mean (port)` is the port's image after the RGBE round "
        "trip; `mean (ref)` and `mean (JAX)` are PARITY.md's \"mean (ref)\" "
        "(the reference binary) and \"mean (ours)\" (the JAX package, same "
        "seed and count). se: standard error of the port's per-iteration "
        "image means; z = (port - ref) / (sqrt(2) se). Gate: |z| <= "
        f"{Z_MAX:g}, el within {100 * EL_RTOL:g}% of the reference; the "
        "column against JAX is not gated.",
        "",
        "| scene | algorithm | runs as | mean (port) | mean (ref) | rel vs "
        "ref | se | z | gate | mean (JAX) | rel vs JAX | s/iteration |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['scene']} | {r['alg']} | {r['runs_as']} | "
            f"{r['mean']:.6f} | {r['ref']:.5f} | "
            f"{r['mean'] / r['ref'] - 1:+.5f} | {r['se']:.3g} | "
            f"{r['z']:+.2f} | {'pass' if r['ok'] else 'FAIL'} | "
            f"{r['ours']:.5f} | {r['mean'] / r['ours'] - 1:+.5f} | "
            f"{r['s_per_iteration']:.3f} |")
    stochastic = [r["z"] for r in rows if r["alg"] != "el"]
    if stochastic:
        lines += ["", f"Mean z over the {len(stochastic)} stochastic rows: "
                  f"{np.mean(stochastic):+.2f}; max |z| "
                  f"{np.max(np.abs(stochastic)):.2f}. Rows failing the "
                  f"gate: {sum(not r['ok'] for r in rows)}."]
    path.write_text("\n".join(lines) + "\n")


def main(argv=None) -> int:
    from smallvcm_tpu_torch import render as R

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--algs", nargs="+", default=list(R.ALGORITHMS),
                    choices=R.ALGORITHMS)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--out", default=str(ROOT / "PARITY_TORCH.md"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from smallvcm_tpu_torch.device import resolve_device
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    device = resolve_device(args.device)
    card = card_line(device)
    print(f"[card] {card}", flush=True)
    table = parse_parity(PARITY_MD.read_text())
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for scene_id in args.scenes:
            scene = load_cornell_box((RES, RES), SCENE_CONFIGS[scene_id],
                                     device=device)
            for alg in args.algs:
                r = render_pair(scene, alg, args.iters, tmp)
                want = table[(scene_id, alg)]
                se, z = z_score(r["mean"], r["iteration_means"], want["ref"])
                r.update(scene=scene_id, alg=alg, se=se, z=z,
                         ok=passes(alg, r["mean"], want["ref"], z), **want)
                rows.append(r)
                print(f"s{scene_id} {alg}: mean {r['mean']:.6f} (raw "
                      f"{r['raw_mean']:.6f}) vs ref {want['ref']:.5f}, z "
                      f"{z:+.2f} {'pass' if r['ok'] else 'FAIL'}; vs JAX "
                      f"{r['mean'] / want['ours'] - 1:+.5f}; "
                      f"{r['s_per_iteration']:.3f} s/iteration", flush=True)
    write_table(Path(args.out), rows, card, args.iters)
    failed = [f"s{r['scene']} {r['alg']}" for r in rows if not r["ok"]]
    print(f"wrote {args.out}; {len(rows) - len(failed)} of {len(rows)} rows "
          f"pass" + (f"; FAILED: {', '.join(failed)}" if failed else ""),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
