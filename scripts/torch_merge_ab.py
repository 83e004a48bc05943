#!/usr/bin/env python3
"""Run chip_smoke.py's merge phase (phase 4) of several checkouts in turn
on one CUDA card, each in a process of its own, to compare two versions of
the port's merge kernel within one run on one card.

    python scripts/torch_merge_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repository (for example a
parent commit unpacked with ``git archive`` into a git-ignored directory);
that checkout's chip_smoke.py and smallvcm_tpu_torch build and run. Prints
the card, then for each run its ptxas lines, its merge lines and its
result (the walk's dict, and the preparation's where the checkout's phase 4
checks csrc/merge_prep.cu too), and exits non-zero if any run fails.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

_CODE = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from smallvcm_tpu_torch.ops import _cuda
_cuda.load_library()
for line in (_cuda.library_path().parent / "build.log").read_text().splitlines():
    if "registers" in line or "Compiling entry" in line or "spill" in line:
        print("  ptxas:", line.strip())
r = c.check_merge(torch, torch.device("cuda", 0))
print("RESULT", json.dumps(r))
"""


def main(roots) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)
    failed = 0
    for i, root in enumerate(roots):
        root = Path(root).resolve()
        print(f"[run {i}] {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", _CODE], cwd=root,
                              capture_output=True, text=True, timeout=900)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
