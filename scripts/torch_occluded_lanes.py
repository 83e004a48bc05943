#!/usr/bin/env python3
"""Time the any-hit kernel at each lanes-a-thread V on one VCM iteration's
shadow-ray calls, one CUDA card, each checkout in a process of its own.

    python scripts/torch_occluded_lanes.py [ROOT ...]

Each ROOT is the root of a checkout of this repository whose any-hit entry
takes its lanes a thread from the host (``ops/sweep.py::occluded_plan``);
the default is this checkout. For each one it records the ``occluded``
calls of one 512x512 scene-0 VCM iteration (chip_smoke.record_iteration),
launches ``svcm_occluded_sweep`` on each call at every V the kernel takes,
holds each launch against ``occluded_plain`` bit for bit, and prints per
call site the summed device ms at each V, as recorded and with no live
lane (the calls' fixed cost), beside the V the plan picks; then the
largest call (2,097,152 lanes) as recorded, with one live lane, with none
and with every lane active. Kernel times are device times
(chip_smoke.time_cuda). This picks ``MIN_BLOCKS_PER_SM`` and
``MAX_LANES_PER_THREAD``; exits non-zero if a launch fails or differs.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
REPO = HERE.parent.parent


def child(root: Path) -> int:
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(REPO))
    import torch

    import chip_smoke as C
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.ops import _cuda
    from smallvcm_tpu_torch.ops import sweep as S
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    lib = _cuda.load_library()
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lanes = [1 << k for k in range(S.MAX_LANES_PER_THREAD.bit_length())]
    scene = load_cornell_box((C.RES, C.RES), SCENE_CONFIGS[0]).to(dev)
    cfg = R.RenderConfig(algorithm="vcm", iterations=1,
                         resolution=(C.RES, C.RES))
    R._ensure_merge_caps(scene, cfg, "vcm")
    calls = C.record_iteration(torch, scene, cfg)
    block = S.scene_block(scene)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launcher(p, d, dist, active, v):
        out = torch.empty_like(active)
        args = (block.data.data_ptr(), block.n_tri, block.n_sph,
                *(a.data_ptr() for a in p), p.x.numel(),
                *(a.data_ptr() for a in d), dist.data_ptr(),
                active.data_ptr(), out.data_ptr(), dist.numel(), v, stream)
        return lambda: _cuda.check(lib.svcm_occluded_sweep(*args),
                                   "svcm_occluded_sweep"), out

    rows, biggest = {}, None
    for site, args in calls["occluded"]:
        _, p, d, dist, active = S.occlusion_operands(*args)
        want = S.occluded_plain(scene, p, d, dist, active)
        for name, mask in ((site, active),
                           (f"{site}, no live lane", torch.zeros_like(
                               active))):
            r = rows.setdefault(name, dict(picked=set(), ms={}))
            r["picked"].add(S.occluded_plan(dist.numel(), n_sm)[0])
            for v in lanes:
                fn, out = launcher(p, d, dist, mask, v)
                fn()
                torch.cuda.synchronize()
                if not torch.equal(out, want & mask):
                    raise AssertionError(f"{name}, V={v}: differs from "
                                         "occluded_plain")
                r["ms"][v] = r["ms"].get(v, 0.0) + C.time_cuda(torch, fn,
                                                               20)
        if biggest is None or dist.numel() > biggest[2].numel():
            biggest = (p, d, dist, active)
    p, d, dist, active = biggest
    one = torch.zeros_like(active)
    one[int(active.nonzero()[0, 0])] = True
    for name, mask in (("masked", active), ("one live lane", one),
                       ("no live lane", torch.zeros_like(active)),
                       ("every lane", torch.ones_like(active))):
        rows[f"{dist.numel()} lanes, {name}"] = dict(
            picked={S.occluded_plan(dist.numel(), n_sm)[0]},
            ms={v: C.time_cuda(torch, launcher(p, d, dist, mask, v)[0], 20)
                for v in lanes})
    print(f"{root}: any-hit ms by lanes a thread V (plan: "
          f"MIN_BLOCKS_PER_SM={S.MIN_BLOCKS_PER_SM}, {n_sm} SMs)")
    for name, r in rows.items():
        print(f"  {name:40s} "
              + "  ".join(f"V={v}: {ms:.4f}" for v, ms in r["ms"].items())
              + f"  (plan picks V={sorted(r['picked'])})", flush=True)
    return 0


def main(roots) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)
    failed = 0
    for root in roots or [str(REPO)]:
        proc = subprocess.run([sys.executable, str(HERE), "--child",
                               str(Path(root).resolve())], timeout=900)
        failed += proc.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(Path(sys.argv[2])))
    sys.exit(main(sys.argv[1:]))
