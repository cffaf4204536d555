#!/usr/bin/env python3
"""Times the pyramid kernels of ``csrc/pyramid.cu`` on the card, level by level.

    python3 scripts/probe_pyramid.py [--size 3072] [--root DIR] [--reps 20]

Prints the card's name and power limit, then one JSON object (ms per call,
CUDA events around ``--reps`` calls queued while the card sleeps, so the host's
issue is not in them):

* ``ladder``, ``expand``: ``reduce_ladder`` of the size's 12-level ladder
  (uniform random data) and ``expand_ladder`` back through its bands, as the
  main path runs them, with their launches;
* with this checkout's package: the same at the tails' cuts 96, 48 and 24 px
  (``ops/cuda/pyramid.py::TAIL_CUT``), each level's fused step, down step
  alone and expand step (mode 2), and each tail from (ladder) or up to
  (expand) each level it holds, all levels below it included, and of that
  level alone;
* with a fused step that walks warp strips (``strip_rows``): each level's
  strip height, the step's bound (its bytes at 3.35 TB/s) and its time at
  other strip heights (``--sweep``), each checked bit for bit against the
  wrapper's step.

``--root DIR`` imports the package of another checkout (a parent unpacked
with ``git archive``); a checkout without the tails gets the ladder and an
expand step a level only.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=3072)
    ap.add_argument("--levels", type=int, default=12)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--root", default=REPO, help="the checkout whose package is timed")
    ap.add_argument("--sweep", default="1,2,3,4,6,8,12,16,19,24,32",
                    help="strip heights the fused step is timed at")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import importlib

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    pyramid = importlib.import_module(f"{PKG}.ops.pyramid")
    kp = importlib.import_module(f"{PKG}.ops.cuda.pyramid")
    launch = importlib.import_module(f"{PKG}.ops.cuda.launch")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())

    def ms(fn, reps=args.reps):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def counted(fn):
        launch.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return {k: v for k, v in launch.LAUNCHES.items() if v}

    def sweep(cur):
        """{rows: ms} of the fused step at each of --sweep's strip heights,
        its outputs equal to the wrapper's."""
        n, d = cur.shape[0], -(-cur.shape[0] // 2)
        band = torch.empty_like(cur)
        dn = torch.empty((d, d), dtype=torch.float32, device="cuda")
        want = kp.reduce_step(cur)
        out = {}
        for r in (int(v) for v in args.sweep.split(",")):
            def step():
                rc = launch.lib().musica_reduce_step(
                    cur.data_ptr(), 0, n, n, n, dn.data_ptr(), 0, d, band.data_ptr(), r,
                    launch.stream(cur.device))
                assert rc == 0, rc
            out[r] = ms(step)
            for g, w in zip((band, dn), want):
                assert torch.equal(g.view(torch.int32), w.view(torch.int32)), (n, r)
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(args.size, args.size, device="cuda", generator=gen)
    L = args.levels
    bands, downs = pyramid.reduce_ladder(x, L)
    top = downs[-1]

    def expand_ladder():
        if hasattr(pyramid, "expand_ladder"):
            return pyramid.expand_ladder(top, bands)
        recon = top
        for b in reversed(bands):
            recon = pyramid.upsample_add(recon, b)
        return recon

    out = {"package": os.path.abspath(args.root), "size": args.size, "levels": L}
    cuts = [getattr(kp, "TAIL_CUT", None)]
    if hasattr(kp, "TAIL_CUT"):
        cuts = [96, 48, 24]
    for cut in cuts:
        if cut is not None:
            kp.TAIL_CUT = cut
        key = f"cut {cut}" if cut is not None else "per level"
        out[key] = {"ladder_ms": ms(lambda: pyramid.reduce_ladder(x, L)),
                    "expand_ms": ms(expand_ladder),
                    "ladder_launches": counted(lambda: pyramid.reduce_ladder(x, L)),
                    "expand_launches": counted(expand_ladder)}
    if hasattr(kp, "TAIL_CUT"):
        sizes = [b.shape[-1] for b in bands]
        steps = {}
        for i, h in enumerate(sizes):
            cur = x if i == 0 else downs[i - 1]
            row = {"add_ms": ms(lambda: kp.upsample_add(downs[i], bands[i])),
                   "down_ms": ms(lambda: kp.smooth_downsample(cur))}
            if pyramid.polyphase(h):
                row["step_ms"] = ms(lambda: kp.reduce_step(cur))
                if hasattr(kp, "strip_rows"):
                    d = -(-h // 2)
                    row["step_rows"] = kp.strip_rows(h)
                    row["step_bound_ms"] = (8 * h * h + 4 * d * d) / 3.35e9
                    row["sweep_ms"] = sweep(cur)
            steps[h] = row
        tails = {}
        for i, h in enumerate(sizes):
            if h > kp.TAIL_MAX:
                continue
            cur = x if i == 0 else downs[i - 1]
            tails[h] = {"ladder_tail_ms": ms(lambda: kp.reduce_tail(cur, L - i)),
                        "ladder_level_alone_ms": ms(lambda: kp.reduce_tail(cur, 1)),
                        "expand_tail_ms": ms(lambda: kp.expand_tail(top, bands[i:])),
                        "levels": L - i}
        out["steps"] = steps
        out["tails"] = tails
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
