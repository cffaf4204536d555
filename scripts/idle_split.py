#!/usr/bin/env python3
"""Where the card's idle time goes between the port's graph replays, on one
CUDA GPU.

    python3 scripts/idle_split.py                  # the reference CLI's config
    python3 scripts/idle_split.py --clahe-linear   # with CLAHE and linear gradation
    python3 scripts/idle_split.py --root DIR       # another checkout's package

Runs a closed loop of requests at 3072^2, each ``graphs.run_batch`` of 8
phantoms resident on the card (what ``process_batch_jit`` calls; with
``--clahe-linear`` for the u8 and the CLAHE image) and then a synchronise,
as the benchmark's ``resident`` traffic does, and prints, with the card's
name and power limit:

* untraced, for 3 s: images per second, and the median host time of one
  ``ForwardGraph.run`` (copy in, graph launch, copies out) by
  ``time.perf_counter``;
* traced (``torch.profiler``, 64 requests): the card's idle
  share of the window (no kernel and no copy), split by the port's spans
  (``utils/spans.py``) into three parts that sum to it: inside a
  ``musica.graph`` device-side range (gaps between the captured graph's
  nodes), inside a request's device extent but in no graph (an image's
  copies' edges, the launch's latency, the host's issue between images),
  and between requests (the caller's turnaround); the median host time of
  a ``musica.replay`` span; the device busy time an image.

The profiler adds its own cost to every host span and operation, so the
traced split overstates the host's share of the gaps: it ranks their
causes and does not size them (the untraced idle is about 1 - busy ms an
image x images a second).  A checkout whose port has no ``musica.request``
spans (``--root`` of an older commit) gives the untraced numbers and no
split.  The last line of stdout is the numbers as JSON.  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW = "idle_split.window"  # the host span around the traced requests
SIZE, BATCH, REQUESTS, SECONDS = 3072, 8, 64, 3.0
PARTS = ("graph", "image", "request")
Interval = Tuple[float, float]


def _merge(iv: Sequence[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _inside(merged: List[Interval], t: float) -> bool:
    i = bisect.bisect_right(merged, (t, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def idle_split(window: Interval, ops: Sequence[Interval], spans) -> Dict[str, float]:
    """The idle time of one card in ``window``, by part: {"graph", "image",
    "request": seconds}.

    ``ops`` are the card's kernels and copies; ``spans`` are the port's
    ``(name, start, end, on_device, thread, id)``: host spans, and the
    device-side ranges the profiler draws over the operations issued inside
    a span and no inner one, each with its host span's id.  A request issues
    nothing itself, so its device extent is the hull of the ranges of the
    spans its host span holds on its thread.  Each idle gap (the window
    less the merged ``ops``) goes to one part by its midpoint."""
    w0, w1 = window
    requests = [s for s in spans if not s[3] and s[0] == "musica.request"]
    owner = {}  # the id of a host span -> the id of the request that holds it
    for name, a, b, on_device, thread, sid in spans:
        if not on_device:
            owner.update({sid: r[5] for r in requests
                          if r[4] == thread and r[1] <= a and b <= r[2]})
    hull: Dict[int, List[float]] = {}
    for name, a, b, on_device, _, sid in spans:
        if on_device and sid in owner:
            h = hull.setdefault(owner[sid], [a, b])
            h[0], h[1] = min(h[0], a), max(h[1], b)
    graphs = _merge([(a, b) for name, a, b, on_device, *_ in spans
                     if on_device and name == "musica.graph"])
    extents = _merge([(a, b) for a, b in hull.values()])
    out = dict.fromkeys(PARTS, 0.0)
    edge = w0
    for a, b in _merge([(max(a, w0), min(b, w1)) for a, b in ops if a < w1 and b > w0]) \
            + [(w1, w1)]:
        if a > edge:
            mid = (edge + a) / 2
            part = ("graph" if _inside(graphs, mid) else
                    "image" if _inside(extents, mid) else "request")
            out[part] += a - edge
        edge = max(edge, b)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clahe-linear", action="store_true",
                    help="ENABLE_CLAHE and GRAD_WITH_LINEAR_IMAGE, both outputs a request")
    ap.add_argument("--root", default=REPO,
                    help="the checkout whose package to run (default: this one)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("idle_split: needs a CUDA GPU", file=sys.stderr)
        return 1
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import graphs, musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        synthetic_radiograph)
    assert os.path.abspath(musica.__file__).rsplit(os.sep, 3)[0] == os.path.abspath(args.root), \
        musica.__file__

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    cfg = MusicaConfig(image_size=SIZE, enable_clahe=args.clahe_linear,
                       grad_with_linear_image=args.clahe_linear)
    outputs = ("out_u8", "clahe_graded") if args.clahe_linear else ("out_u8",)
    anatomies = ("thorax", "hand", "knee", "foot")
    pool = torch.stack([torch.from_numpy(synthetic_radiograph(SIZE, anatomies[i % 4], seed=i))
                        for i in range(BATCH)]).cuda()

    def request():
        graphs.run_batch(musica.musica_forward, pool, cfg, False, outputs)
        torch.cuda.synchronize()

    for _ in range(3):  # kernel build, capture, replays
        request()

    run, issue = graphs.ForwardGraph.run, []

    def timed_run(self, x, into):
        t = time.perf_counter()
        run(self, x, into)
        issue.append(time.perf_counter() - t)

    graphs.ForwardGraph.run = timed_run
    images, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < SECONDS:
        request()
        images += BATCH
    img_per_s = images / (time.perf_counter() - t0)
    graphs.ForwardGraph.run = run

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(64):  # opens the device record before the window
            torch.cuda._sleep(20_000)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            for _ in range(REQUESTS):
                request()
    events = prof.events()
    win = next(e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU)
    window = (win.time_range.start / 1e6, win.time_range.end / 1e6)
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [(e.time_range.start / 1e6, e.time_range.end / 1e6) for e in dev
           if not e.name.startswith(("musica.", WINDOW)) and "spin_kernel" not in e.name]
    kernels = [e for e in dev if not e.name.startswith(("musica.", WINDOW, "Memcpy", "Memset"))
               and window[0] <= e.time_range.start / 1e6 <= window[1]]
    spans = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6,
              e.device_type == DeviceType.CUDA, e.thread, e.id)
             for e in events if e.name in ("musica.request", "musica.replay", "musica.graph")]
    window_s = window[1] - window[0]
    n = REQUESTS * BATCH
    res = {"card": card, "package": args.root,
           "variant": "clahe-linear" if args.clahe_linear else "default", "img_per_s": img_per_s,
           "run_us_untraced": 1e6 * statistics.median(issue),
           "busy_ms_per_img": 1e3 * sum(e.time_range.elapsed_us() / 1e6 for e in kernels) / n}
    part = idle_split(window, ops, spans)
    res["idle_pct"] = 100 * sum(part.values()) / window_s
    if any(s[0] == "musica.request" for s in spans):
        res.update({f"{p}_gap_pct": 100 * part[p] / window_s for p in PARTS})
        res["replay_us_traced"] = 1e6 * statistics.median(
            b - a for name, a, b, on_device, *_ in spans
            if not on_device and name == "musica.replay")
    print(f"card: {card}; package {args.root}")
    print(f"{SIZE}^2, requests of {BATCH}, {res['variant']}: untraced "
          f"{img_per_s:.1f} img/s, ForwardGraph.run {res['run_us_untraced']:.1f} us (median); "
          f"traced window {window_s:.4f} s, busy {res['busy_ms_per_img']:.4f} ms/img, "
          f"idle {res['idle_pct']:.3f} %")
    if "graph_gap_pct" in res:
        print("idle split, % of the window: " + ", ".join(
            f"{p} {res[p + '_gap_pct']:.4f}" for p in PARTS)
            + f"; musica.replay host {res['replay_us_traced']:.1f} us (median, traced)")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
