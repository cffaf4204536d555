#!/usr/bin/env python3
"""Throughput of the PyTorch port's main path on CUDA GPUs.

    python3 scripts/bench_torch.py                  # one line of JSON, on the card(s)
    python3 scripts/bench_torch.py --device cpu --size 256 --windows 1 --calls 1
                                                    # a light run on the CPU
    python3 scripts/bench_torch.py --configs 1x4,2x2        # also spatial meshes

Input: a device-resident ``synthetic_radiograph(size, "thorax")`` (uint16),
the image of the JAX package's ``bench.py``.  Warm-up: the kernel build and
the graphs' capture, then 3 runs (as many as ``--windows`` where it is
fewer).  The legs, in GPix/s (size² pixels per image), measure the
production entries, which replay captured CUDA graphs (``models/graphs.py``):

* single image: ``process_jit`` one call after another, 5 windows
  (``--windows``) of 10 calls (``--calls``) between CUDA events (the host's
  issue time included), the median window;
* batch: ``process_batch_jit`` of 4 copies of the image, 5 windows of 2
  calls (a fifth of ``--calls``, at least 1), the median window;
* mesh: ``parallel.sharding.throughput_step`` over every visible card, 4
  random images per card, the host clock around 5 steps (``--windows``;
  each ends with its checksum on the host), the median step;
* ``single_image_eager_gpix`` and ``batch_eager_gpix``: the same single and
  batch windows of eager ``musica_forward`` and ``forward_batch``, the
  legs the bench measured before the graphs.  The four single and batch
  legs run in interleaved windows, so the host's drift falls on all;
* ``spatial``: per ``--configs`` mesh shape DxS (``scripts/bench_mesh.py``'s
  flag), ``throughput_step`` over ``make_mesh(n_data=D, n_space=S)``, each
  image's rows split over S entries (one image a data row a step, a replay
  of the row's captured graph, ``graphs.SpatialGraph``), the host clock
  around 5 steps (whatever ``--windows`` says), the median step:
  ``ms_per_img`` (a step over D images, so the latency of one image at
  D = 1) and ``gpix``.  The entries take the visible cards in order and
  wrap around where there are fewer cards than entries (several entries on
  one card, each on its stream); ``devices`` names them.

``value`` is the better of the single-image and batch rates, one card's
rate as in ``bench.py``; the mesh rate is that of all the cards together.
The line names the card and its power limit as ``nvidia-smi`` reports them.
Without a card the script exits 1, unless ``--device cpu`` asks for the
CPU, where the host clock replaces the CUDA events and the line says
``"platform": "cpu"``.  No TPU figure is a target here.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

BATCH = 4
WINDOWS = 5  # the single, batch and mesh legs' windows (--windows)
SINGLE_CALLS = 10  # calls a single-image window (--calls); a batch window: a fifth
SPATIAL_STEPS = 5


def card() -> tuple[str, float]:
    """(name, power limit in W) of the first card, from nvidia-smi."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    name, limit = (x.strip() for x in line.rsplit(",", 1))
    return name, float(limit.split()[0])


def window_ms(fn, calls: int, dev) -> float:
    """ms per call over ``calls`` calls of ``fn``: between CUDA events on a
    CUDA device, on the host clock on the CPU."""
    import torch
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3 / calls
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def median(xs):
    return sorted(xs)[len(xs) // 2]


def spatial_leg(cfg, configs, dev) -> list:
    """The ``spatial`` entries: per (data, space) shape, the median of
    ``SPATIAL_STEPS`` throughput steps over that mesh (after one warm-up step)."""
    import torch

    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
    out = []
    for d, s in configs:
        if dev.type == "cuda":
            cards = torch.cuda.device_count()
            devices = [torch.device("cuda", j % cards) for j in range(d * s)]
        else:
            devices = [dev] * (d * s)
        step, example = sharding.throughput_step(cfg, sharding.make_mesh(d, s, devices))
        int(step(example))
        steps = []
        for _ in range(SPATIAL_STEPS):
            t0 = time.perf_counter()
            int(step(example))
            steps.append(time.perf_counter() - t0)
        ms = median(steps) * 1e3 / d
        out.append({"data": d, "space": s, "ms_per_img": ms,
                    "gpix": cfg.image_size ** 2 / ms / 1e6,
                    "devices": [str(x) for x in devices], "steps_ms": [t * 1e3 for t in steps]})
    return out


def parse_configs(text: str) -> list:
    """``"1x4,2x2"`` -> [(1, 4), (2, 2)]."""
    return [tuple(int(v) for v in c.split("x")) for c in text.split(",") if c]


def measure(device: str = "cuda", size: int = 3072, configs=(), windows: int = WINDOWS,
            calls: int = SINGLE_CALLS) -> dict:
    """The three legs on ``device`` (``"cuda"``: the first card for single
    and batch, every visible card for the mesh), ``windows`` windows of
    ``calls`` single-image calls each (a batch window: ``calls // 5``, at
    least 1), and the spatial meshes of ``configs`` ((data, space) pairs);
    returns the JSON record."""
    import torch

    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        synthetic_radiograph)

    dev = torch.device(device)
    cfg = MusicaConfig(image_size=size)
    x = musica.to_device(synthetic_radiograph(size, "thorax"), dev)
    if dev.type == "cuda":
        dev = x.device
        launch.lib()
        mesh = sharding.make_mesh()
        name, power = card()
    else:
        mesh = sharding.make_mesh(devices=[dev])
        name, power = "cpu", None
    xb = torch.stack([x] * BATCH)
    step, example = sharding.throughput_step(cfg, mesh, batch_per_device=BATCH)

    batch_calls = max(1, calls // 5)
    legs = {"single": (lambda: musica.process_jit(x, cfg), calls, 1),
            "single_eager": (lambda: musica.musica_forward(x, cfg)["out_u8"], calls, 1),
            "batch": (lambda: musica.process_batch_jit(xb, cfg), batch_calls, BATCH),
            "batch_eager": (lambda: musica.forward_batch(xb, cfg), batch_calls, BATCH)}
    for _ in range(min(3, windows)):
        for fn, _, _ in legs.values():
            fn()
    int(step(example))

    times = {k: [] for k in legs}
    for _ in range(windows):
        for k, (fn, n_calls, images) in legs.items():
            times[k].append(window_ms(fn, n_calls, dev) / images)
    ms = {k: median(w) for k, w in times.items()}
    steps = []
    for _ in range(windows):
        t0 = time.perf_counter()
        int(step(example))  # the checksum on the host: every device has finished
        steps.append(time.perf_counter() - t0)
    mpix = size * size / 1e6
    single_gpix = mpix / ms["single"]
    batch_gpix = mpix / ms["batch"]
    mesh_gpix = BATCH * len(mesh) * size * size / median(steps) / 1e9
    spatial = spatial_leg(cfg, configs, dev)
    return {"metric": "musica_3072_gpix_per_s", "value": max(single_gpix, batch_gpix),
            "unit": "GPix/s", "single_image_gpix": single_gpix, "batch_gpix": batch_gpix,
            "single_image_eager_gpix": mpix / ms["single_eager"],
            "batch_eager_gpix": mpix / ms["batch_eager"],
            "batch_size": BATCH, "mesh_gpix": mesh_gpix, "devices": len(mesh), "size": size,
            "spatial": spatial, "platform": dev.type, "device": name, "power_limit": power}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the visible cards) or cpu")
    ap.add_argument("--size", type=int, default=3072)
    ap.add_argument("--configs", default="",
                    help="comma-separated DxS spatial mesh shapes (data x space), e.g. 1x4,2x2")
    ap.add_argument("--windows", type=int, default=WINDOWS,
                    help=f"windows of the single, batch and mesh legs (default {WINDOWS}; "
                         f"the spatial leg always takes {SPATIAL_STEPS} steps)")
    ap.add_argument("--calls", type=int, default=SINGLE_CALLS,
                    help=f"calls a single-image window (default {SINGLE_CALLS}); a batch "
                         "window makes a fifth as many, at least 1")
    args = ap.parse_args(argv)
    import torch
    if args.device != "cpu" and not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is False: this bench needs a CUDA "
              "GPU (--device cpu runs it on the CPU)", file=sys.stderr)
        return 1
    if args.windows < 1 or args.calls < 1:
        ap.error("--windows and --calls take at least 1")
    print(json.dumps(measure(args.device, args.size, parse_configs(args.configs), args.windows,
                             args.calls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
