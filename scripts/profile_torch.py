#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path, on one CUDA GPU.

    python3 scripts/profile_torch.py [--size 3072] [--reps 5] [--out DIR]

Runs ``musica_forward`` on a device-resident synthetic radiograph under
``torch.profiler`` and prints, with the card's name and power limit:

* the wall time per image (CUDA events), the kernel launches per image and
  the device's busy share (sum of kernel times over wall time);
* per ``musica.<phase>`` span, the host time spent issuing its ops and its
  span on the device timeline;
* the kernels with the most device time.

A Chrome trace of the run goes to ``DIR/trace.json`` (default
``build/profile_torch``).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=3072)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--anatomy", default="thorax")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile_torch"))
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA GPU", file=sys.stderr)
        return 1
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import (
        synthetic_radiograph)
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    cfg = MusicaConfig(image_size=args.size)
    x = torch.from_numpy(synthetic_radiograph(args.size, args.anatomy)).cuda()
    for _ in range(3):  # warm-up: kernel build, allocator, cuBLAS-free path
        musica.musica_forward(x, cfg)["out_u8"]
    torch.cuda.synchronize()

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(args.reps):
            musica.musica_forward(x, cfg)["out_u8"]
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / args.reps
    events = prof.key_averages()
    on_gpu = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in on_gpu if not e.key.startswith("musica.")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / args.reps
    launches = sum(e.count for e in kernels) / args.reps

    print(f"card: {card}")
    print(f"{args.size}^2 {args.anatomy}, {args.reps} reps under the profiler: "
          f"{wall:.3f} ms/img wall (CUDA events), {launches:.0f} kernels/img, "
          f"device busy {busy:.3f} ms/img = {100 * busy / wall:.1f} %")
    # a span has a host row (time spent issuing its ops) and a device row
    # (first to last kernel of the span on the GPU timeline)
    host = {e.key: e.cpu_time_total for e in events
            if e.key.startswith("musica.") and e.device_type == DeviceType.CPU}
    span = {e.key: e.device_time_total for e in on_gpu if e.key.startswith("musica.")}
    print("per phase, ms/img:       host issue   device span")
    for k in sorted(host, key=lambda k: -host[k]):
        print(f"  {k:20s} {host[k] / 1e3 / args.reps:12.3f} "
              f"{span.get(k, 0.0) / 1e3 / args.reps:13.3f}")
    print("top kernels by device time (ms/img, launches/img):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / args.reps:9.3f} "
              f"{e.count / args.reps:7.1f}  {e.key[:110]}")
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
