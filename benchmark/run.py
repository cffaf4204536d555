#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port of MUSICA: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards.  The
cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix.  Set-up makes the cell's pool of phantoms on the card from the
seed, builds the port's kernels (once a checkout, into ``build/kernels``)
and captures its graphs; then a closed loop sends requests for
``--seconds`` (``--trace 1``: a fixed number of requests under the
profiler); then a sample of the outputs is compared with the plain
reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device`` (with
``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error.

Exits 2 without a result where the cell's cards are missing, and 3 where a
forbidden module (JAX or the JAX package) was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of a build or a compile at a fixed path inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "nv_compute"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import cell, spec

    print(f"torch and the harness imported {time.perf_counter() - T0:.3f} s after start",
          file=sys.stderr)

    chips = spec.workload(spec.benchmark(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    found = cell.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"cards: {card}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
