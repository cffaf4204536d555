#!/usr/bin/env python3
"""Time KA (``contrast_apply_kernel``, the contrast stage) against layout
and formulation variants, on one CUDA GPU.

    python3 scripts/probe_contrast.py [--rounds 5] [--only V1,V2] [--other FILE]

Each variant is a copy of ``csrc/contrast_apply.cu`` under
``build/probe_ka/`` (the package's sources are not touched) with a text
substitution, one ``nvcc -shared`` per variant, all started together.  Each
is timed through the wrapper (``ops/cuda/contrast_apply.py``, its library
swapped) at the main path's 3072^2 thorax inputs in float32 and bf16
storage (CUDA events around 20 calls queued while the GPU sleeps, with the
outputs' allocation), in interleaved rounds, and checked bit for bit
against the plain version (exact variants must be equal).

Variants:

* ``kernel``             the source as it is (2 steps of 8 pixels a thread,
                         blocks of 256 threads, 4 blocks an SM);
* ``steps1``, ``steps4``  1 or 4 steps a block;
* ``t128``, ``t512``     blocks of 128 or 512 threads;
* ``minb1``, ``minb3``   held to the registers of 1 or 3 blocks an SM;
* ``other``              with ``--other FILE``: another ``contrast_apply.cu``
                         (a version tried);
* ``no_search``          diagnostic, inexact: the gain is the sdev itself
                         (no curve lookup);
* ``no_nr``              diagnostic, inexact: the noise reduction's factor
                         constant (no CNR read);
* ``copy``               diagnostic, inexact: a gain of 1 (no sdev read, no
                         curve lookup).

The card's name and power limit come first; then, per storage, each
variant's device microseconds (min and all rounds), its registers and
whether it equals the plain version.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
PKG = "metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch"
SRC = ("contrast_apply.cu", "grid.cuh")
GAIN = "      const float g = has_sdev ? get_y(cv, np, step0, sv[st][j]) : a.hcf;"
CELL = "        const float cell = j < count[st] ? __ldg(cnr + (long long)cr * a.cnr_n + cc) : 0.0f;"


def read() -> dict:
    csrc = os.path.join(REPO, PKG, "csrc")
    return {n: open(os.path.join(csrc, n)).read() for n in SRC}


def sub(files: dict, old: str, new: str) -> dict:
    text = files["contrast_apply.cu"]
    assert old in text, f"probe pattern not found: {old!r}"
    return dict(files, **{"contrast_apply.cu": text.replace(old, new)})


def variants(other):
    """{name: (files, exact)}"""
    f = read()
    out = {
        "kernel": (f, True),
        "steps1": (sub(f, "kSteps = 2;", "kSteps = 1;"), True),
        "steps4": (sub(f, "kSteps = 2;", "kSteps = 4;"), True),
        "t128": (sub(f, "kThreads = 256;", "kThreads = 128;"), True),
        "t512": (sub(f, "kThreads = 256;", "kThreads = 512;"), True),
        "minb1": (sub(f, "kMinBlocks = 4;", "kMinBlocks = 1;"), True),
        "minb3": (sub(f, "kMinBlocks = 4;", "kMinBlocks = 3;"), True),
        "no_search": (sub(f, GAIN, "      const float g = has_sdev ? sv[st][j] : a.hcf;"), False),
        "no_nr": (sub(f, CELL, "        const float cell = 0.0f;"), False),
        "copy": (sub(sub(f, GAIN, "      const float g = 1.0f;"),
                     "    if (has_sdev) load8f(a.sdev, i0, count[st], vec, sv[st]);", ""), False),
    }
    if other:
        out["other"] = (dict(f, **{"contrast_apply.cu": open(other).read()}), True)
    return out


def build_all(found, root):
    build = importlib.import_module(PKG + ".ops.cuda.build")
    nvcc = build._nvcc()
    procs = {}
    for name, (files, _) in found.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(d, fname), "w") as fh:
                fh.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "contrast_apply.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    argtypes, restype = build._SIGNATURES["musica_contrast_apply"]
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for probe {name}:\n{log}")
        regs = re.findall(r"contrast_apply_kernelILb([01])E.*?Used (\d+) registers", log, re.S)
        lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
        lib.musica_contrast_apply.argtypes = argtypes
        lib.musica_contrast_apply.restype = restype
        libs[name] = (lib, {("bf16" if b == "1" else "f32"): int(r) for b, r in regs})
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--only", default="")
    ap.add_argument("--other", default="", help="another contrast_apply.cu to time")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_contrast: needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import (
        contrast_apply as ka)
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        synthetic_radiograph)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    found = variants(args.other)
    if args.only:
        found = {k: v for k, v in found.items() if k in args.only.split(",")}
    libs = build_all(found, os.path.join(REPO, "build", "probe_ka"))
    dev = torch.device("cuda:0")
    x = torch.from_numpy(synthetic_radiograph(3072, "thorax")).to(dev)
    real_lib = launch.lib
    for storage in ("float32", "bfloat16"):
        cfg = MusicaConfig(image_size=3072, storage=storage)
        b, sd, mb, cn = cs.contrast_inputs(x, cfg)
        cnrs = {k: (cn, 0) for k in ka.nr_levels(cfg, False)}
        want = ka.contrast_apply_plain(b, sd, mb, cnrs, cfg)[0]
        times = {k: [] for k in libs}
        exact = {}
        for _ in range(args.rounds):
            for name, (lib, _) in libs.items():
                launch.lib = lambda lib=lib: lib
                try:
                    times[name].append(1e3 * cs.cuda_ms(
                        lambda: ka.contrast_apply(b, sd, mb, cnrs, cfg), 20, 2, device_only=True))
                    got = ka.contrast_apply(b, sd, mb, cnrs, cfg)[0]
                finally:
                    launch.lib = real_lib
                exact[name] = all(torch.equal(g.float().nan_to_num(7.0).view(torch.int32),
                                              w.float().nan_to_num(7.0).view(torch.int32))
                                  for g, w in zip(got, want))
        bound = cs.contrast_bound(b, sd, mb, cn, cfg)[0] * 1e3
        print(f"{storage}: bound {bound:.2f} us (bytes)", flush=True)
        key = "bf16" if storage == "bfloat16" else "f32"
        for name, us in times.items():
            ok = exact[name] == found[name][1]
            print(f"  {name:10s} {min(us):8.2f} us  regs {libs[name][1].get(key)}  exact "
                  f"{exact[name]}{'' if ok else '  (UNEXPECTED)'}  rounds {[round(u, 2) for u in us]}",
                  flush=True)
            assert ok, name
    return 0


if __name__ == "__main__":
    sys.exit(main())
