#!/usr/bin/env python3
"""Time KA (``contrast_apply_kernel``, the contrast stage) against layout
and formulation variants and a parent checkout's, on one CUDA GPU.

    python3 scripts/probe_contrast.py [--rounds 5] [--only V1,V2] [--parent DIR] [--other FILE]

Each variant is a copy of ``csrc/contrast_apply.cu`` under
``build/probe_ka/`` (the package's sources are not touched) with a text
substitution, one ``nvcc -shared`` per variant, all started together.  Each
is timed through the wrapper (``ops/cuda/contrast_apply.py``, its library
swapped; the C interface is the same) at the main path's 3072^2 thorax
inputs in float32 and bf16 storage (CUDA events around 20 calls queued
while the GPU sleeps, with the outputs' allocation), in interleaved rounds,
and checked bit for bit against the plain version (exact variants must be
equal).

Variants:

* ``kernel``             the source as it is (a one-wave grid walking the
                         levels' chunks, 512 threads a block, 2 groups of 4
                         pixels a thread,
                         kStages = 2 chunks in a ring in shared memory
                         (cp.async), every curve built once a block, getY's
                         count from a bucket table, a group's CNR cell once);
* ``parent``             with ``--parent DIR``: that checkout's
                         ``contrast_apply.cu`` (its ``grid.cuh``);
* ``other``              with ``--other FILE``: another ``contrast_apply.cu``;
* ``minb1``, ``minb3``   held to the registers of 1 or 3 blocks an SM;
* ``stages3``, ``stages4``  3 or 4 chunks in the ring;
* ``no_cell4``           every group walks its pixels' cells (exact);
* ``groups1``, ``groups4``  1 or 4 groups of 4 pixels a thread a chunk;
* ``t256``, ``t1024``    blocks of 256 or 1,024 threads;
* ``streaming``          the outputs stored with the evict-first hint
                         (``__stcs``);
* ``shift17``            64 buckets an octave (1,024 buckets);
* ``skip_empty``         a bucket also holds how many points lie in it, and
                         an empty bucket's count reads no key;
* ``full_search``        every level takes the branch-free 6-step search
                         over the +inf-padded points (exact: the parent's
                         search on the new walk);
* ``no_search``          diagnostic, inexact: the gain is the sdev itself
                         (no curve lookup);
* ``no_nr``              diagnostic, inexact: the noise reduction's cells
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
GAIN = "e[j] = S::round(__fmul_rn(b[j], get_y(cv, k, np, bucketed, sd[j])));"
CELL = "__ldg(cnr + cr * a.cnr_n + cc)"
SDEV = "      if (a.sdev != nullptr) cp_async16(&st.sdev[g][t], a.sdev + i);"
SKIP_BUILD_OLD = """      cv.bucket[k][b] = (unsigned char)lo;
      if (points_below(cv.keys[k], np, b + 1) - lo > 2) cv.bucketed[k] = 0;"""
SKIP_BUILD_NEW = """      const int len = points_below(cv.keys[k], np, b + 1) - lo;
      cv.bucket[k][b] = (unsigned char)(lo | (min(len, 3) << 6));
      if (len > 2) cv.bucketed[k] = 0;"""
SKIP_GET_OLD = """    const int lo = cv.bucket[k][bucket_of(x)];
    const int c = lo + (int)!(keys[lo] >= x) + (int)!(keys[lo + 1] >= x);"""
SKIP_GET_NEW = """    const unsigned e = cv.bucket[k][bucket_of(x)];
    const int lo = (int)(e & 63u);
    const float inf = __int_as_float(0x7f800000);
    const float k0 = e >= 64u ? keys[lo] : inf, k1 = e >= 128u ? keys[lo + 1] : inf;
    const int c = lo + (int)!(k0 >= x) + (int)!(k1 >= x);"""
ST32 = "      *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);"
ST16 = "      *reinterpret_cast<uint2*>(q) = make_uint2(lo, hi);"


def read(root: str = REPO) -> dict:
    csrc = os.path.join(root, PKG, "csrc")
    return {n: open(os.path.join(csrc, n)).read() for n in SRC}


def sub(files: dict, old: str, new: str) -> dict:
    text = files["contrast_apply.cu"]
    assert old in text, f"probe pattern not found: {old!r}"
    return dict(files, **{"contrast_apply.cu": text.replace(old, new)})


def variants(parent, other):
    """{name: (files, exact)}"""
    f = read()
    out = {
        "kernel": (f, True),
        "minb1": (sub(f, "kMinBlocks = 2;", "kMinBlocks = 1;"), True),
        "minb3": (sub(f, "kMinBlocks = 2;", "kMinBlocks = 3;"), True),
        "stages3": (sub(f, "kStages = 2;", "kStages = 3;"), True),
        "stages4": (sub(f, "kStages = 2;", "kStages = 4;"), True),
        "no_cell4": (sub(f, "p.cell4[k] = a.scale % 4 == 0 && a.n % 4 == 0;", "p.cell4[k] = 0;"),
                     True),
        "groups1": (sub(f, "kGroups = 2;", "kGroups = 1;"), True),
        "groups4": (sub(f, "kGroups = 2;", "kGroups = 4;"), True),
        "t256": (sub(sub(f, "kThreads = 512;", "kThreads = 256;"), "kMinBlocks = 2;",
                     "kMinBlocks = 4;"), True),
        "t1024": (sub(sub(f, "kThreads = 512;", "kThreads = 1024;"), "kMinBlocks = 2;",
                      "kMinBlocks = 1;"), True),
        "streaming": (sub(sub(f, ST32, ST32.replace("*reinterpret_cast<float4*>(q) = ", "__stcs("
                                                    "reinterpret_cast<float4*>(q), ")
                              .replace(");", "));")),
                          ST16, ST16.replace("*reinterpret_cast<uint2*>(q) = ", "__stcs("
                                             "reinterpret_cast<uint2*>(q), ").replace(");", "));")),
                      True),
        "shift17": (sub(sub(f, "kBucketShift = 18;", "kBucketShift = 17;"), "kBuckets = 512;",
                        "kBuckets = 1024;"), True),
        "full_search": (sub(f, "const bool bucketed = cv.bucketed[k] != 0;",
                            "const bool bucketed = false;"), True),
        "skip_empty": (sub(sub(f, SKIP_BUILD_OLD, SKIP_BUILD_NEW), SKIP_GET_OLD, SKIP_GET_NEW), True),
        "no_search": (sub(f, GAIN, "e[j] = S::round(__fmul_rn(b[j], sd[j]));"), False),
        "no_nr": (sub(f, CELL, "0.0f"), False),
        "copy": (sub(sub(f, GAIN, "e[j] = S::round(b[j]);"), SDEV, ""), False),
    }
    if parent:
        out["parent"] = (read(parent), True)
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
            if name == "kernel":
                raise RuntimeError(f"nvcc failed for probe {name}:\n{log}")
            print(f"nvcc failed for probe {name}; left out:\n{log[-3000:]}", flush=True)
            continue
        regs = re.findall(r"Compiling entry function '\S*contrast_apply_kernelILb([01])E.*?"
                          r"(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S)
        lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
        lib.musica_contrast_apply.argtypes = argtypes
        lib.musica_contrast_apply.restype = restype
        libs[name] = (lib, {("bf16" if b == "1" else "f32"): f"{r} (spills {sp} B)"
                            for b, sp, r in regs})
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--only", default="")
    ap.add_argument("--parent", default="", help="root of another checkout whose KA is timed")
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
    found = variants(args.parent, args.other)
    if args.only:
        found = {k: v for k, v in found.items() if k in args.only.split(",")}
    libs = build_all(found, os.path.join(REPO, "build", "probe_ka"))
    dev = torch.device("cuda:0")
    x = torch.from_numpy(synthetic_radiograph(3072, "thorax")).to(dev)
    real_lib = launch.lib
    bad = []
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
            print(f"  {name:11s} {min(us):8.2f} us  regs {libs[name][1].get(key)}  exact "
                  f"{exact[name]}{'' if ok else '  (UNEXPECTED)'}  rounds {[round(u, 2) for u in us]}",
                  flush=True)
            if not ok:
                bad.append(f"{storage} {name}")
    if bad:
        print(f"probe_contrast: exactness not as expected: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
