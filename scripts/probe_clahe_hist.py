#!/usr/bin/env python3
"""Time KH (``clahe_hist_kernel``, the CLAHE joint histogram with its
relevance test) against layout variants, diagnostics and a parent
checkout's, on one CUDA GPU.

    python3 scripts/probe_clahe_hist.py [--rounds 5] [--only V1,V2] [--parent DIR]

Each variant is a copy of ``csrc/clahe_hist.cu`` (with ``grid.cuh`` and
``relevance.cuh``) under ``build/probe_kh/`` with a text substitution (the
package's sources are not touched), one ``nvcc -shared`` per variant, all
started together.  Each is timed through the wrapper
(``ops/cuda/clahe_hist.py``, its library swapped; the C interface is the
same) on the CLAHE + linear path's 3072^2 thorax inputs (its recon,
normalized image and CNR map) at 4x4 and 8x8 tiles (CUDA events around 20
calls queued while the GPU sleeps, with the histogram's zeroing), in
interleaved rounds, and checked against the plain version (exact variants
must be equal).

Variants:

* ``kernel``        the source as it is (8 columns a thread, a row's recon
                    loaded with its normalized, a CNR row's decisions once,
                    strips cut at the tile rows, each block zeroing and
                    flushing the tiles it reaches);
* ``t256``          blocks of 256 threads (2,048 columns);
* ``px4``           4 columns a thread, blocks of 256 threads (1,024 columns);
* ``minb8``, ``minb12``  held to the registers of 8 or 12 blocks an SM;
* ``copies2``, ``copies4``  2 or 4 copies of the shared histograms, lane l
                    adding to copy l % m (fewer lanes on one address);
* ``match``         same-address lanes of a warp merged before the shared
                    atomic (``__match_any_sync``, the lowest lane adds the
                    count);
* ``no_atomics``    diagnostic, inexact: a shared store in place of each
                    shared atomic;
* ``no_flush``      diagnostic, inexact: no global atomics (the shared
                    histogram read, nothing written);
* ``no_recon``      diagnostic, inexact: no recon read (every relevant
                    pixel in one bin);
* ``no_norm``       diagnostic, inexact: no normalized read (every pixel of
                    a solid block relevant);
* ``no_loads``      diagnostic, inexact: neither image read;
* ``empty``         diagnostic, inexact: no row visited (the launch, the
                    zeroing and the flush);
* ``parent``        with ``--parent DIR``: that checkout's kernel, and its
                    diagnostics ``parent_no_atomics``, ``parent_no_flush``,
                    ``parent_no_recon`` where its source has the patterns
                    (a row a thread at a time, every tile zeroed and flushed
                    by every block).

The card's name and power limit come first; then, per tiling, the bound
(``chip_smoke.clahe_hist_bound``) and each variant's device microseconds
(min and all rounds), its registers and whether it equals the plain
version.  Imports nothing of JAX.
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
SRC = ("clahe_hist.cu", "grid.cuh", "relevance.cuh")
ATOM = "atomicAdd(&sh[tx + base[q] + b], 1);"
ATOM_LINE = ("          if ((rel >> q & 1u) && (unsigned)b < (unsigned)a.bins) "
             "atomicAdd(&sh[tx + base[q] + b], 1);")
MATCH = """            const bool ok = (rel >> q & 1u) && (unsigned)b < (unsigned)a.bins;
            const int lane = (int)(threadIdx.x & 31u);
            const int key = ok ? tx + base[q] + b : -1 - lane;
            const unsigned same = __match_any_sync(__activemask(), key);
            if (ok && __ffs(same) - 1 == lane) atomicAdd(&sh[key], __popc(same));"""
FLUSH = "    atomicAdd(&hist[(txx * a.tiles + tyy) * a.bins + b], c);"
RECON = "          v[g] = load4(rrow + 4 * g, c0 + 4 * g, a.n, a.vec && c0 + 4 * g + 3 < a.n);"
NORM = "            nv[g] = load4(nrow + 4 * g, c0 + 4 * g, a.n, a.vec && c0 + 4 * g + 3 < a.n);"
NO_RECON = "          v[g] = make_float4(0.5f, 0.5f, 0.5f, 0.5f);"
NO_NORM = "            nv[g] = make_float4(0.f, 0.f, 0.f, 0.f);"
# the parent (a row a thread at a time)
P_ATOM = "if (rel[q] && b >= 0 && b < a.bins) atomicAdd(&sh[(tx + ty[q]) * a.bins + b], 1);"
P_FLUSH = "    if (c != 0) atomicAdd(&hist[i], c);"
P_RECON = "      const float4 v = load4(a.recon + off, c0, a.n, a.vec);"


def read(root: str = REPO) -> dict:
    csrc = os.path.join(root, PKG, "csrc")
    return {n: open(os.path.join(csrc, n)).read() for n in SRC}


def sub(files: dict, old: str, new: str):
    """The sources with the substitution in clahe_hist.cu, None if the
    pattern is missing."""
    text = files["clahe_hist.cu"] if files is not None else ""
    if old not in text:
        return None
    return dict(files, **{"clahe_hist.cu": text.replace(old, new)})


def must(files):
    assert files is not None, "probe pattern not found in csrc/clahe_hist.cu"
    return files


def copies(f, m):
    """The shared histograms m times over, lane l adding to copy l % m,
    summed at the flush."""
    f = sub(f, "  for (int i = threadIdx.x; i < nb; i += blockDim.x) sh[i] = 0;",
            f"  for (int i = threadIdx.x; i < {m} * nb; i += blockDim.x) sh[i] = 0;")
    f = sub(f, ATOM, f"atomicAdd(&sh[(threadIdx.x % {m}) * nb + tx + base[q] + b], 1);")
    f = sub(f, "    const int c = sh[i];",
            "    int c = 0;\n" f"    for (int j = 0; j < {m}; ++j) c += sh[j * nb + i];")
    return sub(f, "return sizeof(int) * (size_t)span_x * span_y * bins;",
               f"return {m} * sizeof(int) * (size_t)span_x * span_y * bins;")


def variants(parent):
    """{name: (files, exact)}"""
    f = read()
    out = {
        "kernel": (f, True),
        "t256": (must(sub(f, "kThreads = 128;", "kThreads = 256;")), True),
        "px4": (must(sub(sub(f, "kThreads = 128;", "kThreads = 256;"),
                         "constexpr int kPx = 8;", "constexpr int kPx = 4;")), True),
        "match": (must(sub(f, ATOM_LINE, MATCH)), True),
        "minb8": (must(sub(f, "__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 8)")),
                  True),
        "minb12": (must(sub(f, "__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 12)")),
                   True),
        "copies2": (must(copies(f, 2)), True),
        "copies4": (must(copies(f, 4)), True),
        "no_atomics": (must(sub(f, ATOM, "sh[tx + base[q] + b] = 1;")), False),
        "no_flush": (must(sub(f, FLUSH, "    if (c < 0) hist[0] = c;")), False),
        "no_recon": (must(sub(f, RECON, NO_RECON)), False),
        "no_norm": (must(sub(f, NORM, NO_NORM)), False),
        "no_loads": (must(sub(sub(f, NORM, NO_NORM), RECON, NO_RECON)), False),
        "empty": (must(sub(f, "  if (c0 < a.n) {", "  if (c0 < 0) {")), False),
    }
    if parent:
        p = read(parent)
        out["parent"] = (p, True)
        for name, old, new in (
                ("parent_no_atomics", P_ATOM, "if (rel[q] && b >= 0 && b < a.bins) "
                                              "sh[(tx + ty[q]) * a.bins + b] = 1;"),
                ("parent_no_flush", P_FLUSH, "    if (c < 0) hist[0] = c;"),
                ("parent_no_recon", P_RECON, "      const float4 v = make_float4(0.5f, 0.5f, "
                                             "0.5f, 0.5f);")):
            got = sub(p, old, new)
            if got is not None:
                out[name] = (got, False)
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
             os.path.join(d, "clahe_hist.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    argtypes, restype = build._SIGNATURES["musica_clahe_hist"]
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            if name == "kernel":
                raise RuntimeError(f"nvcc failed for probe {name}:\n{log}")
            print(f"nvcc failed for probe {name}; left out:\n{log[-3000:]}", flush=True)
            continue
        regs = re.findall(r"(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S)
        lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
        lib.musica_clahe_hist.argtypes = argtypes
        lib.musica_clahe_hist.restype = restype
        libs[name] = (lib, "; ".join(f"{r} (spills {sp} B)" for sp, r in regs))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--only", default="")
    ap.add_argument("--parent", default="", help="root of another checkout whose KH is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_clahe_hist: needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import (
        clahe_hist as kh)
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        synthetic_radiograph)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    found = variants(args.parent)
    if args.only:
        found = {k: v for k, v in found.items() if k in args.only.split(",")}
    libs = build_all(found, os.path.join(REPO, "build", "probe_kh"))
    dev = torch.device("cuda:0")
    x = torch.from_numpy(synthetic_radiograph(3072, "thorax")).to(dev)
    cfg = MusicaConfig(image_size=3072, enable_clahe=True, grad_with_linear_image=True)
    res = musica.musica_forward(x, cfg, want_intermediates=True)
    recon, nrm, cnr = res["recon"], res["intermediates"]["normalized"], res["cnr"]
    real_lib = launch.lib
    bad = []
    for tiles in (4, 8):
        c = cfg.with_(clahe_tiles=tiles)
        want = kh.clahe_hist_plain(recon, nrm, cnr, c)
        times = {k: [] for k in libs}
        exact = {}
        for _ in range(args.rounds):
            for name, (lib, _) in libs.items():
                launch.lib = lambda lib=lib: lib
                try:
                    times[name].append(1e3 * cs.cuda_ms(
                        lambda: kh.clahe_hist(recon, nrm, cnr, c), 20, 2, device_only=True))
                    got = kh.clahe_hist(recon, nrm, cnr, c)
                finally:
                    launch.lib = real_lib
                exact[name] = torch.equal(got, want)
        bound = cs.clahe_hist_bound(recon, nrm, cnr, c)[0] * 1e3
        print(f"{tiles}x{tiles} tiles: bound {bound:.2f} us (bytes)", flush=True)
        for name, us in times.items():
            ok = exact[name] == found[name][1]
            print(f"  {name:17s} {min(us):8.2f} us  regs {libs[name][1]}  exact {exact[name]}"
                  f"{'' if ok else '  (UNEXPECTED)'}  rounds {[round(u, 2) for u in us]}",
                  flush=True)
            if not ok:
                bad.append(f"{tiles}x{tiles} {name}")
    if bad:
        print(f"probe_clahe_hist: exactness not as expected: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
