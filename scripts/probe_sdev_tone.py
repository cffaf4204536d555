#!/usr/bin/env python3
"""Time KS (``sdev_kernel``), K7 (``sdev_noise_hist_kernel<16>``) and KT
(``tone_map_kernel``) against layout and formulation variants, on one CUDA
GPU.

    python3 scripts/probe_sdev_tone.py [--parent DIR] [--rounds 3] [--only V1,V2]

Each variant is a copy of the kernel sources under ``build/probe_st/`` (the
package's sources are not touched) with a text substitution, one ``nvcc
-shared`` per variant, all started together.  Every variant is timed at the main path's 3072^2 thorax shapes
(the four analysis levels' bands; the recon and the gradation curve), its C
entry alone (CUDA events around 20 calls queued while the GPU sleeps, each
with its outputs' allocation), in interleaved rounds, and checked bit for
bit against the plain versions (exact variants must be equal).

Variants:

* ``kernel``         the sources as they are;
* ``run16``, ``run64``  KS with runs of 16 or 64 output rows a warp (32 in
                     the sources); ``ahead2``, ``ahead8`` with 2 or 8 rows in
                     flight (4); ``ks_minb5`` held to the registers of 5
                     blocks of 128 on an SM; ``ks_t64``, ``ks_t256`` with
                     blocks of 64 or 256 threads (128); ``ks_ldg`` its loads
                     through the read-only path;
* ``vseg16``, ``band16``, ``band64``, ``minb1``  K7 with a thread's vertical
                     sums over 16 rows (8), with 16- or 64-row tasks (32),
                     without its register cap of 4 blocks an SM;
* ``old_tail``       KS/K7 with the intrinsics' tail (``__ddiv_rn``,
                     ``__dsqrt_rn``, ``__double2float_rn``);
* ``no_tail``        diagnostic, inexact: KS/K7 with the tail a product;
* ``kt_chain``       KT with every curve on the descending chain;
* ``kt_bytes``       KT writing out_u8 a byte a pixel;
* ``kt_no_tone``     diagnostic, inexact: KT copying x (no selection);
* ``parent``         with ``--parent DIR``: another checkout's sources (e.g.
                     the parent commit unpacked with ``git archive`` into a
                     directory that ``.gitignore`` lists).

The card's name and power limit come first; then, per kernel, each
variant's device microseconds (min and all rounds), its registers and
whether it is exact.  Imports nothing of JAX.
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
SDEV = ("sdev_noise.cu", "grid.cuh", "hist_argmax.cuh", "noise_scan.cuh")
TONE = ("tonemap.cu", "grid.cuh")
TAIL = "__device__ __forceinline__ float sdev_tail(double s, bool* slow) {\n"
OLD_TAIL = TAIL + ("  if (true) {\n    *slow = false;\n"
                   "    return __double2float_rn(__dsqrt_rn(__ddiv_rn(s, 25.0)));\n  }\n")
NO_TAIL = TAIL + "  if (true) {\n    *slow = false;\n    return (float)__dmul_rn(s, 0.04);\n  }\n"
SEARCH = "  return __syncthreads_and(search);"
KS_LOAD = "  if (lv.vec[level]) return *reinterpret_cast<const float4*>(p);"
WORDS = "  const bool words = vec && (n - 2 * m) % 4 == 0 &&"
TONE_CALL = "    tone(cv, k, search, step0, v);"
# mangled names of the timed kernels
REGS = {"KS": r"11sdev_kernel", "K7": r"22sdev_noise_hist_kernelILi16E",
        "KT": r"15tone_map_kernelILb1ELb[01]E"}


def read(root: str, names) -> dict:
    csrc = os.path.join(root, PKG, "csrc")
    return {n: open(os.path.join(csrc, n)).read() for n in names
            if os.path.exists(os.path.join(csrc, n))}


def sub(files: dict, name: str, old: str, new: str) -> dict:
    assert old in files[name], f"probe pattern not found in {name}: {old!r}"
    return dict(files, **{name: files[name].replace(old, new)})


def variants(parent):
    """{name: (files, kernels timed, exact)}"""
    s, t = read(REPO, SDEV), read(REPO, TONE)
    both = dict(s, **t)
    ks = ("KS", "K7")

    def ks_src(old, new):
        return sub(s, "sdev_noise.cu", old, new)
    out = {
        "kernel": (both, ("KS", "K7", "KT"), True),
        "run16": (ks_src("kRun = 32;", "kRun = 16;"), ("KS",), True),
        "run64": (ks_src("kRun = 32;", "kRun = 64;"), ("KS",), True),
        "ahead2": (ks_src("kAhead = 4;", "kAhead = 2;"), ("KS",), True),
        "ahead8": (ks_src("kAhead = 4;", "kAhead = 8;"), ("KS",), True),
        "ks_t64": (ks_src("kStreamThreads = 128;", "kStreamThreads = 64;"), ("KS",), True),
        "ks_t256": (ks_src("kStreamThreads = 128;", "kStreamThreads = 256;"), ("KS",), True),
        "ks_minb5": (ks_src("__launch_bounds__(kStreamThreads)",
                            "__launch_bounds__(kStreamThreads, 5)"), ("KS",), True),
        "ks_ldg": (ks_src("return *reinterpret_cast<const float4*>(p);",
                          "return __ldg(reinterpret_cast<const float4*>(p));"), ("KS",), True),
        "vseg16": (ks_src("kVSeg = 8;", "kVSeg = 16;"), ("K7",), True),
        "band16": (ks_src("kBand = 32;", "kBand = 16;"), ("K7",), True),
        "band64": (ks_src("kBand = 32;", "kBand = 64;"), ("K7",), True),
        "minb1": (ks_src("kMinBlocks = 4;", "kMinBlocks = 1;"), ("K7",), True),
        "old_tail": (ks_src(TAIL, OLD_TAIL), ks, True),
        "no_tail": (ks_src(TAIL, NO_TAIL), ks, False),
        "kt_chain": (sub(t, "tonemap.cu", SEARCH, "  __syncthreads_and(search);\n  return false;"),
                     ("KT",), True),
        "kt_bytes": (sub(t, "tonemap.cu", WORDS, "  const bool words = false && (n - 2 * m) % 4 == 0 &&"),
                     ("KT",), True),
        "kt_no_tone": (sub(t, "tonemap.cu", TONE_CALL, ""), ("KT",), False),
    }
    if parent:
        out["parent"] = (dict(read(parent, SDEV), **read(parent, TONE)), ("KS", "K7", "KT"), True)
    return out


def build_all(found, root):
    build = importlib.import_module(PKG + ".ops.cuda.build")
    nvcc = build._nvcc()
    procs = {}
    for name, (files, _, _) in found.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        # the C error string lives in fused_hist.cu; the probes need none
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"),
             *[os.path.join(d, f) for f in files if f.endswith(".cu")]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for probe {name}:\n{log}")
        regs = {}
        for entry, used in re.findall(r"Compiling entry function '(\S+)'.*?Used (\d+) registers",
                                      log, re.S):
            for key, pattern in REGS.items():
                if re.search(pattern, entry):
                    regs[key] = int(used)
        lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
        for fn, (argtypes, restype) in build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        libs[name] = (lib, regs)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", default=None, help="comma-separated variants (default: all)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("probe_sdev_tone: needs a CUDA GPU", file=sys.stderr)
        return 1
    fh = importlib.import_module(PKG + ".ops.cuda.fused_hist")
    k_tone = importlib.import_module(PKG + ".ops.cuda.tonemap")
    stats = importlib.import_module(PKG + ".ops.stats")
    musica = importlib.import_module(PKG + ".models.musica")
    cfg = importlib.import_module(PKG).MusicaConfig()
    synthetic_radiograph = importlib.import_module(PKG + ".testing.phantoms").synthetic_radiograph

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.splitlines()[0]
    print(f"card: {card}")
    found = variants(args.parent)
    if args.only:
        found = {k: v for k, v in found.items() if k in args.only.split(",")}
    libs = build_all(found, os.path.join(REPO, "build", "probe_st"))

    dev = torch.device("cuda")
    res = musica.musica_forward(torch.from_numpy(synthetic_radiograph(3072, "thorax")).to(dev),
                                cfg, want_intermediates=True)
    inter = res["intermediates"]
    bands = [inter[f"red_bandpass_{i}"] for i in cfg.analysis_levels]
    recon = res["recon"]
    gpx, gpy, _ = inter["grad_curve"]
    k, n, m = gpx.shape[0], recon.shape[-1], cfg.out_margin
    print(f"the thorax's gradation curve: {k} points, strictly increasing "
          f"{bool((gpx[1:] > gpx[:-1]).all())}, last {float(gpx[-1])}")
    stream = torch.cuda.current_stream().cuda_stream
    L, nb, tile = len(bands), cfg.noise_histogram_bins, cfg.histogram_area_size
    ints = ctypes.c_int * L
    ns = ints(*[b.shape[-1] for b in bands])
    zeros = ints(*[0] * L)
    covs = ints(*[stats.coverage(b.shape[-1], cfg) for b in bands])
    srcs = (ctypes.c_void_p * L)(*[b.data_ptr() for b in bands])
    want_sd = [stats.img_sdev(b) for b in bands]
    want_h = fh.noise_hists_plain(want_sd, cfg)
    want_t = k_tone.tone_map_plain(recon, gpx, gpy, m)

    def ks(lib):
        out = [torch.empty_like(b) for b in bands]
        dst = (ctypes.c_void_p * L)(*[o.data_ptr() for o in out])
        assert lib.musica_sdev(srcs, dst, ns, zeros, ns, zeros, ns, L, 0, stream) == 0
        return out

    def k7(lib):
        out = [torch.empty_like(b) for b in bands]
        dst = (ctypes.c_void_p * L)(*[o.data_ptr() for o in out])
        h, mb, ticket = fh._hist_buffers(L, nb, dev)
        assert lib.musica_sdev_noise_hist(srcs, dst, ns, covs, zeros, ns, zeros, ns, L,
                                          h.data_ptr(), mb.data_ptr(), ticket.data_ptr(), nb,
                                          tile, float(cfg.max_noise_value), 0, stream) == 0
        return out, h

    def kt(lib):
        graded = torch.empty_like(recon)
        out = torch.empty((n - 2 * m, n - 2 * m), dtype=torch.uint8, device=dev)
        assert lib.musica_tone_map(recon.data_ptr(), graded.data_ptr(), out.data_ptr(),
                                   gpx.data_ptr(), gpy.data_ptr(), k, n, n, 0, m, None,
                                   stream) == 0
        return graded, out

    def same(a, b):
        nan = torch.isnan(b)
        return bool(torch.equal(torch.isnan(a), nan)
                    and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))

    def exact(kern, got):
        if kern == "KS":
            return all(same(g, w) for g, w in zip(got, want_sd))
        if kern == "K7":
            return all(same(g, w) for g, w in zip(got[0], want_sd)) and torch.equal(got[1], want_h)
        return same(got[0], want_t[0]) and torch.equal(got[1], want_t[1])

    def device_us(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)  # ~0.1 s: the host queues every call first
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps * 1e3

    kernels = {"KS": ks, "K7": k7, "KT": kt}
    ok, times = {}, {}
    for name, (lib, _) in libs.items():
        ok[name] = {kern: exact(kern, kernels[kern](lib)) for kern in found[name][1]}
        if found[name][2]:
            assert all(ok[name].values()), f"probe {name} differs: {ok[name]}"
        times[name] = {kern: [] for kern in found[name][1]}
    for _ in range(args.rounds):
        for name, (lib, _) in libs.items():
            for kern in times[name]:
                times[name][kern].append(device_us(lambda: kernels[kern](lib)))
    alloc = device_us(lambda: [torch.empty_like(b) for b in bands])
    print(f"3072^2 thorax, main-path shapes; device us per call incl. the outputs' allocation "
          f"(KS's alone {alloc:.2f}); {args.rounds} interleaved rounds, min (all)")
    for kern in ("KS", "K7", "KT"):
        for name, (_, regs) in libs.items():
            if kern not in times[name]:
                continue
            v = times[name][kern]
            print(f"  {kern} {name:11s} {min(v):8.2f} ({', '.join(f'{u:.2f}' for u in v)})  "
                  f"regs {regs.get(kern)}  {'exact' if ok[name][kern] else 'differs'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
