#!/usr/bin/env python3
"""What holds the hand-written kernels K1, K3, K4, K5 and K7 back, on one
CUDA GPU.

    python3 scripts/probe_hist_kernels.py [--parent DIR] [--rounds 3] [--only V1,V2]

``ncu`` and ``nsys`` are not available everywhere the card is, so this
script answers the question by experiment.  It builds probe variants of the
kernel sources (text substitutions into copies under ``build/probe/``; the
package's sources are not touched), times each variant's kernels at the
main path's 3072^2 thorax shapes, kernel alone (the C entry points, no
wrapper ops), and checks each against the plain PyTorch versions:

* K1 ``noise_hist_kernel`` (since the argmax is folded into it, with its
  argmax tail and, as ``K1-tail``, without: a null ``max_bins``), ``K1+K2``
  the levels' histograms and first-max bins (the sources: K1 with its tail;
  a parent whose argmax is a kernel of its own: its K1, then its
  ``hist_argmax_kernel``), K3 ``grad_hist_kernel<16, true>``, K4
  ``grad_hist_kernel<16, false>`` (csrc/fused_hist.cu), also on a flat
  image of the same shapes (every pixel of a warp step in one bin);
* K7 ``sdev_noise_hist_kernel`` (csrc/sdev_noise.cu) on the analysis
  levels' bands, its sdev images written in place (and, as ``K7-tail``,
  without its argmax);
* K5 ``clahe_apply_kernel`` (csrc/clahe_apply.cu) on the CLAHE + linear
  path's recon and LUTs.

Variants:

* ``kernel``        the sources as they are (one shared atomic per pixel);
* ``warp_uniform``  K1/K3/K4: a warp step whose pixels all fall in one bin
                    merged into one atomic (``__all_sync``,
                    ``__reduce_add_sync``);
* ``run_merge``     K1/K3/K4: every run of equal bins merged (run-head
                    ballot and a segmented sum over 5 shuffles);
* ``match_any``     K1/K3/K4: every set of equal bins merged
                    (``__match_any_sync`` + ``__reduce_add_sync``);
* ``no_division``   diagnostic, inexact: K1's correctly rounded division by
                    0.1 replaced by a product with 10;
* ``no_classify``   diagnostic, inexact: K1's per-pixel bin decision replaced
                    by one comparison;
* ``no_atomics``    diagnostic, inexact: K1's shared atomics removed;
* ``k7_no_hist``    diagnostic, inexact: K7 without its noise scan;
* ``k7_no_flush``   diagnostic, inexact: K7 without its global atomics;
* ``k7_no_divsqrt`` diagnostic, inexact: K7's float64 tail (division, square
                    root, rounding) replaced by one product with 0.04;
* ``k7_band16``, ``k7_band64``  K7 with 16- and 64-row tasks (32 in the
                    sources);
* ``k7_vseg16``, ``k7_vseg32``  K7 with a thread's vertical sums over 16 or
                    32 rows (8 in the sources);
* ``k7_band28``     K7 with 28-row tasks (14-row vertical sums) held to 51
                    registers, so that 5 blocks fit on an SM;
* ``k7_t128``, ``k7_t512``  K7 with blocks of 128 or 512 threads (256);
* ``argmax_lane8``, ``argmax_lane32``  the argmax tail of K1 and K7
                    (csrc/hist_argmax.cuh) with 8 or 32 loads a lane in
                    flight (16 in the sources);
* ``argmax_fence_all``  the tail with a fence in every thread before the
                    ticket (thread 0 alone in the sources);
* ``argmax_ticket_only``  diagnostic, inexact: the tail's barrier, fence
                    and ticket without the argmax;
* ``k5_no_tables``  diagnostic, inexact: K5 without building its tables;
* ``k5_copy``       diagnostic, inexact: K5 copying recon (no lookups);
* ``k5_regs64``     K5 held to 64 registers (4 blocks of 256 on an SM);
* ``k5_group4``     K5 loading 4 items together (2 in the sources);
* ``k5_copy_no_tables``  diagnostic: the copy without the table build;
* ``k5_carveout``, ``k7_carveout``  the kernel's L1/shared split set to the
                    most shared memory before its occupancy is read; each
                    prints its grid once (blocks, tasks a block, wave);
* ``parent``        with ``--parent DIR``: the kernel sources of another
                    checkout of this repository, e.g. the parent commit
                    unpacked with ``git archive`` into a directory that
                    ``.gitignore`` lists; its C interface is read from that
                    checkout's ``ops/cuda/build.py``.  Its K5 is timed alone
                    and with the blend attributes its wrapper computed
                    (``ops.clahe.axis_attrs`` and two stacks).

Times are device time (CUDA events around 20 calls queued while the GPU
sleeps), each call including the output's ``torch.zeros`` or
``torch.empty`` (timed alone too), in interleaved rounds.  The card's name
and power limit are printed first.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
PKG = "metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch"
SOURCES = ("fused_hist.cu", "noise_scan.cuh", "sdev_noise.cu", "clahe_apply.cu", "grid.cuh",
           "hist_argmax.cuh")

HIST_ADD = re.compile(r"__device__ __forceinline__ void hist_add\(.*?\n}\n", re.S)
MERGE = """__device__ __forceinline__ void hist_add(int* sh, int bin, int w) {
  const int lane = threadIdx.x & 31;
%s
}
"""
UNIFORM = """  if (__all_sync(kFull, bin == __shfl_sync(kFull, bin, 0))) {
    const int sum = __reduce_add_sync(kFull, w);
    if (lane == 0 && bin >= 0) atomicAdd(&sh[bin], sum);
  } else if (bin >= 0) {
    atomicAdd(&sh[bin], w);
  }"""
RUNS = """  const int prev = __shfl_up_sync(kFull, bin, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || bin != prev);
  const unsigned later = heads >> lane >> 1;
  const int end = later ? lane + __ffs(later) : 32;
  int sum = bin >= 0 ? w : 0;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(kFull, sum, d);
    if (lane + d < end) sum += o;
  }
  if (bin >= 0 && ((heads >> lane) & 1u)) atomicAdd(&sh[bin], sum);"""
MATCH = """  const unsigned peers = __match_any_sync(kFull, bin);
  const int sum = __reduce_add_sync(peers, bin >= 0 ? w : 0);
  if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&sh[bin], sum);"""
DIVISION = "__fdiv_rn(v, max_noise)"
CLASSIFY = "bin[q] = noise_bin(v, fbins, max_noise);"
K1_ADD = "hist_add(sh, add ? bin[q] : -1, 1);"
K7_SCAN = "    const bool on = r < scan_rows && c / kTile < groups;"
K7_FLUSH = "    if (c != 0) atomicAdd(&out[i], c);"
K7_TAIL = "    x[j] = sdev_tail(sum(j), &sl);"
K7_BAND = "constexpr int kBand = 32;"
K7_VSEG = "constexpr int kVSeg = 8;"
K7_BOUNDS = "__global__ void __launch_bounds__(kThreads, kMinBlocks)\nsdev_noise_hist_kernel("
K5_BUILD = "tbl[off + i].x = __ldg(a.luts + off + i);"
K5_BLEND = "  if (!(x >= 0.0f && x <= 1.0f)) return 0.0f;\n"
K5_BOUNDS = "__global__ void __launch_bounds__(kThreads) clahe_apply_kernel("
K5_GROUP = "constexpr int kGroup = 2;"
INCLUDE = "#include <cuda_runtime.h>\n"
ARGMAX_LANE = "constexpr int kArgmaxPerLane = 16;"
ARGMAX_TICKET = "  int last = 0;\n  if (threadIdx.x == 0) {"
ARGMAX_LAST = "  if (!__syncthreads_or(last)) return;"
CARVEOUT = ("  cudaFuncSetAttribute({k}, cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"
            "  const int e = wave_blocks({k}, kThreads, smem, &wave);")
PRINT_GRID = ("  {{ static bool once = false; if (!once) {{ once = true; printf(\"{name} grid %lld "
              "blocks, %lld a block, wave %lld\\n\", (long long)blocks, (long long){per}, "
              "(long long){wave}); }} }}\n{launch}")


def carveout(src: dict, name: str, kernel: str, launch: str, per: str, wave: str = "wave") -> dict:
    """The kernel's carveout set to the most shared memory, its grid printed
    once (``wave``: the expression of the wave where the launch is, -1 where
    none is in scope)."""
    text = substitute(src[name], INCLUDE, "#include <cstdio>\n" + INCLUDE)
    text = substitute(text, f"  const int e = wave_blocks({kernel}, kThreads, smem, &wave);",
                      CARVEOUT.format(k=kernel))
    text = substitute(text, launch, PRINT_GRID.format(name=name, per=per, wave=wave,
                                                      launch=launch))
    return dict(src, **{name: text})
# mangled names of the timed kernels (a template instance at tile 16, or the
# parent's non-template kernel)
REGS = {"K1": r"17noise_hist_kernel(ILi16E|E)", "K3": r"16grad_hist_kernelI(Li16E)?Lb1E",
        "K4": r"16grad_hist_kernelI(Li16E)?Lb0E", "K5": r"18clahe_apply_kernel",
        "K7": r"22sdev_noise_hist_kernel(ILi16E|E)"}


def substitute(text: str, old, new: str) -> str:
    """Replace a fixed string or a compiled pattern; fail if it is missing."""
    if isinstance(old, str):
        assert old in text, f"probe pattern not found in the sources: {old!r}"
        return text.replace(old, new)
    assert old.search(text), f"probe pattern not found in the sources: {old.pattern!r}"
    return old.sub(lambda _: new, text, count=1)


def read_sources(root: str):
    """{file name: text} of a checkout's kernel sources (those it has)."""
    csrc = os.path.join(root, PKG, "csrc")
    out = {}
    for name in SOURCES:
        path = os.path.join(csrc, name)
        if os.path.exists(path):
            with open(path) as f:
                out[name] = f.read()
    return out


def with_file(src: dict, name: str, old, new: str) -> dict:
    return dict(src, **{name: substitute(src[name], old, new)})


def variants(src: dict, parent: str | None):
    """{name: (sources, kernels timed, must be exact)}"""
    hist = ("K1", "K3", "K4")
    argmax = ("K1", "K1+K2", "K7")
    out = {
        "kernel": (src, hist + ("K1-tail", "K1+K2", "K5", "K7", "K7-tail"), True),
        "warp_uniform": (with_file(src, "fused_hist.cu", HIST_ADD, MERGE % UNIFORM), hist, True),
        "run_merge": (with_file(src, "fused_hist.cu", HIST_ADD, MERGE % RUNS), hist, True),
        "match_any": (with_file(src, "fused_hist.cu", HIST_ADD, MERGE % MATCH), hist, True),
        "no_division": (with_file(src, "noise_scan.cuh", DIVISION, "__fmul_rn(v, 10.0f)"),
                        ("K1",), False),
        "no_classify": (with_file(src, "fused_hist.cu", CLASSIFY,
                                  "bin[q] = v > 0.002f ? 7 + (lane & 7) : -1;"), ("K1",), False),
        "no_atomics": (with_file(src, "fused_hist.cu", K1_ADD, "if (bin[q] == -7) sh[0] = add;"),
                       ("K1",), False),
        "k7_no_hist": (with_file(src, "sdev_noise.cu", K7_SCAN, "    const bool on = false;"),
                       ("K7",), False),
        "k7_no_flush": (with_file(src, "sdev_noise.cu", K7_FLUSH, "    if (c == -7) out[i] = c;"),
                        ("K7",), False),
        "k7_no_divsqrt": (with_file(src, "sdev_noise.cu", K7_TAIL,
                                    "    x[j] = (float)__dmul_rn(sum(j), 0.04);\n    sl = false;"),
                          ("K7",), False),
        "k7_band16": (with_file(src, "sdev_noise.cu", K7_BAND, "constexpr int kBand = 16;"),
                      ("K7",), True),
        "k7_band64": (with_file(src, "sdev_noise.cu", K7_BAND, "constexpr int kBand = 64;"),
                      ("K7",), True),
        "k7_band28": (with_file(with_file(with_file(
            src, "sdev_noise.cu", K7_BAND, "constexpr int kBand = 28;"),
            "sdev_noise.cu", K7_VSEG, "constexpr int kVSeg = 14;"),
            "sdev_noise.cu", K7_BOUNDS, "__global__ void __launch_bounds__(kThreads, 5)\nsdev_noise_hist_kernel("),
            ("K7",), True),
        "k7_t128": (with_file(src, "sdev_noise.cu", "constexpr int kThreads = 256;",
                              "constexpr int kThreads = 128;"), ("K7",), True),
        "k7_t512": (with_file(src, "sdev_noise.cu", "constexpr int kThreads = 256;",
                              "constexpr int kThreads = 512;"), ("K7",), True),
        "k7_vseg16": (with_file(src, "sdev_noise.cu", K7_VSEG, "constexpr int kVSeg = 16;"),
                      ("K7",), True),
        "k7_vseg32": (with_file(src, "sdev_noise.cu", K7_VSEG, "constexpr int kVSeg = 32;"),
                      ("K7",), True),
        "k5_no_tables": (with_file(src, "clahe_apply.cu", K5_BUILD, "(void)0;"), ("K5",), False),
        "k5_copy": (with_file(src, "clahe_apply.cu", K5_BLEND, "  return x;\n" + K5_BLEND),
                    ("K5",), False),
        "k5_group4": (with_file(src, "clahe_apply.cu", K5_GROUP, "constexpr int kGroup = 4;"),
                      ("K5",), True),
        "k5_copy_no_tables": (with_file(with_file(src, "clahe_apply.cu", K5_BLEND,
                                                  "  return x;\n" + K5_BLEND),
                                        "clahe_apply.cu", K5_BUILD, "(void)0;"), ("K5",), False),
        "k5_regs64": (with_file(src, "clahe_apply.cu", K5_BOUNDS,
                                "__global__ void __launch_bounds__(kThreads, 4) "
                                "clahe_apply_kernel("), ("K5",), True),
        "k5_carveout": (carveout(src, "clahe_apply.cu", "clahe_apply_kernel",
                                 "  clahe_apply_kernel<<<", "a.per_block"), ("K5",), True),
        # K7's occupancy is read in split_tasks, for any kernel it is given
        "k7_carveout": (carveout(src, "sdev_noise.cu", "kernel",
                                 "  sdev_noise_hist_kernel<kTile><<<", "lv.per_block", "-1"),
                        ("K7",), True),
        "argmax_lane8": (with_file(src, "hist_argmax.cuh", ARGMAX_LANE,
                                   "constexpr int kArgmaxPerLane = 8;"), argmax, True),
        "argmax_lane32": (with_file(src, "hist_argmax.cuh", ARGMAX_LANE,
                                    "constexpr int kArgmaxPerLane = 32;"), argmax, True),
        "argmax_fence_all": (with_file(src, "hist_argmax.cuh", ARGMAX_TICKET,
                                       "  __threadfence();\n" + ARGMAX_TICKET), argmax, True),
        "argmax_ticket_only": (with_file(src, "hist_argmax.cuh", ARGMAX_LAST,
                                         "  if (__syncthreads_or(last) || true) return;"),
                               ("K1", "K7"), False),
    }
    if parent:
        out["parent"] = (read_sources(parent), hist + ("K1+K2", "K5", "K7"), True)
    return out


def signatures(root: str):
    """The C interface (``_SIGNATURES``) of a checkout's ops/cuda/build.py."""
    path = os.path.join(root, PKG, "ops", "cuda", "build.py")
    spec = importlib.util.spec_from_file_location(f"probe_build_{abs(hash(root))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._SIGNATURES


def build_all(found, root, sigs):
    """One nvcc per variant, all started together; returns {name: (lib, regs)}."""
    build = importlib.import_module(PKG + ".ops.cuda.build")
    nvcc = build._nvcc()
    procs = {}
    for name, (files, _, _) in found.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
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
        for fn, (argtypes, restype) in sigs[name].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        libs[name] = (lib, regs)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="root of another checkout whose kernels are timed beside")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", default=None,
                    help="comma-separated variants to build and time (default: all)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("probe_hist_kernels: needs a CUDA GPU", file=sys.stderr)
        return 1
    fh = importlib.import_module(PKG + ".ops.cuda.fused_hist")
    k_clahe = importlib.import_module(PKG + ".ops.cuda.clahe_apply")
    clahe = importlib.import_module(PKG + ".ops.clahe")
    stats = importlib.import_module(PKG + ".ops.stats")
    musica = importlib.import_module(PKG + ".models.musica")
    MusicaConfig = importlib.import_module(PKG).MusicaConfig
    synthetic_radiograph = importlib.import_module(PKG + ".testing.phantoms").synthetic_radiograph

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    print(f"card: {card}")
    found = variants(read_sources(REPO), args.parent)
    if args.only:
        found = {k: v for k, v in found.items() if k in args.only.split(",")}
    mine = signatures(REPO)
    sigs = {name: (signatures(args.parent) if name == "parent" else mine) for name in found}
    libs = build_all(found, os.path.join(REPO, "build", "probe"), sigs)

    dev = torch.device("cuda")
    cfg = MusicaConfig()
    cfg_var = cfg.with_(enable_clahe=True, grad_with_linear_image=True)
    x = torch.from_numpy(synthetic_radiograph(3072, "thorax")).to(dev)
    res = musica.musica_forward(x, cfg, want_intermediates=True)
    inter, cnr = res["intermediates"], res["cnr"]
    nrm, rel = inter["normalized"], inter["relevant"]
    thorax = {"recon": res["recon"],
              "levels": [inter[f"sdev_{i}"] for i in cfg.analysis_levels],
              "bands": [inter[f"red_bandpass_{i}"] for i in cfg.analysis_levels]}
    # a flat image: every pixel of a warp step in one bin
    flat = {"recon": torch.full_like(thorax["recon"], 0.5),
            "levels": [torch.full_like(v, 0.05) for v in thorax["levels"]]}
    var = musica.musica_forward(x, cfg_var, want_intermediates=True)
    v_recon = var["recon"]
    v_px, v_py = clahe.clahe_curves(
        clahe.clahe_histograms(v_recon, var["intermediates"]["relevant"], cfg_var), cfg_var)
    t, bins = cfg_var.clahe_tiles, cfg_var.clahe_bins
    wplane = fh.relevance_weight_plane(cnr, cfg).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    n, L = nrm.shape[-1], len(thorax["levels"])
    nb, gb, tile = cfg.noise_histogram_bins, cfg.grad_histogram_bins, cfg.histogram_area_size
    ns = (ctypes.c_int * L)(*[s.shape[-1] for s in thorax["levels"]])
    covs = (ctypes.c_int * L)(*[stats.coverage(s.shape[-1], cfg) for s in thorax["levels"]])
    strides = (ctypes.c_int * L)(*[s.stride(0) for s in thorax["levels"]])

    def pointers(tensors):
        return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])

    def k1(lib, inp, argmax=True):
        """(histograms, first-max bins or None); a parent whose C entry
        takes no argmax output runs its histogram kernel alone."""
        fn = lib.musica_noise_hist
        if len(fn.argtypes) == 10:
            h = torch.zeros((L, nb), dtype=torch.int32, device=dev)
            assert fn(inp["ptrs"], ns, covs, strides, L, h.data_ptr(), nb, tile,
                      float(cfg.max_noise_value), stream) == 0
            return h, None
        h, mb, ticket = fh._hist_buffers(L, nb, dev)
        # from PR 9 on the entry takes each level's row window (whole here)
        window = ((ctypes.c_int * L)(*[0] * L), ns) if len(fn.argtypes) == 14 else ()
        assert fn(inp["ptrs"], ns, covs, strides, *window, L, h.data_ptr(),
                  mb.data_ptr() if argmax else None, ticket.data_ptr(), nb, tile,
                  float(cfg.max_noise_value), stream) == 0
        return h, (mb if argmax else None)

    def k12(lib, inp):
        h, mb = k1(lib, inp)
        if mb is None:  # the parent's separate argmax kernel
            mb = torch.empty(L, dtype=torch.int32, device=dev)
            assert lib.musica_hist_argmax(h.data_ptr(), L, nb, mb.data_ptr(), stream) == 0
        return h, mb

    def k3(lib, inp):
        h = torch.zeros(gb, dtype=torch.int32, device=dev)
        fn = lib.musica_grad_hist_relevant
        if len(fn.argtypes) == 22:
            # the block weights computed in the kernel from the CNR map
            assert fn(inp["recon"].data_ptr(), nrm.data_ptr(), n, n, 0, n, cnr.data_ptr(), None,
                      cnr.shape[-1], 0, cnr.shape[-2], n // cnr.shape[-1], cfg.relevant_border,
                      *fh.relevance_rule(cfg), int(cfg.relevant_k), h.data_ptr(), gb, tile,
                      stream) == 0
            return h
        # from PR 9 on: the row window (whole here) and the plane's rows
        rows = (0, n) if len(fn.argtypes) == 17 else ()
        plane = (0, cnr.shape[-2]) if rows else ()
        assert fn(inp["recon"].data_ptr(), nrm.data_ptr(), n, n, *rows, wplane.data_ptr(),
                  cnr.shape[-1], *plane, n // cnr.shape[-1], cfg.relevant_border,
                  float(cfg.relevant_max_pixel), h.data_ptr(), gb, tile, stream) == 0
        return h

    def k4(lib, inp):
        h = torch.zeros(gb, dtype=torch.int32, device=dev)
        rows = (0, n) if len(lib.musica_grad_hist.argtypes) == 10 else ()
        assert lib.musica_grad_hist(inp["recon"].data_ptr(), rel.data_ptr(), n, n, *rows,
                                    h.data_ptr(),
                                    gb, tile, stream) == 0
        return h

    sdevs = [torch.empty_like(b) for b in thorax["bands"]]

    def k7(lib, inp, argmax=True):
        fn = lib.musica_sdev_noise_hist
        if len(fn.argtypes) == 17:  # row windows: every level whole
            h, mb, ticket = fh._hist_buffers(L, nb, dev)
            zeros = (ctypes.c_int * L)(*[0] * L)
            assert fn(inp["srcs"], inp["dsts"], ns, covs, zeros, ns, zeros, ns, L, h.data_ptr(),
                      mb.data_ptr() if argmax else None, ticket.data_ptr(), nb, tile,
                      float(cfg.max_noise_value), 0, stream) == 0
            return h
        if len(fn.argtypes) == 13:
            h, mb, ticket = fh._hist_buffers(L, nb, dev)
            assert fn(inp["srcs"], inp["dsts"], ns, covs, L, h.data_ptr(),
                      mb.data_ptr() if argmax else None, ticket.data_ptr(), nb, tile,
                      float(cfg.max_noise_value), 0, stream) == 0
            return h
        h = torch.zeros((L, nb), dtype=torch.int32, device=dev)
        grid = (0,) if len(fn.argtypes) == 11 else ()  # older parents take no grid size
        assert fn(inp["srcs"], inp["dsts"], ns, covs, L, h.data_ptr(), nb, tile,
                  float(cfg.max_noise_value), *grid, stream) == 0
        return h

    def k5(lib, inp, attrs=None):
        out = torch.empty_like(v_recon)
        fn = lib.musica_clahe_apply
        if len(fn.argtypes) == 9 and fn.argtypes[3] is ctypes.c_int:  # a row window: all rows
            assert fn(v_recon.data_ptr(), out.data_ptr(), v_py.data_ptr(), n, 0, n, t, bins,
                      stream) == 0
        elif len(fn.argtypes) == 7:
            assert fn(v_recon.data_ptr(), out.data_ptr(), v_py.data_ptr(), n, t, bins,
                      stream) == 0
        else:  # the parent's: blend attributes from its wrapper
            ax_tile, ax_w = attrs if attrs is not None else parent_attrs()
            assert fn(v_recon.data_ptr(), out.data_ptr(), v_py.data_ptr(), ax_tile.data_ptr(),
                      ax_w.data_ptr(), n, t, bins, stream) == 0
        return out

    def parent_attrs():
        base_i, nb_i, w_base, w_nb, zero = clahe.axis_attrs(n, cfg_var, v_recon)
        return (torch.stack([base_i, nb_i, zero.to(torch.int32)]), torch.stack([w_base, w_nb]))

    fixed_attrs = parent_attrs()
    thorax.update(ptrs=pointers(thorax["levels"]), srcs=pointers(thorax["bands"]),
                  dsts=pointers(sdevs))
    flat.update(ptrs=pointers(flat["levels"]))
    want_sd, want_h = fh.sdev_noise_hists_plain(thorax["bands"], cfg)
    want_clahe = k_clahe.clahe_apply_plain(v_recon, v_px, v_py, cfg_var)
    kernels = {"K1": lambda lib, inp: k1(lib, inp)[0],
               "K1-tail": lambda lib, inp: k1(lib, inp, argmax=False)[0],
               "K1+K2": k12, "K3": k3, "K4": k4, "K7": k7,
               "K7-tail": lambda lib, inp: k7(lib, inp, argmax=False),
               "K5": lambda lib, inp: k5(lib, inp, fixed_attrs)}
    cases = {"thorax": (thorax, ("K1", "K1-tail", "K1+K2", "K3", "K4", "K5", "K7", "K7-tail")),
             "flat": (flat, ("K1", "K3", "K4"))}
    want = {}
    for case, (inp, _) in cases.items():
        h1 = fh.noise_hists_plain(inp["levels"], cfg)
        want[case] = {"K1": h1, "K1-tail": h1, "K1+K2": (h1, fh.hist_argmax_plain(h1)),
                      "K3": fh.grad_hist_relevant_plain(inp["recon"], nrm, cnr, cfg),
                      "K4": fh.grad_hist_plain(inp["recon"], rel, cfg)}
    want["thorax"]["K7"] = want["thorax"]["K7-tail"] = want_h

    def equal(k, got, case):
        if k == "K5":
            return bool(torch.equal(torch.isnan(got), torch.isnan(want_clahe))
                        and torch.equal(got.nan_to_num(), want_clahe.nan_to_num()))
        if k == "K1+K2":
            return all(torch.equal(a, b) for a, b in zip(got, want[case][k]))
        ok = torch.equal(got, want[case][k])
        if k in ("K7", "K7-tail"):
            ok = ok and all(torch.equal(a, b) for a, b in zip(sdevs, want_sd))
        return bool(ok)

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

    zeros = {"K1/K7": device_us(lambda: torch.zeros((L, nb), dtype=torch.int32, device=dev)),
             "K3/K4": device_us(lambda: torch.zeros(gb, dtype=torch.int32, device=dev)),
             "K5": device_us(lambda: torch.empty_like(v_recon))}
    for case, (inp, timed) in cases.items():
        exact, times = {}, {}
        for name, (lib, _) in libs.items():
            ks = [k for k in found[name][1] if k in timed]
            exact[name] = {k: equal(k, kernels[k](lib, inp), case) for k in ks}
            if found[name][2]:
                assert all(exact[name].values()), f"probe {name} differs on {case}: {exact[name]}"
            times[name] = {k: [] for k in ks}
        for _ in range(args.rounds):
            for name, (lib, _) in libs.items():
                for k in times[name]:
                    times[name][k].append(device_us(lambda: kernels[k](lib, inp)))
        print(f"3072^2 {case}, main-path shapes (K5: the CLAHE + linear path's); device us per "
              f"call incl. the output's allocation (alone: "
              + ", ".join(f"{k} {v:.2f}" for k, v in zeros.items())
              + f"); {args.rounds} interleaved rounds, min (all)")
        for name, (_, regs) in libs.items():
            if not times[name]:
                continue
            cells = "  ".join(f"{k} {min(v):7.2f} ({', '.join(f'{u:.2f}' for u in v)})"
                              for k, v in times[name].items())
            flags = "exact" if all(exact[name].values()) else \
                "differs: " + ",".join(k for k, ok in exact[name].items() if not ok)
            print(f"  {name:13s} {cells}  regs {regs}  {flags}")
    copy_out = torch.empty_like(v_recon)
    copies = [device_us(lambda: copy_out.copy_(v_recon)) for _ in range(args.rounds)]
    print(f"  torch copy_ of the 3072^2 recon (the card's copy rate, for K5): {min(copies):.2f} "
          f"({', '.join(f'{u:.2f}' for u in copies)}) us")
    if "parent" in libs:
        lib = libs["parent"][0]
        with_attrs = [device_us(lambda: k5(lib, thorax)) for _ in range(args.rounds)]
        print(f"  parent K5 with its wrapper's blend attributes (axis_attrs, two stacks): "
              f"{min(with_attrs):.2f} ({', '.join(f'{u:.2f}' for u in with_attrs)}) us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
