#!/usr/bin/env python3
"""What holds the histogram kernels K1, K3 and K4 back, on one CUDA GPU.

    python3 scripts/probe_hist_kernels.py [--parent DIR] [--rounds 3]

``ncu`` and ``nsys`` are not available everywhere the card is, so this
script answers the question by experiment.  It builds probe variants of
``csrc/fused_hist.cu`` (text substitutions into copies under
``build/probe/``; the package's sources are not touched), times each one's
``noise_hist_kernel`` (K1), ``grad_hist_kernel<true>`` (K3) and
``grad_hist_kernel<false>`` (K4) at the main path's 3072^2 thorax shapes
and on a flat image of the same shapes (every pixel of a warp step in one
bin), kernel alone (the C entry points, no wrapper ops), and checks each against
the plain PyTorch versions.  ``csrc/sdev_noise.cu`` (K7), which shares the
noise histogram's bin decision, is built and timed beside them:

* ``kernel``       the sources as they are (one shared atomic per pixel);
* ``warp_uniform`` a warp step whose pixels all fall in one bin merged into
                   one atomic (``__all_sync``, ``__reduce_add_sync``);
* ``run_merge``    every run of equal bins merged (run-head ballot and a
                   segmented sum over 5 shuffles);
* ``match_any``    every set of equal bins merged (``__match_any_sync`` +
                   ``__reduce_add_sync``);
* ``no_division``  diagnostic, inexact: K1's correctly rounded division by
                   0.1 replaced by a product with 10;
* ``no_classify``  diagnostic, inexact: K1's per-pixel bin decision replaced
                   by one comparison;
* ``no_atomics``   diagnostic, inexact: K1's shared atomics removed;
* ``parent``       with ``--parent DIR``: the ``csrc/fused_hist.cu``,
                   ``noise_scan.cuh`` and ``sdev_noise.cu`` of another
                   checkout of this repository (its C interface must be the
                   same), e.g. the parent commit unpacked with ``git
                   archive`` into a directory that ``.gitignore`` lists.

Times are device time (CUDA events around 20 calls queued while the GPU
sleeps), each call including a 1024- or 4x2048-int ``torch.zeros`` of the
output (timed alone too), in interleaved rounds.  K7 is timed on the
analysis levels' bands, its sdev images written in place.  The card's name and power
limit are printed first.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
PKG = "metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch"

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


def substitute(text: str, old, new: str) -> str:
    """Replace a fixed string or a compiled pattern; fail if it is missing."""
    if isinstance(old, str):
        assert old in text, f"probe pattern not found in the sources: {old!r}"
        return text.replace(old, new)
    assert old.search(text), f"probe pattern not found in the sources: {old.pattern!r}"
    return old.sub(lambda _: new, text, count=1)


def read_sources(root: str):
    """(fused_hist.cu, noise_scan.cuh, sdev_noise.cu) of a checkout."""
    csrc = os.path.join(root, PKG, "csrc")
    out = []
    for name in ("fused_hist.cu", "noise_scan.cuh", "sdev_noise.cu"):
        with open(os.path.join(csrc, name)) as f:
            out.append(f.read())
    return tuple(out)


def variants(src: str, hdr: str, sdev: str, parent: str | None):
    """{name: (fused_hist.cu, noise_scan.cuh, sdev_noise.cu, must be exact)}"""
    out = {
        "kernel": (src, hdr, sdev, True),
        "warp_uniform": (substitute(src, HIST_ADD, MERGE % UNIFORM), hdr, sdev, True),
        "run_merge": (substitute(src, HIST_ADD, MERGE % RUNS), hdr, sdev, True),
        "match_any": (substitute(src, HIST_ADD, MERGE % MATCH), hdr, sdev, True),
        "no_division": (src, substitute(hdr, DIVISION, "__fmul_rn(v, 10.0f)"), sdev, False),
        "no_classify": (substitute(src, CLASSIFY, "bin[q] = v > 0.002f ? 7 + (lane & 7) : "
                                   "-1;"),
                        hdr, sdev, False),
        "no_atomics": (substitute(src, K1_ADD, "if (bin[q] == -7) sh[0] = add;"), hdr,
                       sdev, False),
    }
    if parent:
        out["parent"] = read_sources(parent) + (True,)
    return out


def build_all(found, root):
    """One nvcc per variant, all started together; returns {name: (lib, regs)}."""
    import importlib
    build = importlib.import_module(PKG + ".ops.cuda.build")
    nvcc = build._nvcc()
    procs = {}
    for name, (src, hdr, sdev, _) in found.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for fname, text in (("fused_hist.cu", src), ("noise_scan.cuh", hdr),
                            ("sdev_noise.cu", sdev)):
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "fused_hist.cu"), os.path.join(d, "sdev_noise.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for probe {name}:\n{log}")
        regs = {}
        for entry, used in re.findall(r"Compiling entry function '(\S+)'.*?Used (\d+) registers",
                                      log, re.S):
            for short, key in (("17noise_hist_kernel", "K1"), ("grad_hist_kernelILb1", "K3"),
                               ("grad_hist_kernelILb0", "K4"), ("sdev_noise_hist_kernel", "K7")):
                if short in entry:
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
    ap.add_argument("--parent", default=None,
                    help="root of another checkout whose fused_hist.cu is timed beside")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import importlib

    import torch
    if not torch.cuda.is_available():
        print("probe_hist_kernels: needs a CUDA GPU", file=sys.stderr)
        return 1
    fh = importlib.import_module(PKG + ".ops.cuda.fused_hist")
    stats = importlib.import_module(PKG + ".ops.stats")
    musica = importlib.import_module(PKG + ".models.musica")
    MusicaConfig = importlib.import_module(PKG).MusicaConfig
    synthetic_radiograph = importlib.import_module(PKG + ".testing.phantoms").synthetic_radiograph

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    print(f"card: {card}")
    found = variants(*read_sources(REPO), args.parent)
    libs = build_all(found, os.path.join(REPO, "build", "probe"))

    dev = torch.device("cuda")
    cfg = MusicaConfig()
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
    wplane = fh.relevance_weight_plane(cnr, cfg).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    n, L = nrm.shape[-1], len(thorax["levels"])
    nb, gb, tile = cfg.noise_histogram_bins, cfg.grad_histogram_bins, cfg.histogram_area_size
    ns = (ctypes.c_int * L)(*[s.shape[-1] for s in thorax["levels"]])
    covs = (ctypes.c_int * L)(*[stats.coverage(s.shape[-1], cfg) for s in thorax["levels"]])
    strides = (ctypes.c_int * L)(*[s.stride(0) for s in thorax["levels"]])

    def pointers(tensors):
        return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])

    def k1(lib, inp):
        h = torch.zeros((L, nb), dtype=torch.int32, device=dev)
        assert lib.musica_noise_hist(inp["ptrs"], ns, covs, strides, L, h.data_ptr(), nb, tile,
                                     float(cfg.max_noise_value), stream) == 0
        return h

    def k3(lib, inp):
        h = torch.zeros(gb, dtype=torch.int32, device=dev)
        assert lib.musica_grad_hist_relevant(
            inp["recon"].data_ptr(), nrm.data_ptr(), n, n, wplane.data_ptr(), cnr.shape[-1],
            n // cnr.shape[-1], cfg.relevant_border, float(cfg.relevant_max_pixel),
            h.data_ptr(), gb, tile, stream) == 0
        return h

    def k4(lib, inp):
        h = torch.zeros(gb, dtype=torch.int32, device=dev)
        assert lib.musica_grad_hist(inp["recon"].data_ptr(), rel.data_ptr(), n, n, h.data_ptr(),
                                    gb, tile, stream) == 0
        return h

    sdevs = [torch.empty_like(b) for b in thorax["bands"]]

    def k7(lib, inp):
        h = torch.zeros((L, nb), dtype=torch.int32, device=dev)
        assert lib.musica_sdev_noise_hist(inp["srcs"], inp["dsts"], ns, covs, L, h.data_ptr(),
                                          nb, tile, float(cfg.max_noise_value), stream) == 0
        return h

    thorax.update(ptrs=pointers(thorax["levels"]), srcs=pointers(thorax["bands"]),
                  dsts=pointers(sdevs))
    flat.update(ptrs=pointers(flat["levels"]))
    want_sd, want_h = fh.sdev_noise_hists_plain(thorax["bands"], cfg)
    cases = {"thorax": (thorax, {"K1": k1, "K3": k3, "K4": k4, "K7": k7}),
             "flat": (flat, {"K1": k1, "K3": k3, "K4": k4})}
    want = {case: {"K1": fh.noise_hists_plain(inp["levels"], cfg),
                   "K3": fh.grad_hist_relevant_plain(inp["recon"], nrm, cnr, cfg),
                   "K4": fh.grad_hist_plain(inp["recon"], rel, cfg)}
            for case, (inp, _) in cases.items()}
    want["thorax"]["K7"] = want_h

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

    zeros = {"K1": device_us(lambda: torch.zeros((L, nb), dtype=torch.int32, device=dev)),
             "K3/K4": device_us(lambda: torch.zeros(gb, dtype=torch.int32, device=dev))}
    for case, (inp, kernels) in cases.items():
        exact = {}
        for name, (lib, _) in libs.items():
            exact[name] = {k: torch.equal(fn(lib, inp), want[case][k]) for k, fn in kernels.items()}
            if "K7" in kernels:
                exact[name]["K7"] &= all(torch.equal(a, b) for a, b in zip(sdevs, want_sd))
        for name, (_, _, _, must_be_exact) in found.items():
            if must_be_exact:
                assert all(exact[name].values()), f"probe {name} differs on {case}"
        times = {name: {k: [] for k in kernels} for name in libs}
        for _ in range(args.rounds):
            for name, (lib, _) in libs.items():
                for k, fn in kernels.items():
                    times[name][k].append(device_us(lambda: fn(lib, inp)))
        print(f"3072^2 {case}, main-path shapes; device us per call incl. the output's "
              f"torch.zeros (alone: K1 {zeros['K1']:.2f}, K3/K4 {zeros['K3/K4']:.2f}); "
              f"{args.rounds} interleaved rounds, min (all)")
        for name, (_, regs) in libs.items():
            cells = "  ".join(f"{k} {min(t):7.2f} ({', '.join(f'{v:.2f}' for v in t)})"
                              for k, t in times[name].items())
            flags = "exact" if all(exact[name].values()) else \
                "differs: " + ",".join(k for k, ok in exact[name].items() if not ok)
            print(f"  {name:13s} {cells}  regs {regs}  {flags}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
