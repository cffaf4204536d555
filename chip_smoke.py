#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port of MUSICA on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Builds the CUDA kernels from ``..._tpu_torch/csrc`` with nvcc, holds every
kernel against its plain PyTorch version at the paths' 3072^2 shapes
(integer histograms exactly equal, and the first-max bins that the noise
histogram kernels K1 and K7 take in their last block equal to
``torch.argmax`` of their histograms and to the plain argmax; the CLAHE
apply and the sdev exactly equal with equal NaN masks) and the histogram
scans K1, K3 and
K4 also on adversarial inputs at 3072, 600 and 144 and at histogram tiles 8,
12 and 32 ([3a]), K5 and K6 also at 8x8 CLAHE tiles and K5 on random LUTs
with x at the segment edges ([3b]), K7 also with block ranges that cross
levels ([3d]), K1, K3, K4, K6, K5 and K7 on the row windows of the spatial
path's plan (3072 over 4 shards; adversarial inputs at 3072, 600 and 144;
tiles 8, 12, 32; K5 also on windows that start on odd rows; K6's and K7's
windows summed against the whole image's) and K2 as a launch of its own on
the summed histograms ([3e]), the pyramid kernels KP1 (the fused reduce
step and the down step alone), KP2 (every mode, a bf16 band too) and the
ladder's and the expand's tails (``pyramid_tail``) bit for bit at every level of 3072,
600 and 144 on adversarial inputs, on the thorax's ladder and expand and on
every row window of the spatial plans at 3072, 600 and 144 over 4 shards
([3f]), the tone map KT (graded bit for bit, NaN included, and out_u8
equal) and the default analysis path's sdev KS (bit for bit) at 3072, 600
and 144 on the gradation curves of every path, on adversarial curves and
inputs, its tables against the plain version's, and on every shard window
of the 1x4 and 2x2 plans, KS at every analysis level and on the shards'
row windows ([3g]), the contrast stage KA (the contrast curves, their
apply and the noise reduction in one launch) bit for bit with equal NaN
masks at 3072, 600 and 144 in float32 and bf16 storage, with and without
intermediates, on a phantom's, adversarial and random-max-bin inputs, on
every shard window of the 1x4 and 2x2 plans, and the curves its blocks
build at all 2,048 max bins ([3h]), normalize KN (its extrema and apply
passes) bit for bit with equal NaN masks at 3072, 600, 144 and 512 (the
quirks' chain aligned), quirks on and off, on the phantoms, all 65,536
uint16 values, constant, zero, int32 and unaligned inputs and every shard
window of the 1x4 and 2x2 plans, its square root over all 65,536 values,
and the gradation curve KG bit for bit on every path's histograms at 3072,
600 and 144 and on adversarial and random ones with negative bins ([3i]),
the relevance mask inside the kernels that read it: K3 computing each CNR
block's weight from the CNR map against the route that reads the weight
plane and its plain version on dense CNR values (every float32 within 64
ulps of the rule's edges, 0, NaN, +-inf), whole and on every shard window,
the CLAHE joint histogram KH (its relevance test inside) and the LUTs KC bit
for bit at 3072, 600 and 144 with 4x4 and 8x8 tiles on the paths' and
adversarial inputs (bin edges +-1 ulp, NaN, +-inf, max_pixel +-1 ulp), on
every shard window, KC also on 256 random histograms ([3j]),
drives
the port's main path
(``process`` on a 3072^2 uint16 radiograph, then the intermediates path of
``process --debug-dump``), the CLAHE + linear-gradation variant path
(``musica_forward`` as ``process --clahe --linear-gradation`` runs it), the
fused-sdev analysis path (``musica_forward(fused_sdev=True)``, ``process``,
``timed_process``) and bf16 band storage (``process --bf16``) and checks
that each went through its kernels and agrees with the port's CPU path (or,
for fused-sdev, with the default path bit for bit; for bf16 also with the
float32 output to tests/test_bf16.py's contract), runs ``process`` at
histogram tiles 8, 12 and 32 and with 8x8 CLAHE tiles through the kernels
([4g]), runs the metamorphic-testing campaign on the card (``run_campaign``
as ``cli campaign`` runs it): thorax at 3072, its 30 cases against the
committed TPU campaign's thorax rows (``artifacts/mt_campaign_3072``), one
3052^2 row against the float64 host oracles ([4h]), and the bf16 against
the float32 campaign at 512 over all six anatomies, slope flags equal
([4i]), drives the rest of the host surface at 3072 (``cli process
--save-last-raw --cnr-out``, ``--profile`` in a process of its own, and
``cli report``, [4j]), the HTTP viewer at 512 ([4k]) and the data-parallel
path (``process_sharded`` of 4 images and ``throughput_step`` over every
card, against ``forward_batch``; with two cards also over two and
``process`` on ``cuda:1``, [4l]), holds the compiled entries (``process_jit``
and ``process_batch_jit``, replays of ``musica_forward``'s captured CUDA
graph, ``models/graphs.py``) against eager ``musica_forward`` bit for bit in
every variant, on a second image and on a transposed one, and the graph
mesh against ``forward_batch`` ([4m]), drives the spatial path
(``process_sharded`` of two 3072^2 radiographs with each image's rows split
over 1x4 and 2x2 mesh entries on one card, in the main path, the CLAHE +
linear-gradation variant, with fused-sdev and in bf16, 600 over 1x4 for K4,
and one image over every card where there are several), each image a
replay of the mesh row's captured graph (``models/graphs.py::SpatialGraph``,
cut into segments at the exchanges between cards), against the eager
spatial path and ``process_batch_jit`` bit for bit, counting K1 per shard
with covered rows, K2 per image and K3 per shard (CLAHE: K3, KH and K5 per
shard, KC per entry; fused-sdev: K7 and K3 per shard) against the profiler's kernel
events, with each graph's capture seconds and pool MB, and times the
replays beside the eager spatial path and one card's unsharded replay of
the same variant ([4n]), runs a batch of 4 through
``process_batch`` in float32 and in bf16, and times the pipeline paths
(graph replays against eager) in interleaved windows,
``scripts/bench_torch.py``'s measurement, the mesh's worker threads on one
card, a campaign case's parts, and each kernel beside its plain version,
its bound (bytes
over the HBM rate, operations over the peak rate, at this run's inputs)
and, where one exists, the one PyTorch call that computes the same function
(``torch.argmax`` for the argmax, ``torch.bincount`` for the generic
histogram, float64 ``F.conv2d`` and ``F.conv_transpose2d`` for the pyramid
steps, float64 ``F.avg_pool2d`` of the squares for KS; none for KA, KN,
KG, KH and KC, whose plain chains' launches are counted instead), with CUDA
events; with ``--parent DIR`` (another checkout, e.g. the parent commit
unpacked with ``git archive``) also KA (float32 and bf16) and KH built
from that checkout's sources, timed in the same call as this one's, in
turns (parent, this, this, parent);
the folded argmax also as the difference between K1 (and K7) with and
without it.

Every phase prints one line; any failure raises and exits non-zero.  The
line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import csv
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SIZE = 3072
BATCH = 4
ROUNDS = 7  # interleaved timing windows per single-image path
PKG = "metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch"
PALLAS_DIR = ("metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_"
              "processing_tpu/ops/pallas")
PALLAS = f"{PALLAS_DIR}/fused_hist.py"
JAX_PYRAMID = ("metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_"
               "processing_tpu/ops/pyramid.py")
JAX_OPS = "metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu/ops"
JAX_MUSICA = ("metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_"
              "processing_tpu/models/musica.py")
SOURCES = {"noise_hist": "fused_hist.cu", "hist_argmax": "hist_argmax.cuh",
           "grad_hist_relevant": "fused_hist.cu", "grad_hist": "fused_hist.cu",
           "histogram": "histogram.cu", "clahe_apply": "clahe_apply.cu",
           "sdev_noise_hist": "sdev_noise.cu", "pyramid_down": "pyramid.cu",
           "pyramid_up": "pyramid.cu", "pyramid_tail": "pyramid.cu",
           "sdev": "sdev_noise.cu", "tone_map": "tonemap.cu",
           "contrast_apply": "contrast_apply.cu", "normalize": "normalize.cu",
           "gradation_curve": "gradation_curve.cu", "clahe_hist": "clahe_hist.cu",
           "clahe_curves": "clahe_curves.cu"}
REPLACES = {
    "noise_hist": f"{PALLAS}:139 (_noise_kernel of noise_hist_fused; also the "
                  f"histogram of _noise_multi_kernel, :181)",
    "hist_argmax": f"{PALLAS}:234 (noise_hist_argmax_multi: the first-max argmax "
                   f"that _noise_multi_kernel takes on its last row block, :202-211; "
                   f"folded into noise_hist and sdev_noise_hist)",
    "grad_hist_relevant": f"{PALLAS}:397 (_grad_relevant_kernel of "
                          f"grad_hist_relevant_fused, pallas_call :485; with the block weight "
                          f"plane that grad_hist_relevant_fused makes with XLA ops, :468-480)",
    "grad_hist": f"{PALLAS}:381 (_grad_kernel of grad_hist_fused)",
    "histogram": f"{PALLAS_DIR}/histogram.py:97 (_hist_kernel of "
                 f"factorized_histogram_pallas, pallas_call :148)",
    "clahe_apply": f"{PALLAS_DIR}/clahe_apply.py:80 (_kernel of "
                   f"clahe_apply_fused, pallas_call :188)",
    "sdev_noise_hist": f"{PALLAS}:262 (_sdev_noise_kernel of "
                       f"sdev_noise_hist_fused, pallas_call :334)",
    # counterparts of XLA code, not of Pallas kernels
    "pyramid_down": f"{JAX_PYRAMID}:213 (reduce_step_split, XLA, no Pallas kernel: a level's "
                    f"down and band in one step; the down alone: smooth_downsample, :85)",
    "pyramid_up": f"{JAX_PYRAMID}:310 (upsample_smooth, XLA, no Pallas kernel; with "
                  f"reduce_ladder's subtraction, :261, and models/musica.py:155's expand add)",
    "pyramid_tail": f"{JAX_PYRAMID}:261 (reduce_ladder's per-level tail, XLA, no Pallas kernel; "
                    f"and models/musica.py:150-157's expand loop on the coarse levels)",
    "sdev": f"{JAX_OPS}/stats.py:27 (img_sdev, XLA, no Pallas kernel: every analysis level's "
            f"sdev on the default path, {JAX_MUSICA}:106)",
    "tone_map": f"{JAX_OPS}/curves.py:151 (curve_get_y_general, XLA, no Pallas kernel) with "
                f"curve_apply_u8_adaptive, :221, as {JAX_MUSICA}:186-190 calls them",
    "contrast_apply": f"{JAX_OPS}/curves.py:41 (contrast_curve, XLA, no Pallas kernel) with "
                      f"curve_get_y_sorted, :99, contrast_curve_apply, :232, and "
                      f"{JAX_OPS}/noise.py:45 (nearest_upsample) with noise_reduction, :58, "
                      f"as {JAX_MUSICA}:112-140 calls them",
    "normalize": f"{JAX_OPS}/normalize.py:56 (normalize_from_u16, XLA, no Pallas kernel) with "
                 f"img_normalize, :78, as {JAX_MUSICA}:80 calls them",
    "gradation_curve": f"{JAX_OPS}/gradation.py:119 (gradation_curve, XLA, no Pallas kernel) "
                       f"with curves.py:21's bezier_points, as {JAX_MUSICA}:179 calls it",
    "clahe_hist": f"{JAX_OPS}/noise.py:78 (img_relevant, XLA, no Pallas kernel) with "
                  f"clahe.py:30 (clahe_histograms: its joint bins, XLA, counted by "
                  f"{PALLAS_DIR}/histogram.py:148, factorized_histogram_pallas), as "
                  f"{JAX_MUSICA}:166-172 calls them",
    "clahe_curves": f"{JAX_OPS}/clahe.py:52 (clahe_curves, XLA, no Pallas kernel), as "
                    f"clahe_grade calls it ({JAX_MUSICA}:170-171)",
}
# each hand-written kernel's CUDA kernel events as the profiler names them
# (scripts/profile_torch.py matches them alike)
KERNEL_EVENTS = {
    "noise_hist": r"(?<![A-Za-z_])noise_hist(_serial)?_kernel\b",
    "hist_argmax": r"hist_argmax_kernel\b",
    "grad_hist_relevant": r"grad_hist(_serial)?_kernel<(\d+, )?true>",
    "grad_hist": r"grad_hist(_serial)?_kernel<(\d+, )?false>",
    "histogram": r"(?<![A-Za-z_])histogram_kernel\b",
    "clahe_apply": r"clahe_apply_kernel\b",
    "sdev_noise_hist": r"sdev_noise_hist_kernel\b",
    "sdev": r"(?<![A-Za-z_])sdev_kernel\b",
    "tone_map": r"tone_map_kernel<(true|false)(, (true|false))?>",
    "contrast_apply": r"contrast_apply_kernel<(true|false)>",
    "normalize": r"normalize_(extrema|apply)_kernel<",
    "gradation_curve": r"gradation_curve_kernel\b",
    "clahe_hist": r"clahe_hist_kernel\b",
    "clahe_curves": r"clahe_curves_kernel\b",
    "pyramid_down": r"reduce_step_kernel<(true|false)>",
    "pyramid_up": r"upsample_smooth_kernel<\d>",
    "pyramid_tail": r"pyramid_tail_kernel<(true|false)>",
    # KS's tail alone ([3g]'s check of its rounding; never on a path)
    "sdev_tail": r"sdev_tail_kernel\b",
}
# clahe_graded against the port's CPU path: the LUTs are order-stable sums
# and the apply is exact, so only a recon that differs could move it; the
# bound is the JAX package's own against golden (tests/test_clahe.py)
CLAHE_ATOL = 1e-4
# u8 parity bar against the port's own CPU path (docs/PARITY.md)
MIN_PSNR, MIN_EXACT, MAX_DIFF = 90.0, 0.9999, 1
# bf16 against float32 storage from 512 px (tests/test_bf16.py::
# test_bf16_contract_512): knife-edge flips (> 32) at most 3e-4 of the
# pixels, every other pixel within 16, PSNR over those >= 38 dB
BF16_KNIFE, BF16_MAX_INLIER, BF16_MIN_PSNR = 3e-4, 16, 38.0
# the campaign: its CSV values against the TPU campaign's (the pipelines'
# u8 outputs may differ at a few pixels within the parity bar); a row's
# float32 numbers against the float64 host oracles (tests/test_metamorphic.py)
CAMPAIGN_ATOL, ROW_ATOL = 1e-3, 2e-5
MT_ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                           "mt_campaign_3072")
MT_BF16_SIZE = 512  # artifacts/mt_bf16_vs_f32_512.json
# the least time of a kernel's work: bytes over the H100 SXM's HBM3 rate and
# float32 operations over its rate outside the tensor cores (NVIDIA's H100
# SXM data sheet); float64 instructions at 64 per SM per clock (the Hopper
# architecture white paper), at the card's SM count and its largest SM clock
# (nvidia-smi).  Integer operations are not counted.
HBM_BYTES_PER_S, FP32_PER_S, FP64_PER_SM_CLOCK = 3.35e12, 67e12, 64
SECTOR_PX = 8  # float32 pixels of a 32-byte DRAM sector
# spin kernels that begin each run under the profiler (profiled_run)
PAD_KERNELS = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def u8_agreement(a: np.ndarray, b: np.ndarray):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    mse = float(np.mean(d.astype(np.float64) ** 2))
    psnr = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    return psnr, float(np.mean(d == 0)), int(d.max())


def check_parity(name: str, got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape, (name, got.shape, want.shape)
    psnr, exact, dmax = u8_agreement(got, want)
    log(f"  {name}: PSNR {psnr:.2f} dB, bit-exact {exact * 100:.5f} %, "
        f"max |du8| {dmax}")
    assert psnr >= MIN_PSNR and exact > MIN_EXACT and dmax <= MAX_DIFF, name


def check_bf16_contract(name: str, o16: np.ndarray, o32: np.ndarray) -> None:
    d = np.abs(o16.astype(np.int64) - o32.astype(np.int64))
    knife = d > 32
    inlier = d[~knife].astype(np.float64)
    mse = float(np.mean(inlier ** 2))
    psnr = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    log(f"  {name}: {float(np.mean(d > 0)) * 100:.5f} % of px differ, knife-edge "
        f"flips {float(knife.mean())} (bound {BF16_KNIFE}), max inlier |du8| "
        f"{int(inlier.max())} (bound {BF16_MAX_INLIER}), inlier PSNR {psnr:.2f} dB "
        f"(bound {BF16_MIN_PSNR})")
    assert (float(knife.mean()) <= BF16_KNIFE and inlier.max() <= BF16_MAX_INLIER
            and psnr >= BF16_MIN_PSNR), name


class KernelRecord:
    """max |kernel - plain| over every comparison, per kernel."""

    def __init__(self):
        self.err = {k: None for k in REPLACES}

    def equal(self, kernel: str, case: str, got, want) -> None:
        import torch
        assert got.shape == want.shape and got.dtype == want.dtype, \
            (kernel, case, got.shape, want.shape, got.dtype, want.dtype)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        prev = self.err[kernel]
        self.err[kernel] = err if prev is None else max(prev, err)
        log(f"  {kernel} [{case}]: max |kernel - plain| = {err}")
        assert err == 0, f"{kernel} [{case}] differs from its plain version"

    def equal_bits(self, kernel: str, case: str, got, want) -> bool:
        """float32 images equal bit for bit (-0.0 is not +0.0); records
        max |kernel - plain| without a line of its own."""
        import torch
        assert got.shape == want.shape and got.dtype == want.dtype == torch.float32, \
            (kernel, case, got.shape, want.shape, got.dtype, want.dtype)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        err = 0.0 if same else float((got.double() - want.double()).abs().nan_to_num(
            float("inf")).max())
        prev = self.err[kernel]
        self.err[kernel] = err if prev is None else max(prev, err)
        assert same, f"{kernel} [{case}] differs from its plain version (max |d| {err})"
        return same

    def equal_bytes(self, kernel: str, case: str, got, want) -> None:
        """Integer tensors exactly equal; records max |kernel - plain|
        without a line of its own."""
        import torch
        assert got.shape == want.shape and got.dtype == want.dtype, (kernel, case)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        prev = self.err[kernel]
        self.err[kernel] = err if prev is None else max(prev, err)
        assert err == 0, f"{kernel} [{case}] differs from its plain version"

    def equal_float(self, kernel: str, case: str, got, want) -> None:
        """Equal NaN masks and max |kernel - plain| = 0 on finite values."""
        import torch
        assert got.shape == want.shape and got.dtype == want.dtype, (kernel, case)
        nan_g, nan_w = torch.isnan(got), torch.isnan(want)
        assert torch.equal(nan_g, nan_w), f"{kernel} [{case}]: NaN masks differ"
        fin = ~nan_w
        err = float((got[fin] - want[fin]).abs().max())
        prev = self.err[kernel]
        self.err[kernel] = err if prev is None else max(prev, err)
        log(f"  {kernel} [{case}]: max |kernel - plain| = {err} on "
            f"{int(fin.sum())} finite px, {int(nan_w.sum())} NaN px in both")
        assert err == 0.0, f"{kernel} [{case}] differs from its plain version"


def random_levels(rng, sizes, dev):
    """Noise-hist inputs with every break kind: zeros, values above 0.1 and
    values mapping to bin 0."""
    import torch
    out = []
    for n in sizes:
        sd = rng.uniform(0.0, 0.12, (n, n)).astype(np.float32)
        sd[rng.uniform(size=(n, n)) < 0.05] = 0.0
        sd[rng.uniform(size=(n, n)) < 0.01] = 1e-6
        out.append(torch.from_numpy(sd).to(dev))
    return out


def random_bands(rng, sizes, dev):
    """sdev-kernel inputs whose sdev has every break kind: 8x8 patches
    scaled to zero (sdev 0.0), to ~1e-6 (bin 0) and by 6 (above 0.1)."""
    import torch
    out = []
    for n in sizes:
        b = rng.normal(0.0, 0.03, (n, n)).astype(np.float32)
        nb = -(-n // 8)
        scale = rng.choice(np.float32([0.0, 1e-4, 6.0, 1.0]), size=(nb, nb),
                           p=[0.1, 0.1, 0.1, 0.7])
        b *= np.kron(scale, np.ones((8, 8), np.float32))[:n, :n]
        out.append(torch.from_numpy(b).to(dev))
    return out


def analysis_bands(img, cfg, dev):
    """The bandpass images of the analysis levels, as the main path makes
    them."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import (
        normalize, pyramid)
    x = torch.from_numpy(img).to(dev)
    nrm, _, _ = normalize.normalize_from_u16(x, cfg.quirks)
    bands, _ = pyramid.reduce_ladder(nrm, cfg.pyramid_levels)
    return [bands[i] for i in cfg.analysis_levels]


def analysis_levels(img, cfg, dev):
    """The sdev images of the analysis levels, as the main path makes them."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import stats
    return [stats.img_sdev(b) for b in analysis_bands(img, cfg, dev)]


def check_argmax(rec, case, h, mb, want_h):
    """The argmax folded into K1 or K7 (K2): the first-max bins equal
    ``torch.argmax`` (the first maximum) of the kernel's histograms and the
    plain version's argmax of the plain histograms."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    rec.equal("hist_argmax", f"{case}, vs torch.argmax of the kernel's histograms", mb,
              torch.argmax(h, dim=-1).to(torch.int32))
    rec.equal("hist_argmax", f"{case}, vs the plain version", mb, fh.hist_argmax_plain(want_h))


def check_noise(rec, cfg, levels, case):
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    h, mb = fh.noise_hists(levels, cfg)
    want = fh.noise_hists_plain(levels, cfg)
    rec.equal("noise_hist", case, h, want)
    check_argmax(rec, f"K1 {case}", h, mb, want)


def check_sdev_noise(rec, cfg, bands, case, grid=0):
    """K7: every level's sdev (concatenated) and the histograms against the
    plain version on the same bands (``grid`` > 0: at most that many blocks,
    so that block ranges cross levels)."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    sds, h, mb = fh.sdev_noise_hists(bands, cfg, grid=grid)
    p_sds, p_h = fh.sdev_noise_hists_plain(bands, cfg)
    sizes = "/".join(str(b.shape[-1]) for b in bands)
    rec.equal_float("sdev_noise_hist", f"{case} ({sizes}), sdev",
                    torch.cat([s.flatten() for s in sds]),
                    torch.cat([s.flatten() for s in p_sds]))
    rec.equal("sdev_noise_hist", f"{case}, histograms ({int(h.sum())} counts)", h, p_h)
    check_argmax(rec, f"K7 {case}", h, mb, p_h)


def unfolded_noise_hists(levels, cfg):
    """K1 without its argmax (a null ``max_bins``), through its C entry: the
    histogram kernel as it ran before the argmax was folded into it.  For
    timing only; it counts no launch."""
    import ctypes
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import stats
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
    L, nb, dev = len(levels), cfg.noise_histogram_bins, levels[0].device
    h, _, ticket = fh._hist_buffers(L, nb, dev)
    ints = ctypes.c_int * L
    rc = launch.lib().musica_noise_hist(
        (ctypes.c_void_p * L)(*[s.data_ptr() for s in levels]),
        ints(*[s.shape[-1] for s in levels]),
        ints(*[stats.coverage(s.shape[-1], cfg) for s in levels]),
        ints(*[s.stride(0) for s in levels]), ints(*[0] * L), ints(*[s.shape[-1] for s in levels]),
        L, h.data_ptr(), None, ticket.data_ptr(), nb, cfg.histogram_area_size,
        float(cfg.max_noise_value), launch.stream(dev))
    assert rc == 0, rc
    return h


def unfolded_sdev_noise_hists(bands, cfg):
    """K7 without its argmax, as ``unfolded_noise_hists``."""
    import ctypes
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import stats
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
    L, nb, dev = len(bands), cfg.noise_histogram_bins, bands[0].device
    sdevs = [torch.empty_like(b) for b in bands]
    h, _, ticket = fh._hist_buffers(L, nb, dev)
    ints = ctypes.c_int * L
    ns = ints(*[b.shape[-1] for b in bands])
    rc = launch.lib().musica_sdev_noise_hist(
        (ctypes.c_void_p * L)(*[b.data_ptr() for b in bands]),
        (ctypes.c_void_p * L)(*[s.data_ptr() for s in sdevs]), ns,
        ints(*[stats.coverage(b.shape[-1], cfg) for b in bands]), ints(*[0] * L), ns,
        ints(*[0] * L), ns, L, h.data_ptr(), None, ticket.data_ptr(), nb,
        cfg.histogram_area_size, float(cfg.max_noise_value), 0, launch.stream(dev))
    assert rc == 0, rc
    return sdevs, h


def csv_values(rows, first):
    """(row names, float64 [rows, columns]) of a campaign CSV's rows after
    its header; the first ``first`` columns name the row."""
    return [r[:first] for r in rows[1:]], np.array([[float(v) for v in r[first:]]
                                                    for r in rows[1:]])


def check_campaign_rows(name, got_rows, want_rows, first):
    """Equal row names; max |got - want| per column within CAMPAIGN_ATOL."""
    names, got = csv_values(got_rows, first)
    want_names, want = csv_values(want_rows, first)
    assert names == want_names, (name, names[:3], want_names[:3])
    assert got.shape == want.shape and np.isfinite(got).all(), name
    worst = np.abs(got - want).max(axis=0)
    log(f"  {name}: {got.shape[0]} rows, max |H100 - TPU| per column "
        f"{[float(w) for w in worst]}")
    assert float(worst.max()) <= CAMPAIGN_ATOL, f"{name} differs from the TPU campaign"
    return float(worst.max())


def random_clahe(rng, n, dev):
    """CLAHE inputs: recon in [-0.1, 1.1] with exact 1.0 pixels, a random
    relevance mask that leaves tile (1, 2) empty, so its LUT is NaN (at 3072
    no tile lies inside the 100-px relevance border)."""
    import torch
    recon = rng.uniform(-0.1, 1.1, (n, n)).astype(np.float32)
    recon[rng.uniform(size=(n, n)) < 0.01] = 1.0
    relevant = (rng.uniform(size=(n, n)) < 0.6).astype(np.float32)
    ts = n // 4
    relevant[ts:2 * ts, 2 * ts:3 * ts] = 0.0
    return torch.from_numpy(recon).to(dev), torch.from_numpy(relevant).to(dev)


def check_clahe(rec, cfg, recon, relevant, case):
    """K6 on the CLAHE joint histogram, KC on it and K5 on the resulting
    LUTs, each against its plain version on the same inputs."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import clahe
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import clahe_apply as k_clahe
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import histogram as k_hist
    nb = cfg.clahe_tiles ** 2 * cfg.clahe_bins
    joint, w = clahe.clahe_joint_bins(recon, relevant, cfg)
    h = k_hist.histogram(joint, w, nb)
    rec.equal("histogram", f"{case}, {nb} joint bins", h, k_hist.histogram_plain(joint, w, nb))
    px, py = check_kc(rec, case, h.reshape(cfg.clahe_tiles, cfg.clahe_tiles, -1), cfg)
    nan_tiles = int(torch.isnan(py).all(dim=-1).sum())
    rec.equal_float("clahe_apply", f"{case}, {nan_tiles} NaN tile(s)",
                    k_clahe.clahe_apply(recon, px, py, cfg),
                    k_clahe.clahe_apply_plain(recon, px, py, cfg))
    return nan_tiles


def check_k3(rec, case, recon, nrm, cnr, cfg, row0=0, c0=0):
    """K3 (``grad_hist_relevant``: each CNR block's weight computed in the
    kernel) against its plain version and against the same kernel reading
    ``relevance_weight_plane`` (the route of an exponent that is no integer
    in 1..8), exactly; returns K3's histogram."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    got = fh.grad_hist_relevant(recon, nrm, cnr, cfg, row0, c0)
    rec.equal("grad_hist_relevant", case, got,
              fh.grad_hist_relevant_plain(recon, nrm, cnr, cfg, row0, c0))
    rec.equal_bytes("grad_hist_relevant", f"{case}, vs the weight plane", got,
                    fh._launch_grad_hist_relevant(recon, nrm, cnr, cfg, row0, c0, 0))
    return got


def check_kc(rec, case, hists, cfg):
    """KC (``clahe.clahe_curves`` on the card) against
    ``clahe_curves_plain``: px and py bit for bit, NaN masks equal; returns
    (px, py)."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import clahe
    px, py = clahe.clahe_curves(hists, cfg)
    ppx, ppy = clahe.clahe_curves_plain(hists, cfg)
    rec.equal_bits("clahe_curves", f"{case}, px", px, ppx)
    nan_g, nan_w = torch.isnan(py), torch.isnan(ppy)
    assert torch.equal(nan_g, nan_w), f"clahe_curves [{case}]: NaN masks differ"
    rec.equal_bits("clahe_curves", case, py.nan_to_num(), ppy.nan_to_num())
    return px, py


def check_kh(rec, case, recon, nrm, cnr, cfg, space):
    """KH (``clahe_hist``) against its plain version (the relevance image,
    then ``clahe_histograms_rows``) on the whole image, every shard's rows
    of ``spatial.row_plan(n, space)``, a partition whose inner windows start
    on odd rows and one with windows of 1 and 5 rows, each partition's
    windows summed against the whole; KC on the whole histogram.  Returns
    the whole histogram."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import noise
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import clahe_hist as kh
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    n, ws = cfg.image_size, cnr.shape[-1]
    whole = kh.clahe_hist(recon, nrm, cnr, cfg)
    rec.equal("clahe_hist", case, whole, kh.clahe_hist_plain(recon, nrm, cnr, cfg))
    parts = 0
    # the plan's shards, odd starts, and windows of 1, 1, 5 rows and a
    # window's worth that cross tile rows anywhere
    few = [0, 1, 2, 7, n // 3, n // 3 + 1, n - 1, n]
    for bounds in (spatial.row_plan(n, space, cfg).bounds[0], odd_bounds(n, space), few):
        total = torch.zeros_like(whole)
        for a, b in zip(bounds, bounds[1:]):
            c0, c1 = noise.cnr_rows(ws, n, a, b)
            got = kh.clahe_hist(recon[a:b], nrm[a:b], cnr[c0:c1], cfg, a, c0)
            rec.equal_bytes("clahe_hist", f"{case}, rows [{a}, {b})", got, kh.clahe_hist_plain(
                recon[a:b], nrm[a:b], cnr[c0:c1], cfg, a, c0))
            total += got
            parts += 1
        rec.equal_bytes("clahe_hist", f"{case}, windows {list(bounds)} summed", total, whole)
    _, py = check_kc(rec, case, whole, cfg)
    log(f"  clahe_hist [{case}]: {parts} windows equal to the plain version's and summing to "
        f"the whole; clahe_curves: {int(torch.isnan(py).all(dim=-1).sum())} NaN tile(s)")
    return whole


def check_relevance(rec, rng, dev, cfg, main, var):
    """[3j]: the relevance mask inside the kernels that read it.  K3 on
    dense CNR maps (``dense_cnr``) at 3072 over 4 shards and 144 over 2
    (border 10: the default 100-px border leaves no pixel of 144 inside),
    with an integer exponent and with 4.5 (the plane route), and at 640
    with 4-px tiles (the serial kernel) over 2; KH on the
    CLAHE path's inputs (``var``: recon, normalized, cnr) and on adversarial
    ones (``clahe_recon``, ``pixel_tests``, ``dense_cnr``) at 3072, 600 and
    144 with 4x4 and 8x8 tiles, whole and on every shard's window, also with
    exponent 4.5; KC on every histogram KH gave, on the main path's
    inputs' (``main``), and on 256 random histograms with empty tiles
    (``testing/relevance_cases.py``)."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import noise
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import (
        hist_cases, relevance_cases)

    def t(a):
        return torch.from_numpy(a).to(dev)

    # the CNR map at scale 8; at 4-px tiles at scale 4, where the serial
    # kernel (a thread a tile) computes the weights
    for c, space, scale in ((cfg, 4, 8),
                            (cfg.with_(image_size=144, quirks=False, relevant_border=10), 2, 8),
                            (cfg.with_(relevant_k=4.5), 4, 8),
                            (cfg.with_(image_size=640, histogram_area_size=4, relevant_border=10),
                             2, 4)):
        n, m = c.image_size, -(-c.image_size // scale)
        recon = t(hist_cases.gradation_image(rng, n))
        nrm = t(relevance_cases.pixel_tests(rng, n, c))
        cnr = t(relevance_cases.dense_cnr(rng, c, m))
        case = f"{n} dense CNR, tile {c.histogram_area_size}, exponent {c.relevant_k}"
        whole = check_k3(rec, case, recon, nrm, cnr, c)
        total = torch.zeros_like(whole)
        plan = spatial.row_plan(n, space, c)
        for i in range(space):
            a, b = plan.rows(0, i)
            c0, c1 = noise.cnr_rows(m, n, a, b)
            total += check_k3(rec, f"{case}, shard {i} rows [{a}, {b})", recon[a:b], nrm[a:b],
                              cnr[c0:c1], c, a, c0)
        rec.equal("grad_hist_relevant", f"{case}, {space} windows summed vs the whole", total,
                  whole)
    cfg_var = cfg.with_(enable_clahe=True, grad_with_linear_image=True)
    for tiles in (4, 8):
        c = cfg_var.with_(clahe_tiles=tiles)
        check_kh(rec, f"3072 thorax, the CLAHE path's inputs, {tiles}x{tiles} tiles", *var, c, 4)
        check_kh(rec, f"3072 thorax, the main path's inputs, {tiles}x{tiles} tiles", *main, c, 4)
        for n, q, border, space, k in ((3072, True, 100, 4, 5), (600, True, 100, 4, 5),
                                       (144, False, 10, 2, 5), (3072, True, 100, 4, 4.5)):
            cn = c.with_(image_size=n, quirks=q, relevant_border=border, relevant_k=k)
            recon = t(relevance_cases.clahe_recon(rng, n, cn.clahe_bins))
            nrm = t(relevance_cases.pixel_tests(rng, n, cn))
            cnr = t(relevance_cases.dense_cnr(rng, cn, -(-n // 8)))
            check_kh(rec, f"{n} adversarial, {tiles}x{tiles} tiles, border {border}, exponent "
                     f"{cn.relevant_k}", recon, nrm, cnr, cn, space)
    # 40x40 tiles of 16 bins: more tile rows than KH's strips follow (its
    # one-segment route)
    cn = cfg_var.with_(image_size=600, clahe_tiles=40, clahe_bins=16)
    recon = t(relevance_cases.clahe_recon(rng, 600, 16))
    check_kh(rec, "600 adversarial, 40x40 tiles of 16 bins", recon,
             t(relevance_cases.pixel_tests(rng, 600, cn)),
             t(relevance_cases.dense_cnr(rng, cn, -(-600 // 8))), cn, 4)
    for k in range(256):
        c = cfg_var.with_(clahe_tiles=4 if k % 2 else 8)
        check_kc(rec, f"random {k}", t(relevance_cases.random_clahe_hists(rng, c)), c)
    log("  clahe_curves: 256 random histograms (4x4 and 8x8 tiles, empty bins and tiles) bit "
        "for bit, NaN masks equal")


def check_clahe_edges(rec, rng, n, dev, t=4, bins=256):
    """K5 on random sorted LUTs with a NaN tile and x at every segment edge
    i / bins and the next float up, 1.0, +-0.0, out of [0, 1] and denormal."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import clahe_apply as k_clahe
    cfg = MusicaConfig(image_size=n, enable_clahe=True, clahe_tiles=t, clahe_bins=bins)
    py = np.sort(rng.uniform(0, 1, (t, t, bins)).astype(np.float32), axis=-1)
    py[t - 1, 0] = np.nan
    edges = np.arange(bins + 1, dtype=np.float32) / np.float32(bins)
    special = np.float32([1.0, -0.0, 0.0, -1e-3, 1.001, 1e-40, -1e-40, 1e-45, 2.0])
    pool = np.concatenate([edges, np.nextafter(edges, np.float32(2)), special])
    x = rng.uniform(-0.05, 1.05, (n, n)).astype(np.float32)
    pick = rng.uniform(size=(n, n)) < 0.5
    x[pick] = rng.choice(pool, int(pick.sum()))
    recon, py = torch.from_numpy(x).to(dev), torch.from_numpy(py).to(dev)
    rec.equal_float("clahe_apply", f"{n} random LUTs, {t}x{t} tiles, x at segment edges",
                    k_clahe.clahe_apply(recon, None, py, cfg),
                    k_clahe.clahe_apply_plain(recon, None, py, cfg))


def check_adversarial(rec, rng, dev):
    """K1, K3 and K4 against their plain versions on adversarial inputs
    (``testing/hist_cases.py``: a 0.0 at a tile's or group's first and last
    pixel and at the scans' lane and step boundaries, values out of range,
    negative values, bin == n_bins, bin 0) at 3072, 600 (ragged: pixels past
    n, cropped noise coverage) and 144 (clean math: padded noise levels down
    to 18 px), and on constant images (one bin everywhere: every lane's
    shared atomic on one address)."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import stats
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import hist_cases

    def t(a):
        return torch.from_numpy(a).to(dev)

    for cfg, grad_kernels in ((MusicaConfig(image_size=3072), ("K3", "K4")),
                              (MusicaConfig(image_size=600), ("K4",)),
                              (MusicaConfig(image_size=144, quirks=False), ("K3", "K4"))):
        n = cfg.image_size
        sizes = [-(-n // 2 ** i) for i in cfg.analysis_levels]
        levels = [t(a) for a in hist_cases.noise_levels(rng, sizes)]
        check_noise(rec, cfg, levels, f"{n} adversarial levels {sizes}")
        check_noise(rec, cfg, [torch.full((m, m), 0.05, device=dev) for m in sizes],
                    f"{n} constant levels")
        check_noise(rec, cfg, [t(a) for a in hist_cases.tie_levels(sizes)],
                    f"{n} levels whose bins 1500, 7 and 2047 tie")
        recon = t(hist_cases.gradation_image(rng, n))
        flat = torch.full((n, n), 0.5, device=dev)
        rel = t(rng.uniform(0.0, 1.0, (n, n)).astype(np.float32))
        nrm = t(rng.uniform(0.0, 1.01, (n, n)).astype(np.float32))
        cnr = t(rng.uniform(0.0, 0.1, (n // 8, n // 8)).astype(np.float32))
        for case, r in (("adversarial", recon), ("constant", flat)):
            if "K4" in grad_kernels:
                rec.equal("grad_hist", f"{n} {case}", fh.grad_hist(r, rel, cfg),
                          fh.grad_hist_plain(r, rel, cfg))
            if "K3" in grad_kernels:
                check_k3(rec, f"{n} {case}", r, nrm, cnr, cfg)
    # the quirks coverage of a 256 image is 0: every histogram empty, every
    # folded argmax bin 0
    cfg = MusicaConfig(image_size=256)
    sizes = [-(-256 // 2 ** i) for i in cfg.analysis_levels]
    assert all(stats.coverage(m, cfg) == 0 for m in sizes)
    levels = [t(a) for a in hist_cases.noise_levels(rng, sizes)]
    check_noise(rec, cfg, levels, "256 adversarial levels, quirks coverage 0")
    check_sdev_noise(rec, cfg, levels, "256 adversarial bands, quirks coverage 0")
    # histogram tiles other than 16: the warp layouts at 8 and 32 px, the
    # serial kernels at 12 (K1, K4, K7; K3 where the CNR scale 8 divides the
    # tile and the tile divides n)
    for tile in (8, 12, 32):
        for cfg in (MusicaConfig(image_size=600, histogram_area_size=tile),
                    MusicaConfig(image_size=144, quirks=False, histogram_area_size=tile)):
            n = cfg.image_size
            sizes = [-(-n // 2 ** i) for i in cfg.analysis_levels]
            levels = [t(a) for a in hist_cases.noise_levels(rng, sizes)]
            check_noise(rec, cfg, levels, f"{n} adversarial levels, tile {tile}")
            check_sdev_noise(rec, cfg, levels, f"{n} adversarial bands, tile {tile}")
            recon = t(hist_cases.gradation_image(rng, n))
            rel = t(rng.uniform(0.0, 1.0, (n, n)).astype(np.float32))
            rec.equal("grad_hist", f"{n} adversarial, tile {tile}", fh.grad_hist(recon, rel, cfg),
                      fh.grad_hist_plain(recon, rel, cfg))
            if tile % 8 == 0 and n % tile == 0:
                nrm = t(rng.uniform(0.0, 1.01, (n, n)).astype(np.float32))
                cnr = t(rng.uniform(0.0, 0.1, (n // 8, n // 8)).astype(np.float32))
                check_k3(rec, f"{n} adversarial, tile {tile}", recon, nrm, cnr, cfg)


def plan_rows(plan, k, i):
    """Shard i's rows of level k under ``plan``; a level past the sharded
    ones is scanned whole by the first shard, as ``spatial.forward`` does."""
    if k < plan.replicated:
        return plan.rows(k, i)
    return (0, plan.sizes[k]) if i == 0 else (0, 0)


def check_windows(rec, cfg, levels, case, space=4, grad=None, relevant=None, cfg_grad=None):
    """K1, K3 and K4 on the row windows of ``spatial.row_plan(n, space)``
    and K2's own launch, each against its plain version on the same
    windows, exactly; the windows' histograms summed against the whole
    image's, and K2 on the sum against K1's folded argmax.  ``levels``: the
    analysis levels' sdev images; ``grad``: (recon, normalized, cnr) for K3;
    ``relevant``: (image, relevance) for K4 (under ``cfg_grad``)."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import noise
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    n = cfg.image_size
    plan = spatial.row_plan(n, space, cfg)
    lv = list(cfg.analysis_levels)
    dev = levels[0].device
    h1 = torch.zeros((len(lv), cfg.noise_histogram_bins), dtype=torch.int32, device=dev)
    h3 = torch.zeros(cfg.grad_histogram_bins, dtype=torch.int32, device=dev)
    h4 = torch.zeros_like(h3)
    launched = 0
    for i in range(space):
        rows = [plan_rows(plan, k, i) for k in lv]
        wins, r0s = [sd[a:b] for sd, (a, b) in zip(levels, rows)], [a for a, _ in rows]
        got = fh.noise_hists_rows(wins, r0s, cfg)
        want = fh.noise_hists_rows_plain(wins, r0s, cfg)
        if got is None:
            assert not bool(want.any()), f"{case}: shard {i} launched nothing but has counts"
        else:
            launched += 1
            rec.equal("noise_hist", f"{case}, shard {i} rows {rows}", got, want)
            h1 += got
        a, b = plan.rows(0, i)
        if grad is not None:
            recon, nrm, cnr = grad
            c0, c1 = noise.cnr_rows(cnr.shape[-1], n, a, b)
            h3 += check_k3(rec, f"{case}, shard {i} rows [{a}, {b}), CNR rows [{c0}, {c1})",
                           recon[a:b], nrm[a:b], cnr[c0:c1], cfg, a, c0)
        if relevant is not None:
            img, rel = relevant
            c = cfg_grad or cfg
            got = fh.grad_hist(img[a:b], rel[a:b], c, a)
            rec.equal("grad_hist", f"{case}, shard {i} rows [{a}, {b})", got,
                      fh.grad_hist_plain(img[a:b], rel[a:b], c, a))
            h4 += got
    whole, mb = fh.noise_hists(levels, cfg)
    rec.equal("noise_hist", f"{case}, {launched} shards' windows summed vs the whole", h1, whole)
    k2 = fh.hist_argmax(h1)
    rec.equal("hist_argmax", f"{case}, own launch on the summed windows vs the plain version",
              k2, fh.hist_argmax_plain(h1))
    rec.equal("hist_argmax", f"{case}, own launch vs K1's folded argmax", k2, mb)
    if grad is not None:
        rec.equal("grad_hist_relevant", f"{case}, windows summed vs the whole", h3,
                  fh.grad_hist_relevant(*grad, cfg))
    if relevant is not None:
        rec.equal("grad_hist", f"{case}, windows summed vs the whole", h4,
                  fh.grad_hist(*relevant, cfg_grad or cfg))


def odd_bounds(n, space):
    """A partition of n rows into ``space`` windows, the inner ones
    starting on odd rows."""
    return [0] + [i * n // space + (1 - i * n // space % 2) for i in range(1, space)] + [n]


def k7_windows(plan, bands, cfg, i):
    """K7's arguments on shard i of ``plan``, as ``spatial.forward`` makes
    them: each analysis level's band rows (the 2-row halos included), their
    first row, the sdev rows and whether the shard counts the level (a
    replicated level: whole on every shard, counted by the first)."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import pyramid
    lv = list(cfg.analysis_levels)
    rows = [plan.rows(k, i) if k < plan.replicated else (0, plan.sizes[k]) for k in lv]
    need = [pyramid.needed_rows("img_sdev", b.shape[-1], *r) for b, r in zip(bands, rows)]
    return ([b[lo:hi] for b, (lo, hi) in zip(bands, need)], [lo for lo, _ in need], rows,
            [k < plan.replicated or i == 0 for k in lv])


def check_variant_windows(rec, cfg, bands, case, space=4, clahe_in=None):
    """[3e], the variants' kernels on the row windows of
    ``spatial.row_plan(n, space)``, each against its plain version on the
    same windows, exactly: K7 (``bands``: the analysis levels' bandpass
    images) on every shard's windows, its sdev rows also against the
    whole-image K7's and its histograms summed against the whole image's;
    with ``clahe_in`` = (recon, relevance, cfg) K6 on every shard's joint
    bins, summed against the whole joint histogram, and K5 on every shard's
    rows and on a partition whose inner windows start on odd rows, also
    against the whole apply's rows."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import clahe
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import clahe_apply as k_clahe
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import histogram as k_hist
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    n = cfg.image_size
    plan = spatial.row_plan(n, space, cfg)
    whole_sd, whole_h, _ = fh.sdev_noise_hists(bands, cfg)
    total = torch.zeros_like(whole_h)
    for i in range(space):
        wins, los, rows, counted = k7_windows(plan, bands, cfg, i)
        sds, h = fh.sdev_noise_hists_rows(wins, los, rows, cfg, counted)
        p_sds, p_h = fh.sdev_noise_hists_rows_plain(wins, los, rows, cfg, counted)
        rec.equal_float("sdev_noise_hist", f"{case}, shard {i} rows {rows}, sdev",
                        torch.cat([x.flatten() for x in sds]),
                        torch.cat([x.flatten() for x in p_sds]))
        rec.equal_float("sdev_noise_hist", f"{case}, shard {i}, sdev vs the whole K7's rows",
                        torch.cat([x.flatten() for x in sds]),
                        torch.cat([w[a:b].flatten() for w, (a, b) in zip(whole_sd, rows)]))
        rec.equal("sdev_noise_hist", f"{case}, shard {i}, histograms", h, p_h)
        total += h
    rec.equal("sdev_noise_hist", f"{case}, {space} shards' windows summed vs the whole",
              total, whole_h)
    if clahe_in is None:
        return
    recon, rel, c = clahe_in
    t, nb = c.clahe_tiles, c.clahe_tiles ** 2 * c.clahe_bins
    joint, w = clahe.clahe_joint_bins(recon, rel, c)
    whole6 = k_hist.histogram(joint, w, nb)
    px, py = clahe.clahe_curves(whole6.reshape(t, t, -1), c)
    whole5 = k_clahe.clahe_apply(recon, px, py, c)
    h6 = torch.zeros_like(whole6)
    for i in range(space):
        a, b = plan.rows(0, i)
        jr, wr = clahe.clahe_joint_bins_rows(recon[a:b], rel[a:b], a, n, c)
        got = k_hist.histogram(jr, wr, nb)
        rec.equal("histogram", f"{case}, shard {i} rows [{a}, {b}), {nb} joint bins", got,
                  k_hist.histogram_plain(jr, wr, nb))
        h6 += got
    rec.equal("histogram", f"{case}, {space} shards' joint histograms summed vs the whole", h6,
              whole6)
    ob = odd_bounds(n, space)
    for name, bounds in (("shard", plan.bounds[0]), ("odd window", ob)):
        for a, b in zip(bounds, bounds[1:]):
            got = k_clahe.clahe_apply(recon[a:b], px, py, c, a)
            rec.equal_float("clahe_apply", f"{case}, {name} rows [{a}, {b})", got,
                            k_clahe.clahe_apply_plain(recon[a:b], px, py, c, a))
            rec.equal_float("clahe_apply", f"{case}, {name} rows [{a}, {b}) vs the whole "
                            "apply's", got, whole5[a:b])


def check_window_kernels(rec, rng, dev, cfg, lv3072, main, var, var3072):
    """[3e]: ``check_windows`` and ``check_variant_windows`` at the 3072
    shapes of the spatial plan over 4 shards (the thorax's levels, K3 on its
    recon, K4 on the CLAHE + linear path's squared image, K7 on its bands,
    K6 and K5 on the CLAHE + linear path's recon), on the adversarial
    inputs of ``testing/hist_cases.py`` at 3072, 600 and 144 (over 2: 144
    holds no 4 shards of whole 16-px tiles), and at histogram tiles 8, 12
    and 32."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import hist_cases

    def t(a):
        return torch.from_numpy(a).to(dev)

    cfg_var, linear, v_rel = var
    check_windows(rec, cfg, lv3072, "3072 thorax over 4", grad=main,
                  relevant=(linear, v_rel), cfg_grad=cfg_var)
    b3072, v_recon = var3072
    check_variant_windows(rec, cfg, b3072, "3072 thorax over 4",
                          clahe_in=(v_recon, v_rel, cfg_var))
    cases = [(MusicaConfig(image_size=3072), 4), (MusicaConfig(image_size=600), 4),
             (MusicaConfig(image_size=144, quirks=False), 2)]
    cases += [(MusicaConfig(image_size=n, quirks=q, histogram_area_size=tile), s)
              for tile in (8, 12, 32) for n, q, s in ((600, True, 4), (144, False, 2))]
    for c, space in cases:
        n, tile = c.image_size, c.histogram_area_size
        sizes = [-(-n // 2 ** i) for i in c.analysis_levels]
        recon = t(hist_cases.gradation_image(rng, n))
        rel = t(rng.uniform(0.0, 1.0, (n, n)).astype(np.float32))
        nrm = t(rng.uniform(0.0, 1.01, (n, n)).astype(np.float32))
        cnr = t(rng.uniform(0.0, 0.1, (-(-n // 8), -(-n // 8))).astype(np.float32))
        check_windows(rec, c, [t(a) for a in hist_cases.noise_levels(rng, sizes)],
                      f"{n} adversarial, tile {tile}, over {space}", space,
                      grad=(recon, nrm, cnr) if tile % 8 == 0 else None, relevant=(recon, rel))
        # K7 on adversarial levels as bands, K5 and K6 on the adversarial
        # gradation image (values past 1.0, exact 1.0, 0.0, negatives) with a
        # random relevance whose first tile is empty (a NaN LUT)
        rel_c = (rel > 0.3).to(torch.float32)
        rel_c[:n // 4, :n // 4] = 0.0
        check_variant_windows(rec, c, [t(a) for a in hist_cases.noise_levels(rng, sizes)],
                              f"{n} adversarial, tile {tile}, over {space}", space,
                              clahe_in=(recon, rel_c, c.with_(enable_clahe=True))
                              if tile == 16 else None)


def check_pyramid(rec, rng, dev, nrm, cfg):
    """[3f]: KP1 (the fused ``reduce_step`` and ``smooth_downsample``), KP2
    (``upsample_smooth``, ``upsample_subtract``, ``upsample_add``, a bf16
    band too) and the tails (``reduce_tail``, ``expand_tail`` with float32
    and bf16 bands) against their plain versions bit for bit: at every level
    of 3072, 600 and 144 on adversarial inputs (+-0, denormals, +-1e30) and
    constant planes (-0.0, 1e30, 3.0, the denormal 3e-39), the fused step
    at every level of the expand's polyphase size, the tails from every
    level they hold down through 1 px and back; the 3072 thorax's ladder
    (``reduce_ladder``) and expand (``expand_ladder``, and an
    ``upsample_add`` a level); every row window of the spatial plans at
    3072 and 600 (16-px tiles) and 144 (12-px tiles) over 4 shards, windows
    that start on odd rows among them."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import pyramid
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import pyramid as kp
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import pyramid_cases as pc

    def data(shape, case="mixed"):
        return torch.from_numpy(pc.adversarial(rng, shape, case)).to(dev)
    L = cfg.pyramid_levels
    bands, downs = pyramid.reduce_ladder(nrm, L)
    p_bands, p_downs = pyramid.reduce_ladder_plain(nrm, L)
    for i in range(L):
        rec.equal_bits("pyramid_down", f"3072 thorax ladder, level {i}", downs[i], p_downs[i])
        rec.equal_bits("pyramid_up", f"3072 thorax ladder, band {i}", bands[i], p_bands[i])
    recon, p_recon = downs[-1], p_downs[-1]
    for lvl in range(L - 1, -1, -1):
        recon = pyramid.upsample_add(recon, bands[lvl])
        p_recon = kp.upsample_add_plain(p_recon, bands[lvl])
        rec.equal_bits("pyramid_up", f"3072 thorax expand, level {lvl}", recon, p_recon)
    for b in (bands, [t.to(torch.bfloat16) for t in bands]):
        rec.equal_bits("pyramid_tail", f"3072 thorax expand_ladder, {b[0].dtype} bands",
                       pyramid.expand_ladder(downs[-1], b), kp.expand_ladder_plain(downs[-1], b))
    log(f"  the 3072 thorax: reduce_ladder's {L} downs and bands, an expand of {L} steps and "
        f"expand_ladder (float32 and bf16 bands) equal the plain versions bit for bit")
    for n in (SIZE, 600, 144):
        count = 0
        sizes = pc.level_sizes(n)
        for i, h in enumerate(sizes):
            src = -(-h // 2)
            for case in pc.CASES:
                x, small = data((h, h), case), data((src, src), case)
                what = f"{n}: level {h}, {case}"
                if pyramid.polyphase(h):
                    p_band, p_dn = kp.reduce_step_plain(x)
                    band, dn = kp.reduce_step(x)
                    rec.equal_bits("pyramid_down", what + ", fused step band", band, p_band)
                    rec.equal_bits("pyramid_down", what + ", fused step down", dn, p_dn)
                    count += 1
                if h <= kp.TAIL_MAX:
                    levels = len(sizes) - i
                    t_bands, t_downs = kp.reduce_tail(x, levels)
                    p_bands, p_downs = kp.reduce_tail_plain(x, levels)
                    for j, (g, w) in enumerate(zip(t_bands + t_downs, p_bands + p_downs)):
                        rec.equal_bits("pyramid_tail", f"{what}, ladder tail output {j}", g, w)
                    top = data(tuple(p_downs[-1].shape), case)
                    for b in (p_bands, [t.to(torch.bfloat16) for t in p_bands]):
                        rec.equal_bits("pyramid_tail", f"{what}, expand tail {b[0].dtype}",
                                       kp.expand_tail(top, b), kp.expand_tail_plain(top, b))
                    count += 3
                rec.equal_bits("pyramid_down", what, kp.smooth_downsample(x),
                               kp.smooth_downsample_plain(x))
                rec.equal_bits("pyramid_up", what, kp.upsample_smooth(small, h),
                               pyramid.upsample_smooth_plain(small, h))
                rec.equal_bits("pyramid_up", what + ", subtract", kp.upsample_subtract(x, small),
                               kp.upsample_subtract_plain(x, small))
                for band in (x, x.to(torch.bfloat16)):
                    rec.equal_bits("pyramid_up", f"{what}, add {band.dtype}",
                                   kp.upsample_add(small, band), kp.upsample_add_plain(small, band))
                count += 5
        log(f"  every level of {n} ({len(pc.level_sizes(n))} levels) on {len(pc.CASES)} inputs "
            f"each: {count} "
            f"launches equal their plain versions bit for bit")
    for n, tile in ((SIZE, 16), (600, 16), (144, 12)):
        wins = pc.shard_windows(n, tile)
        images = {}
        for op, h, (lo, hi), (a, b) in wins:
            if h not in images:
                images[h] = data((h, h)), data((-(-h // 2),) * 2)
            x, small = images[h]
            what = f"{n} over 4, level {h}, rows [{a}, {b})"
            if op == "down":
                rec.equal_bits("pyramid_down", what, kp.smooth_downsample_rows(x[lo:hi], lo, h, a, b),
                               kp.smooth_downsample_rows_plain(x[lo:hi], lo, h, a, b))
                continue
            s = small[lo:hi]
            rec.equal_bits("pyramid_up", what, kp.upsample_smooth_rows(s, lo, h, a, b),
                           kp.upsample_rows_plain(s, lo, h, a, b))
            cur = x[a:b]
            rec.equal_bits("pyramid_up", what + ", subtract", kp.upsample_subtract(cur, s, lo, a),
                           kp.upsample_subtract_plain(cur, s, lo, a))
            band = cur.to(torch.bfloat16)
            rec.equal_bits("pyramid_up", what + ", add", kp.upsample_add(s, band, lo, a),
                           kp.upsample_add_plain(s, band, lo, a))
        odd = sum(b[0] % 2 for *_, b in wins)
        log(f"  {n} over 4 shards ({tile}-px tiles): {len(wins)} windows ({odd} starting on odd "
            f"rows), each kernel and mode equal to its plain row-window version")


def tone_inputs(x_dev, c, fused):
    """(gradation input, gpx, gpy) of ``musica_forward`` of ``x_dev`` under
    ``c``: the input its tone map reads and its gradation curve."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
    res = musica.musica_forward(x_dev, c, want_intermediates=True, fused_sdev=fused)
    gpx, gpy, _ = res["intermediates"]["grad_curve"]
    return res["intermediates"].get("linear", res["recon"]), gpx, gpy


# [3g]'s curves on row windows: two paths' and four adversarial ones (fold-back
# and 63 random take KT's chain, infinite slope and increasing 22 its search)
WINDOW_CURVES = ("main", "CLAHE + linear", "fold-back", "infinite slope", "63 random",
                 "increasing 22")


def searched(gpx) -> bool:
    """Whether KT takes the binary search on the curve ``gpx``
    (csrc/tonemap.cu: strictly increasing, its last point >= 0) rather than
    the descending chain."""
    return bool((gpx[1:] > gpx[:-1]).all()) and float(gpx[-1]) >= 0.0


def check_sdev_tail(rec, rng, dev):
    """[3g]: KS's and K7's per-output tail (``sdev_tail_kernel``: div25 and
    sqrt_to_f32 of csrc/sdev_noise.cu) against ``torch.sqrt(s / 25)`` to
    float32 bit for bit (NaN where it has NaN) on the adversarial sums of
    ``testing/sdev_cases.py`` and 4 million random doubles; and the relative
    error of rsqrt.approx.ftz.f64, where sqrt_to_f32 starts, on every
    significand its high word holds and on random q over the tail's range:
    the proof needs it below 2^-16."""
    import math
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import sdev_cases
    counts = {}
    for what, s in (("adversarial", sdev_cases.adversarial_sums(rng)),
                    ("random", sdev_cases.random_doubles(rng, 4 << 20))):
        t = torch.from_numpy(s).to(dev)
        got, want = fh.sdev_tail(t), fh.sdev_tail_plain(t)
        nan = torch.isnan(want)
        rec.equal("sdev", f"tail on {what} sums, NaN positions", torch.isnan(got), nan)
        rec.equal_bits("sdev", f"tail on {what} sums", got[~nan].contiguous(),
                       want[~nan].contiguous())
        counts[what] = (s.size, int(nan.sum()))
    hi = np.arange(1 << 20, dtype=np.int64)
    q = np.concatenate([((e << 52) | (hi << 32) | low).view(np.float64)
                        for e in (1022, 1023) for low in (0, 0xffffffff)])
    t = torch.from_numpy(q).to(dev)
    e_high = (fh.sdev_tail_rsqrt(t) * torch.sqrt(t) - 1.0).abs().max().item()
    t = torch.from_numpy(np.exp2(rng.uniform(-245.0, 236.0, 4 << 20))).to(dev)
    e_rand = (fh.sdev_tail_rsqrt(t) * torch.sqrt(t) - 1.0).abs().max().item()
    assert max(e_high, e_rand) < 2.0 ** -16, (e_high, e_rand)
    log(f"  KS's tail (div25, sqrt_to_f32): {counts['adversarial'][0]} adversarial sums and "
        f"{counts['random'][0]} random doubles ({counts['random'][1]} NaN) bit for bit as "
        f"torch.sqrt(s / 25) to float32; rsqrt.approx.ftz.f64's relative error at most "
        f"2^{math.log2(e_high):.2f} over every high word of two binades, 2^{math.log2(e_rand):.2f} "
        f"over 4M random q (the proof needs < 2^-16)")


def check_tone_sdev(rec, rng, dev, variants):
    """[3g]: KT (``tonemap.tone_map``) against its plain version: ``graded``
    bit for bit (NaN where it has NaN) and ``out_u8`` equal, at 3072, 600
    and 144 on the gradation input and curve of every path in ``variants``
    (name, cfg, fused_sdev) and on the adversarial curves of
    ``testing/tone_cases.py`` over images that hit every knot, its 1-ulp
    neighbours and the special values (denormals too); the tables the
    kernel's first block builds against ``curves.general_tables``; every
    shard window of the 1x4 and 2x2 plans (4 and 2 shards; 12-px tiles at
    144) and windows starting on odd rows and inside the margins, each
    against its plain window and all put together against the whole.  KS
    (``fused_hist.sdevs``) against ``img_sdev`` at every analysis level of
    3072, 600 and 144 (a phantom's bands and random bands, also with a few
    blocks whose task ranges cross levels) and on every shard's row
    windows of the 4-shard plan (``img_sdev_rows``)."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import curves, stats
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import tonemap
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import tone_cases
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        synthetic_radiograph)

    def same(got, want, what):
        rec.equal_bits("tone_map", f"{what}, graded", got[0], want[0])
        rec.equal_bytes("tone_map", f"{what}, out_u8", got[1], want[1])

    for n, anatomy in ((SIZE, "thorax"), (600, "pelvis"), (144, "hand")):
        m = 10
        x_dev = torch.from_numpy(synthetic_radiograph(n, anatomy)).to(dev)
        cases = [(name, *tone_inputs(x_dev, c.with_(image_size=n, quirks=n > 144), fused))
                 for name, c, fused in variants]
        for name, (px, py) in tone_cases.adversarial_curves(rng).items():
            cases.append((name, torch.from_numpy(tone_cases.image(rng, (n, n), px)).to(dev),
                          torch.from_numpy(px).to(dev), torch.from_numpy(py).to(dev)))
        nan = 0
        for name, x, gpx, gpy in cases:
            what = f"{n} {anatomy}, {name} curve ({gpx.shape[0]} points)"
            got = tonemap.tone_map(x, gpx, gpy, m)
            same(got, tonemap.tone_map_plain(x, gpx, gpy, m), what)
            g, o, tab = tonemap.tone_tables(x, gpx, gpy, m)
            same((g, o), got, what + ", with its tables")
            for j, w in enumerate(curves.general_tables(gpx, gpy)):
                rec.equal_bits("tone_map", f"{what}, table {j}", tab[j, :w.shape[0]].contiguous(),
                               w)
            nan += int(torch.isnan(got[0]).sum())
        way = {c[0]: "search" if searched(c[2]) else "chain" for c in cases}
        assert {"search", "chain"} <= set(way.values())
        log(f"  KT at {n}: {len(cases)} curves (the paths' {', '.join(v[0] for v in variants)}; "
            f"{', '.join(c[0] for c in cases[len(variants):])}): graded bit for bit ({nan} NaN "
            f"px in all), out_u8 equal, the block's tables equal curves.general_tables; "
            f"selection: {way}")
        tile = 16 if n > 144 else 12
        cfg_n = MusicaConfig(image_size=n, quirks=n > 144, histogram_area_size=tile)
        windows = 0
        for bounds in (spatial.row_plan(n, 4, cfg_n).bounds[0],
                       spatial.row_plan(n, 2, cfg_n).bounds[0],
                       (0, 5, 11, n // 2 + 1, n - 9, n)):
            for name, x, gpx, gpy in [c for c in cases if c[0] in WINDOW_CURVES]:
                whole = tonemap.tone_map(x, gpx, gpy, m)
                parts = []
                for a, b in zip(bounds, bounds[1:]):
                    got = tonemap.tone_map(x[a:b], gpx, gpy, m, a)
                    same(got, tonemap.tone_map_plain(x[a:b], gpx, gpy, m, a),
                         f"{n} {name}, rows [{a}, {b})")
                    parts.append(got)
                    windows += 1
                same((torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])), whole,
                     f"{n} {name}, windows {list(bounds)} put together")
        log(f"  KT at {n}: {windows} row windows (1x4, 2x2 and odd rows, {tile}-px tiles) equal "
            f"their plain versions and, put together, the whole image and its crop")
        # KS: every analysis level in one launch
        lv = list(cfg_n.analysis_levels)
        for label, bands in ((anatomy, analysis_bands(synthetic_radiograph(n, anatomy), cfg_n,
                                                      dev)),
                             ("random", random_bands(rng, [-(-n // 2 ** i) for i in lv], dev))):
            want = [stats.img_sdev(b) for b in bands]
            for grid in (0, 3):
                for j, (g, w) in enumerate(zip(fh.sdevs(bands, grid=grid), want)):
                    rec.equal_bits("sdev", f"{n} {label}, level {lv[j]}, grid {grid}", g, w)
            plan = spatial.row_plan(n, 4, cfg_n)
            for i in range(4):
                wins, los, rows, _ = k7_windows(plan, bands, cfg_n, i)
                got = fh.sdevs_rows(wins, los, rows)
                for j, (g, p, w) in enumerate(zip(got, fh.sdevs_rows_plain(wins, los, rows), want)):
                    rec.equal_bits("sdev", f"{n} {label}, shard {i}, level {lv[j]}", g, p)
                    rec.equal_bits("sdev", f"{n} {label}, shard {i}, level {lv[j]} vs the whole",
                                   g, w[rows[j][0]:rows[j][1]].contiguous())
        log(f"  KS at {n}: levels {[b.shape[-1] for b in bands]} of the {anatomy} and of random "
            f"bands (one wave and 3 blocks) and every shard's windows over 4 equal img_sdev / "
            f"img_sdev_rows bit for bit")


def same_band(rec, kernel, case, got, want):
    """Bands (float32 or bf16) equal bit for bit, NaN where the other has
    NaN; records max |kernel - plain| without a line of its own."""
    import torch
    assert got.shape == want.shape and got.dtype == want.dtype, (kernel, case, got.shape,
                                                                 want.shape, got.dtype)
    g, w = got.float(), want.float()
    nan = torch.isnan(w)
    assert torch.equal(torch.isnan(g), nan), f"{kernel} [{case}]: NaN masks differ"
    same = torch.equal(g[~nan].view(torch.int32), w[~nan].view(torch.int32))
    err = 0.0 if same else float((g[~nan].double() - w[~nan].double()).abs().max())
    prev = rec.err[kernel]
    rec.err[kernel] = err if prev is None else max(prev, err)
    assert same, f"{kernel} [{case}] differs from its plain version (max |d| {err})"
    return int(nan.sum())


def unaligned(t):
    """A contiguous copy of ``t`` that starts one element past an
    allocation's start (not 16-byte aligned)."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def contrast_inputs(x_dev, c):
    """(bands [L] in c's storage dtype, sdevs, max bins, cnr) of
    ``musica_forward`` of ``x_dev`` under ``c``: what its contrast stage
    reads."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
    res = musica.musica_forward(x_dev, c, want_intermediates=True)
    it = res["intermediates"]
    return ([it[f"red_bandpass_{k}"] for k in range(c.pyramid_levels)],
            {k: it[f"sdev_{k}"] for k in c.analysis_levels},
            {k: it[f"noise_max_bin_{k}"] for k in c.analysis_levels}, res["cnr"])


def adversarial_contrast(rng, c, bands, sdevs, cnr):
    """The stage's inputs with, at random pixels of each analysis level's
    sdev, every control point of its curve, px[0], the float32 above the
    last point, +-0 (the flat level also 1, its successor and 2), NaN, +-inf
    and denormals; NaN, +-inf, denormal and huge band values; CNR cells at
    each ramp end and its float32 neighbours, NaN and inf."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import curves
    f32 = np.float32
    odd = [np.nan, np.inf, -np.inf, 1e-40, -1e-40, 1e-45, float(np.finfo(f32).max)]

    def put(t, values):
        t = t.clone().reshape(-1)
        at = torch.from_numpy(rng.choice(t.numel(), min(t.numel(), 3 * len(values)),
                                         replace=False)).to(t.device)
        v = torch.tensor(np.resize(np.array(values, f32), at.numel()), device=t.device)
        t[at] = v.to(t.dtype)
        return t

    out_s = {}
    for k, sd in sdevs.items():
        px, _ = curves.contrast_curve(torch.zeros((), dtype=torch.int32, device=sd.device),
                                      *c.contrast_factors[k], c)
        px = px.cpu().numpy()
        vals = [*px, np.nextafter(px[-1], f32(np.inf)), 0.0, -0.0, *odd]
        if c.contrast_factors[k][0] == 1.0:
            vals += [1.0, float(np.nextafter(f32(1), f32(2))), 2.0]
        out_s[k] = put(sd, vals).reshape(sd.shape)
    out_b = [put(b, odd).reshape(b.shape) for b in bands]
    ends = [f32(v) for v in c.noise_reduction_params[0][0::2]]
    vals = [float(w / f32(c.max_cnr_value)) for e in ends
            for w in (e, np.nextafter(e, f32(0)), np.nextafter(e, f32(np.inf)))]
    return out_b, out_s, put(cnr, vals + [np.nan, np.inf]).reshape(cnr.shape)


def check_contrast(rec, rng, dev, cfg):
    """[3h]: KA (``contrast_apply.contrast_apply``) against its plain version
    (``contrast_apply_plain``) on the card, bit for bit with equal NaN
    masks: the curves its blocks build (``contrast_tables``) against
    ``curves.contrast_curve`` and their slopes at all 2,048 max bins on every
    level; the bands the expand reads and, with intermediates, every
    contrast band, noise-reduced band and curve, at 3072, 600 and 144 in
    float32 and bf16 on a phantom's inputs, on the adversarial ones
    (``adversarial_contrast``) and with random max bins; and every shard's
    row window of the 1x4 and 2x2 plans (4 and 2 shards; 12-px tiles at 144)
    against the plain window and the whole stage's rows."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import curves, noise
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import (
        contrast_apply as ka)
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        synthetic_radiograph)

    def compare(got, want, what):
        nan = 0
        for k, (g, w) in enumerate(zip(got[0], want[0])):
            nan += same_band(rec, "contrast_apply", f"{what}, the expand's band {k}", g, w)
        assert set(got[1]) == set(want[1]), what
        for key, w in want[1].items():
            if key.startswith("contrast_curve"):
                for g_, w_ in zip(got[1][key], w):
                    rec.equal_bits("contrast_apply", f"{what}, {key}", g_.contiguous(), w_)
            else:
                nan += same_band(rec, "contrast_apply", f"{what}, {key}", got[1][key], w)
        return nan

    # the curves at every max bin, on tiny bands (a row of 8 px a level)
    L = cfg.pyramid_levels
    one = [torch.zeros((1, 8), dtype=torch.float32, device=dev) for _ in range(L)]
    sd1 = {k: one[k] for k in cfg.analysis_levels}
    cnr1 = {k: (torch.zeros((1, 1), device=dev), 0) for k in ka.nr_levels(cfg, False)}
    bez = [k for k, (lcf, _) in enumerate(cfg.contrast_factors) if lcf != 1.0]
    for mb in range(cfg.noise_histogram_bins):
        t = torch.tensor(mb, dtype=torch.int32, device=dev)
        _, _, tab = ka.contrast_tables(one, sd1, {k: t for k in cfg.analysis_levels}, cnr1, cfg)
        for k in (bez if mb else range(L)):
            px, py = curves.contrast_curve(t, *cfg.contrast_factors[k], cfg)
            m = px.shape[0]
            slopes = (py[1:] - py[:-1]) / (px[1:] - px[:-1])
            for j, w in enumerate((px, py, slopes)):
                rec.equal_bits("contrast_apply", f"max bin {mb}, level {k}, table {j}",
                               tab[k, j, :w.shape[0]].contiguous(), w)
            assert m == (33 if k in bez else 2)
    log(f"  KA's curves: all {cfg.noise_histogram_bins} max bins on the bezier levels {bez} "
        f"(the flat levels at max bin 0): points and slopes equal curves.contrast_curve's")

    for n, anatomy in ((SIZE, "thorax"), (600, "pelvis"), (144, "hand")):
        tile = 16 if n > 144 else 12
        c32 = MusicaConfig(image_size=n, quirks=n > 144, histogram_area_size=tile)
        x_dev = torch.from_numpy(synthetic_radiograph(n, anatomy)).to(dev)
        for c in (c32, c32.with_(storage="bfloat16")):
            bands, sdevs, mbs, cnr = contrast_inputs(x_dev, c)
            adv = adversarial_contrast(rng, c, bands, sdevs, cnr)
            rnd_mb = {k: torch.tensor(int(rng.integers(0, c.noise_histogram_bins)), dtype=torch.int32,
                                    device=dev)
                      for k in mbs}
            cases = {"phantom": (bands, sdevs, mbs, cnr), "adversarial": (adv[0], adv[1], mbs,
                                                                         adv[2]),
                     "random max bins": (bands, sdevs, rnd_mb, cnr),
                     # every array one element past a 16-byte boundary: no
                     # level takes the vector path
                     "unaligned": ([unaligned(t) for t in adv[0]],
                                   {k: unaligned(t) for k, t in adv[1].items()}, mbs, adv[2])}
            nans, windows = 0, 0
            for name, (b, sd, mb, cn) in cases.items():
                what = f"{n} {anatomy} {c.storage}, {name}"
                for inter in (False, True):
                    cnrs = {k: (cn, 0) for k in ka.nr_levels(c, inter)}
                    got = ka.contrast_apply(b, sd, mb, cnrs, c, intermediates=inter)
                    nans += compare(got, ka.contrast_apply_plain(b, sd, mb, cnrs, c,
                                                                 intermediates=inter),
                                    f"{what}{', intermediates' if inter else ''}")
                whole = got[0]
                for space in (4, 2):
                    plan = spatial.row_plan(n, space, c)
                    for i in range(space):
                        rows = [plan.rows(k, i) if k < plan.replicated else (0, plan.sizes[k])
                                for k in range(c.pyramid_levels)]
                        cnrs = {}
                        for k in ka.nr_levels(c, False):
                            lo, hi = noise.cnr_rows(cn.shape[-1], plan.sizes[k], *rows[k])
                            cnrs[k] = (cn[lo:hi], lo)
                        wb = [b[k][r0:r1] for k, (r0, r1) in enumerate(rows)]
                        ws = {k: sd[k][r0:r1] for k, (r0, r1) in enumerate(rows) if k in sd}
                        r0s = [r0 for r0, _ in rows]
                        got_w = ka.contrast_apply(wb, ws, mb, cnrs, c, r0s)
                        want_w = ka.contrast_apply_plain(wb, ws, mb, cnrs, c, r0s)
                        for k, (r0, r1) in enumerate(rows):
                            wc = f"{what}, shard {i} of {space}, level {k}"
                            same_band(rec, "contrast_apply", wc, got_w[0][k], want_w[0][k])
                            same_band(rec, "contrast_apply", wc + " vs the whole",
                                      got_w[0][k], whole[k][r0:r1])
                        windows += 1
                # three windows a level, the inner ones starting on odd rows
                # (unaligned where the level's width is odd; levels of
                # fewer than 6 rows whole)
                cuts = [odd_bounds(m, 3) if m >= 6 else [0, m, m, m]
                        for m in (t.shape[-1] for t in b)]
                for i in range(3):
                    rows = [(cb[i], cb[i + 1]) if cb[2] < m else (0, m)
                            for cb, m in zip(cuts, (t.shape[-1] for t in b))]
                    cnrs = {}
                    for k in ka.nr_levels(c, False):
                        lo, hi = noise.cnr_rows(cn.shape[-1], b[k].shape[-1], *rows[k])
                        cnrs[k] = (cn[lo:hi], lo)
                    wb = [b[k][r0:r1] for k, (r0, r1) in enumerate(rows)]
                    ws = {k: sd[k][r0:r1] for k, (r0, r1) in enumerate(rows) if k in sd}
                    r0s = [r0 for r0, _ in rows]
                    got_w = ka.contrast_apply(wb, ws, mb, cnrs, c, r0s)
                    want_w = ka.contrast_apply_plain(wb, ws, mb, cnrs, c, r0s)
                    for k, (r0, r1) in enumerate(rows):
                        wc = f"{what}, odd window {i} of 3, level {k} rows [{r0}, {r1})"
                        same_band(rec, "contrast_apply", wc, got_w[0][k], want_w[0][k])
                        same_band(rec, "contrast_apply", wc + " vs the whole", got_w[0][k],
                                  whole[k][r0:r1])
                    windows += 1
            small = sum(t.numel() < ka.CHUNK_PX for t in bands)
            ragged = sum(t.numel() % ka.CHUNK_PX != 0 for t in bands)
            log(f"  KA at {n} {c.storage}: {len(cases)} input sets (the phantom's, adversarial, "
                f"random max bins, unaligned), with and without intermediates, bit for bit "
                f"({nans} NaN px in all); {windows} windows (1x4, 2x2 shards; odd rows) equal "
                f"their plain versions and the whole stage's rows; {small} of "
                f"{len(bands)} levels smaller than a chunk ({ka.CHUNK_PX} px), {ragged} "
                f"ending in part of one")


def normalize_images(rng):
    """[3i]'s integer images for KN: name -> [n, n] array."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        synthetic_radiograph)
    imgs = {f"{n} {a}": synthetic_radiograph(n, a)
            for n, a in ((SIZE, "thorax"), (600, "pelvis"), (144, "hand"), (512, "thorax"))}
    v = np.arange(65536, dtype=np.uint16)
    imgs["256 all 65,536 values"] = rng.permutation(v).reshape(256, 256)
    imgs["512 all values"] = rng.permutation(np.concatenate(
        [v, rng.integers(0, 65536, 512 * 512 - 65536).astype(np.uint16)])).reshape(512, 512)
    imgs["512 constant"] = np.full((512, 512), 5000, np.uint16)
    imgs["600 constant"] = np.full((600, 600), 5000, np.uint16)
    imgs["512 zero"] = np.zeros((512, 512), np.uint16)
    imgs["75 random (a ragged tail)"] = rng.integers(0, 65536, (75, 75)).astype(np.uint16)
    imgs["600 int32 in [0, 2^31)"] = rng.integers(0, 2 ** 31, (600, 600)).astype(np.int32)
    imgs["600 int32, negative values"] = rng.integers(-2 ** 31, 2 ** 31,
                                                      (600, 600)).astype(np.int32)
    imgs[f"{SIZE} thorax as int32"] = imgs[f"{SIZE} thorax"].astype(np.int32)
    return imgs


def check_normalize_curve(rec, rng, dev, variants):
    """[3i]: KN (``normalize.normalize_from_u16`` on the card: the extrema
    pass, then the apply pass) against ``normalize_from_u16_plain`` on the
    card, bit for bit with equal NaN masks (the image, vmax and vmin), with
    quirks on and off: the phantoms at 3072, 600, 144 and 512 (where the
    quirks' reduce chain is aligned, so vmin is trunc(sqrt(min))), all
    65,536 uint16 values, constant and all-zero images, a ragged size, int32
    images (conversions that round, negative values), an input whose base is
    not 16-byte aligned (the pixel-a-thread path), and every shard window of
    the 1x4 and 2x2 plans with the extrema reduced over the shards (also
    against the whole image's rows); the square root alone over all 65,536
    values (extrema 1 and 0 on an aligned width) against the float64 root
    rounded to float32 and NumPy's.  KG (``gradation.gradation_curve`` on
    the card) against ``gradation_curve_plain`` on the card and on the CPU,
    bit for bit (px, py, t0, ta, t1), on K3's histograms of every path at
    3072, 600 and 144, on ``testing/grad_cases.py`` and on 256 random
    histograms with negative bins."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import (
        gradation, normalize)
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import grad_cases
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        synthetic_radiograph)

    def same_norm(got, want, what):
        nan = 0
        for part, g, w in zip(("image", "vmax", "vmin"), got, want):
            nan += same_band(rec, "normalize", f"{what}, {part}", g.reshape(-1), w.reshape(-1))
        return nan

    nans, cases = 0, 0
    for name, img in normalize_images(rng).items():
        x = torch.from_numpy(img).to(dev)
        for quirks in (True, False):
            nans += same_norm(normalize.normalize_from_u16(x, quirks),
                              normalize.normalize_from_u16_plain(x, quirks),
                              f"{name}, quirks {quirks}")
            cases += 1
    # an input 2 bytes past a 16-byte boundary: the kernels' scalar path
    flat = torch.from_numpy(synthetic_radiograph(600, "pelvis")).reshape(-1).to(dev)
    buf = torch.empty(flat.numel() + 1, dtype=torch.uint16, device=dev)
    buf[1:] = flat
    x = buf[1:].view(600, 600)
    assert x.data_ptr() % 16 == 2
    for quirks in (True, False):
        nans += same_norm(normalize.normalize_from_u16(x, quirks),
                          normalize.normalize_from_u16_plain(x, quirks),
                          f"600 pelvis at an odd address, quirks {quirks}")
        cases += 1
    log(f"  KN: {cases} image cases, quirks on and off, bit for bit with equal NaN masks "
        f"({nans} NaN values in all)")

    # the root alone: extrema (1, 0) on a 512-wide window (the chain aligned),
    # quirks on: vmax 1, vmin 0, no clamp, so the output is sqrt(x)
    v = torch.from_numpy(np.arange(65536, dtype=np.uint16).reshape(128, 512)).to(dev)
    one, zero = torch.ones((), device=dev), torch.zeros((), device=dev)
    got = normalize.normalize_from_u16(v, True, extrema=(one, zero))[0]
    rec.equal_bits("normalize", "sqrt of all 65,536 values", got,
                   normalize._sqrt(v.to(torch.float32)))
    want = np.sqrt(np.arange(65536, dtype=np.float32)).reshape(128, 512)
    assert np.array_equal(got.cpu().numpy().view(np.int32), want.view(np.int32))
    log("  KN's root (__fsqrt_rn) over all 65,536 uint16 values: equal to the float64 root "
        "rounded to float32 and to NumPy's float32 sqrt, bit for bit")

    windows = 0
    for n, anatomy in ((SIZE, "thorax"), (600, "pelvis"), (144, "hand")):
        tile = 16 if n > 144 else 12
        c = MusicaConfig(image_size=n, histogram_area_size=tile)
        x = torch.from_numpy(synthetic_radiograph(n, anatomy)).to(dev)
        xf = x.to(torch.float32)
        for space in (4, 2):
            bounds = spatial.row_plan(n, space, c).bounds[0]
            parts = [normalize.extrema_partials(x[a:b]) for a, b in zip(bounds, bounds[1:])]
            q = torch.cat(parts)
            ext = torch.stack([q[:, 0].amax(), q[:, 1].amin()])
            assert torch.equal(ext, torch.stack([xf.amax(), xf.amin()])), (n, space)
            for quirks in (True, False):
                whole = normalize.normalize_from_u16(x, quirks)[0]
                for a, b in zip(bounds, bounds[1:]):
                    what = f"{n} {anatomy}, rows [{a}, {b}) of {space}, quirks {quirks}"
                    got = normalize.normalize_from_u16(x[a:b], quirks, extrema=(ext[0], ext[1]))
                    same_norm(got, normalize.normalize_from_u16_plain(
                        x[a:b], quirks, extrema=(ext[0], ext[1])), what)
                    same_band(rec, "normalize", what + " vs the whole", got[0], whole[a:b])
                    windows += 1
    log(f"  KN: {windows} shard windows (1x4, 2x2 at {SIZE}, 600, 144; quirks on and off) with "
        f"the extrema pass's partials all-reduced: equal to their plain versions and the whole "
        f"image's rows")

    def same_curve(got, want, what):
        for part, g, w in zip(("px", "py", "t0", "ta", "t1"), (*got[:2], *got[2]),
                              (*want[:2], *want[2])):
            rec.equal_bits("gradation_curve", f"{what}, {part}", g.reshape(-1).to(w.device),
                           w.reshape(-1))

    hists = {}
    for n, anatomy in ((SIZE, "thorax"), (600, "pelvis"), (144, "hand")):
        x = torch.from_numpy(synthetic_radiograph(n, anatomy)).to(dev)
        for name, c, fused in variants:
            res = musica.musica_forward(x, c.with_(image_size=n, quirks=n > 144),
                                        want_intermediates=True, fused_sdev=fused)
            hists[f"{n} {anatomy}, {name}"] = res["intermediates"]["grad_hist"]
    for name, (h, _) in grad_cases.cases().items():
        hists[name] = torch.from_numpy(h).to(dev)
    for k in range(256):
        peak, width = rng.integers(20, 1000), rng.uniform(20, 300)
        h = rng.gamma(2.0, 200.0, 1024) * np.exp(-((np.arange(1024) - peak) / width) ** 2)
        h = (h.astype(np.int64) * 100).astype(np.int32)
        h[rng.integers(0, 1024, rng.integers(0, 4))] = -rng.integers(1, 2 ** 31 - 1)
        hists[f"random {k}"] = torch.from_numpy(h).to(dev)
    cfg = MusicaConfig(image_size=SIZE)
    for name, h in hists.items():
        got = gradation.gradation_curve(h, cfg)
        same_curve(got, gradation.gradation_curve_plain(h, cfg), name)
        same_curve(got, gradation.gradation_curve_plain(h.cpu(), cfg), name + ", the CPU's")
    log(f"  KG: {len(hists)} histograms (K3's of {len(variants)} paths at {SIZE}, 600, 144; "
        f"{len(grad_cases.cases())} adversarial; 256 random with negative bins) bit for bit "
        f"against the plain version on the card and on the CPU")


def covered(c, space):
    """Shards of a ``space``-way plan that hold rows inside some analysis
    level's histogram coverage (K1 launches on those alone)."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import stats
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    plan = spatial.row_plan(c.image_size, space, c)
    return sum(any(plan_rows(plan, k, i)[0] < min(plan_rows(plan, k, i)[1],
                                                  stats.coverage(plan.sizes[k], c))
                   for k in c.analysis_levels) for i in range(space))


def host_ms(fn, reps=3):
    """(median, runs): ms of ``fn()`` on the host clock, each run between
    two synchronisations of the card."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2], times


def spatial_launches(c, fused, s, b):
    """Each kernel's launches on the spatial path for b images over ``s``
    shards."""
    # on every shard at each of the plan's R sharded levels, the down step
    # and a band, and an expand step on the way back; each entry's coarse
    # levels (whole on every entry) a fused step and an expand step above
    # the tails' cut, and one ladder tail and one expand tail below it
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import pyramid as kp
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    plan = spatial.row_plan(c.image_size, s, c)
    coarse = plan.sizes[plan.replicated:c.pyramid_levels]
    big = sum(h > kp.TAIL_CUT for h in coarse)
    pyr = {"pyramid_down": b * s * (plan.replicated + big),
           "pyramid_up": b * s * (2 * plan.replicated + big),
           "pyramid_tail": 2 * b * s * (big < len(coarse))}
    # KT and KA on every shard's rows; KS every level's sdev rows of a shard
    pyr["tone_map"] = pyr["contrast_apply"] = b * s
    # KN's two passes and KG on every shard
    pyr["normalize"], pyr["gradation_curve"] = 2 * b * s, b * s
    if fused:
        return {"sdev_noise_hist": b * s, "hist_argmax": b, "grad_hist_relevant": b * s, **pyr}
    want = {"noise_hist": b * covered(c, s), "hist_argmax": b, "sdev": b * s, **pyr}
    # K3 where the CNR scale divides the tile and the tile divides n, else K4
    scale = -(-c.image_size // plan.sizes[c.cnr_level])
    tile = c.histogram_area_size
    fused_relevance = tile % scale == 0 and c.image_size % tile == 0
    want["grad_hist_relevant" if fused_relevance else "grad_hist"] = b * s
    if c.enable_clahe:
        # KH per shard, KC on every entry after the all-reduce, K5 per shard
        want.update({"clahe_hist": b * s, "clahe_curves": b * s, "clahe_apply": b * s})
    return want


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def assert_same(got, want, what, dev):
    """Every tensor of ``got`` equal to ``want``'s on ``dev``, bit for bit
    (NaN where it has NaN)."""
    import torch
    for k, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g.to(dev), w.to(dev), rtol=0, atol=0, equal_nan=True,
                                   msg=f"{what}: output {k}")


def first_graph_call(run, key, rows, dev):
    """The spatial graphs' first call (warm-up, capture, replays) after an
    eager run filled the allocator's cache: (result, seconds, MB more
    reserved on ``dev``, the ``rows`` new graphs)."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import graphs
    torch.cuda.synchronize()
    reserved, before = torch.cuda.memory_reserved(dev), graphs.capture_count()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    grown = (torch.cuda.memory_reserved(dev) - reserved) / 2 ** 20
    assert graphs.capture_count() == before + rows, f"{key}: {rows} captures expected"
    new = graphs.cached_graphs()[-rows:]
    assert all(isinstance(g, graphs.SpatialGraph) for g in new), key
    return got, sec, grown, new


def spatial_variants(cfg, cfg_var, cfg16):
    """[4n]'s variants: (name, cfg, fused_sdev, outputs)."""
    return (("main", cfg, False, ("out_u8",)),
            ("CLAHE + linear", cfg_var, False, ("out_u8", "clahe_graded")),
            ("fused-sdev", cfg, True, ("out_u8",)),
            ("bf16", cfg16, False, ("out_u8", "recon")))


def check_spatial(imgs, cfg, dev, imgs600, cfg_var, cfg16):
    """[4n]: ``process_sharded`` of ``imgs`` over a 1 x 4 and a 2 x 2 mesh
    of entries on ``dev`` (each with a stream of its own), each image a
    replay of its mesh row's captured graph (``graphs.SpatialGraph``; one
    graph a row on one card), in the main path, the CLAHE + linear variant
    ``cfg_var``, fused-sdev and bf16 storage ``cfg16``: every output bit
    for bit against the eager spatial path (``process_sharded_eager``),
    ``out_u8`` against ``process_batch_jit`` and ``clahe_graded`` against
    the unsharded ``musica_forward``'s; with every count set to 0 just
    before a run and read just after (the 1 x 4 run under the profiler, its
    kernel events equal to the counts, and each kernel's device ms per
    launch inside the replay): K1 once per shard that holds covered rows,
    K2 once per image, K3 once per shard (CLAHE: K3, KH and K5 per shard,
    KC per entry; fused-sdev: K7 and K3 per shard); a second call captures
    nothing.
    Then ``imgs600`` over 1 x 4 (K4), and where two or more cards are
    visible one image over ``n_space`` = every card (the graph cut into
    segments at the exchanges between cards; a 512^2 image of each variant
    too).  Times (host clock around a run that ends with the card's
    synchronisation, medians of 3): the replays and the eager spatial path
    per image, beside one card's unsharded replay of the same variant (CUDA
    events); each graph's first call in seconds and the growth of
    ``torch.cuda.memory_reserved`` over it after an eager run filled the
    allocator's cache (its private pools)."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import graphs, musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding

    out = {"counts": {}, "ms_per_img": {}, "eager_ms_per_img": {}, "replay_ms": {},
           "capture": {}, "window_ms": {}}
    b = len(imgs)
    x_imgs = torch.from_numpy(imgs).to(dev)
    variants = spatial_variants(cfg, cfg_var, cfg16)
    for name, c, fused, names in variants:
        want = musica.process_batch_jit(x_imgs, c, fused)
        whole = [musica.musica_forward(x, c, fused_sdev=fused) for x in x_imgs]
        x0 = x_imgs[0]
        out["replay_ms"][name] = cuda_ms(lambda c=c, fused=fused: musica.process_jit(x0, c, fused),
                                         10, 2)
        for d, s in ((1, 4), (2, 2)):
            mesh = sharding.make_mesh(n_data=d, n_space=s, devices=[dev] * 4)
            key = f"{name}, {d}x{s} on {dev}"

            def run(mesh=mesh, c=c, fused=fused, names=names):
                return as_tuple(sharding.process_sharded(imgs, c, mesh, outputs=names,
                                                    fused_sdev=fused))

            def eager(mesh=mesh, c=c, fused=fused, names=names):
                return as_tuple(sharding.process_sharded_eager(imgs, c, mesh, outputs=names,
                                                          fused_sdev=fused))
            want_e = eager()  # the entries' streams and their allocator caches
            first, first_s, grown, new = first_graph_call(run, key, d, dev)
            assert all(g.segments == 1 for g in new), f"{key}: one graph a row on one card"
            captures = graphs.capture_count()
            if (d, s) == (1, 4):
                times = {}
                got, counts = profiled_run(run, f"spatial {key}", times)
                out["window_ms"][name] = times
            else:
                torch.cuda.synchronize()
                launch.reset_launch_counts()
                got = run()
                torch.cuda.synchronize()
                counts = dict(launch.LAUNCHES)
            assert graphs.capture_count() == captures, f"{key}: a second call captured"
            assert_same(first, want_e, f"spatial {key}: first call against eager", dev)
            assert_same(got, want_e, f"spatial {key}: replay against eager", dev)
            assert torch.equal(got[0].to(dev), want), f"spatial {key} differs from process_batch_jit"
            for k, nm in enumerate(names[1:], 1):
                assert_same(list(got[k]), [r[nm] for r in whole], f"spatial {key}: {nm}",
                            dev)
            exp = spatial_launches(c, fused, s, b)
            assert counts == {k: exp.get(k, 0) for k in counts}, (key, counts, exp)
            med, runs = host_ms(run)
            med_e, runs_e = host_ms(eager)
            out["counts"][key] = counts
            out["ms_per_img"][key] = med / b
            out["eager_ms_per_img"][key] = med_e / b
            # the first call: a warm-up of one image, the capture, b replays
            capture_s = first_s - (med_e / b + med) / 1e3
            out["capture"][key] = {"first_call_s": first_s, "capture_s_about": capture_s,
                                   "pool_mb": grown, "graphs": d}
            log(f"  {key}: {b} x {c.image_size}^2, replays equal the eager spatial path "
                f"({', '.join(names)}) and process_batch_jit bit for bit"
                + (" (clahe_graded equal the unsharded forward's, NaN tiles too)"
                   if "clahe_graded" in names else "")
                + f"; launches {counts} (K1: {covered(c, s)} of {s} shards hold covered rows)"
                + (" = the profiler's kernel events" if (d, s) == (1, 4) else "")
                + f"; {d} graph(s) of 1 segment, first call {first_s:.3f} s (capture ~"
                f"{capture_s:.3f} s), +{grown:.1f} MB reserved; replay {med / b} ms/img "
                f"(ms: {runs}) against eager {med_e / b} ms/img (ms: {runs_e}) and one "
                f"card's unsharded replay {out['replay_ms'][name]} ms/img (CUDA events)")
        log(f"  {name}: each hand-written kernel's device ms per launch inside the 1x4 "
            f"replay: {out['window_ms'][name]}")
    c600 = cfg.with_(image_size=imgs600.shape[-1])
    mesh = sharding.make_mesh(n_data=1, n_space=4, devices=[dev] * 4)
    want_e = sharding.process_sharded_eager(imgs600, c600, mesh)
    sharding.process_sharded(imgs600, c600, mesh)
    torch.cuda.synchronize()
    launch.reset_launch_counts()
    got = sharding.process_sharded(imgs600, c600, mesh)
    torch.cuda.synchronize()
    counts = dict(launch.LAUNCHES)
    want600 = musica.process_batch_jit(torch.from_numpy(imgs600).to(dev), c600)
    assert torch.equal(got.to(dev), want600), "spatial 600 differs from process_batch_jit"
    assert torch.equal(got, want_e), "spatial 600 replay differs from eager"
    b6 = len(imgs600)
    assert (counts["grad_hist"], counts["hist_argmax"], counts["grad_hist_relevant"]) == (
        b6 * 4, b6, 0), counts
    out["counts"]["600 1x4"] = counts
    log(f"  {b6} x 600^2 over 1x4 on {dev}: replays equal eager and process_batch_jit; "
        f"launches {counts} (K4 once a shard: 600 is no multiple of the 16-px tile)")
    if torch.cuda.device_count() > 1:
        check_spatial_cards(imgs, cfg, dev, variants, out)
    else:
        log("  one image over every card: skipped, one card visible")
    return out


def check_spatial_cards(imgs, cfg, dev, variants, out):
    """[4n] over every visible card: one 3072^2 image over ``n_space`` =
    every card, replays of its graph's segments (cut at the exchanges
    between cards) against the eager spatial path and
    ``process_batch_jit`` bit for bit, launches against the profiler's
    kernel events, segments, copies, first-call seconds and ms/img beside
    eager; then a 512^2 image of each variant in ``variants[1:]``.  Adds
    its numbers to ``out``."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        synthetic_radiograph)
    cards = torch.cuda.device_count()
    x_imgs = torch.from_numpy(imgs).to(dev)
    want = musica.process_batch_jit(x_imgs, cfg)
    mesh = sharding.make_mesh(n_data=1, n_space=cards)
    key = f"1x{cards} over {cards} cards"
    run = lambda: sharding.process_sharded(imgs[:1], cfg, mesh)  # noqa: E731
    eager = lambda: sharding.process_sharded_eager(imgs[:1], cfg, mesh)  # noqa: E731
    want_e = eager()
    first, first_s, grown, (g,) = first_graph_call(run, key, 1, dev)
    assert g.segments > cards and len(g.devices) == cards, (g.segments, g.devices)
    copies = sum(step[0] == "copy" for step in g.steps)
    got, counts = profiled_run(run, f"spatial {key}")
    assert torch.equal(got, want_e) and torch.equal(first, want_e), f"{key}: against eager"
    assert torch.equal(got.to(dev), want[:1]), f"{key}: against process_batch_jit"
    exp = spatial_launches(cfg, False, cards, 1)
    assert counts == {k: exp.get(k, 0) for k in counts}, (key, counts, exp)
    med, runs = host_ms(run)
    med_e, runs_e = host_ms(eager)
    out["counts"][key] = counts
    out["ms_per_img"][key] = med
    out["eager_ms_per_img"][key] = med_e
    out["capture"][key] = {"first_call_s": first_s, "segments": g.segments,
                           "copies": copies, "pool_mb_on_first_card": grown}
    log(f"  one 3072^2 image over n_space = {cards} cards: the replay of {g.segments} "
        f"segments and {copies} copies between cards equals eager and process_batch_jit "
        f"bit for bit; launches {counts} = the profiler's kernel events; first call "
        f"{first_s:.3f} s, +{grown:.1f} MB reserved on {dev}; replay {med} ms/img (ms: "
        f"{runs}) against eager {med_e} ms/img (ms: {runs_e})")
    im512 = synthetic_radiograph(512, "thorax")
    for name, c, fused, names in variants[1:]:
        c = c.with_(image_size=512)
        got = as_tuple(sharding.process_sharded(im512[None], c, mesh, outputs=names,
                                           fused_sdev=fused))
        got_e = as_tuple(sharding.process_sharded_eager(im512[None], c, mesh, outputs=names,
                                                   fused_sdev=fused))
        r = musica.musica_forward(torch.from_numpy(im512).to(dev), c, fused_sdev=fused)
        assert_same(got, got_e, f"{name} over {cards} cards against eager", dev)
        assert_same([g[0] for g in got], [r[k] for k in names], f"{name} over {cards} cards",
                    dev)
        log(f"  {name}: one 512^2 image over n_space = {cards} cards, replayed, equals "
            f"eager and the unsharded forward ({', '.join(names)})")


def spatial_over_cards() -> int:
    """``python3 chip_smoke.py --spatial-over-cards``: [4n]'s part over
    every visible card alone (``check_spatial_cards``), for a call on
    several cards; each card's name and power limit, then the numbers as
    one JSON line.  Exits 1 with fewer than two cards."""
    import torch
    if torch.cuda.device_count() < 2:
        print("chip_smoke: --spatial-over-cards needs two or more CUDA devices", file=sys.stderr)
        return 1
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        synthetic_radiograph)
    t0 = time.perf_counter()
    launch.lib()
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True, timeout=60).stdout.splitlines():
        log(f"  card: {line}")
    cfg = MusicaConfig(image_size=SIZE)
    variants = spatial_variants(cfg, cfg.with_(enable_clahe=True, grad_with_linear_image=True),
                                cfg.with_(storage="bfloat16"))
    imgs = np.stack([synthetic_radiograph(SIZE, a) for a in ("thorax", "pelvis")])
    out = {"counts": {}, "ms_per_img": {}, "eager_ms_per_img": {}, "capture": {}}
    log(f"[4n] the spatial path over {torch.cuda.device_count()} cards as replays of a "
        f"segmented graph, against the eager spatial path and process_batch_jit")
    check_spatial_cards(imgs, cfg, torch.device("cuda:0"), variants, out)
    log(json.dumps(out))
    return 0


def bound(n_bytes: float, flops: float = 0.0, rate: float = FP32_PER_S):
    """(ms, "bytes" or "operations"): the least time for the work."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sector_bytes(mask) -> int:
    """Bytes of the 32-byte sectors of a contiguous float32 [n, n] image that
    hold a pixel of the boolean ``mask``: the least a read of those pixels
    moves from memory."""
    import torch
    import torch.nn.functional as F
    flat = mask.reshape(-1).to(torch.uint8)
    flat = F.pad(flat, (0, -flat.numel() % SECTOR_PX))
    return 4 * SECTOR_PX * int(flat.reshape(-1, SECTOR_PX).amax(-1).sum())


def noise_scan(sd, cfg):
    """(read, groups, broken, short) of a noise histogram's scan of the
    level ``sd`` [n, n]: the boolean mask of the pixels read (each 16-px
    group of the coverage up to and including its first break: 0.0,
    adjusted > 1 or bin 0; pixels past n are not in memory), and, over the
    groups that start in memory, their number, the number that break and
    the number that break in their first 8 px (their second sector is not
    needed)."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import (
        f32, stats)
    n, tile = sd.shape[-1], cfg.histogram_area_size
    read = torch.zeros((n, n), dtype=torch.bool, device=sd.device)
    v = stats.coverage_view(sd, cfg)
    if v is None:
        return read, 0, 0, 0
    cov = v.shape[-1]
    adjusted = v / f32(cfg.max_noise_value, v)
    bins = (adjusted * float(cfg.noise_histogram_bins) + 0.5).to(torch.int32)
    brk = ((v == 0.0) | (adjusted > 1.0) | (bins == 0)).to(torch.int32)
    brk = brk.reshape(cov, cov // tile, tile)
    before = torch.cumsum(brk, -1) - brk
    m = min(n, cov)
    read[:m, :m] = (before == 0).reshape(cov, cov)[:m, :m]
    live = brk[:m, :-(-m // tile)]
    broken = live.amax(-1)
    short = live[..., :SECTOR_PX].amax(-1)
    return read, broken.numel(), int(broken.sum()), int(short.sum())


def grad_scan(recon, cfg):
    """(loaded, counted) boolean [n, n] masks of a gradation histogram's scan
    of ``recon``: the pixels read (each 16x16 tile in the GLSL order up to
    and including its first 0.0; pixels past n are not in memory) and those
    added (before the first 0.0, bin in range)."""
    import torch
    import torch.nn.functional as F
    n, tile = recon.shape[-1], cfg.histogram_area_size
    cov = -(-n // tile) * tile
    t = cov // tile
    v = F.pad(recon, (0, cov - n, 0, cov - n))
    z = (v == 0.0).reshape(t, tile, t, tile).permute(0, 2, 1, 3).reshape(t, t, -1).to(torch.int32)
    before = torch.cumsum(z, -1) - z

    def back(m):
        return m.reshape(t, t, tile, tile).permute(0, 2, 1, 3).reshape(cov, cov)[:n, :n]

    loaded = back(before == 0)
    b = (recon * float(cfg.grad_histogram_bins)).to(torch.int32)
    counted = loaded & (recon != 0.0) & (b >= 0) & (b < cfg.grad_histogram_bins)
    return loaded, counted


def fp64_sass_lengths():
    """FP64 instructions of ``__ddiv_rn(x, 25.0)``, ``__dsqrt_rn(x)`` and
    KS's tail (csrc/sdev_noise.cu::sdev_tail: the division, square root and
    rounding to float32 that replace them) as this toolkit compiles them for
    sm_90a: one probe kernel each, built with the kernels' flags,
    ``cuobjdump -sass``, counting the float64 instructions (D*, MUFU.*64H,
    F2F to or from F64) from the function's start to its first EXIT (the
    fast path; the slow-path subroutine placed after it runs only for
    special operands)."""
    import re
    from pathlib import Path
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import build
    src = ('extern "C" __global__ void probe_ddiv(const double* a, double* o) '
           '{ o[threadIdx.x] = __ddiv_rn(a[threadIdx.x], 25.0); }\n'
           'extern "C" __global__ void probe_dsqrt(const double* a, double* o) '
           '{ o[threadIdx.x] = __dsqrt_rn(a[threadIdx.x]); }\n'
           '#include "sdev_noise.cu"\n'
           'extern "C" __global__ void probe_tail(const double* a, float* o) '
           '{ bool slow; o[threadIdx.x] = sdev_tail(a[threadIdx.x], &slow); }\n')
    nvcc = build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        cu, cubin = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.cubin")
        with open(cu, "w") as f:
            f.write(src)
        subprocess.run([nvcc, *build.ARCH, "-O3", "-fmad=false", "-I", str(build.SRC_DIR),
                        "-cubin", "-o", cubin, cu], check=True, capture_output=True, timeout=120)
        sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", cubin],
                              check=True, capture_output=True, text=True, timeout=60).stdout
    fp64 = re.compile(r"^(?!DEPBAR)(D[A-Z]+|MUFU\.\w*64H|F2F\.F64\.\w+|F2F\.\w+\.F64)")
    out, name, done = {}, None, False
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name, done = m.group(1), False
            out[name] = 0
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name is None or done or not m:
            continue
        if m.group(1) == "EXIT":
            done = True
        elif fp64.match(m.group(1)):
            out[name] += 1
    return out["probe_ddiv"], out["probe_dsqrt"], out["probe_tail"]


def fp64_rate():
    """(float64 instructions a second, SMs, MHz): 64 a clock on every SM at
    the card's largest SM clock."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return FP64_PER_SM_CLOCK * sms * mhz * 1e6, sms, mhz


def pyramid_work(sizes, tail_from=None):
    """(bytes, float64 instructions) of the pyramid kernels on a ladder whose
    levels are ``sizes`` px square (level 0 first): each input read once
    and each output written once, and the float64 products and sums of the
    plain path's stencils (the down step: 9 a vertical sum at each even row
    and every column, 9 a horizontal sum at each output; the expand: 5 or 3
    a vertical phase at each output row and small column, 5 or 3 a
    horizontal phase at each output, 4 on average).  Keys: ``down``
    (the down step alone), ``step`` (the fused step: cur read, the band and
    the down written), ``up`` (mode 0), ``subtract`` and ``add`` (cur or the
    band read too), all at level 0; ``ladder`` (a fused step's bytes at
    every level: each level read, its band and down written) and ``expand``
    (an expand step's at every level: the small image and the band read,
    the result written); ``tail`` and ``expand_tail``: the tails from level
    ``tail_from`` on (the first level read, each band and down written; the
    top and each band read, the result written)."""
    def down(h):
        dh = -(-h // 2)
        return 4 * h * h + 4 * dh * dh, 9 * dh * h + 9 * dh * dh

    def up(h, reads):
        src = -(-h // 2)
        return 4 * src * src + 4 * h * h * (1 + reads), 4 * h * src + 4 * h * h

    def step(h):
        return 4 * h * h + down(h)[0], down(h)[1] + up(h, 1)[1]

    def total(works):
        return tuple(sum(w[i] for w in works) for i in (0, 1))
    n = sizes[0]
    out = {"down": down(n), "step": step(n), "up": up(n, 0), "subtract": up(n, 1),
           "add": up(n, 1), "ladder": total([step(h) for h in sizes]),
           "expand": total([up(h, 1) for h in sizes])}
    if tail_from is not None:
        tail = sizes[tail_from:]
        s0, top = tail[0], -(-tail[-1] // 2)
        ops = total([step(h) for h in tail])[1]
        out["tail"] = (4 * s0 * s0 + sum(4 * h * h + 4 * (-(-h // 2)) ** 2 for h in tail), ops)
        out["expand_tail"] = (4 * top * top + sum(4 * h * h for h in tail) + 4 * s0 * s0,
                              total([up(h, 1) for h in tail])[1])
    return out


def contrast_bound(bands, sdevs, max_bins, cnr, c):
    """KA's least time at these inputs (ms, "bytes" or "operations"): each
    band read and the band the expand reads written once, each analysis
    level's sdev, the CNR map and the max bins read once; per pixel 10
    float32 operations with an sdev (6 search steps, the lerp's 3, the gain),
    1 without, 5 more where the noise reduction runs."""
    px = [b.numel() for b in bands]
    n_bytes = (sum(2 * b.numel() * b.element_size() for b in bands)
               + sum(4 * s.numel() for s in sdevs.values()) + 4 * cnr.numel()
               + 4 * len(max_bins))
    ops = (sum(10 * p if k in sdevs else p for k, p in enumerate(px))
           + 5 * sum(px[:c.cnr_level - 1]))
    return bound(n_bytes, ops)


def clahe_hist_bound(recon, nrm, cnr, c):
    """KH's least time at these inputs (ms, "bytes" or "operations"): recon
    read where a pixel is relevant, normalized where a pixel inside the
    border lies in a solid block (32-byte sectors), the CNR map read, the
    histogram written; a product and a sum a relevant pixel."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import noise
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    n = recon.shape[-1]
    scale = -(-n // cnr.shape[-1])
    weights = fh.relevance_weight_plane(cnr, c).repeat_interleave(scale, 0) \
        .repeat_interleave(scale, 1)[:n, :n]
    xs = torch.arange(n, device=recon.device)
    inner = (xs > c.relevant_border) & (xs < n - c.relevant_border)
    need_norm = (weights == -1) & inner[:, None] & inner[None, :]
    need_recon = noise.img_relevant(nrm, cnr, c) == 1.0
    hist_bytes = 4 * c.clahe_tiles ** 2 * c.clahe_bins
    return bound(sector_bytes(need_recon) + sector_bytes(need_norm) + 4 * cnr.numel()
                 + hist_bytes, 2 * int(need_recon.sum()))


def build_parent(root):
    """Start building KA's and KH's C entries from another checkout's
    sources (each .cu with the headers beside it, one ``nvcc -shared``
    each, started together) for [6]'s before and after; returns a function
    that waits and gives {kernel: the loaded library}."""
    import ctypes
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import build
    csrc = os.path.join(root, PKG, "csrc")
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "parent_kernels")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, fn in (("contrast_apply", "musica_contrast_apply"),
                     ("clahe_hist", "musica_clahe_hist")):
        so = os.path.join(out, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", so,
             os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so, fn)

    def wait():
        libs = {}
        for name, (proc, so, fn) in procs.items():
            text = proc.communicate()[0]
            assert proc.returncode == 0, f"the parent's {name}.cu did not build:\n{text}"
            lib = ctypes.CDLL(so)
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = build._SIGNATURES[fn]
            libs[name] = lib
        return libs
    return wait


def parent_turns(launch, lib, fn, rounds=2):
    """ms of ``fn`` (device time, 20 calls) with the parent's library in
    place of this one's and with this one's, in turns: parent, this, this,
    parent, ``rounds`` times; returns (parent ms, this ms), each in run
    order."""
    real = launch.lib
    parent, this = [], []
    for _ in range(rounds):
        for which in ("parent", "this", "this", "parent"):
            launch.lib = (lambda: lib) if which == "parent" else real
            try:
                (parent if which == "parent" else this).append(
                    cuda_ms(fn, 20, 2, device_only=True))
            finally:
                launch.lib = real
    return parent, this


def kernel_events(fn) -> int:
    """The CUDA kernels one call of ``fn`` launches (the profiler's kernel
    events; copies and fills of memory not counted).  Each record begins
    with PAD_KERNELS spin kernels, as in ``profiled_run``: the profiler may
    drop the first events of a record, and a record counts only if it kept
    one of them (it once kept none before KA's plain chain).  The call is
    recorded until two counted records agree, at most five times; the
    check fails if none do."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    counts = []
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD_KERNELS):
                torch.cuda._sleep(20_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith(("Memcpy", "Memset"))]
        pad = sum("spin_kernel" in n for n in names)
        if pad < PAD_KERNELS:
            log(f"  kernel_events: the profiler recorded {pad} of the {PAD_KERNELS} spin "
                f"kernels before the call{'; the record is not counted' if not pad else ''}")
        if not pad:
            continue
        counts.append(len(names) - pad)
        agreed = [c for c in counts if counts.count(c) > 1]
        if agreed:
            return agreed[0]
        if len(counts) > 1:
            log(f"  kernel_events: records of one call counted {counts} kernels")
    raise AssertionError(f"kernel_events: no two of five records of one call agreed "
                         f"(counted: {counts})")


def kernel_bounds(cfg, lv3072, recon, cnr, linear, v_recon, v_joint, nb, v_px, b3072, gpx):
    """Per kernel (ms, "bytes" or "operations"): the bound at this run's
    main-path inputs (``gpx``: the tone map's curve).  Where a scan stops
    early (K1, K3, K4) only the 32-byte sectors holding a pixel that the
    reference's scan reaches count."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    L, nbn, gb = len(lv3072), cfg.noise_histogram_bins, cfg.grad_histogram_bins
    out = {}
    # K1: each level's pixels up to and including each group's first break
    # (a division, a product and a sum each), the histograms written
    scans = [noise_scan(s, cfg) for s in lv3072]
    px = sum(int(r.sum()) for r, *_ in scans)
    out["noise_hist"] = bound(sum(sector_bytes(r) for r, *_ in scans) + 4 * L * nbn, 3 * px)
    groups, broken, short = (sum(s[i] for s in scans) for i in (1, 2, 3))
    log(f"  K1's scan of the main path's levels: {broken} of {groups} 16-px groups "
        f"break, {short} in their first {SECTOR_PX} px; {px} of "
        f"{sum(s.numel() for s in lv3072)} px read")
    out["hist_argmax"] = bound(4 * L * nbn + 4 * L)
    # K3: recon up to each tile's first 0.0, normalized where a counted pixel
    # lies in a solid block inside the border, the CNR map, the histogram
    n = recon.shape[-1]
    loaded, counted = grad_scan(recon, cfg)
    scale = -(-n // cnr.shape[-1])
    wp = fh.relevance_weight_plane(cnr, cfg).repeat_interleave(scale, 0) \
        .repeat_interleave(scale, 1)[:n, :n]
    xs = torch.arange(n, device=recon.device)
    inner = (xs > cfg.relevant_border) & (xs < n - cfg.relevant_border)
    need_norm = counted & (wp == -1) & inner[:, None] & inner[None, :]
    out["grad_hist_relevant"] = bound(sector_bytes(loaded) + sector_bytes(need_norm)
                                      + 4 * cnr.numel() + 4 * gb)
    # K4 (the CLAHE + linear path's squared image): recon up to each tile's
    # first 0.0, the relevance image where a pixel is counted
    loaded, counted = grad_scan(linear, cfg)
    out["grad_hist"] = bound(sector_bytes(loaded) + sector_bytes(counted) + 4 * gb)
    # K6: the int32 (bin, weight) pairs; K5: recon in, the graded image out,
    # the LUTs, ~20 float32 operations a pixel
    out["histogram"] = bound(8 * v_joint.numel() + 4 * nb)
    m = v_recon.numel()
    out["clahe_apply"] = bound(8 * m + 2 * 4 * v_px.numel(), 20 * m)
    # K7: the bands in, the sdev out; per pixel 8 float64 additions, the
    # square's conversion to float64, and the tail (the division, the square
    # root and the rounding to float32) as long as its SASS, at 64 float64
    # instructions per SM per clock
    px7 = sum(b.numel() for b in b3072)
    n_div, n_sqrt, n_tail = fp64_sass_lengths()
    per_px = 8 + 1 + n_tail
    rate64, sms, mhz = fp64_rate()
    t_bytes = (8 * px7 + 4 * L * nbn) / HBM_BYTES_PER_S * 1e3
    t_fp64 = px7 * per_px / rate64 * 1e3
    log(f"  K7's bound: bytes {t_bytes} ms ({8 * px7 + 4 * L * nbn} B); float64 issue {t_fp64} "
        f"ms ({per_px} FP64 instructions a pixel: 8 additions, a conversion, the tail's "
        f"{n_tail} in its SASS, where __ddiv_rn's {n_div}, __dsqrt_rn's {n_sqrt} and a "
        f"conversion were; {px7} px at 64 a clock on {sms} SMs at {mhz:.0f} MHz)")
    out["sdev_noise_hist"] = (max(t_bytes, t_fp64), "bytes" if t_bytes >= t_fp64 else "operations")
    # KS: K7's without the histograms
    t_bytes_s = 8 * px7 / HBM_BYTES_PER_S * 1e3
    log(f"  KS's bound: bytes {t_bytes_s} ms ({8 * px7} B); float64 issue {t_fp64} ms")
    out["sdev"] = (max(t_bytes_s, t_fp64), "bytes" if t_bytes_s >= t_fp64 else "operations")
    # KT: recon in and graded out (4 bytes each a pixel), the cropped u8 out;
    # per pixel two float32 compares an interval, the nonfinite test, the
    # lerp's three operations and the quantization's product, trunc and
    # clamp (two)
    k, m = gpx.shape[0], cfg.out_margin
    n = recon.shape[-1]
    tone_bytes = 8 * n * n + (n - 2 * m) ** 2
    out["tone_map"] = bound(tone_bytes, (2 * k + 7) * n * n)
    log(f"  KT's bound: {tone_bytes} B, {(2 * k + 7) * n * n} float32 operations ({k} points)")
    # KP1 (the down step alone) and KP2 (mode 0) at level 0, the rows' own
    # functions; the ladder's tail from the cut (the fused step's, the
    # ladder's and the expand's sums in pyramid_work, logged in [6])
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import pyramid as kp
    sizes = [-(-recon.shape[-1] // 2 ** k) for k in range(cfg.pyramid_levels)]
    work = pyramid_work(sizes, next(i for i, h in enumerate(sizes) if h <= kp.TAIL_CUT))
    out["pyramid_down"] = bound(*work["down"], rate=rate64)
    out["pyramid_up"] = bound(*work["up"], rate=rate64)
    out["pyramid_tail"] = bound(*work["tail"], rate=rate64)
    return out


def check_host_surface(img, cfg, dev):
    """[4j]: ``cli process --save-last-raw --cnr-out`` and ``cli report`` in
    this process (launches counted), ``cli process`` with ``--profile`` too
    in a process of its own, as a user runs it, so that the profiler's
    tracing cannot touch this process's later timings.  Returns the BMP's
    pixels."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import cli
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.utils import debug
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.utils import io as uio
    n = cfg.image_size
    log(f"[4j] the host surface at {n}: `cli process --save-last-raw --cnr-out --profile` "
        f"and `cli report` on the {n}^2 raw")
    img_t = np.ascontiguousarray(img.T)  # the CLI loads the raw transposed
    want_t = musica.musica_forward(torch.from_numpy(img_t).to(dev), cfg)
    want_out, want_cnr = want_t["out_u8"].cpu().numpy(), want_t["cnr"].cpu().numpy()
    common = ["--size", str(n), "--device", str(dev)]
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "in.raw")
        uio.save_raw(raw, img)
        paths = {k: os.path.join(tmp, k) for k in ("out.bmp", "last.raw", "cnr.bmp", "rep")}
        launch.reset_launch_counts()
        assert cli.main(["process", *common, "--save-last-raw", paths["last.raw"],
                         "--cnr-out", paths["cnr.bmp"], raw, paths["out.bmp"]]) == 0
        launches_cli = dict(launch.LAUNCHES)
        rc, launches_rep = profiled_run(lambda: cli.main(["report", *common, raw, paths["rep"]]),
                                        "cli report")
        assert rc == 0
        prof = os.path.join(tmp, "prof")
        args = ["process", *common, "--save-last-raw", prof + ".raw",
                "--cnr-out", prof + "_cnr.bmp", "--profile", prof, raw, prof + ".bmp"]
        r = subprocess.run([sys.executable, "-m", f"{PKG}.cli", *args], capture_output=True,
                           text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
        for a, b in ((prof + ".raw", paths["last.raw"]), (prof + "_cnr.bmp", paths["cnr.bmp"]),
                     (prof + ".bmp", paths["out.bmp"])):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f"--profile changed {os.path.basename(b)}"
        with open(os.path.join(prof, "trace.json")) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        spans = sorted(x for x in names if x.startswith("musica."))
        if dev.type == "cuda":
            for k in ("noise_hist_kernel", "grad_hist_kernel"):
                assert any(k in x for x in names), f"trace.json names no {k}"
        assert {f"musica.{p}" for p in ("normalize", "reduce", "analysis", "apply", "expand",
                                        "gradation", "tonemap")} <= set(spans), spans
        cli_bmp = uio.load_bmp(paths["out.bmp"])
        assert np.array_equal(cli_bmp, want_out), "cli process: BMP"
        with open(paths["last.raw"], "rb") as f:
            last = f.read()
        assert last == b"\x00" * uio.RAW_HEADER_BYTES + img_t.astype("<u2").tobytes(), \
            "--save-last-raw: not the loaded (transposed) raw"
        cnr_bmp = uio.load_bmp(paths["cnr.bmp"])
        assert np.array_equal(cnr_bmp, debug.cnr_u8(want_cnr)), "--cnr-out"
        rep = paths["rep"]
        assert os.path.exists(os.path.join(rep, "index.html"))
        assert np.array_equal(uio.load_bmp(os.path.join(rep, "out.bmp")), cli_bmp)
        assert np.array_equal(uio.load_bmp(os.path.join(rep, "cnr.bmp")), cnr_bmp)
        n_rep = len(os.listdir(rep))
    log(f"  process launches {launches_cli}; report launches {launches_rep}")
    if dev.type == "cuda":
        assert launches_cli["noise_hist"] == launches_cli["grad_hist_relevant"] == 1, launches_cli
        assert launches_rep["noise_hist"] == launches_rep["grad_hist"] == 1, launches_rep
        hist = {k: v for k, v in launches_rep.items()
                if not k.startswith("pyramid") and k not in ("sdev", "tone_map", "contrast_apply",
                                                             "normalize", "gradation_curve")}
        assert sum(hist.values()) == 2, launches_rep
        # KS: the analysis levels' sdev; KT: the tone map; KA: the contrast
        # stage; KG: the gradation curve; KN: two passes
        for counts in (launches_cli, launches_rep):
            assert counts["sdev"] == counts["tone_map"] == counts["contrast_apply"] == 1, counts
            assert counts["normalize"] == 2 and counts["gradation_curve"] == 1, counts
        # report runs with intermediates: the ladder (the fused step at
        # 3072 .. 96 px, one tail from 48 px), then an exp_lowpass and an
        # expand step at each of the 12 levels
        assert pyramid_counts(launches_rep) == (6, 24, 1), launches_rep
    log(f"  BMP equals musica_forward on the transposed raw; the re-saved raw is the loaded "
        f"(transposed) raw byte for byte; the CNR BMP equals clip(cnr x 255); with --profile "
        f"(its own process) the same three files, and trace.json names noise_hist_kernel, "
        f"grad_hist_kernel and {spans}; the report wrote {n_rep} files, its out.bmp and "
        f"cnr.bmp equal process's")
    return want_out


def check_viewer(dev, n=512):
    """[4k]: ``serve`` on port 0, not blocking: GET / and /img/out, two POST
    /execute, /flip, /debug; the pipeline runs in the server's threads."""
    import urllib.request
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        synthetic_radiograph)
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.utils import io as uio
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.utils.viewer import serve
    log(f"[4k] the viewer at {n} (`cli view`: serve on port 0, not blocking) on {dev}")
    img = synthetic_radiograph(n, "hand")
    cfg = MusicaConfig(image_size=n)
    want = musica.musica_forward(torch.from_numpy(np.ascontiguousarray(img.T)).to(dev),
                                 cfg)["out_u8"].cpu().numpy()

    def http(url, post=False):
        req = urllib.request.Request(url, method="POST" if post else "GET",
                                     data=b"" if post else None)
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()

    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "in.raw")
        uio.save_raw(raw, img)
        launch.reset_launch_counts()
        server, state = serve(raw, cfg, port=0, report_dir=os.path.join(tmp, "rep"),
                              block=False, device=str(dev))
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            status, page = http(base + "/")
            assert status == 200 and b"execute()" in page
            status, blob = http(base + "/img/out")
            assert status == 200 and blob[:2] == b"BM"
            out_path = os.path.join(tmp, "out.bmp")
            with open(out_path, "wb") as f:
                f.write(blob)
            assert np.array_equal(uio.load_bmp(out_path), want), "viewer out image"
            for _ in range(2):
                assert http(base + "/execute", post=True)[0] == 200
            assert state.n_executes == 3 and len(state.outputs) == 2 and state.current == 1
            http(base + "/flip", post=True)
            assert state.current == 0
            status, body = http(base + "/debug", post=True)
            assert status == 200 and os.path.exists(json.loads(body)["report"])
        finally:
            server.shutdown()
            server.server_close()
        launches = dict(launch.LAUNCHES)
    log(f"  GET / and /img/out (equal to musica_forward on the transposed raw), two POST "
        f"/execute (buffer 2 of 2 shown), /flip, /debug (a report); launches {launches}")
    if dev.type == "cuda":
        # 3 executes and the report, each one K1 and one K4, from the server's threads
        assert launches["noise_hist"] == launches["grad_hist"] == 4, launches


def check_data_parallel(imgs, cfg, mesh, dev):
    """[4l]: ``process_sharded`` over ``mesh`` against ``forward_batch`` on
    ``dev``, bit for bit, also with ``outputs=("out_u8", "cnr")``, and
    ``throughput_step``'s checksum against the outputs' sum."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import graphs
    b = len(imgs)
    ref = musica.forward_batch(torch.from_numpy(imgs).to(dev), cfg)
    # the first call captures each entry's graph; the second is counted
    assert torch.equal(sharding.process_sharded(imgs, cfg, mesh).to(dev), ref)
    captures = graphs.capture_count()
    launch.reset_launch_counts()
    out, cnr = sharding.process_sharded(imgs, cfg, mesh, outputs=("out_u8", "cnr"))
    counts = dict(launch.LAUNCHES)
    assert graphs.capture_count() == captures, "the mesh captured its graphs again"
    if dev.type == "cuda":
        # one replay an image
        assert counts["noise_hist"] == counts["grad_hist_relevant"] == b, counts
    assert out.device == mesh[0] and torch.equal(out.to(dev), ref), "process_sharded"
    for i in range(b):
        want = musica.musica_forward(torch.from_numpy(imgs[i]).to(dev), cfg)["cnr"]
        assert torch.equal(cnr[i].to(dev), want), f"cnr {i}"
    step, example = sharding.throughput_step(cfg, mesh)
    total = int(step(example))
    want_sum = sum(int(musica.forward_batch(e.to(dev), cfg).sum(dtype=torch.int64))
                   for e in example)
    assert total == want_sum, (total, want_sum)
    log(f"  mesh {[str(d) for d in mesh]}: out_u8 and cnr equal forward_batch's bit for bit; "
        f"launches {counts}; throughput_step checksum {total} equals the outputs' sum")


def pyramid_counts(launches):
    """(fused or down steps, expand steps, tails) of a run's counts."""
    return tuple(launches[k] for k in ("pyramid_down", "pyramid_up", "pyramid_tail"))


def profiled_run(fn, what: str, times=None):
    """One run of a path whose graph is captured already, with every count
    set to 0 just before ``fn()`` and read just after, under
    ``torch.profiler``: ``(fn's result, launches)``, ``launches`` the CUDA
    kernel events of each hand-written kernel (``KERNEL_EVENTS``) that the
    profiler recorded.  Fails unless they equal ``launch.LAUNCHES``, which
    a replay adds from its capture's tally.  The profiler may record no CUDA
    event for a run, or miss its first kernels (it did so once for one K5
    launch, and late in this script's process for the first ~15 kernels of
    a profiled run, which a process of its own recorded whole): each run
    under the profiler therefore begins with PAD_KERNELS spin kernels of
    its own, which the profiler may drop in their place, and is made once
    more, counted anew, if its record still misses a kernel; it fails unless
    the second run's events equal its counts.  ``times``, a dict, gets each
    launched kernel's device ms per launch in this run, from its events'
    spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
    for attempt in range(2):
        torch.cuda.synchronize()
        launch.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD_KERNELS):
                torch.cuda._sleep(20_000)  # ~10 us each
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
        counted = dict(launch.LAUNCHES)
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = {k: sum(bool(re.search(p, n)) for n in names) for k, p in KERNEL_EVENTS.items()}
        pad = sum("spin_kernel" in n for n in names)
        if pad < PAD_KERNELS:
            log(f"  {what}: the profiler recorded {pad} of the {PAD_KERNELS} spin kernels "
                f"before the run")
        if names and seen == counted:
            break
        # only a record that misses events is made again; one with events
        # that were not counted fails at once
        assert all(seen[k] <= counted[k] for k in seen), \
            f"{what}: the profiler saw {seen}, LAUNCHES counted {counted}"
        log(f"  {what}: the profiler recorded {len(names)} CUDA events and {seen} of "
            f"{counted}{'; the run is made again' if attempt == 0 else ''}")
    assert names, f"{what}: the profiler recorded no CUDA event in two runs"
    assert seen == counted, f"{what}: the profiler saw {seen}, LAUNCHES counted {counted}"
    if times is not None:
        for k, p in KERNEL_EVENTS.items():
            us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and re.search(p, e.name)]
            if us:
                times[k] = sum(us) / len(us) / 1e3
    return out, seen


def check_graphs(imgs, x_dev, variants, dev):
    """[4m]: ``process_jit`` (a graph replay) against eager ``musica_forward``
    bit for bit per variant, on the thorax, then on a second image (a stale
    static buffer would show) with the first result kept unchanged, and on
    the transposed thorax (a strided input); the first call's seconds and
    the growth of ``torch.cuda.memory_reserved`` over it, after an eager run
    has filled the allocator's cache with the warm-up's blocks (so the
    growth is the graph's private pool), and the capture's seconds: the
    first call less that eager run and a replay."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import graphs, musica

    def host_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    x2 = torch.from_numpy(imgs[1]).to(dev)
    for name, c, fused in variants:
        want1, eager_s = host_s(lambda: musica.musica_forward(x_dev, c, fused_sdev=fused)["out_u8"])
        reserved = torch.cuda.memory_reserved(dev)
        out1, first_s = host_s(lambda: musica.process_jit(x_dev, c, fused))
        grown = (torch.cuda.memory_reserved(dev) - reserved) / 2 ** 20
        g = graphs.cached_graphs()[-1]
        kept = out1.clone()
        out2, replay_s = host_s(lambda: musica.process_jit(x2, c, fused))
        want2 = musica.musica_forward(x2, c, fused_sdev=fused)["out_u8"]
        out_t = musica.process_jit(x_dev.T, c, fused)
        eager_t = musica.musica_forward(x_dev.T, c, fused_sdev=fused)
        want_t = eager_t["out_u8"]
        assert torch.equal(out1, want1), f"{name}: replay differs from eager"
        assert torch.equal(out2, want2), f"{name}: second image differs from eager"
        assert torch.equal(out1, kept), f"{name}: a later replay changed an earlier result"
        assert torch.equal(out_t, want_t), f"{name}: transposed input differs from eager"
        assert not torch.equal(want1, want2)
        for k, v in g.outputs.items():
            torch.testing.assert_close(v, eager_t[k], rtol=0, atol=0, equal_nan=True,
                                       msg=f"{name}: {k}")
        log(f"  {name}: out_u8 equals eager on the thorax, on a second image (the first "
            f"result unchanged) and on the transposed thorax, static outputs "
            f"{sorted(g.outputs)} equal eager's; first call {first_s:.3f} s (an eager run "
            f"{eager_s:.3f} s, a replay {replay_s:.3f} s: capture ~{first_s - eager_s - replay_s:.3f}"
            f" s), private pool +{grown:.1f} MB reserved over the first call; tally {g.tally}")


def cuda_ms(fn, reps: int, warmup: int = 1, device_only: bool = False) -> float:
    """ms per call of ``fn`` between two CUDA events.  With ``device_only``
    the GPU sleeps while the host queues every call, so the events bracket
    the device's work alone and not the host's issue rate."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if device_only:
        torch.cuda._sleep(200_000_000)  # ~0.1 s at H100 clocks
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(parent_root=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 1

    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig, cli
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import graphs, musica
    import torch.nn.functional as F
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import clahe, noise, pyramid, stats
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import gradation, normalize
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import build, launch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import pyramid as k_pyr
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import clahe_apply as k_clahe
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import clahe_hist as k_kh
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import histogram as k_hist
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import tonemap as k_tone
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import (
        contrast_apply as k_ka)
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import (
        analysis, campaign, metrics, perturb)
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        ANATOMIES, synthetic_radiograph)
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.utils import io as uio

    # ---- 1. device -------------------------------------------------------
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0].strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[1] device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible")
    log(card)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    log(f"[2] build: {time.perf_counter() - t0:.2f} s -> {build.library_path().name} "
        f"({', '.join(p.name for p in build.sources())})")
    for line in build.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    parent_libs = build_parent(parent_root) if parent_root else None

    # ---- 3. kernels against their plain versions -------------------------
    rec = KernelRecord()
    rng = np.random.default_rng(2024)
    cfg = MusicaConfig(image_size=SIZE)
    cfg_var = cfg.with_(enable_clahe=True, grad_with_linear_image=True)
    img = synthetic_radiograph(SIZE, "thorax")
    log("[3] kernels vs plain versions on the card (exact equality)")
    lv3072 = analysis_levels(img, cfg, dev)
    check_noise(rec, cfg, lv3072, "3072 thorax, levels 0-3")
    check_noise(rec, cfg, random_levels(rng, [v.shape[-1] for v in lv3072], dev),
                "3072 random levels")
    cfg512 = MusicaConfig(image_size=512)
    lv512 = analysis_levels(synthetic_radiograph(512, "thorax"), cfg512, dev)
    check_noise(rec, cfg512, lv512, "512 thorax stack")
    check_noise(rec, cfg512, random_levels(rng, [512, 256, 128, 64], dev),
                "512 random stack")

    x_dev = torch.from_numpy(img).to(dev)
    inter = musica.musica_forward(x_dev, cfg, want_intermediates=True)
    recon, nrm, cnr = inter["recon"], inter["intermediates"]["normalized"], inter["cnr"]
    relevant = inter["intermediates"]["relevant"]
    assert cnr.shape == (384, 384), cnr.shape
    check_k3(rec, "3072 thorax, 384^2 CNR", recon, nrm, cnr, cfg)
    r_recon = torch.from_numpy(rng.uniform(-0.1, 1.2, (SIZE, SIZE)).astype(np.float32)).to(dev)
    r_recon[torch.from_numpy(rng.uniform(size=(SIZE, SIZE)) < 0.002).to(dev)] = 0.0
    r_nrm = torch.from_numpy(rng.uniform(0.0, 1.01, (SIZE, SIZE)).astype(np.float32)).to(dev)
    r_cnr = torch.from_numpy(rng.uniform(0.0, 0.1, (384, 384)).astype(np.float32)).to(dev)
    check_k3(rec, "3072 random", r_recon, r_nrm, r_cnr, cfg)
    rec.equal("grad_hist", "3072 thorax (debug-dump path)",
              fh.grad_hist(recon, relevant, cfg), fh.grad_hist_plain(recon, relevant, cfg))
    cfg600 = MusicaConfig(image_size=600)
    inter600 = musica.musica_forward(
        torch.from_numpy(synthetic_radiograph(600, "pelvis")).to(dev), cfg600,
        want_intermediates=True)
    rec600, rel600 = inter600["recon"], inter600["intermediates"]["relevant"]
    rec.equal("grad_hist", "600 pelvis", fh.grad_hist(rec600, rel600, cfg600),
              fh.grad_hist_plain(rec600, rel600, cfg600))
    r_rel = noise.img_relevant(r_nrm, r_cnr, cfg)
    rec.equal("grad_hist", "3072 random", fh.grad_hist(r_recon, r_rel, cfg),
              fh.grad_hist_plain(r_recon, r_rel, cfg))

    log("[3a] K1, K3, K4 vs plain versions on adversarial inputs: 0.0 at a tile's or "
        "group's first and last pixel and at the scans' lane and step boundaries, "
        "constant images, values out of range, negative values, bin == n_bins, bin 0; "
        "and K1, K3, K4, K7 at histogram tiles 8, 12 and 32")
    check_adversarial(rec, rng, dev)

    log("[3b] CLAHE kernels vs plain versions at 3072 (histogram exact; apply "
        "exact with equal NaN masks), also at 8x8 tiles and with x at segment edges")
    var_inter = musica.musica_forward(x_dev, cfg_var, want_intermediates=True)
    v_recon, v_rel = var_inter["recon"], var_inter["intermediates"]["relevant"]
    rec.equal("grad_hist", "3072 thorax, squared image (CLAHE + linear path)",
              fh.grad_hist(var_inter["intermediates"]["linear"], v_rel, cfg_var),
              fh.grad_hist_plain(var_inter["intermediates"]["linear"], v_rel, cfg_var))
    check_clahe(rec, cfg_var, v_recon, v_rel, "3072 thorax LUTs")
    c_recon, c_rel = random_clahe(rng, SIZE, dev)
    assert check_clahe(rec, cfg_var, c_recon, c_rel, "3072 random LUTs") >= 1
    b256 = torch.from_numpy(rng.integers(-5, 261, SIZE * SIZE).astype(np.int32)).to(dev)
    w256 = torch.from_numpy((rng.uniform(size=SIZE * SIZE) < 0.8).astype(np.float32)).to(dev)
    rec.equal("histogram", "3072^2 pairs, 256 bins, float32 weights",
              k_hist.histogram(b256, w256, 256), k_hist.histogram_plain(b256, w256, 256))
    # ragged sizes: the kernel runs at every n (no block-shape condition)
    for n in (600, 144):
        cfg_n = MusicaConfig(image_size=n, enable_clahe=True)
        check_clahe(rec, cfg_n, *random_clahe(rng, n, dev), f"{n} random LUTs")
    # 8x8 tiles: 16,384 joint bins (64 KB) and 128 KB of K5 tables, past the
    # 48 KB a block has without the shared-memory opt-in
    cfg_c8 = cfg_var.with_(clahe_tiles=8)
    check_clahe(rec, cfg_c8, v_recon, v_rel, "3072 thorax LUTs, 8x8 tiles")
    assert check_clahe(rec, cfg_c8, c_recon, c_rel, "3072 random LUTs, 8x8 tiles") >= 1
    for n in (17, 600, SIZE):
        check_clahe_edges(rec, rng, n, dev)
    check_clahe_edges(rec, rng, 600, dev, t=8, bins=64)

    log("[3c] CLAHE coordinates on the card vs numpy's true float32 division")
    like = torch.zeros(1, device=dev)
    ids = clahe.tile_ids(SIZE, cfg_var.clahe_tiles, like).cpu().numpy()
    q = np.arange(SIZE, dtype=np.float32) / np.float32(SIZE)
    assert np.array_equal(ids, (q * np.float32(4)).astype(np.int32)), "tile ids"
    attrs = [a.cpu().numpy() for a in clahe.axis_attrs(SIZE, cfg_var, like)]
    coord = np.arange(SIZE, dtype=np.float32) / np.float32(SIZE // 4)
    base = np.floor(coord) + np.float32(0.5)
    assert np.array_equal(attrs[2], np.float32(1) - np.abs(base - coord)), "weights"
    assert np.array_equal(attrs[4], coord == base), "centre flags"
    recip = (torch.arange(SIZE, dtype=torch.float32, device=dev) / float(SIZE // 4)).cpu().numpy()
    log(f"  tile ids and blend weights equal numpy's; the reciprocal form "
        f"(tensor / python float) differs at {int((recip != coord).sum())} of {SIZE} "
        f"coordinates i/{SIZE // 4}")

    log("[3d] K7 (sdev + noise histogram) vs its plain version (sdev and histograms "
        "exactly equal)")
    b3072 = analysis_bands(img, cfg, dev)
    check_sdev_noise(rec, cfg, b3072, "3072 thorax bands, levels 0-3")
    check_sdev_noise(rec, cfg, random_bands(rng, [b.shape[-1] for b in b3072], dev),
                     "3072 random bands")
    # a grid of a few blocks: each block's range of tasks crosses levels
    check_sdev_noise(rec, cfg, b3072, "3072 thorax bands, 7 blocks", grid=7)
    check_sdev_noise(rec, cfg512, analysis_bands(synthetic_radiograph(512, "thorax"), cfg512, dev),
                     "512 thorax stack")
    # 600: level 0's coverage cropped to 512, coarser levels padded; 144 in
    # clean-math mode: every level but the first padded, levels down to 18 px
    for cfg_n, anatomy in ((MusicaConfig(image_size=600), "pelvis"),
                           (MusicaConfig(image_size=144, quirks=False), "hand")):
        n = cfg_n.image_size
        bands_n = analysis_bands(synthetic_radiograph(n, anatomy), cfg_n, dev)
        covs = [stats.coverage(b.shape[-1], cfg_n) for b in bands_n]
        check_sdev_noise(rec, cfg_n, bands_n, f"{n} {anatomy} stack, coverage {covs}")
        check_sdev_noise(rec, cfg_n, random_bands(rng, [b.shape[-1] for b in bands_n], dev),
                         f"{n} random stack")
        check_sdev_noise(rec, cfg_n, bands_n, f"{n} {anatomy} stack, 3 blocks", grid=3)

    log("[3e] the spatial path's kernels on row windows: K1, K3, K4, K6, K5 and K7 per "
        "shard vs their plain versions and summed vs the whole image, K2's own launch on "
        "the summed histograms (exact)")
    check_window_kernels(rec, rng, dev, cfg, lv3072, (recon, nrm, cnr),
                         (cfg_var, var_inter["intermediates"]["linear"], v_rel),
                         (b3072, v_recon))

    log("[3f] the pyramid kernels KP1 (reduce_step_kernel<band>), KP2 "
        "(upsample_smooth_kernel<mode>) and the tails (pyramid_tail_kernel<expand>) vs their "
        "plain versions, bit for bit")
    check_pyramid(rec, rng, dev, nrm, cfg)

    log("[3g] the tone map KT (tone_map_kernel) and the default path's sdev KS (sdev_kernel) "
        "vs their plain versions, bit for bit")
    cfg16 = cfg.with_(storage="bfloat16")
    check_tone_sdev(rec, rng, dev, [("main", cfg, False), ("CLAHE + linear", cfg_var, False),
                                    ("fused-sdev", cfg, True), ("bf16", cfg16, False)])
    check_sdev_tail(rec, rng, dev)

    log("[3h] the contrast stage KA (contrast_apply_kernel<bf16>) vs its plain version, bit "
        "for bit with equal NaN masks")
    check_contrast(rec, rng, dev, cfg)

    log("[3i] normalize KN (normalize_extrema_kernel, normalize_apply_kernel) and the "
        "gradation curve KG (gradation_curve_kernel) vs their plain versions, bit for bit with "
        "equal NaN masks")
    check_normalize_curve(rec, rng, dev, [("main", cfg, False), ("CLAHE + linear", cfg_var, False),
                                          ("fused-sdev", cfg, True), ("bf16", cfg16, False)])

    log("[3j] the relevance mask inside the kernels that read it: K3's block weights from the "
        "CNR map (grad_hist_kernel<tile, true>), the CLAHE joint histogram KH "
        "(clahe_hist_kernel) and its LUTs KC (clahe_curves_kernel) vs their plain versions, "
        "bit for bit with equal NaN masks")
    check_relevance(rec, rng, dev, cfg, (recon, nrm, cnr),
                    (v_recon, var_inter["intermediates"]["normalized"], var_inter["cnr"]))

    # ---- 4. the main path at 3072^2 ----------------------------------------
    log(f"[4] main path: process() on a {SIZE}^2 thorax phantom; a first call captures its "
        f"graph (eager warm-up, capture, one replay), the next (one replay) is counted")
    graphs.release_graphs()
    captures = graphs.capture_count()
    first_out = musica.process(img, cfg, "cuda")
    assert graphs.capture_count() == captures + 1, "process did not capture the main path's graph"
    out_gpu, launches = profiled_run(lambda: musica.process(img, cfg, "cuda"), "main path")
    log(f"  launches: {launches} (one replay: the profiler's kernel events, equal to LAUNCHES)")
    assert np.array_equal(out_gpu, first_out)
    for k in ("noise_hist", "grad_hist_relevant"):
        assert launches[k] > 0, f"the main path did not launch {k}"
    # K1 + K2: one launch, which takes the argmaxes too
    assert launches["noise_hist"] == 1 and launches["hist_argmax"] == 0, launches
    assert launches["sdev_noise_hist"] == 0, "the default analysis launched K7"
    # KS: the four analysis levels' sdev in one launch; KT: the tone map; KA:
    # the contrast stage
    assert launches["sdev"] == launches["tone_map"] == launches["contrast_apply"] == 1, launches
    # KN: the extrema pass and the apply pass; KG: the gradation curve
    assert launches["normalize"] == 2 and launches["gradation_curve"] == 1, launches
    # the fused step at 3072 .. 96 px, the ladder's tail from 48 px, the
    # expand's tail up to 48 px, an expand step at 96 .. 3072
    L = cfg.pyramid_levels
    assert pyramid_counts(launches) == (6, 6, 2), launches
    m = cfg.out_margin
    assert out_gpu.shape == (SIZE - 2 * m, SIZE - 2 * m) and out_gpu.dtype == np.uint8
    assert 0 < int(out_gpu.max()) and int(out_gpu.min()) < 255, "degenerate output"
    t0 = time.perf_counter()
    out_cpu = musica.process(img, cfg, "cpu")
    log(f"  CPU path: {time.perf_counter() - t0:.1f} s")
    check_parity("GPU vs the port's CPU path", out_gpu, out_cpu)
    assert np.array_equal(inter["out_u8"].cpu().numpy(), out_gpu)

    log("[4b] intermediates path (process --debug-dump)")
    launch.reset_launch_counts()
    dbg = musica.musica_forward(x_dev, cfg, want_intermediates=True)
    torch.cuda.synchronize()
    launches_dbg = dict(launch.LAUNCHES)
    log(f"  launches: {launches_dbg}")
    for k in ("noise_hist", "grad_hist"):
        assert launches_dbg[k] > 0, f"the intermediates path did not launch {k}"
    # the ladder's 6 fused steps and tail, then an exp_lowpass_{i} and an
    # expand step at each of the 12 levels
    assert pyramid_counts(launches_dbg) == (6, 24, 1), launches_dbg
    # KA writes the intermediates' contrast and noise-reduced bands too
    assert launches_dbg["contrast_apply"] == 1, launches_dbg
    assert launches_dbg["normalize"] == 2 and launches_dbg["gradation_curve"] == 1, launches_dbg
    assert np.array_equal(dbg["out_u8"].cpu().numpy(), out_gpu)
    assert all(bool(torch.isfinite(v).all()) for v in dbg["intermediates"].values()
               if isinstance(v, torch.Tensor) and v.is_floating_point())

    log(f"[4c] variant path: musica_forward with CLAHE + linear gradation "
        f"(process --clahe --linear-gradation) on the {SIZE}^2 thorax phantom")
    launch.reset_launch_counts()
    var = musica.musica_forward(x_dev, cfg_var)
    var_out = var["out_u8"].cpu().numpy()
    var_clahe = var["clahe_graded"].cpu()
    torch.cuda.synchronize()
    launches_var_eager = dict(launch.LAUNCHES)
    log(f"  launches (musica_forward): {launches_var_eager}")
    for k in ("noise_hist", "grad_hist_relevant", "clahe_hist", "clahe_curves", "clahe_apply"):
        assert launches_var_eager[k] > 0, f"the variant path did not launch {k}"
    musica.process(img, cfg_var, "cuda")  # captures the variant's graph
    var_replay, launches_var = profiled_run(lambda: musica.process(img, cfg_var, "cuda"),
                                            "CLAHE + linear")
    log(f"  launches (process, one replay: the profiler's kernel events, equal to LAUNCHES): "
        f"{launches_var}")
    assert np.array_equal(var_replay, var_out), "the variant's replay differs from musica_forward"
    for k in ("noise_hist", "grad_hist_relevant", "clahe_hist", "clahe_curves", "clahe_apply",
              "sdev", "tone_map", "contrast_apply", "gradation_curve"):
        assert launches_var[k] == 1, f"the variant's replay launched {k} {launches_var[k]} times"
    # no relevance image: neither K4 nor the joint bins' histogram K6
    assert launches_var["grad_hist"] == launches_var["histogram"] == 0, launches_var
    assert launches_var["normalize"] == 2, launches_var
    assert pyramid_counts(launches_var) == (6, 6, 2), launches_var
    assert var_out.shape == out_gpu.shape and var_out.dtype == np.uint8
    assert 0 < int(var_out.max()) and int(var_out.min()) < 255, "degenerate output"
    assert var_clahe.shape == (SIZE, SIZE) and bool(torch.isfinite(var_clahe).any())
    t0 = time.perf_counter()
    var_cpu = musica.musica_forward(torch.from_numpy(img), cfg_var)
    log(f"  CPU path: {time.perf_counter() - t0:.1f} s")
    check_parity("out_u8, GPU vs the port's CPU path", var_out, var_cpu["out_u8"].numpy())
    d_recon = float((var["recon"].cpu() - var_cpu["recon"]).abs().max())
    nan_g, nan_c = torch.isnan(var_clahe), torch.isnan(var_cpu["clahe_graded"])
    assert torch.equal(nan_g, nan_c), "clahe_graded: NaN masks differ"
    d_clahe = (var_clahe - var_cpu["clahe_graded"])[~nan_c].abs()
    clahe_err = float(d_clahe.max())
    log(f"  recon: max |GPU - CPU| = {d_recon}; clahe_graded: NaN masks equal "
        f"({int(nan_c.sum())} NaN px), max |GPU - CPU| = {clahe_err} on finite px "
        f"(bound {CLAHE_ATOL}), {int((d_clahe > 1e-2).sum())} px > 1e-2")
    assert clahe_err <= CLAHE_ATOL, "clahe_graded differs from the CPU path"
    # the parent's route on the card: the relevance image, K4 on the squared
    # image, K6 on the joint bins, the plain LUTs and K5
    v_nrm = var_inter["intermediates"]["normalized"]
    rel_old = noise.img_relevant(v_nrm, var["cnr"], cfg_var)
    lin_old = var["recon"] * var["recon"]
    gpx_o, gpy_o, _ = gradation.gradation_curve(fh.grad_hist(lin_old, rel_old, cfg_var), cfg_var)
    graded_o, out_o = k_tone.tone_map(lin_old, gpx_o, gpy_o, cfg_var.out_margin)
    px_o, py_o = clahe.clahe_curves_plain(clahe.clahe_histograms(var["recon"], rel_old, cfg_var),
                                          cfg_var)
    clahe_o = k_clahe.clahe_apply(var["recon"], px_o, py_o, cfg_var)
    for name, got, want in (("clahe_graded", var["clahe_graded"], clahe_o),
                            ("graded", var["graded"], graded_o)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            f"{name} differs from the parent's route"
    assert torch.equal(var["out_u8"], out_o), "out_u8 differs from the parent's route"
    log("  clahe_graded, graded and out_u8 equal, bit for bit, the parent's route on the card "
        "(the relevance image, K4, K6, the plain LUTs, K5)")
    # each variant alone: CLAHE leaves the tone map alone, linear gradation
    # alone gives the variant path's tone map
    only_clahe = musica.musica_forward(x_dev, cfg.with_(enable_clahe=True))
    assert np.array_equal(only_clahe["out_u8"].cpu().numpy(), out_gpu)
    torch.testing.assert_close(only_clahe["clahe_graded"].cpu(), var_clahe,
                               rtol=0, atol=0, equal_nan=True)
    only_linear = musica.musica_forward(x_dev, cfg.with_(grad_with_linear_image=True))
    assert np.array_equal(only_linear["out_u8"].cpu().numpy(), var_out)
    log("  CLAHE alone: the main path's out_u8 and the variant's clahe_graded; "
        "linear gradation alone: the variant's out_u8")

    log("[4d] the variant through timed_process and `cli process --clahe "
        "--linear-gradation --timing`")
    t_out, times, extras = musica.timed_process(img, cfg_var, "cuda", want_extras=True)
    assert np.array_equal(t_out, var_out), "timed_process out_u8"
    torch.testing.assert_close(torch.from_numpy(extras["clahe_graded"]), var_clahe,
                               rtol=0, atol=0, equal_nan=True)
    log("  timed_process (ms, host clock, one synchronize per phase): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    with tempfile.TemporaryDirectory() as tmp:
        raw, bmp = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.bmp")
        uio.save_raw(raw, img)
        assert cli.main(["process", "--clahe", "--linear-gradation", "--timing",
                         "--size", str(SIZE), raw, bmp]) == 0
        cli_out = uio.load_bmp(bmp)
    # the CLI loads the raw transposed, as the reference CLI does
    want = musica.musica_forward(torch.from_numpy(np.ascontiguousarray(img.T)).to(dev),
                                 cfg_var)["out_u8"].cpu().numpy()
    assert np.array_equal(cli_out, want), "cli process --clahe --linear-gradation"
    log("  CLI BMP equals musica_forward on the transposed raw")

    log(f"[4e] fused-sdev path: musica_forward(fused_sdev=True) (hist_method="
        f"\"fused_sdev\") on the {SIZE}^2 thorax phantom")
    launch.reset_launch_counts()
    fused = musica.musica_forward(x_dev, cfg, fused_sdev=True)
    fused_out = fused["out_u8"].cpu().numpy()
    torch.cuda.synchronize()
    launches_fused_eager = dict(launch.LAUNCHES)
    log(f"  launches (musica_forward): {launches_fused_eager}")
    for k in ("sdev_noise_hist", "grad_hist_relevant"):
        assert launches_fused_eager[k] > 0, f"the fused-sdev path did not launch {k}"
    assert launches_fused_eager["noise_hist"] == 0, "the fused-sdev path launched K1"
    assert np.array_equal(fused_out, out_gpu), "fused-sdev out_u8 differs from the default path"
    assert torch.equal(fused["recon"], inter["recon"]) and torch.equal(fused["cnr"], inter["cnr"])
    assert np.array_equal(musica.process(img, cfg, "cuda", fused_sdev=True), out_gpu)  # captures
    fused_replay, launches_fused = profiled_run(
        lambda: musica.process(img, cfg, "cuda", fused_sdev=True), "fused-sdev")
    log(f"  launches (process, one replay: the profiler's kernel events, equal to LAUNCHES): "
        f"{launches_fused}")
    assert np.array_equal(fused_replay, out_gpu)
    assert launches_fused["sdev_noise_hist"] == launches_fused["grad_hist_relevant"] == 1, \
        launches_fused
    assert launches_fused["noise_hist"] == 0, "the fused-sdev replay launched K1"
    assert launches_fused["sdev"] == 0, launches_fused
    assert launches_fused["tone_map"] == launches_fused["contrast_apply"] == 1, launches_fused
    assert launches_fused["normalize"] == 2 and launches_fused["gradation_curve"] == 1, \
        launches_fused
    assert pyramid_counts(launches_fused) == (6, 6, 2), launches_fused
    f_out, f_times = musica.timed_process(img, cfg, "cuda", fused_sdev=True)
    assert np.array_equal(f_out, out_gpu), "timed_process(fused_sdev=True) out_u8"
    log("  out_u8, recon and cnr equal the default path's on the card bit for bit; "
        "process and timed_process (fused_sdev=True) give the same out_u8")
    log("  timed_process (ms, host clock, one synchronize per phase): "
        + ", ".join(f"{k} {v:.3f}" for k, v in f_times.items()))

    log(f"[4f] bf16 band storage: process --bf16 (storage=\"bfloat16\") on the {SIZE}^2 "
        f"thorax phantom")
    launch.reset_launch_counts()
    out16 = musica.process(img, cfg16, "cuda")
    torch.cuda.synchronize()
    launches_bf16 = dict(launch.LAUNCHES)
    log(f"  launches: {launches_bf16}")
    for k in ("noise_hist", "grad_hist_relevant", "sdev", "tone_map"):
        assert launches_bf16[k] > 0, f"the bf16 path did not launch {k}"
    replay16, launches_bf16 = profiled_run(lambda: musica.process(img, cfg16, "cuda"), "bf16")
    log(f"  launches (process, one replay: the profiler's kernel events, equal to LAUNCHES): "
        f"{launches_bf16}")
    assert np.array_equal(replay16, out16), "the bf16 replay differs from its first call"
    for k in ("noise_hist", "grad_hist_relevant", "sdev", "tone_map", "contrast_apply",
              "gradation_curve"):
        assert launches_bf16[k] == 1, f"the bf16 replay launched {k} {launches_bf16[k]} times"
    assert launches_bf16["normalize"] == 2, launches_bf16
    assert pyramid_counts(launches_bf16) == (6, 6, 2), launches_bf16
    assert out16.shape == out_gpu.shape and out16.dtype == np.uint8
    t0 = time.perf_counter()
    out16_cpu = musica.process(img, cfg16, "cpu")
    log(f"  CPU path: {time.perf_counter() - t0:.1f} s")
    check_parity("bf16, GPU vs the port's CPU path", out16, out16_cpu)
    check_bf16_contract("bf16 vs float32 storage on the card", out16, out_gpu)
    dbg16 = musica.musica_forward(x_dev, cfg16, want_intermediates=True)
    bf16_keys = sorted(k for k, v in dbg16["intermediates"].items()
                       if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16)
    assert bf16_keys and all(k.split("_")[0] in ("red", "contrast", "nr") for k in bf16_keys)
    assert dbg16["recon"].dtype == dbg16["cnr"].dtype == torch.float32
    log(f"  {len(bf16_keys)} bf16 intermediates, all bands (red_/contrast_/nr_bandpass_*); "
        f"recon, cnr, sdev float32")
    assert np.array_equal(musica.process(img, cfg16, "cuda", fused_sdev=True), out16)
    t16, times16 = musica.timed_process(img, cfg16, "cuda")
    assert np.array_equal(t16, out16), "bf16 timed_process out_u8"
    log("  fused_sdev=True and timed_process give the same bf16 out_u8; timed_process ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in times16.items()))

    log(f"[4g] configurations the JAX package's kernels take beyond the defaults: "
        f"process() at histogram_area_size 8, 12 and 32 and with 8x8 CLAHE tiles on the "
        f"{SIZE}^2 thorax phantom, each kernel vs its plain version on that run's inputs")
    for tile in (8, 12, 32):
        cfg_t = cfg.with_(histogram_area_size=tile)
        first_t = musica.process(img, cfg_t, "cuda")  # captures the tile's graph
        launch.reset_launch_counts()
        out_t = musica.process(img, cfg_t, "cuda")
        torch.cuda.synchronize()
        launches_t = dict(launch.LAUNCHES)
        assert np.array_equal(out_t, first_t)
        # the CNR scale (8 at 3072) divides 8 and 32: K3; not 12: K4
        k_grad = "grad_hist_relevant" if tile % 8 == 0 else "grad_hist"
        assert launches_t["noise_hist"] == launches_t[k_grad] == 1, (tile, launches_t)
        inter_t = musica.musica_forward(x_dev, cfg_t, want_intermediates=True)
        assert np.array_equal(inter_t["out_u8"].cpu().numpy(), out_t)
        assert np.array_equal(musica.process(img, cfg_t, "cuda", fused_sdev=True), out_t)
        check_noise(rec, cfg_t, lv3072, f"3072 thorax levels, tile {tile}")
        check_sdev_noise(rec, cfg_t, b3072, f"3072 thorax bands, tile {tile}")
        r_t, n_t, c_t = (inter_t["recon"], inter_t["intermediates"]["normalized"],
                         inter_t["cnr"])
        rel_t = inter_t["intermediates"]["relevant"]
        rec.equal("grad_hist", f"3072 thorax, tile {tile}", fh.grad_hist(r_t, rel_t, cfg_t),
                  fh.grad_hist_plain(r_t, rel_t, cfg_t))
        if tile % 8 == 0:
            check_k3(rec, f"3072 thorax, tile {tile}", r_t, n_t, c_t, cfg_t)
        d = np.abs(out_t.astype(np.int64) - out_gpu.astype(np.int64))
        log(f"  tile {tile}: launches {launches_t}; out_u8 differs from the 16-px tile's at "
            f"{int((d > 0).sum())} px (max {int(d.max())}); fused_sdev gives the same out_u8")
    cfg_c8 = cfg.with_(enable_clahe=True, clahe_tiles=8)
    launch.reset_launch_counts()
    res_c8 = musica.musica_forward(x_dev, cfg_c8, want_intermediates=True)
    torch.cuda.synchronize()
    launches_c8 = dict(launch.LAUNCHES)
    assert (launches_c8["clahe_hist"] == launches_c8["clahe_curves"] == launches_c8["clahe_apply"]
            == 1 and launches_c8["histogram"] == 0), launches_c8
    assert np.array_equal(res_c8["out_u8"].cpu().numpy(), out_gpu)
    nan_tiles = check_clahe(rec, cfg_c8, res_c8["recon"], res_c8["intermediates"]["relevant"],
                            "3072 thorax, 8x8 tiles, the run's LUTs")
    h_c8 = check_kh(rec, "3072 thorax, 8x8 tiles, the run's inputs", res_c8["recon"],
                    res_c8["intermediates"]["normalized"], res_c8["cnr"], cfg_c8, 4)
    assert torch.equal(h_c8, clahe.clahe_histograms(res_c8["recon"],
                                                    res_c8["intermediates"]["relevant"], cfg_c8))
    assert np.array_equal(musica.process(img, cfg_c8, "cuda"), out_gpu)
    log(f"  8x8 CLAHE tiles: launches {launches_c8}; {nan_tiles} NaN tile(s); out_u8 equals "
        f"the main path's (CLAHE leaves the tone map alone)")

    log(f"[4h] the metamorphic campaign on the card (run_campaign, as `cli campaign` runs "
        f"it): thorax at {SIZE}, seed 0, its 30 cases against the TPU campaign's thorax rows "
        f"(artifacts/mt_campaign_3072)")
    t0 = time.perf_counter()
    mt_rng = campaign.advance_rng(np.random.default_rng(0), SIZE, ANATOMIES[:-1])
    log(f"  the generator drawn past {', '.join(ANATOMIES[:-1])} on the host: "
        f"{time.perf_counter() - t0:.1f} s")
    # the runner's graph (the main path's, if it is still cached) before the
    # counted run
    assert np.array_equal(campaign.default_runner(SIZE, device="cuda")(img.T), out_gpu)
    with tempfile.TemporaryDirectory() as tmp:
        captures = graphs.capture_count()
        launch.reset_launch_counts()
        t0 = time.perf_counter()
        mt = campaign.run_campaign(out_dir=tmp, image_size=SIZE, anatomies=["thorax"],
                                   rng=mt_rng, device="cuda")
        torch.cuda.synchronize()
        launches_mt = dict(launch.LAUNCHES)
        mt_s = time.perf_counter() - t0
    assert graphs.capture_count() == captures, "the campaign captured a graph of its own"
    log(f"  {mt_s:.1f} s for 31 pipeline runs (graph replays) and 51 rows; launches: "
        f"{launches_mt}")
    # 1 unaltered + 30 altered runs; 3 value counts a row: the reference row,
    # 30 direct rows and 20 registration rows
    assert launches_mt["noise_hist"] == launches_mt["grad_hist_relevant"] == 31, launches_mt
    assert launches_mt["histogram"] == 3 * (1 + 30 + 20), launches_mt
    for name, first in ((campaign.R_CSV, 2), (campaign.NR_CSV, 2), (campaign.S_CSV, 1)):
        with open(os.path.join(MT_ARTIFACT, name), newline="") as f:
            rows = list(csv.reader(f))
        want = [rows[0]] + [r for r in rows[1:] if r[0] == "thorax"]
        check_campaign_rows(name, mt[name], want, first)
    # one row at the campaign's crop against the float64 host oracles: the
    # main path's output, a noisy run of it, and the CLAHE + linear output
    alt = musica.process(perturb.add_gaussian_noise(img, 0.0, 64.0, np.random.default_rng(5)),
                         cfg, "cuda")
    unalt_t, ref_t = torch.from_numpy(out_gpu).to(dev), torch.from_numpy(var_out).to(dev)
    row = metrics.measure_row(alt, unalt_t, ref_t)
    want = [metrics.mse_similarity(alt, out_gpu), metrics.ssim_similarity(alt, out_gpu),
            metrics.hist_similarity(alt, out_gpu)[1], metrics.mse_similarity(alt, var_out),
            metrics.ssim_similarity(alt, var_out), metrics.hist_similarity(alt, var_out)[1]]
    row_err = float(np.abs(np.array(row) - np.array(want)).max())
    log(f"  measure_row at {alt.shape[0]}^2 on the card: {row}; max |card - float64 oracle| "
        f"{row_err} (bound {ROW_ATOL})")
    assert row_err <= ROW_ATOL, "measure_row differs from the host oracles"
    counts = metrics.counts256(unalt_t).cpu().numpy()
    assert np.array_equal(counts, np.bincount(out_gpu.reshape(-1), minlength=256)), "counts256"
    log("  counts256 (the histogram kernel) equals np.bincount")

    log(f"[4i] the campaign in bf16 band storage against float32 at {MT_BF16_SIZE}, all six "
        f"anatomies, seed 0: slope flags (artifacts/mt_bf16_vs_f32_512.json: 54/54)")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mt32 = campaign.run_campaign(out_dir=os.path.join(tmp, "f32"), image_size=MT_BF16_SIZE,
                                     device="cuda")
        mt16 = campaign.run_campaign(out_dir=os.path.join(tmp, "bf16"), image_size=MT_BF16_SIZE,
                                     storage="bfloat16", device="cuda")
        log(f"  two campaigns of 180 cases: {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(os.path.dirname(MT_ARTIFACT), "mt_bf16_vs_f32_512.json")) as f:
        jax_bf16 = json.load(f)
    for name, first, key in ((campaign.R_CSV, 2, "direct_robustness"),
                             (campaign.NR_CSV, 2, "reg_based_robustness"),
                             ("deltas.csv", 1, "deltas")):
        names32, v32 = csv_values(mt32[name], first)
        names16, v16 = csv_values(mt16[name], first)
        assert names32 == names16 and np.isfinite(v16).all(), name
        d = np.abs(v16 - v32)
        log(f"  {name}: {v32.shape[0]} rows, max |bf16 - f32| {float(d.max())}, mean "
            f"{float(d.mean())} (the JAX package's, on the CPU: max "
            f"{jax_bf16[key]['max_abs_diff']}, mean {jax_bf16[key]['mean_abs_diff']})")
    flags32 = [f for *_, f in analysis.slope_analysis(mt32["deltas.csv"])]
    flags16 = [f for *_, f in analysis.slope_analysis(mt16["deltas.csv"])]
    agree = sum(a == b for a, b in zip(flags32, flags16))
    log(f"  slope flags agree {agree}/{len(flags32)} ({sum(flags32)} flagged in float32)")
    assert len(flags32) == 54 and agree == 54, "bf16 changes the campaign's slope flags"

    out_gpu_t = check_host_surface(img, cfg, dev)
    check_viewer(dev)
    log(f"[4l] data parallelism: process_sharded of {BATCH} x {SIZE}^2 over make_mesh() "
        f"against forward_batch, and throughput_step")
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
    dp_imgs = np.stack([synthetic_radiograph(SIZE, a) for a in ("thorax", "pelvis", "hand", "knee")])
    check_data_parallel(dp_imgs, cfg, sharding.make_mesh(), dev)
    if torch.cuda.device_count() > 1:
        check_data_parallel(dp_imgs, cfg, sharding.make_mesh(n_data=2), dev)
        with tempfile.TemporaryDirectory() as tmp:
            raw, bmp = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.bmp")
            uio.save_raw(raw, img)
            assert cli.main(["process", "--device", "cuda:1", "--size", str(SIZE), raw, bmp]) == 0
            assert np.array_equal(uio.load_bmp(bmp), out_gpu_t), "process on cuda:1"
        log("  process --device cuda:1 equals cuda:0's BMP")
    else:
        log("  a mesh of two cards and process on cuda:1: skipped, one card visible")

    anatomies = ["thorax", "pelvis", "hand", "knee"][:BATCH]
    imgs = np.stack([synthetic_radiograph(SIZE, a) for a in anatomies])
    log(f"[4m] the compiled entries at {SIZE}: process_jit and process_batch_jit (replays of "
        f"musica_forward's captured CUDA graph) against eager, bit for bit")
    graphs.release_graphs()
    torch.cuda.empty_cache()
    check_graphs(imgs, x_dev, [
        ("main path", cfg, False), ("CLAHE + linear", cfg_var, False),
        ("fused-sdev", cfg, True), ("bf16", cfg16, False),
        *[(f"tile {t}", cfg.with_(histogram_area_size=t), False) for t in (8, 12, 32)]], dev)
    xb_dev = torch.from_numpy(imgs).to(dev)
    want_b = musica.forward_batch(xb_dev, cfg)
    assert torch.equal(musica.process_batch_jit(xb_dev, cfg), want_b), "process_batch_jit"
    for mesh in (sharding.make_mesh(devices=[dev] * 2), sharding.make_mesh()):
        assert torch.equal(sharding.process_sharded(imgs, cfg, mesh).to(dev), want_b), mesh
    log(f"  process_batch_jit of {', '.join(anatomies)} equals forward_batch; process_sharded "
        f"through graphs equals it with 2 mesh entries on {dev} and over every card "
        f"({torch.cuda.device_count()})")
    musica.process_jit(x_dev, cfg)
    g = graphs.cached_graphs()[-1]
    launch.reset_launch_counts()
    for _ in range(5):
        musica.process_jit(x_dev, cfg)
    torch.cuda.synchronize()
    counts = dict(launch.LAUNCHES)
    assert counts == {k: 5 * g.tally.get(k, 0) for k in counts}, (counts, g.tally)
    log(f"  LAUNCHES after 5 replays of the main path's graph: {counts} = 5 x its tally "
        f"{g.tally}; {len(graphs.cached_graphs())} graphs cached, "
        f"{torch.cuda.memory_reserved(dev) / 2 ** 30:.2f} GiB reserved on {dev}")

    log(f"[4n] the spatial path: process_sharded of 2 x {SIZE}^2 with each image's rows split "
        f"over the space entries (1x4 and 2x2 on {dev}) as replays of captured graphs, against "
        f"the eager spatial path and process_batch_jit, bit for bit")
    spatial_run = check_spatial(imgs[:2], cfg, dev, np.stack(
        [synthetic_radiograph(600, a) for a in ("pelvis", "hand")]), cfg_var, cfg16)
    sp_counts = spatial_run["counts"][f"main, 1x4 on {dev}"]

    # ---- 5. a batch of 4 ---------------------------------------------------
    for c in (cfg, cfg16):
        outs = musica.process_batch(imgs, c, "cuda")
        assert outs.shape == (BATCH,) + out_gpu.shape
        for a, im, o in zip(anatomies, imgs, outs):
            assert np.array_equal(o, musica.process(im, c, "cuda")), (a, c.storage)
    log(f"[5] process_batch: {BATCH} x {SIZE}^2 ({', '.join(anatomies)}) "
        f"equal to single-image runs, in float32 and in bf16 storage")

    # ---- 6. timings ----------------------------------------------------------
    # the single-image paths run in interleaved windows (default, fused-sdev,
    # bf16, CLAHE + linear, each eager and as a graph replay, default, ...),
    # so the host's drift falls on all
    xb_dev = torch.from_numpy(imgs).to(dev)
    variants = {"default": (cfg, False), "fused_sdev": (cfg, True), "bf16": (cfg16, False),
                "CLAHE + linear": (cfg_var, False)}
    paths = {}
    for k, (c, fused) in variants.items():
        paths[k] = (lambda c=c, fused=fused:
                    musica.musica_forward(x_dev, c, fused_sdev=fused)["out_u8"])
        paths[f"{k} (graph)"] = lambda c=c, fused=fused: musica.process_jit(x_dev, c, fused)
    for _ in range(3):
        for fn in paths.values():
            fn()
    windows = {k: [] for k in paths}
    for _ in range(ROUNDS):
        for k, fn in paths.items():
            windows[k].append(cuda_ms(fn, 10, 0))
    batch_fns = {"eager": lambda: musica.forward_batch(xb_dev, cfg),
                 "graph": lambda: musica.process_batch_jit(xb_dev, cfg)}
    batch_runs = {k: [] for k in batch_fns}
    for _ in range(3):
        for k, fn in batch_fns.items():
            batch_runs[k].append(cuda_ms(fn, 2, 1) / BATCH)
    mpix = SIZE * SIZE / 1e6
    log(f"[6] timings on {card} (CUDA events, device-resident u16 input; "
        f"pipeline: host issue included; kernels: device time)")
    for k, w in windows.items():
        med = sorted(w)[ROUNDS // 2]
        log(f"  single, {k}: median {med} ms/img = {mpix / med} GPix/s "
            f"({ROUNDS} interleaved windows of 10, in run order: {w})")
    for k in variants:
        ratios = [a / b for a, b in zip(windows[f"{k} (graph)"], windows[k])]
        log(f"  {k}, graph / eager per round: {ratios} (median {sorted(ratios)[ROUNDS // 2]})")
    for k in ("fused_sdev", "bf16"):
        diffs = [a - b for a, b in zip(windows[k], windows["default"])]
        log(f"  {k} - default, per round: {diffs} ms/img (median "
            f"{sorted(diffs)[ROUNDS // 2]}, {sum(d < 0 for d in diffs)} of {ROUNDS} below 0)")
    for k, runs in batch_runs.items():
        med = sorted(runs)[1]
        log(f"  batch of {BATCH}, {k}: median {med} ms/img = {mpix / med} GPix/s "
            f"(3 windows of 2 batches, interleaved with the other's: {runs})")
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_torch", os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                                    "bench_torch.py"))
    bench_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_torch)
    bench = bench_torch.measure("cuda", SIZE)
    log("  scripts/bench_torch.py:")
    log(json.dumps(bench))
    # the mesh leg's worker threads on one card: throughput_step (graph
    # replays) over 1, 2 and 4 mesh entries that are all this card (one
    # thread, one stream, one graph and one random image each), host clock,
    # medians of 3 steps after one that captures; 4 threads also with the
    # interpreter's switch interval at 0.1 ms instead of 5 ms
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
    interval = sys.getswitchinterval()
    for k, switch in ((1, interval), (2, interval), (4, interval), (4, 1e-4)):
        step, example = sharding.throughput_step(cfg, sharding.make_mesh(devices=[dev] * k))
        sys.setswitchinterval(switch)
        try:
            int(step(example))
            steps = []
            for _ in range(3):
                t0 = time.perf_counter()
                int(step(example))
                steps.append((time.perf_counter() - t0) * 1e3)
        finally:
            sys.setswitchinterval(interval)
        med = sorted(steps)[1]
        log(f"  throughput_step through graphs, {k} worker thread(s) on {dev}, switch interval "
            f"{switch} s: "
            f"{med / k} ms/img = {k * mpix / med} GPix/s (steps, ms: {steps})")
    # a campaign case at 3072 (thorax), in its parts: each perturbation on the
    # host, process() (host clock: the raw's upload, the graph's replay, the
    # output's download; and the same with eager musica_forward in place of
    # the replay) and a row's measure_row (the altered output's
    # upload, the row on the card, the counts' download); medians of 5
    def host_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[reps // 2]

    g = np.random.default_rng(6)
    case_ms = {"perturbation " + k: host_ms(fn) for k, fn in (
        ("collimator", lambda: perturb.apply_collimator(img, 200, 200, g)),
        ("translation", lambda: perturb.clamp_translation(img, x_shift=300)),
        ("rotation", lambda: perturb.clamp_rotate(img, 27)),
        ("gaussian", lambda: perturb.add_gaussian_noise(img, 0.0, 64.0, g)),
        ("quantum", lambda: perturb.apply_quantum_noise(img, 0.1, g)))}
    case_ms["process"] = host_ms(lambda: musica.process(img.T, cfg, "cuda"))
    case_ms["process eager"] = host_ms(lambda: musica.musica_forward(
        musica.to_device(img.T, "cuda"), cfg)["out_u8"].cpu().numpy())
    case_ms["measure_row"] = host_ms(lambda: metrics.measure_row(alt, unalt_t, ref_t))
    case_ms["rotated reference (host)"] = host_ms(lambda: perturb.rotate_nearest_u8(out_gpu, 27))
    log("  a campaign case at 3072, ms (host clock, medians of 5): "
        + ", ".join(f"{k} {v}" for k, v in case_ms.items()))

    v_px, v_py = clahe.clahe_curves(clahe.clahe_histograms(v_recon, v_rel, cfg_var), cfg_var)
    v_joint, v_w = clahe.clahe_joint_bins(v_recon, v_rel, cfg_var)
    nb = cfg_var.clahe_tiles ** 2 * cfg_var.clahe_bins
    linear = var_inter["intermediates"]["linear"]
    h3072, mb3072 = fh.noise_hists(lv3072, cfg)
    dn0 = k_pyr.smooth_downsample(nrm)
    # the main path's tone map: its gradation input (recon) and curve
    gpx, gpy, _ = inter["intermediates"]["grad_curve"]
    m = cfg.out_margin
    # KH and KC on the CLAHE + linear path's inputs: its recon, normalized
    # image and CNR map, its joint histogram
    v_nrm, v_cnr = var_inter["intermediates"]["normalized"], var_inter["cnr"]
    v_h = k_kh.clahe_hist(v_recon, v_nrm, v_cnr, cfg_var)
    # KN's and KG's main-path inputs: the thorax and its gradation histogram;
    # the image's extrema for KN's apply pass on a window
    ghist = inter["intermediates"]["grad_hist"]
    q_ext = normalize.extrema_partials(x_dev)
    ext = torch.stack([q_ext[:, 0].amax(), q_ext[:, 1].amin()])
    # KA on the main path's inputs, in float32 and in bf16 band storage
    ka_cfg = {"float32": cfg, "bfloat16": cfg16}
    ka_in = {st: contrast_inputs(x_dev, c) for st, c in ka_cfg.items()}

    def ka_call(fn, st):
        b, sd, mb, cn = ka_in[st]
        return fn(b, sd, mb, {k: (cn, 0) for k in k_ka.nr_levels(ka_cfg[st], False)},
                  ka_cfg[st])
    cases = {
        "noise_hist": (lambda: fh.noise_hists(lv3072, cfg),
                       lambda: fh.noise_hists_plain(lv3072, cfg)),
        # folded into K1 and K7: its time is theirs with it less theirs without
        "hist_argmax": (None, lambda: fh.hist_argmax_plain(h3072)),
        "grad_hist_relevant": (lambda: fh.grad_hist_relevant(recon, nrm, cnr, cfg),
                               lambda: fh.grad_hist_relevant_plain(recon, nrm, cnr, cfg)),
        "grad_hist": (lambda: fh.grad_hist(linear, v_rel, cfg_var),
                      lambda: fh.grad_hist_plain(linear, v_rel, cfg_var)),
        "histogram": (lambda: k_hist.histogram(v_joint, v_w, nb),
                      lambda: k_hist.histogram_plain(v_joint, v_w, nb)),
        "clahe_apply": (lambda: k_clahe.clahe_apply(v_recon, v_px, v_py, cfg_var),
                        lambda: k_clahe.clahe_apply_plain(v_recon, v_px, v_py, cfg_var)),
        "sdev_noise_hist": (lambda: fh.sdev_noise_hists(b3072, cfg),
                            lambda: fh.sdev_noise_hists_plain(b3072, cfg)),
        # level 0 of the thorax's ladder: the normalized image down (the
        # down step alone), its next level up (mode 0); the ladder's tail
        # from the cut (48 px, 6 levels)
        "pyramid_down": (lambda: k_pyr.smooth_downsample(nrm),
                         lambda: k_pyr.smooth_downsample_plain(nrm)),
        "pyramid_up": (lambda: k_pyr.upsample_smooth(dn0, SIZE),
                       lambda: pyramid.upsample_smooth_plain(dn0, SIZE)),
        "pyramid_tail": (lambda: k_pyr.reduce_tail(tail_in, tail_levels),
                         lambda: k_pyr.reduce_tail_plain(tail_in, tail_levels)),
        # the four analysis levels' sdev of the thorax; its tone map
        "sdev": (lambda: fh.sdevs(b3072), lambda: fh.sdevs_plain(b3072)),
        "tone_map": (lambda: k_tone.tone_map(recon, gpx, gpy, m),
                     lambda: k_tone.tone_map_plain(recon, gpx, gpy, m)),
        # the contrast stage of the thorax's main path
        "contrast_apply": (lambda: ka_call(k_ka.contrast_apply, "float32"),
                           lambda: ka_call(k_ka.contrast_apply_plain, "float32")),
        # the thorax's normalize (both passes) and its gradation curve
        "normalize": (lambda: normalize.normalize_from_u16(x_dev, cfg.quirks),
                      lambda: normalize.normalize_from_u16_plain(x_dev, cfg.quirks)),
        "gradation_curve": (lambda: gradation.gradation_curve(ghist, cfg),
                            lambda: gradation.gradation_curve_plain(ghist, cfg)),
        # the CLAHE + linear path's joint histogram and LUTs
        "clahe_hist": (lambda: k_kh.clahe_hist(v_recon, v_nrm, v_cnr, cfg_var),
                       lambda: k_kh.clahe_hist_plain(v_recon, v_nrm, v_cnr, cfg_var)),
        "clahe_curves": (lambda: clahe.clahe_curves(v_h, cfg_var),
                         lambda: clahe.clahe_curves_plain(v_h, cfg_var)),
    }
    # one PyTorch call computing the same function, where there is one
    # (timed as a yardstick only; the port never calls it)
    joint_flat, w_flat = v_joint.reshape(-1), v_w.reshape(-1)
    assert int(joint_flat.min()) >= 0 and int(joint_flat.max()) < nb
    assert torch.equal(torch.bincount(joint_flat, weights=w_flat, minlength=nb).to(torch.int32),
                       k_hist.histogram(v_joint, v_w, nb))
    assert torch.equal(torch.argmax(h3072, dim=1).to(torch.int32), mb3072)
    assert torch.equal(unfolded_noise_hists(lv3072, cfg), h3072)
    library = {"hist_argmax": lambda: torch.argmax(h3072, dim=1),
               "histogram": lambda: torch.bincount(joint_flat, weights=w_flat, minlength=nb)}
    # the pyramid steps as one float64 convolution each (zero borders and
    # another order of sums, so a time only; the float64 copies are made
    # beforehand): stride 2 with the 5x5 outer product of the taps, and its
    # transpose with 4 x that kernel
    w64 = torch.tensor(pyramid._W, dtype=torch.float64, device=dev)
    k55 = torch.outer(w64, w64)[None, None]
    nrm64, dn64 = nrm.double()[None, None], dn0.double()[None, None]
    library["pyramid_down"] = lambda: F.conv2d(nrm64, k55, stride=2, padding=2)
    library["pyramid_up"] = lambda: F.conv_transpose2d(dn64, 4 * k55, stride=2, padding=2,
                                                       output_padding=1)
    assert library["pyramid_down"]().shape[-2:] == dn0.shape
    assert library["pyramid_up"]().shape[-2:] == nrm.shape
    # KS: a 5x5 mean of the float64 squares a level (zero padding, another
    # order of sums and no square root, so a time only; the squares are made
    # beforehand)
    sq64 = [(b.double() * b.double())[None, None] for b in b3072]
    library["sdev"] = lambda: [F.avg_pool2d(q, 5, stride=1, padding=2) for q in sq64]
    assert [t.shape for t in library["sdev"]()] == [q.shape for q in sq64]
    # the ladder (a fused step a level down to the cut, one tail) and the
    # expand (one tail, an expand step a level) of the thorax, kernels and
    # plain versions, with their bounds
    L = cfg.pyramid_levels
    lad_bands, lad_downs = pyramid.reduce_ladder(nrm, L)
    sizes = [t.shape[-1] for t in (nrm, *lad_downs[:-1])]
    cut = next(i for i, h in enumerate(sizes) if h <= k_pyr.TAIL_CUT)
    tail_in, tail_levels = lad_downs[cut - 1], L - cut
    # the launches of one ladder and of one expand, counted around them
    launch.reset_launch_counts()
    pyramid.reduce_ladder(nrm, L)
    torch.cuda.synchronize()
    ladder_launches = dict(zip(("pyramid_down", "pyramid_up", "pyramid_tail"),
                               pyramid_counts(launch.LAUNCHES)))
    launch.reset_launch_counts()
    pyramid.expand_ladder(lad_downs[-1], lad_bands)
    torch.cuda.synchronize()
    expand_launches = dict(zip(("pyramid_down", "pyramid_up", "pyramid_tail"),
                               pyramid_counts(launch.LAUNCHES)))
    # 3072 .. 96 px in fused steps (expand steps), 48 .. 2 in one tail
    assert list(ladder_launches.values()) == [6, 0, 1], ladder_launches
    assert list(expand_launches.values()) == [0, 6, 1], expand_launches
    work = pyramid_work(sizes, cut)
    rate64 = fp64_rate()[0]

    def b_ms(key):
        return bound(*work[key], rate=rate64)[0]
    top = lad_downs[-1]
    pyr_extra = {
        "pyramid_down": {
            "step_ms": cuda_ms(lambda: k_pyr.reduce_step(nrm), 20, 2, device_only=True),
            "step_plain_ms": cuda_ms(lambda: k_pyr.reduce_step_plain(nrm), 3, 1,
                                     device_only=True),
            "step_bound_ms": b_ms("step"),
            "last_step_px": sizes[cut - 1],
            "last_step_ms": cuda_ms(lambda: k_pyr.reduce_step(lad_downs[cut - 2]), 20, 2,
                                   device_only=True),
            "ladder_ms": cuda_ms(lambda: pyramid.reduce_ladder(nrm, L), 10, 2, device_only=True),
            "ladder_plain_ms": cuda_ms(lambda: pyramid.reduce_ladder_plain(nrm, L), 3, 1,
                                       device_only=True),
            "ladder_bound_ms": b_ms("ladder"), "ladder_launches": ladder_launches},
        "pyramid_up": {
            "subtract_ms": cuda_ms(lambda: k_pyr.upsample_subtract(nrm, dn0), 20, 2,
                                   device_only=True),
            "add_ms": cuda_ms(lambda: k_pyr.upsample_add(dn0, nrm), 20, 2, device_only=True),
            "add_bound_ms": b_ms("add"),
            "expand_ms": cuda_ms(lambda: pyramid.expand_ladder(top, lad_bands), 10, 2,
                                 device_only=True),
            "expand_plain_ms": cuda_ms(lambda: k_pyr.expand_ladder_plain(top, lad_bands), 3, 1,
                                       device_only=True),
            "expand_bound_ms": b_ms("expand"), "expand_launches": expand_launches},
        "pyramid_tail": {
            "tail_from_px": sizes[cut], "tail_levels": tail_levels,
            "expand_tail_ms": cuda_ms(lambda: k_pyr.expand_tail(top, lad_bands[cut:]), 20, 2,
                                      device_only=True),
            "expand_tail_plain_ms": cuda_ms(lambda: k_pyr.expand_tail_plain(top, lad_bands[cut:]),
                                            3, 1, device_only=True),
            "expand_tail_bound_ms": b_ms("expand_tail")},
    }
    # KA in bf16 storage, and the kernels its plain chain launches (the
    # profiler's kernel events over one call)
    # KN's passes alone (the apply pass with the image's extrema), and the
    # kernels each plain chain launches (the profiler's kernel events)
    pyr_extra["normalize"] = {
        "extrema_ms": cuda_ms(lambda: normalize.extrema_partials(x_dev), 20, 2, device_only=True),
        "apply_ms": cuda_ms(lambda: normalize.normalize_from_u16(x_dev, cfg.quirks,
                                                                 extrema=(ext[0], ext[1])),
                            20, 2, device_only=True),
        "plain_launches": kernel_events(
            lambda: normalize.normalize_from_u16_plain(x_dev, cfg.quirks))}
    pyr_extra["gradation_curve"] = {
        "plain_launches": kernel_events(lambda: gradation.gradation_curve_plain(ghist, cfg))}
    # the kernels of KH's and KC's plain chains, and of the weight plane K3
    # computes itself now (the profiler's kernel events over one call)
    pyr_extra["clahe_hist"] = {"plain_launches": kernel_events(
        lambda: k_kh.clahe_hist_plain(v_recon, v_nrm, v_cnr, cfg_var))}
    pyr_extra["clahe_curves"] = {"plain_launches": kernel_events(
        lambda: clahe.clahe_curves_plain(v_h, cfg_var))}
    pyr_extra["grad_hist_relevant"] = {"weight_plane_launches": kernel_events(
        lambda: fh.relevance_weight_plane(cnr, cfg))}
    pyr_extra["contrast_apply"] = {
        "bf16_ms": cuda_ms(lambda: ka_call(k_ka.contrast_apply, "bfloat16"), 20, 2,
                           device_only=True),
        "bf16_plain_ms": cuda_ms(lambda: ka_call(k_ka.contrast_apply_plain, "bfloat16"), 5, 1,
                                 device_only=True),
        "bf16_bound_ms": contrast_bound(*ka_in["bfloat16"], cfg16)[0],
        "plain_launches": kernel_events(lambda: ka_call(k_ka.contrast_apply_plain, "float32")),
        "bf16_plain_launches": kernel_events(
            lambda: ka_call(k_ka.contrast_apply_plain, "bfloat16"))}
    # with --parent: KA (float32, bf16) and KH (4x4 and 8x8 tiles) built from
    # the parent checkout's sources, timed in turns with this checkout's on
    # the same inputs, after checking that the two give the same outputs
    if parent_libs is not None:
        plibs = parent_libs()
        cfg_var8 = cfg_var.with_(clahe_tiles=8)
        turns = (("", "contrast_apply", lambda: ka_call(k_ka.contrast_apply, "float32")),
                 ("bf16_", "contrast_apply", lambda: ka_call(k_ka.contrast_apply, "bfloat16")),
                 ("", "clahe_hist", lambda: k_kh.clahe_hist(v_recon, v_nrm, v_cnr, cfg_var)),
                 ("8x8_", "clahe_hist", lambda: k_kh.clahe_hist(v_recon, v_nrm, v_cnr, cfg_var8)))
        def tensors(x):
            if isinstance(x, torch.Tensor):
                return [x]
            items = x.values() if isinstance(x, dict) else x
            return [t for v in items for t in tensors(v)]
        for key, name, fn in turns:
            real = launch.lib
            launch.lib = lambda lib=plibs[name]: lib
            try:
                theirs = tensors(fn())
            finally:
                launch.lib = real
            mine = tensors(fn())
            assert len(mine) == len(theirs)
            for g, w in zip(mine, theirs):
                assert torch.equal(g.float().nan_to_num(7.0).view(torch.int32),
                                   w.float().nan_to_num(7.0).view(torch.int32)), \
                    f"{key}{name}: the parent's kernel gives other outputs"
            par, this = parent_turns(launch, plibs[name], fn)
            pyr_extra.setdefault(name, {}).update({f"{key}parent_turns_ms": par,
                                                   f"{key}this_turns_ms": this})
            log(f"  {key}{name} built from {parent_root} beside this checkout's, ms in turns "
                f"(parent, this, this, parent, twice): parent {par}, this {this}")
    else:
        log("  no --parent given: the parent's KA and KH are not timed")
    log("  pyramid bounds, ms: " + ", ".join(
        f"{k} {b_ms(k)}" for k in ("step", "ladder", "subtract", "add", "expand", "tail",
                                   "expand_tail")))
    # the fold: K1 and K7 with and without the argmax, and K1 without it
    # followed by one argmax launch, as the main path ran before the fold
    # (torch.argmax in place of the argmax kernel it had); 5 interleaved
    # rounds, medians
    fold_fns = {
        "k1_ms": lambda: fh.noise_hists(lv3072, cfg),
        "k1_without_argmax_ms": lambda: unfolded_noise_hists(lv3072, cfg),
        "k1_then_argmax_launch_ms": lambda: torch.argmax(unfolded_noise_hists(lv3072, cfg), 1),
        "k7_ms": lambda: fh.sdev_noise_hists(b3072, cfg),
        "k7_without_argmax_ms": lambda: unfolded_sdev_noise_hists(b3072, cfg),
    }
    fold_runs = {k: [] for k in fold_fns}
    for _ in range(5):
        for k, fn in fold_fns.items():
            fold_runs[k].append(cuda_ms(fn, 20, 2, device_only=True))
    fold = {k: sorted(v)[2] for k, v in fold_runs.items()}
    log(f"  the argmax folded into K1 and K7, ms (medians of 5 interleaved rounds): {fold}; "
        f"in run order: {fold_runs}")
    bounds = kernel_bounds(cfg, lv3072, recon, cnr, linear, v_recon, v_joint, nb, v_px, b3072,
                           gpx)
    bounds["contrast_apply"] = contrast_bound(*ka_in["float32"], cfg)
    # KN: the integer image read once, the float32 image written once (the
    # extrema pass's second read is the two-pass design's cost, not the
    # function's); a root, a subtraction and a division a pixel.  KG: the
    # histogram read, the curve written (its time is one block's latency)
    px_n = x_dev.numel()
    bounds["normalize"] = bound((x_dev.element_size() + 4) * px_n, 3 * px_n)
    bounds["gradation_curve"] = bound(ghist.numel() * 4 + 47 * 4)
    # KH: the relevant pixels' bytes (clahe_hist_bound).  KC: the histograms
    # read, the LUTs written (its time is one block's latency)
    bounds["clahe_hist"] = clahe_hist_bound(v_recon, v_nrm, v_cnr, cfg_var)
    bounds["clahe_curves"] = bound(4 * v_h.numel() + 4 * (v_h.numel() + cfg_var.clahe_bins))
    # each count: the profiler's kernel events over one process call (one
    # graph replay), checked equal to LAUNCHES ([4], [4c], [4e])
    from_run = {"noise_hist": (launches, "process (one graph replay)"),
                "grad_hist_relevant": (launches, "process (one graph replay)"),
                "grad_hist": (launches_dbg, "musica_forward with want_intermediates (process "
                              "--debug-dump, eager): the relevance image is an intermediate"),
                "histogram": (launches_mt, "run_campaign of [4h] (thorax at 3072: 31 graph "
                              "replays and 51 rows, three value counts a row)"),
                "clahe_apply": (launches_var, "process with enable_clahe and "
                                "grad_with_linear_image (one graph replay)"),
                "clahe_hist": (launches_var, "process with enable_clahe and "
                               "grad_with_linear_image (one graph replay)"),
                "clahe_curves": (launches_var, "process with enable_clahe and "
                                 "grad_with_linear_image (one graph replay)"),
                "sdev_noise_hist": (launches_fused, "process(fused_sdev=True) (one graph "
                                    "replay; the JAX package's hist_method=\"fused_sdev\")"),
                "pyramid_down": (launches, "process (one graph replay)"),
                "pyramid_up": (launches, "process (one graph replay)"),
                "pyramid_tail": (launches, "process (one graph replay)"),
                "sdev": (launches, "process (one graph replay)"),
                "tone_map": (launches, "process (one graph replay)"),
                "contrast_apply": (launches, "process (one graph replay)"),
                "normalize": (launches, "process (one graph replay)"),
                "gradation_curve": (launches, "process (one graph replay)")}
    # the spatial path's own count of each kernel ([4n]: 1x4 at 3072, the
    # main path, the CLAHE + linear variant and fused-sdev)
    sp_path = f"process_sharded of 2 x {SIZE}^2 over 1x4 on {dev}"
    spatial_from = {k: (sp_counts, sp_path) for k in ("noise_hist", "hist_argmax",
                                                      "grad_hist_relevant", "pyramid_down",
                                                      "pyramid_up", "pyramid_tail", "sdev",
                                                      "tone_map", "contrast_apply",
                                                      "normalize", "gradation_curve")}
    for k in ("clahe_hist", "clahe_curves", "clahe_apply"):
        spatial_from[k] = (spatial_run["counts"][f"CLAHE + linear, 1x4 on {dev}"],
                           f"{sp_path}, enable_clahe and grad_with_linear_image")
    spatial_from["grad_hist"] = (spatial_run["counts"]["600 1x4"],
                                 f"process_sharded of 600^2 over 1x4 on {dev}")
    spatial_from["sdev_noise_hist"] = (spatial_run["counts"][f"fused-sdev, 1x4 on {dev}"],
                                       f"{sp_path}, fused_sdev=True")
    # one launch on the window of the second of 4 shards at 3072 (its rows
    # and halos as spatial.forward passes them), per kernel with a window
    plan4 = spatial.row_plan(SIZE, 4, cfg)
    a1, b1 = plan4.rows(0, 1)
    c0, c1 = noise.cnr_rows(cnr.shape[-1], SIZE, a1, b1)
    lv_rows = [plan4.rows(k, 1) for k in cfg.analysis_levels]
    lv_wins = [sd[a:b] for sd, (a, b) in zip(lv3072, lv_rows)]
    jr, wr = clahe.clahe_joint_bins_rows(v_recon[a1:b1], v_rel[a1:b1], a1, SIZE, cfg_var)
    vc0, vc1 = noise.cnr_rows(v_cnr.shape[-1], SIZE, a1, b1)
    k7_win = k7_windows(plan4, b3072, cfg, 1)
    # KP1: level 1's rows of shard 1 from level 0's; KP2: shard 1's level-0
    # rows from level 1's
    d0, d1 = plan4.rows(1, 1)
    dlo, dhi = pyramid.needed_rows("smooth_downsample", SIZE, d0, d1)
    ulo, uhi = pyramid.needed_rows("upsample_smooth", SIZE, a1, b1)
    # KA: every level's rows of shard 1 (the replicated levels whole), the
    # CNR rows each noise-reduced level reads
    ka_rows = [plan4.rows(k, 1) if k < plan4.replicated else (0, plan4.sizes[k])
               for k in range(cfg.pyramid_levels)]
    ka_b, ka_s, ka_mb, ka_cn = ka_in["float32"]
    ka_cnrs = {}
    for k in k_ka.nr_levels(cfg, False):
        lo, hi = noise.cnr_rows(ka_cn.shape[-1], plan4.sizes[k], *ka_rows[k])
        ka_cnrs[k] = (ka_cn[lo:hi], lo)
    ka_wb = [ka_b[k][r0:r1] for k, (r0, r1) in enumerate(ka_rows)]
    ka_ws = {k: ka_s[k][r0:r1] for k, (r0, r1) in enumerate(ka_rows) if k in ka_s}
    windows = {
        "contrast_apply": lambda: k_ka.contrast_apply(ka_wb, ka_ws, ka_mb, ka_cnrs, cfg,
                                                      [r0 for r0, _ in ka_rows]),
        "noise_hist": lambda: fh.noise_hists_rows(lv_wins, [a for a, _ in lv_rows], cfg),
        "grad_hist_relevant": lambda: fh.grad_hist_relevant(recon[a1:b1], nrm[a1:b1],
                                                            cnr[c0:c1], cfg, a1, c0),
        "grad_hist": lambda: fh.grad_hist(linear[a1:b1], v_rel[a1:b1], cfg_var, a1),
        "histogram": lambda: k_hist.histogram(jr, wr, nb),
        "clahe_apply": lambda: k_clahe.clahe_apply(v_recon[a1:b1], v_px, v_py, cfg_var, a1),
        "clahe_hist": lambda: k_kh.clahe_hist(v_recon[a1:b1], v_nrm[a1:b1], v_cnr[vc0:vc1],
                                              cfg_var, a1, vc0),
        "sdev_noise_hist": lambda: fh.sdev_noise_hists_rows(*k7_win[:3], cfg, k7_win[3]),
        "pyramid_down": lambda: k_pyr.smooth_downsample_rows(nrm[dlo:dhi], dlo, SIZE, d0, d1),
        "pyramid_up": lambda: k_pyr.upsample_smooth_rows(dn0[ulo:uhi], ulo, SIZE, a1, b1),
        "sdev": lambda: fh.sdevs_rows(*k7_win[:3]),
        "tone_map": lambda: k_tone.tone_map(recon[a1:b1], gpx, gpy, m, a1),
        # the apply pass alone on shard 1's rows, with the image's extrema
        "normalize": lambda: normalize.normalize_from_u16(x_dev[a1:b1], cfg.quirks,
                                                          extrema=(ext[0], ext[1])),
    }
    h_sum = h3072.clone()
    k2_own_ms = cuda_ms(lambda: fh.hist_argmax(h_sum), 20, 2, device_only=True)
    kernels = []
    for name, (kern, plain) in cases.items():
        p_ms = cuda_ms(plain, 5, 1, device_only=True)
        lib_ms = cuda_ms(library[name], 20, 2, device_only=True) if name in library else None
        b_ms, b_by = bounds[name]
        row = {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{SOURCES[name]}",
               "replaces": REPLACES[name]}
        if kern is None:
            # no launch of its own: the main path's K1 launches took it
            k_ms = fold["k1_ms"] - fold["k1_without_argmax_ms"]
            row.update({"launches": launches["noise_hist"],
                        "folded_into": ["noise_hist", "sdev_noise_hist"],
                        "launched_by": "process (one graph replay; inside noise_hist's launch)"})
        else:
            k_ms = cuda_ms(kern, 20, 2, device_only=True)
            counts, path = from_run[name]
            row.update({"launches": counts[name], "launched_by": path})
        row.update({"max_abs_err": rec.err[name], "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        if name == "tone_map":  # the main path's curve: the binary search or the chain
            row["selection"] = "search" if searched(gpx) else "chain"
            extra_kt = ", ".join(f"{k} {row[k]}" for k in ("selection",))
            log(f"  tone_map on the main path's {gpx.shape[0]}-point curve: {extra_kt}")
        row.update(pyr_extra.get(name, {}))
        if kern is None:
            row.update(fold)
            row["k7_argmax_ms"] = fold["k7_ms"] - fold["k7_without_argmax_ms"]
            # its own launch (hist_argmax_kernel) on the spatial path
            row.update({"own_launches": sp_counts["hist_argmax"], "own_ms": k2_own_ms})
        if name in spatial_from:
            counts, path = spatial_from[name]
            row.update({"spatial_launches": counts[name], "spatial_launched_by": path})
        if name in windows:
            row.update({"window_ms": cuda_ms(windows[name], 20, 2, device_only=True),
                        "window": f"rows [{a1}, {b1}) of {SIZE} (shard 1 of 4)"})
        if name in spatial_from and name != "grad_hist":
            # device ms per launch inside the 1x4 replay at 3072 ([4n],
            # profiler spans)
            variant = {"clahe_hist": "CLAHE + linear", "clahe_curves": "CLAHE + linear",
                       "clahe_apply": "CLAHE + linear",
                       "sdev_noise_hist": "fused-sdev"}.get(name, "main")
            row["replay_window_ms"] = spatial_run["window_ms"][variant].get(name)
        extra = ", ".join(f"{k} {row[k]}" for k in ("k7_argmax_ms", "own_ms",
                                                    *pyr_extra.get(name, {}),
                                                    "spatial_launches", "window_ms",
                                                    "replay_window_ms") if k in row)
        log(f"  {name}: kernel {k_ms} ms, plain {p_ms} ms, bound {b_ms} ms ({b_by}), "
            f"one PyTorch call {lib_ms} ms" + (f"; {extra}" if extra else ""))
        kernels.append(row)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--spatial-over-cards"]:
        sys.exit(spatial_over_cards())
    if sys.argv[1:2] == ["--parent"] and len(sys.argv) == 3:
        sys.exit(main(sys.argv[2]))
    if sys.argv[1:]:
        sys.exit(f"usage: {sys.argv[0]} [--parent DIR | --spatial-over-cards]")
    sys.exit(main())
