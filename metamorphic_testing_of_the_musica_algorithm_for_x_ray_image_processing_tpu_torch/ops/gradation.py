"""Gradation (tone) phase: relevance-weighted histogram, histogram-driven
tone-curve synthesis.  Port of the JAX package's ``ops/gradation.py``.

The reference's gradation_curve_generate is a single-thread kernel with
three sequential scans over the 1024-bin histogram; here they are vectorized
prefix reductions on the device (no host round trip):

* weighted mean      -> masked sums, uint32 wrap-around emulated in int64;
* peak in [10, mean) -> masked first-max argmax;
* t0 walk-down / t1 walk-up -> contiguous-run tests via cumulative sums.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import f32
from .curves import bezier_points

F32 = torch.float32
_U32 = 0xFFFFFFFF


def gradation_bins(recon: torch.Tensor, relevant: torch.Tensor, cfg):
    """Per-pixel (bin, weight) of an [n, n] image with the tile-``return``
    quirk (QUIRKS #16, #17): the whole 16x16 tile scan (rows of the tile
    outer, 16 pixels along axis -1 inner) aborts at its first pixel == 0.0.
    bin = trunc(v * 1024); weight = trunc(relevant * 100) as int64; OOB bins
    are dropped atomics.  Pixels past n read as 0.0 (ceil dispatch)."""
    n = recon.shape[-1]
    tile = cfg.histogram_area_size
    cov = -(-n // tile) * tile
    v, r = recon, relevant
    if cov > n:
        v = F.pad(v, (0, cov - n, 0, cov - n))
        r = F.pad(r, (0, cov - n, 0, cov - n))
    t = cov // tile
    zero = (v == 0.0).reshape(t, tile, t, tile).permute(0, 2, 1, 3)
    dead = torch.cumsum(zero.reshape(t, t, tile * tile).to(torch.int32), -1)
    alive = (dead == 0).reshape(t, t, tile, tile).permute(0, 2, 1, 3)
    bins = (v * float(cfg.grad_histogram_bins)).to(torch.int32)  # trunc
    w = (r * 100.0).to(torch.int32).to(torch.int64)
    keep = alive.reshape(cov, cov) & (bins >= 0) & (bins < cfg.grad_histogram_bins)
    w = torch.where(keep, w, 0)
    return bins.reshape(-1), w.reshape(-1)


def gradation_histogram(recon: torch.Tensor, relevant: torch.Tensor,
                        cfg) -> torch.Tensor:
    """Gradation histogram (int32 [1024]) from a relevance image."""
    from .cuda import fused_hist

    return fused_hist.grad_hist(recon, relevant, cfg)


def gradation_histogram_fused_relevance(recon: torch.Tensor,
                                        normalized: torch.Tensor,
                                        cnr: torch.Tensor,
                                        cfg) -> torch.Tensor:
    """Gradation histogram with the relevance mask computed inside the
    kernel (no full-size relevance image).  Taken under the JAX package's
    condition: the CNR scale divides the 16-px tile and n is a multiple of
    16; otherwise the relevance image is made and histogrammed."""
    from . import noise as noise_ops
    from .cuda import fused_hist

    n = recon.shape[-1]
    tile = cfg.histogram_area_size
    scale = int(math.ceil(n / cnr.shape[-1]))
    if tile % scale == 0 and n % tile == 0:
        return fused_hist.grad_hist_relevant(recon, normalized, cnr, cfg)
    relevant = noise_ops.img_relevant(normalized, cnr, cfg)
    return gradation_histogram(recon, relevant, cfg)


def gradation_curve(hist: torch.Tensor, cfg):
    """Tone curve from the gradation histogram
    (shaders/gradation_curve_generate.comp:49-182).

    Returns (px[22], py[22], (t0, ta, t1)) as device tensors.  Quirks
    preserved: uint32 wrap-around of the weighted-mean accumulators (QUIRKS
    #18; computed in int64, masked to 32 bits, which is the same sum modulo
    2^32), integer division for the mean bin, thresholds truncated to int
    (#19, #20)."""
    bins = cfg.grad_histogram_bins
    lowest = cfg.grad_lowest_relevant_bin
    dev = hist.device
    counts = hist.to(torch.int64) // 100
    idx = torch.arange(bins, dtype=torch.int64, device=dev)
    rel = idx >= lowest

    mean_count = torch.where(rel, counts * idx, 0).sum() & _U32
    mean_sum = torch.where(rel, counts, 0).sum() & _U32
    mean_bin = torch.where(mean_sum == 0, 0,
                           mean_count // torch.clamp(mean_sum, min=1))
    mean_hist_pos = mean_bin.to(F32) / f32(bins, hist)
    # int64 holds every value here, the same decisions as a saturating cast
    mean_limit = (mean_hist_pos * float(bins)).to(torch.int64)

    # peak in [lowest, mean_limit), first maximum
    vals = torch.where(rel & (idx < mean_limit), counts, 0)
    max_count = vals.max()
    max_position = torch.where(max_count > 0, torch.argmax(vals), 0)
    low_threshold = (max_count.to(F32) * cfg.grad_low_threshold_frac
                     ).to(torch.int64)

    # t0: largest contiguous >= threshold run ending at max_position
    bad = ((counts < low_threshold) & (idx <= max_position)).to(torch.int64)
    c = torch.cumsum(bad, 0)
    c_prev = torch.cat([c.new_zeros(1), c[:-1]])
    suffix = c.index_select(0, max_position.reshape(1)) - c_prev
    a = (suffix == 0) & (idx >= 1) & (idx <= max_position)
    t0_pos = torch.argmax(a.to(torch.uint8))  # first True
    t0 = torch.where(a.any(), t0_pos.to(F32) * (1.0 / bins), 0.0)

    # t1: longest contiguous > 0 run starting at max_position
    bad2 = ((counts <= 0) & (idx >= max_position)).to(torch.int64)
    b_run = (torch.cumsum(bad2, 0) == 0) & (idx >= max_position)
    t1_pos = torch.where(b_run, idx, -1).max()
    t1 = torch.where(b_run.any(), t1_pos.to(F32) * (1.0 / bins), 0.0)

    ta = max_position.to(F32) * (1.0 / bins)
    zero = f32(0.0, hist)
    one = f32(1.0, hist)
    t0 = torch.maximum(t0 - cfg.grad_t0_backoff, zero)
    t1 = torch.minimum(t1, one)

    m = f32(cfg.grad_slope, hist)
    y_m = f32(cfg.grad_y_mid, hist)
    tf = torch.maximum(-(f32(0.5, hist) / m) + ta, t0)
    seg1 = bezier_points((t0, zero), (tf, zero), (ta, y_m), False)
    m2 = torch.where(tf == t0, y_m / (ta - tf), m)  # slope recomputed if clipped
    ts = (y_m / m2) + ta
    seg2 = bezier_points((ta, y_m), (ts, one), (t1, one), False)

    px = torch.cat([zero[None], seg1[0], seg2[0], one[None]])
    py = torch.cat([zero[None], seg1[1], seg2[1], one[None]])
    return px, py, (t0, ta, t1)
