"""Local statistics + histograms: sdev (5x5 RMS), the noise histogram with
the reference's per-tile-column ``break`` semantics, and histogram argmax.
Port of the JAX package's ``ops/stats.py`` without its histogram-method zoo:
the analysis levels' sdev, the noise histograms (and, on the fused-sdev
path, the sdev with them) go through ``ops/cuda/fused_hist.py`` and
``fixed_histogram`` through ``ops/cuda/histogram.py``; each launches its
CUDA kernel for a CUDA tensor and runs its plain version for a CPU tensor.

The ``break`` quirk (shaders/noise_hist.comp:30-40): each GPU thread scans
16-pixel groups along axis -1 ("tile columns"); the first pixel of a group
that is 0.0, out of range (> 0.1) or maps to bin 0 stops that group's scan.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import f32


def img_sdev(img: torch.Tensor) -> torch.Tensor:
    """5x5 RMS (not mean-subtracted), zero padding at borders (QUIRKS #5).

    The float32 squares are summed left to right in float64 and the RMS is
    rounded to float32 once, as the golden model does (see ops/pyramid.py
    on accumulation)."""
    h = img.shape[-2]
    return img_sdev_rows(img, 0, h, 0, h)


def img_sdev_rows(x: torch.Tensor, x0: int, h: int, r0: int, r1: int) -> torch.Tensor:
    """Rows [r0, r1) of ``img_sdev`` of an [h, w] image, from ``x``, its rows
    [x0, ...) (at least ``pyramid.needed_rows("img_sdev", ...)``): the zero
    padding only past the image's true first and last rows, the same sums
    in the same order, so bit-equal to the whole op's rows."""
    lo, hi = max(r0 - 2, 0), min(r1 + 2, h)
    sq = (x.narrow(-2, lo - x0, hi - lo) * x.narrow(-2, lo - x0, hi - lo)).double()
    p = F.pad(sq, (2, 2, lo - (r0 - 2), (r1 + 2) - hi))
    cnt, w = r1 - r0, x.shape[-1]
    tmp = p[..., 0:cnt, :]
    for m in range(1, 5):
        tmp = tmp + p[..., m:m + cnt, :]
    s = tmp[..., :, 0:w]
    for n in range(1, 5):
        s = s + tmp[..., :, n:n + w]
    return sdev_of_sums(s).to(x.dtype)


def sdev_of_sums(s: torch.Tensor) -> torch.Tensor:
    """``img_sdev``'s last step on float64 sums of 25 squares: the square
    root of a true division by 25, both correctly rounded in float64, then
    rounded to float32 (the golden model's chain, NumPy's IEEE operations)."""
    return sqrt64(s / torch.full((), 25.0, dtype=s.dtype, device=s.device)).to(torch.float32)


def sqrt64(q: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of float64 ``q`` on every device.

    PyTorch's CPU float64 ``sqrt`` (2.13, AVX512) misses the nearest double
    by one step on ~0.9 % of values, where the card's and NumPy's do not; a
    miss moves the float32 sdev where the root lies next to a float32
    midpoint.  So the root r of q's significand m in [0.5, 2) (q = m 2^2k)
    is corrected by its exact residual m - r^2 (Dekker's product: p = r r
    rounded and err = r r - p exactly, from Veltkamp's 26-bit halves of r):
    the root exceeds the midpoint r + u/2 to the next double iff m - r^2 >
    r u, and lies below r - ul/2 iff m - r^2 <= -r ul (u, ul: the steps to
    r's neighbours; both sides are multiples of 2^-106 and where they are
    rounded their difference exceeds |err|).  One step suffices for a start
    within one step of the root.  0, +inf, NaN and negative q take
    ``torch.sqrt``."""
    m, e = torch.frexp(q)  # q = m 2^e, m in [0.5, 1)
    odd = e & 1
    m = torch.where(odd == 1, m * 2.0, m)
    r = torch.sqrt(m)
    u = torch.nextafter(r, torch.full_like(r, 2.0)) - r
    ul = r - torch.nextafter(r, torch.zeros_like(r))
    c = r * 134217729.0  # 2^27 + 1
    hi = c - (c - r)
    lo = r - hi
    p = r * r
    err = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
    d = m - p  # exact: p is within a few steps of m
    r = torch.where(d - r * u > err, r + u, torch.where(d + r * ul <= err, r - ul, r))
    # 2^k from its bits (a normal double for every finite q > 0), exact
    k = ((e - odd) >> 1).to(torch.int64)
    scale = ((k + 1023) << 52).view(torch.float64)
    return torch.where((q > 0) & torch.isfinite(q), r * scale, torch.sqrt(q))


def coverage(n: int, cfg) -> int:
    """Pixels per axis the noise histogram scans for an [n, n] level: the
    tile dispatch (``histogram_area_size``, 16 px in the shaders), rounded
    down to ``cfg.hist_coverage`` in quirks mode (integer-division dispatch,
    QUIRKS #8) and then to whole tiles, as the golden model's tile loop
    does.  0 means nothing is scanned."""
    tile = cfg.histogram_area_size
    n_pad = -(-n // tile) * tile
    return min(n_pad, cfg.hist_coverage) // tile * tile if cfg.quirks else n_pad


def coverage_view(sdev: torch.Tensor, cfg) -> Optional[torch.Tensor]:
    """Crop or zero-pad a level image to its histogram coverage (None when
    the dispatch covers nothing)."""
    n = sdev.shape[-1]
    cov = coverage(n, cfg)
    if cov == 0:
        return None
    if cov > n:
        return F.pad(sdev, (0, cov - n, 0, cov - n))
    return sdev[..., :cov, :cov]


def noise_bins_view(v: torch.Tensor, n_bins: int, tile: int,
                    max_noise: float):
    """Per-pixel (bin, weight) of a coverage view [..., cov, cov], flattened
    over the last two axes, with the tile-column break.  ``/ max_noise`` is a
    true, correctly rounded division (QUIRKS #6, #7).  Weights are int64 0/1;
    a pixel survives iff no break occurs at or before it in its group."""
    adjusted = v / f32(max_noise, v)
    # a NaN sdev is bin 0, a break, as XLA's and the card's conversion give
    # it (PyTorch's CPU conversion gives INT_MIN, and the group went on)
    bf = adjusted * float(n_bins) + 0.5
    bins = torch.where(torch.isnan(bf), 0.0, bf).to(torch.int32)
    brk = (v == 0.0) | (adjusted > 1.0) | (bins == 0)
    groups = brk.reshape(brk.shape[:-1] + (v.shape[-1] // tile, tile))
    alive = (torch.cumsum(groups.to(torch.int32), dim=-1) == 0).reshape(v.shape)
    # bin n_bins is an OOB atomic (dropped); negative bins never occur for
    # an RMS image and are dropped as well
    keep = alive & (bins >= 0) & (bins < n_bins)
    return (bins.reshape(bins.shape[:-2] + (-1,)),
            keep.to(torch.int64).reshape(keep.shape[:-2] + (-1,)))


def noise_bins(sdev: torch.Tensor, cfg):
    """Per-pixel (bin, weight) for one level's noise histogram including the
    break semantics and the dispatch coverage."""
    v = coverage_view(sdev, cfg)
    if v is None:
        z = torch.zeros(sdev.shape[:-2] + (0,), dtype=torch.int64,
                        device=sdev.device)
        return z.to(torch.int32), z
    return noise_bins_view(v, cfg.noise_histogram_bins,
                           cfg.histogram_area_size, cfg.max_noise_value)


def noise_bins_rows(sd: torch.Tensor, row0: int, cfg):
    """``noise_bins`` of the rows [row0, row0 + rows) of an [n, n] level,
    held in ``sd`` [rows, n]: the window's rows inside the coverage, each
    scanned as the whole level's scan scans it (its columns cropped or
    zero-padded to the coverage), so the histograms of a partition of the
    rows sum to the whole level's."""
    n = sd.shape[-1]
    cov = coverage(n, cfg)
    keep = max(0, min(sd.shape[-2], cov - row0))
    v = sd[..., :keep, :]
    v = F.pad(v, (0, cov - n)) if cov > n else v[..., :cov]
    return noise_bins_view(v, cfg.noise_histogram_bins, cfg.histogram_area_size,
                           cfg.max_noise_value)


def fixed_histogram(bins_idx: torch.Tensor, weights: torch.Tensor,
                    n_bins: int) -> torch.Tensor:
    """Weighted histogram of int32 ``bins_idx`` (any shape) into exact int32
    counts [n_bins] (the GLSL histograms are uint32 atomics).  ``weights``
    are integers, possibly as float32; out-of-range bins are dropped
    atomics: their weights are zeroed and their bins clamped.  One kernel
    launch on a CUDA device, the plain scatter-add on the CPU."""
    from .cuda import histogram

    return histogram.histogram(bins_idx, weights, n_bins)


def analysis_sdevs(bands: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
    """``img_sdev`` of every analysis level's float32 bandpass image
    (``bands`` keyed by level), keyed by level: one kernel launch (KS) on a
    CUDA device, ``img_sdev`` a level on the CPU; equal bit for bit."""
    from .cuda import fused_hist

    levels = list(bands)
    return dict(zip(levels, fused_hist.sdevs([bands[i] for i in levels])))


def analysis_noise_hists(sdevs: Dict[int, torch.Tensor], cfg):
    """Noise histogram + first-max argmax for every analysis level at once.

    Returns ``(hists, max_bins)`` dicts keyed by level, as int32 device
    tensors ([n_bins] and 0-d).  One kernel launch covers all levels and
    their argmaxes, at every size."""
    from .cuda import fused_hist

    levels = list(cfg.analysis_levels)
    hs, mbs = fused_hist.noise_hists([sdevs[i] for i in levels], cfg)
    return ({i: hs[j] for j, i in enumerate(levels)},
            {i: mbs[j] for j, i in enumerate(levels)})


def sdev_and_noise_histograms(bands, cfg):
    """sdev, noise histogram and first-max argmax of every analysis level
    from its float32 bandpass image (``bands[i]`` for each level ``i``):
    the counterpart of the JAX package's ``sdev_and_noise_histogram`` plus
    ``histogram_max``, its ``hist_method="fused_sdev"`` path.

    Returns ``(sdevs, hists, max_bins)`` dicts keyed by level.  One kernel
    launch computes every level's sdev, histogram and argmax, at every size
    (the JAX package's kernel needs full coverage and falls back to two
    steps elsewhere; this one needs no fallback).  The results equal
    ``img_sdev`` + ``analysis_noise_hists`` exactly."""
    from .cuda import fused_hist

    levels = list(cfg.analysis_levels)
    sds, hs, mbs = fused_hist.sdev_noise_hists([bands[i] for i in levels], cfg)
    return ({i: sds[j] for j, i in enumerate(levels)},
            {i: hs[j] for j, i in enumerate(levels)},
            {i: mbs[j] for j, i in enumerate(levels)})


def sdev_and_noise_histogram(band: torch.Tensor, cfg, fused_sdev: bool = False):
    """(sdev, noise histogram) of one bandpass level, the JAX package's
    function of the same name: ``img_sdev`` and K1, or with ``fused_sdev``
    K7 (both outputs in one launch), as ``sdev_and_noise_histograms`` does
    for every level.  Equal either way."""
    if fused_sdev:
        from .cuda import fused_hist

        sds, hs, _ = fused_hist.sdev_noise_hists([band], cfg)
        return sds[0], hs[0]
    sd = img_sdev(band)
    return sd, noise_histogram(sd, cfg)


def noise_histogram(sdev: torch.Tensor, cfg) -> torch.Tensor:
    """One level's noise histogram (int32 [n_bins])."""
    from .cuda import fused_hist

    return fused_hist.noise_hists([sdev], cfg)[0][0]


def histogram_max(hist: torch.Tensor):
    """(max_value, max_bin); the first maximum wins and an all-zero
    histogram yields bin 0 (QUIRKS #9).  ``torch.argmax`` returns the first
    maximal index (pinned by tests/test_torch_ops.py)."""
    return hist.amax(dim=-1), torch.argmax(hist, dim=-1).to(torch.int32)
