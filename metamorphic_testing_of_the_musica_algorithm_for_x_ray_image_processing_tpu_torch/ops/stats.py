"""Local statistics + histograms: sdev (5x5 RMS), the noise histogram with
the reference's per-tile-column ``break`` semantics, and histogram argmax.
Port of the JAX package's ``ops/stats.py`` without its histogram-method zoo:
the histograms go through ``ops/cuda/fused_hist.py``, which launches the
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
    h, w = img.shape[-2], img.shape[-1]
    p = F.pad((img * img).double(), (2, 2, 2, 2))
    tmp = p[..., 0:h, :]
    for m in range(1, 5):
        tmp = tmp + p[..., m:m + h, :]
    s = tmp[..., :, 0:w]
    for n in range(1, 5):
        s = s + tmp[..., :, n:n + w]
    return torch.sqrt(s / torch.full((), 25.0, dtype=s.dtype, device=s.device)
                      ).to(img.dtype)


def coverage(n: int, cfg) -> int:
    """Pixels per axis the noise histogram scans for an [n, n] level: the
    16-px tile dispatch, rounded down to ``cfg.hist_coverage`` in quirks mode
    (integer-division dispatch, QUIRKS #8).  0 means nothing is scanned."""
    tile = cfg.histogram_area_size
    n_pad = -(-n // tile) * tile
    return min(n_pad, cfg.hist_coverage) if cfg.quirks else n_pad


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
    bins = (adjusted * float(n_bins) + 0.5).to(torch.int32)
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


def analysis_noise_hists(sdevs: Dict[int, torch.Tensor], cfg):
    """Noise histogram + first-max argmax for every analysis level at once.

    Returns ``(hists, max_bins)`` dicts keyed by level, as int32 device
    tensors ([n_bins] and 0-d).  One kernel launch covers all levels and one
    more takes the argmaxes, at every size."""
    from .cuda import fused_hist

    levels = list(cfg.analysis_levels)
    hs, mbs = fused_hist.noise_hist_levels([sdevs[i] for i in levels], cfg)
    return ({i: hs[j] for j, i in enumerate(levels)},
            {i: mbs[j] for j, i in enumerate(levels)})


def noise_histogram(sdev: torch.Tensor, cfg) -> torch.Tensor:
    """One level's noise histogram (int32 [n_bins])."""
    from .cuda import fused_hist

    return fused_hist.noise_hist_levels([sdev], cfg)[0][0]


def histogram_max(hist: torch.Tensor):
    """(max_value, max_bin); the first maximum wins and an all-zero
    histogram yields bin 0 (QUIRKS #9).  ``torch.argmax`` returns the first
    maximal index (pinned by tests/test_torch_ops.py)."""
    return hist.amax(dim=-1), torch.argmax(hist, dim=-1).to(torch.int32)
