"""CNR map, noise reduction, and relevance mask.  Port of the JAX package's
``ops/noise.py``.

The CNR image lives at the cnr_level resolution (384^2 for a 3072 input)
and is read at finer resolutions through integer nearest upsampling
(scale = ceil(target/size), idx = x // scale).

On the spatial path (``parallel/spatial.py``) a shard holds a window of
rows: ``row0`` is the window's first global row and ``cnr_row0`` that of
the CNR rows it is given (``cnr_rows`` says which), so every row index and
the relevance border are global and a window equals the whole op's rows.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import f32


def chain_exponent(k: float) -> int:
    """k where ``_pow_maybe_int`` takes its multiply chain (an integer in
    1..8), else 0.  The kernels that compute the relevance mask (K3, KH)
    take the same chain; for 0 they read the block weights that the plain
    version computed with pow (``cuda/fused_hist.py::relevance_weight_plane``)
    instead."""
    return int(k) if float(k).is_integer() and 1 <= int(k) <= 8 else 0


def _pow_maybe_int(x: torch.Tensor, k: float) -> torch.Tensor:
    """x ** k; for small integer k an exact multiply chain, so every backend
    agrees bit for bit (a library pow differs by ulps and flips uint(rel*100)
    weight boundaries, QUIRKS #24)."""
    if chain_exponent(k):
        acc = x
        for _ in range(int(k) - 1):
            acc = acc * x
        return acc
    return x ** float(k)


def img_cnr(sdev: torch.Tensor, max_bin: torch.Tensor, cfg) -> torch.Tensor:
    """cnr = sdev / referenceNoiseLevel / MAX_CNR; the reference noise level
    is clipped to >= 1 bin.  Stepwise f32 rounding as the GLSL evaluates it:
    (maxBin * (1/2048)) * 0.1."""
    inv_bins = 1.0 / cfg.noise_histogram_bins
    ref = max_bin.to(torch.float32) * inv_bins * cfg.max_noise_value
    floor_ref = float(np.float32(inv_bins) * np.float32(cfg.max_noise_value))
    ref = torch.where(ref == 0.0, floor_ref, ref)
    return sdev / ref / f32(cfg.max_cnr_value, sdev)


def cnr_rows(size: int, target: int, r0: int, r1: int) -> tuple:
    """[lo, hi): the rows of a ``size``-px CNR map that rows [r0, r1) of its
    nearest upsample to ``target`` px read."""
    scale = int(math.ceil(target / size))
    return r0 // scale, (r1 - 1) // scale + 1


def nearest_upsample(small: torch.Tensor, target: int, row0: int = 0,
                     rows: Optional[int] = None, small_row0: int = 0) -> torch.Tensor:
    """Integer-scale nearest upsample: scale = ceil(target/size),
    idx = x // scale (a repeat truncated to target).  ``size`` is the small
    image's width; with ``rows`` only the output rows [row0, row0 + rows),
    ``small`` holding the rows [small_row0, ...) of the small image."""
    scale = int(math.ceil(target / small.shape[-1]))
    start = row0 - small_row0 * scale
    rows = target if rows is None else rows
    up = torch.repeat_interleave(small, scale, dim=-2)[..., start:start + rows, :]
    return torch.repeat_interleave(up, scale, dim=-1)[..., :, :target]


def noise_reduction(bandpass: torch.Tensor, cnr: torch.Tensor,
                    low_cnr: float, low_factor: float,
                    high_cnr: float, high_factor: float,
                    cfg, row0: int = 0, cnr_row0: int = 0) -> torch.Tensor:
    """Per-pixel damping/boost from the CNR map.  Quirk preserved: inside
    the ramp the factor is ``m * cnr + lowFactor`` with the ABSOLUTE cnr, so
    the ramp is anchored at cnr = 0 (QUIRKS #13, #14)."""
    cnr_up = nearest_upsample(cnr, bandpass.shape[-1], row0, bandpass.shape[-2],
                              cnr_row0) * cfg.max_cnr_value
    m = float(np.float32((high_factor - low_factor) / (high_cnr - low_cnr)))
    lo_f = float(np.float32(low_factor))
    hi_f = float(np.float32(high_factor))
    factor = torch.where(
        cnr_up < low_cnr, lo_f,
        torch.where(cnr_up > high_cnr, hi_f, m * cnr_up + lo_f))
    return bandpass * factor


def img_relevant(normalized: torch.Tensor, cnr: torch.Tensor,
                 cfg, row0: int = 0, cnr_row0: int = 0) -> torch.Tensor:
    """Relevance mask from CNR + intensity (shaders/img_relevant.comp:27-63):
    ramp (cnr/6)^5 for cnr in [1, 6]; 1.0 for cnr in [6, 256] and pixel
    <= 0.90; 100-px border excluded; else 0."""
    rows, size = normalized.shape[-2], normalized.shape[-1]
    cnr_up = nearest_upsample(cnr, size, row0, rows, cnr_row0) * cfg.max_cnr_value
    xs = torch.arange(size, device=normalized.device)
    b = cfg.relevant_border
    inb = (xs > b) & (xs < size - b)
    inb2d = inb[row0:row0 + rows, None] & inb[None, :]
    lo = cfg.relevant_cnr_low
    top = cfg.relevant_cnr_low + cfg.relevant_cnr_ramp
    ramp_region = (cnr_up >= lo) & (cnr_up <= top) & inb2d
    solid_region = ((cnr_up >= top) & (cnr_up <= cfg.max_cnr_value)
                    & (normalized <= cfg.relevant_max_pixel) & inb2d)
    ramp_val = _pow_maybe_int(cnr_up / f32(top, cnr_up), cfg.relevant_k)
    return torch.where(ramp_region, ramp_val,
                       torch.where(solid_region, 1.0, 0.0))
