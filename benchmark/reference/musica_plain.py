"""The benchmark's plain reference of the MUSICA pipeline: one [n, n] integer
radiograph in, the margin-cropped uint8 image out (and, with CLAHE on, the
CLAHE-graded float32 image), in plain PyTorch on any device.

A frozen copy of the port's plain chain, the functions named ``*_plain`` in
its ``ops`` and ``ops/cuda`` modules and what they call, as they run on a
CPU tensor.  It imports nothing of the port and nothing of JAX: the
configuration comes in as the plain field dict of ``benchmark/configs/*.json``
and its derived schedules are computed here again.  Later changes to the
port do not change it; the benchmark holds the port's outputs to it.

Numerics (each kept from the port's plain versions, which the port's tests
hold bit for bit to the golden NumPy model and its kernels):

* stencils (the pyramid's smooth, the 5x5 sdev) sum in float64 in a fixed
  tap order and round to float32 once;
* square roots are correctly rounded (float64 root rounded to float32;
  float64 roots corrected by their exact residual, ``sqrt64``);
* divisions by a constant divide by a 0-d device tensor (``_f32``): CUDA's
  ``tensor / python_float`` multiplies by the reciprocal;
* histograms are exact integer scatter-adds; a NaN converts to bin 0.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
I32 = torch.int32
_U32 = 0xFFFFFFFF


# ----------------------------------------------------------------------
# configuration: the fields and the derived schedules
# ----------------------------------------------------------------------

class PlainConfig:
    """The configuration's fields as attributes, with the schedules that
    the reference CLI derives from them (``src/vk_processing.cpp:259-331``,
    ``:1989``, ``:2284``, ``:2292``)."""

    def __init__(self, fields: Dict[str, object]):
        self.__dict__.update(fields)
        if self.storage not in ("float32", "bfloat16"):
            raise ValueError(f"storage={self.storage!r}")
        n = self.image_size
        self.pyramid_levels = int(math.ceil(math.log2(n)))
        sizes = [n]
        for _ in range(self.pyramid_levels):
            sizes.append(-(-sizes[-1] // 2))
        self.level_sizes = tuple(sizes)
        self.contrast_factors = self._contrast_factors()
        lo_f, hi_f = self.nr_min_low_factor, self.nr_max_high_factor
        self.noise_reduction_params = tuple(
            (self.nr_low_cnr, float(lo_f + (1.0 - lo_f) * (lv / self.cnr_level)),
             self.nr_high_cnr, float(hi_f - (hi_f - 1.0) * (lv / self.cnr_level)))
            for lv in range(self.cnr_level))
        self.analysis_levels = tuple(i for i in range(self.pyramid_levels)
                                     if i < self.coarser_levels_start or i <= self.cnr_level)
        self.hist_coverage = (n // self.hist_workgroup_coverage * self.hist_workgroup_coverage
                              if self.quirks else n)

    def _contrast_factors(self):
        out = []
        levels, coarser = self.pyramid_levels, self.coarser_levels_start
        for i in range(levels):
            if self.linear_high_contrast:
                hcf = (1.0 if i < coarser else
                       1.0 - (i - coarser) * (1.0 - self.high_contrast_max_reduction)
                       / (levels - coarser - 1))
            else:
                hcf = (1.0 if i < coarser else
                       self.high_contrast_max_reduction ** ((i - coarser) / (levels - coarser - 1)))
            if self.linear_low_contrast:
                lcf = (self.low_contrast_max_enhancement
                       - i * ((self.low_contrast_max_enhancement - 1.0) / coarser)
                       if i < coarser else 1.0)
            else:
                lcf = (self.low_contrast_max_enhancement ** (1.0 - i / coarser)
                       if i < coarser else 1.0)
            out.append((float(lcf), float(hcf)))
        return tuple(out)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=F32, device=like.device)


# ----------------------------------------------------------------------
# normalize
# ----------------------------------------------------------------------

def _sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).to(F32)


def _chain_misaligned(n: int, area: int = 8) -> bool:
    while n > 1:
        if n % area != 0:
            return True
        n = -(-n // area)
    return False


def normalize(img_u16: torch.Tensor, quirks: bool):
    """(normalized, vmax, vmin): the sqrt image rescaled by the quirk-exact
    global extrema (QUIRKS #1-#3)."""
    x = img_u16.to(F32)
    vmax, vmin = _sqrt(x.amax()), _sqrt(x.amin())
    if quirks:
        vmax = torch.trunc(vmax)
        misaligned = _chain_misaligned(img_u16.shape[-1]) or _chain_misaligned(img_u16.shape[-2])
        vmin = torch.zeros_like(vmin) if misaligned else torch.trunc(vmin)
    out = (_sqrt(x) - vmin) / (vmax - vmin)
    if not quirks:
        out = out.clamp(0.0, 1.0)
    return out, vmax, vmin


# ----------------------------------------------------------------------
# pyramid
# ----------------------------------------------------------------------

_W = [float(w) for w in np.array([0.25 - 0.3 / 2, 0.25, 0.3, 0.25, 0.25 - 0.3 / 2],
                                 dtype=np.float32)]
_WE = (_W[0], _W[2], _W[4])
_WO = (_W[1], _W[3])


def _mirror_idx(n: int):
    idx = np.empty(n + 4, dtype=np.int64)
    valid = np.empty(n + 4, dtype=np.float32)
    for k in range(-2, n + 2):
        v = k
        if v > n - 1:
            v = (n - 1) - (v - (n - 1))
        elif v < 0:
            v = -v
        ok = 0 <= v <= n - 1
        idx[k + 2] = v if ok else 0
        valid[k + 2] = 1.0 if ok else 0.0
    return idx, valid


def _mirror_pad(img: torch.Tensor) -> torch.Tensor:
    out = img
    for axis in (img.ndim - 2, img.ndim - 1):
        n = img.shape[axis]
        idx, valid = _mirror_idx(n)

        def tap(k):
            if valid[k + 2]:
                return out.narrow(axis, int(idx[k + 2]), 1)
            return torch.zeros_like(out.narrow(axis, 0, 1))

        out = torch.cat([tap(-2), tap(-1), out, tap(n), tap(n + 1)], dim=axis)
    return out


def _smooth(img: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    h, w = img.shape[-2], img.shape[-1]
    p = _mirror_pad(img.double())
    tmp = _W[0] * p[..., 0:h, :]
    for m in range(1, 5):
        tmp = tmp + _W[m] * p[..., m:m + h, :]
    out = _W[0] * tmp[..., :, 0:w]
    for n in range(1, 5):
        out = out + _W[n] * tmp[..., :, n:n + w]
    if gain != 1.0:
        out = out * gain
    return out.to(img.dtype)


def _slice(a: torch.Tensor, axis: int, start: int, stop: int, step: int = 1):
    s = [slice(None)] * a.ndim
    s[axis] = slice(start, stop, step)
    return a[tuple(s)]


def _decimate_axis(a: torch.Tensor, axis: int, n: int, dn: int) -> torch.Tensor:
    idx, valid = _mirror_idx(n)

    def tap_rows(positions):
        total = None
        for m, pos in enumerate(positions):
            row = a.narrow(axis, int(idx[pos + 2]), 1)
            row = row * float(np.float32(_W[m]) * valid[pos + 2])
            total = row if total is None else total + row
        return total

    first = tap_rows([-2, -1, 0, 1, 2])
    last = tap_rows([2 * (dn - 1) + m - 2 for m in range(5)])
    interior = _W[0] * _slice(a, axis, 0, 2 * (dn - 2) - 1, 2)
    for m in range(1, 5):
        interior = interior + _W[m] * _slice(a, axis, m, m + 2 * (dn - 2) - 1, 2)
    return torch.cat([first, interior, last], dim=axis)


def smooth_downsample(img: torch.Tensor) -> torch.Tensor:
    """Smooth then decimate by 2, the smooth evaluated at even coordinates."""
    h, w = img.shape[-2], img.shape[-1]
    dh, dw = -(-h // 2), -(-w // 2)
    ra, ca = img.ndim - 2, img.ndim - 1
    x = img.double()
    if h < 8 or w < 8:
        p = _mirror_pad(x)
        tmp = _W[0] * _slice(p, ra, 0, 2 * dh - 1, 2)
        for m in range(1, 5):
            tmp = tmp + _W[m] * _slice(p, ra, m, m + 2 * dh - 1, 2)
        out = _W[0] * _slice(tmp, ca, 0, 2 * dw - 1, 2)
        for n in range(1, 5):
            out = out + _W[n] * _slice(tmp, ca, n, n + 2 * dw - 1, 2)
        return out.to(img.dtype)
    tmp = _decimate_axis(x, ra, h, dh)
    return _decimate_axis(tmp, ca, w, dw).to(img.dtype)


def _upsample(img: torch.Tensor, out_size: int) -> torch.Tensor:
    src = -(-out_size // 2)
    out = img.new_zeros(img.shape[:-2] + (2 * src, 2 * src))
    out[..., ::2, ::2] = img[..., :src, :src]
    return out[..., :out_size, :out_size]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int, total: int) -> torch.Tensor:
    if b.shape[axis] < a.shape[axis]:
        pad_shape = list(b.shape)
        pad_shape[axis] = a.shape[axis] - b.shape[axis]
        b = torch.cat([b, b.new_zeros(pad_shape)], dim=axis)
    st = torch.stack([a, b], dim=axis + 1)
    shape = list(a.shape)
    shape[axis] = 2 * a.shape[axis]
    return _slice(st.reshape(shape), axis, 0, total)


def _phase_conv(a: torch.Tensor, axis: int, n: int, edge: int):
    n_even, n_odd = -(-n // 2), n // 2
    e = torch.cat([a.narrow(axis, 1, 1), a, a.narrow(axis, edge, 1)], dim=axis)
    ph0 = (_WE[0] * e.narrow(axis, 0, n_even) + _WE[1] * e.narrow(axis, 1, n_even)
           + _WE[2] * e.narrow(axis, 2, n_even))
    ph1 = _WO[0] * e.narrow(axis, 1, n_odd) + _WO[1] * e.narrow(axis, 2, n_odd)
    return ph0, ph1


def upsample_smooth(img: torch.Tensor, out_size: int) -> torch.Tensor:
    """Zero-stuff x2 then smooth with gain 4 (the expand step), in the
    polyphase form where it applies."""
    n = out_size
    src = -(-n // 2)
    if not (n >= 6 and src >= 3) or img.shape[-1] < 3 or img.shape[-2] < 3:
        return _smooth(_upsample(img, out_size), gain=4.0)
    r = img[..., :src, :src].double()
    edge = n - 1 - src
    ra, ca = r.ndim - 2, r.ndim - 1
    r0, r1 = _phase_conv(r, ra, n, edge)
    a00, a01 = _phase_conv(r0, ca, n, edge)
    a10, a11 = _phase_conv(r1, ca, n, edge)
    a00, a01, a10, a11 = (a.to(img.dtype) * 4.0 for a in (a00, a01, a10, a11))
    return _interleave(_interleave(a00, a01, ca, n), _interleave(a10, a11, ca, n), ra, n)


def reduce_ladder(normalized: torch.Tensor, levels: int):
    bandpass, downs = [], []
    cur = normalized
    for _ in range(levels):
        dn = smooth_downsample(cur)
        bandpass.append(cur - upsample_smooth(dn, cur.shape[-1]))
        downs.append(dn)
        cur = dn
    return bandpass, downs


def expand_ladder(top: torch.Tensor, bands) -> torch.Tensor:
    recon = top
    for band in reversed(list(bands)):
        recon = upsample_smooth(recon, band.shape[-1]) + band.float()
    return recon


# ----------------------------------------------------------------------
# analysis: sdev, noise histograms
# ----------------------------------------------------------------------

def sqrt64(q: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float64 square root on every device (the root
    of q's significand corrected by its exact residual)."""
    m, e = torch.frexp(q)
    odd = e & 1
    m = torch.where(odd == 1, m * 2.0, m)
    r = torch.sqrt(m)
    u = torch.nextafter(r, torch.full_like(r, 2.0)) - r
    ul = r - torch.nextafter(r, torch.zeros_like(r))
    c = r * 134217729.0
    hi = c - (c - r)
    lo = r - hi
    p = r * r
    err = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
    d = m - p
    r = torch.where(d - r * u > err, r + u, torch.where(d + r * ul <= err, r - ul, r))
    k = ((e - odd) >> 1).to(torch.int64)
    scale = ((k + 1023) << 52).view(torch.float64)
    return torch.where((q > 0) & torch.isfinite(q), r * scale, torch.sqrt(q))


def img_sdev(img: torch.Tensor) -> torch.Tensor:
    """5x5 RMS, zero padding at the borders (QUIRKS #5), float64 sums."""
    h, w = img.shape[-2], img.shape[-1]
    p = F.pad((img * img).double(), (2, 2, 2, 2))
    tmp = p[..., 0:h, :]
    for m in range(1, 5):
        tmp = tmp + p[..., m:m + h, :]
    s = tmp[..., :, 0:w]
    for n in range(1, 5):
        s = s + tmp[..., :, n:n + w]
    q = s / torch.full((), 25.0, dtype=s.dtype, device=s.device)
    return sqrt64(q).to(F32).to(img.dtype)


def histogram(bins: torch.Tensor, weights: torch.Tensor, n_bins: int) -> torch.Tensor:
    b = bins.reshape(-1).to(torch.int64)
    w = weights.reshape(-1).to(torch.int64)
    in_range = (b >= 0) & (b < n_bins)
    h = torch.zeros(n_bins, dtype=torch.int64, device=bins.device)
    h.scatter_add_(0, b.clamp(0, n_bins - 1), torch.where(in_range, w, 0))
    return h.to(I32)


def _coverage(n: int, cfg) -> int:
    tile = cfg.histogram_area_size
    n_pad = -(-n // tile) * tile
    return min(n_pad, cfg.hist_coverage) // tile * tile if cfg.quirks else n_pad


def noise_histogram(sdev: torch.Tensor, cfg) -> torch.Tensor:
    """One level's noise histogram with the tile-column break (QUIRKS
    #6-#8)."""
    n_bins, tile = cfg.noise_histogram_bins, cfg.histogram_area_size
    n = sdev.shape[-1]
    cov = _coverage(n, cfg)
    if cov == 0:
        return torch.zeros(n_bins, dtype=I32, device=sdev.device)
    v = F.pad(sdev, (0, cov - n, 0, cov - n)) if cov > n else sdev[..., :cov, :cov]
    adjusted = v / _f32(cfg.max_noise_value, v)
    bf = adjusted * float(n_bins) + 0.5
    bins = torch.where(torch.isnan(bf), 0.0, bf).to(I32)
    brk = (v == 0.0) | (adjusted > 1.0) | (bins == 0)
    groups = brk.reshape(brk.shape[:-1] + (v.shape[-1] // tile, tile))
    alive = (torch.cumsum(groups.to(I32), dim=-1) == 0).reshape(v.shape)
    keep = alive & (bins >= 0) & (bins < n_bins)
    return histogram(bins, keep.to(torch.int64), n_bins)


# ----------------------------------------------------------------------
# CNR, noise reduction, relevance
# ----------------------------------------------------------------------

def _pow_maybe_int(x: torch.Tensor, k: float) -> torch.Tensor:
    if float(k).is_integer() and 1 <= int(k) <= 8:
        acc = x
        for _ in range(int(k) - 1):
            acc = acc * x
        return acc
    return x ** float(k)


def img_cnr(sdev: torch.Tensor, max_bin: torch.Tensor, cfg) -> torch.Tensor:
    inv_bins = 1.0 / cfg.noise_histogram_bins
    ref = max_bin.to(F32) * inv_bins * cfg.max_noise_value
    floor_ref = float(np.float32(inv_bins) * np.float32(cfg.max_noise_value))
    ref = torch.where(ref == 0.0, floor_ref, ref)
    return sdev / ref / _f32(cfg.max_cnr_value, sdev)


def nearest_upsample(small: torch.Tensor, target: int) -> torch.Tensor:
    scale = int(math.ceil(target / small.shape[-1]))
    up = torch.repeat_interleave(small, scale, dim=-2)[..., :target, :]
    return torch.repeat_interleave(up, scale, dim=-1)[..., :, :target]


def noise_reduction(bandpass, cnr, low_cnr, low_factor, high_cnr, high_factor, cfg):
    """The CNR ramp anchored at cnr = 0 (QUIRKS #13, #14)."""
    cnr_up = nearest_upsample(cnr, bandpass.shape[-1]) * cfg.max_cnr_value
    m = float(np.float32((high_factor - low_factor) / (high_cnr - low_cnr)))
    lo_f, hi_f = float(np.float32(low_factor)), float(np.float32(high_factor))
    factor = torch.where(cnr_up < low_cnr, lo_f,
                         torch.where(cnr_up > high_cnr, hi_f, m * cnr_up + lo_f))
    return bandpass * factor


def img_relevant(normalized: torch.Tensor, cnr: torch.Tensor, cfg) -> torch.Tensor:
    size = normalized.shape[-1]
    cnr_up = nearest_upsample(cnr, size) * cfg.max_cnr_value
    xs = torch.arange(size, device=normalized.device)
    b = cfg.relevant_border
    inb = (xs > b) & (xs < size - b)
    inb2d = inb[:, None] & inb[None, :]
    lo = cfg.relevant_cnr_low
    top = cfg.relevant_cnr_low + cfg.relevant_cnr_ramp
    ramp_region = (cnr_up >= lo) & (cnr_up <= top) & inb2d
    solid_region = ((cnr_up >= top) & (cnr_up <= cfg.max_cnr_value)
                    & (normalized <= cfg.relevant_max_pixel) & inb2d)
    ramp_val = _pow_maybe_int(cnr_up / _f32(top, cnr_up), cfg.relevant_k)
    return torch.where(ramp_region, ramp_val, torch.where(solid_region, 1.0, 0.0))


# ----------------------------------------------------------------------
# curves
# ----------------------------------------------------------------------

def bezier_points(start, middle, end, inclusive: bool):
    sx, sy = start
    mx, my = middle
    ex, ey = end
    t = torch.arange(11 if inclusive else 10, dtype=F32, device=sx.device) / _f32(10.0, sx)
    xa, ya = sx + (mx - sx) * t, sy + (my - sy) * t
    xb, yb = mx + (ex - mx) * t, my + (ey - my) * t
    return xa + (xb - xa) * t, ya + (yb - ya) * t


def contrast_curve(max_bin: torch.Tensor, lcf_v: float, hcf_v: float, cfg):
    """Per-level contrast LUT (QUIRKS #10)."""
    one = _f32(1.0, max_bin)
    hcf = _f32(hcf_v, max_bin)
    if lcf_v == 1.0:
        return torch.stack([one * 0.0, one]), torch.stack([hcf, hcf])
    lcf = _f32(lcf_v, max_bin)
    five = _f32(5.0, max_bin)
    p = max_bin.to(F32) * (1.0 / cfg.noise_histogram_bins) * cfg.max_noise_value
    p45, p65, p75 = p * 4.0 / five, p * 6.0 / five, p * 7.0 / five
    l45 = lcf * 4.0 / five
    s1 = bezier_points((one * 0.0, one), (p45, lcf), (p, lcf), True)
    s2 = bezier_points((p, lcf), (p65, lcf), (p75, l45), True)
    s3 = bezier_points((p75, l45), (p * 2.0, one), (one, one), True)
    return torch.cat([s1[0], s2[0], s3[0]]), torch.cat([s1[1], s2[1], s3[1]])


def curve_get_y_sorted(px, py, x):
    n = px.shape[0]
    ms = (py[1:] - py[:-1]) / (px[1:] - px[:-1])
    cnt = torch.searchsorted(px, x.contiguous())
    sel = (cnt - 1).clamp(0, n - 2)
    result = torch.take(ms, sel) * (x - torch.take(px, sel)) + torch.take(py, sel)
    result = torch.where(cnt > 0, result, torch.where(x == px[0], py[0], 0.0))
    return torch.where(cnt == n, 0.0, result)


def curve_get_y_general(px, py, x):
    """First-match getY for any px (the gradation curve may fold back)."""
    n = px.shape[0]
    zero = px.new_zeros(1)
    px_e, py_e = torch.cat([px, zero]), torch.cat([py, zero])
    ms = (py_e[1:] - py_e[:-1]) / (px_e[1:] - px_e[:-1])
    nonmono = px_e[1:] <= px_e[:-1]
    m_tab = torch.cat([torch.where(nonmono, 0.0, ms), zero])
    px_hi = torch.where(nonmono, px_e[:-1], px_e[1:])
    x = torch.where(torch.isfinite(x), x, 3.0e38)
    sel = torch.full(x.shape, n, dtype=torch.int64, device=x.device)
    for i in range(n - 1, -1, -1):
        sel = torch.where((px_e[i] <= x) & (x <= px_hi[i]), i, sel)
    return torch.take(m_tab, sel) * (x - torch.take(px_e, sel)) + torch.take(py_e, sel)


def curve_apply_u8(g: torch.Tensor) -> torch.Tensor:
    """clip(trunc(255 y)) as uint8 (QUIRKS #22)."""
    return torch.clamp(torch.trunc(255.0 * g), 0.0, 255.0).to(torch.uint8)


# ----------------------------------------------------------------------
# contrast stage: curves, apply, noise reduction
# ----------------------------------------------------------------------

def contrast_apply(bands, sdevs, max_bins, cnr, cfg):
    """The bands the expand reads: each level's contrast-applied band (the
    flat gain hcf where no sdev is computed), noise-reduced on the levels
    below ``cnr_level - 1``, stored in the bands' dtype."""
    sd = bands[0].dtype
    no_bin = torch.zeros((), dtype=I32, device=bands[0].device)
    curve_list = [contrast_curve(max_bins.get(k, no_bin), lcf, hcf, cfg)
                  for k, (lcf, hcf) in enumerate(cfg.contrast_factors)]
    out = []
    for k in range(len(bands)):
        if k in sdevs:
            e = bands[k].float() * curve_get_y_sorted(*curve_list[k], sdevs[k])
        else:
            e = bands[k].float() * cfg.contrast_factors[k][1]
        e = e.to(sd)
        if k < cfg.cnr_level - 1:
            lo_c, lo_f, hi_c, hi_f = cfg.noise_reduction_params[k]
            e = noise_reduction(e.float(), cnr, lo_c, lo_f, hi_c, hi_f, cfg).to(sd)
        out.append(e)
    return out


# ----------------------------------------------------------------------
# gradation
# ----------------------------------------------------------------------

def gradation_histogram(recon: torch.Tensor, relevant: torch.Tensor, cfg) -> torch.Tensor:
    """The 1024-bin histogram weighted by trunc(relevant * 100), each 16x16
    tile's scan ending at its first 0.0 (QUIRKS #16, #17)."""
    h, n = recon.shape[-2], recon.shape[-1]
    tile = cfg.histogram_area_size
    cov, cov_h = -(-n // tile) * tile, -(-h // tile) * tile
    v, r = recon, relevant
    if cov > n or cov_h > h:
        v = F.pad(v, (0, cov - n, 0, cov_h - h))
        r = F.pad(r, (0, cov - n, 0, cov_h - h))
    t, th = cov // tile, cov_h // tile
    zero = (v == 0.0).reshape(th, tile, t, tile).permute(0, 2, 1, 3)
    dead = torch.cumsum(zero.reshape(th, t, tile * tile).to(I32), -1)
    alive = (dead == 0).reshape(th, t, tile, tile).permute(0, 2, 1, 3)
    bf = v * float(cfg.grad_histogram_bins)
    bins = torch.where(torch.isnan(bf), 0.0, bf).to(I32)
    w = (r * 100.0).to(I32).to(torch.int64)
    keep = alive.reshape(cov_h, cov) & (bins >= 0) & (bins < cfg.grad_histogram_bins)
    w = torch.where(keep, w, 0)
    return histogram(bins, w, cfg.grad_histogram_bins)


def gradation_curve(hist: torch.Tensor, cfg):
    """The tone curve (px[22], py[22]) from the histogram, with the uint32
    quirks (QUIRKS #18-#20)."""
    bins, lowest = cfg.grad_histogram_bins, cfg.grad_lowest_relevant_bin
    dev = hist.device
    counts = (hist.to(torch.int64) & _U32) // 100
    idx = torch.arange(bins, dtype=torch.int64, device=dev)
    rel = idx >= lowest
    mean_count = torch.where(rel, counts * idx, 0).sum() & _U32
    mean_sum = torch.where(rel, counts, 0).sum() & _U32
    mean_bin = torch.where(mean_sum == 0, 0, mean_count // torch.clamp(mean_sum, min=1))
    mean_limit = ((mean_bin.to(F32) / _f32(bins, hist)) * float(bins)).to(torch.int64)
    vals = torch.where(rel & (idx < mean_limit), counts, 0)
    max_count = vals.max()
    max_position = torch.where(max_count > 0, torch.argmax(vals), 0)
    low_threshold = (max_count.to(F32) * cfg.grad_low_threshold_frac).to(torch.int64)
    bad = ((counts < low_threshold) & (idx <= max_position)).to(torch.int64)
    c = torch.cumsum(bad, 0)
    c_prev = torch.cat([c.new_zeros(1), c[:-1]])
    suffix = c.index_select(0, max_position.reshape(1)) - c_prev
    a = (suffix == 0) & (idx >= 1) & (idx <= max_position)
    t0 = torch.where(a.any(), torch.argmax(a.to(torch.uint8)).to(F32) * (1.0 / bins), 0.0)
    bad2 = ((counts <= 0) & (idx >= max_position)).to(torch.int64)
    b_run = (torch.cumsum(bad2, 0) == 0) & (idx >= max_position)
    t1_pos = torch.where(b_run, idx, -1).max()
    t1 = torch.where(b_run.any(), t1_pos.to(F32) * (1.0 / bins), 0.0)
    ta = max_position.to(F32) * (1.0 / bins)
    zero, one = _f32(0.0, hist), _f32(1.0, hist)
    t0 = torch.maximum(t0 - cfg.grad_t0_backoff, zero)
    t1 = torch.minimum(t1, one)
    m = _f32(cfg.grad_slope, hist)
    y_m = _f32(cfg.grad_y_mid, hist)
    tf = torch.maximum(-(_f32(0.5, hist) / m) + ta, t0)
    seg1 = bezier_points((t0, zero), (tf, zero), (ta, y_m), False)
    m2 = torch.where(tf == t0, y_m / (ta - tf), m)
    ts = (y_m / m2) + ta
    seg2 = bezier_points((ta, y_m), (ts, one), (t1, one), False)
    return (torch.cat([zero[None], seg1[0], seg2[0], one[None]]),
            torch.cat([zero[None], seg1[1], seg2[1], one[None]]))


# ----------------------------------------------------------------------
# CLAHE
# ----------------------------------------------------------------------

def clahe_histograms(recon: torch.Tensor, relevant: torch.Tensor, cfg) -> torch.Tensor:
    """[t, t, bins] histograms of the pixels with relevant == 1.0."""
    t, bins = cfg.clahe_tiles, cfg.clahe_bins
    n = recon.shape[-1]
    bf = recon * float(bins - 1) + 0.5
    b = torch.where(torch.isnan(bf), 0.0, bf).to(I32)
    xs = (torch.arange(n, dtype=F32, device=recon.device) / _f32(n, recon) * float(t)).to(I32)
    tile_id = xs[:, None] * t + xs[None, :]
    in_range = (b >= 0) & (b < bins)
    joint = torch.where(in_range, b + tile_id * bins, 0)
    w = torch.where(in_range, (relevant == 1.0).to(I32), 0)
    return histogram(joint, w, t * t * bins).reshape(t, t, bins)


def clahe_curves(hists: torch.Tensor, cfg):
    """Per-tile clipped CDFs py [t, t, bins], summed in float64 (exact)."""
    bins = cfg.clahe_bins
    counts = hists.to(F32)
    total = hists.to(torch.int64).sum(dim=-1, keepdim=True).to(F32)
    norm = counts / total
    clipped = torch.minimum(norm, _f32(cfg.clahe_clip_limit, counts))
    excess = (norm - clipped).double().sum(dim=-1, keepdim=True).to(F32)
    redist = clipped + excess / _f32(bins, counts)
    return torch.cumsum(redist.double(), dim=-1).to(F32)


def _lut_eval(py_flat, tile_idx, x, bins: int):
    bins_t = _f32(bins, x)
    i = torch.clamp((x * float(bins)).to(I32), 0, bins - 2)
    x1 = i.to(F32) / bins_t
    x2 = torch.where(i == bins - 2, 1.0, (i + 1).to(F32) / bins_t)
    flat1 = (tile_idx * bins + i).to(torch.int64)
    y1 = torch.take(py_flat, flat1)
    y2 = torch.take(py_flat, flat1 + 1)
    val = (y2 - y1) / (x2 - x1) * (x - x1) + y1
    last = torch.take(py_flat, (tile_idx * bins + bins - 1).to(torch.int64))
    val = torch.where(x == 1.0, last, val)
    return torch.where((x >= 0.0) & (x <= 1.0), val, 0.0)


def clahe_apply(recon: torch.Tensor, py: torch.Tensor, cfg) -> torch.Tensor:
    """The bilinear blend of up to 4 neighbouring tiles' LUTs; a negative
    tile coordinate saturates to 0."""
    t, bins = cfg.clahe_tiles, cfg.clahe_bins
    n = recon.shape[-1]
    coord = torch.arange(n, dtype=F32, device=recon.device) / _f32(n // t, recon)
    base = torch.floor(coord).to(I32).to(F32) + 0.5
    diff = coord - base
    sgn = torch.sign(diff).to(I32)
    base_i = torch.floor(base).to(I32)
    nb_i = torch.clamp(base_i + sgn, 0, t - 1)
    base_i = torch.clamp(base_i, 0, t - 1)
    w_base = 1.0 - torch.abs(base - coord)
    w_nb = 1.0 - torch.abs((base_i + sgn).to(F32) + 0.5 - coord)
    zero = diff == 0.0
    py_flat = py.reshape(-1)
    bx, nx, by, ny = base_i[:, None], nb_i[:, None], base_i[None, :], nb_i[None, :]
    wbx, wnx, wby, wny = w_base[:, None], w_nb[:, None], w_base[None, :], w_nb[None, :]
    zx, zy = zero[:, None], zero[None, :]

    def ev(tx, ty):
        return _lut_eval(py_flat, tx * t + ty, recon, bins)

    g_bb, g_nb, g_bn, g_nn = ev(bx, by), ev(nx, by), ev(bx, ny), ev(nx, ny)
    v_x0 = wby * g_bb + wny * g_bn
    v_y0 = wbx * g_bb + wnx * g_nb
    v_4 = wbx * wby * g_bb + wnx * wby * g_nb + wbx * wny * g_bn + wnx * wny * g_nn
    return torch.where(zx & zy, g_bb, torch.where(zx, v_x0, torch.where(zy, v_y0, v_4)))


# ----------------------------------------------------------------------
# the whole pass
# ----------------------------------------------------------------------

def forward(img_u16: torch.Tensor, cfg: PlainConfig) -> Dict[str, torch.Tensor]:
    """One [n, n] integer image -> {"out_u8": [n-2m, n-2m] uint8} and, with
    CLAHE on, "clahe_graded" ([n, n] float32), on the image's device."""
    n = cfg.image_size
    if tuple(img_u16.shape) != (n, n):
        raise ValueError(f"image {tuple(img_u16.shape)} != image_size {n}")
    sd = torch.bfloat16 if cfg.storage == "bfloat16" else F32
    normalized, _, _ = normalize(img_u16.contiguous(), cfg.quirks)
    bandpass, downs = reduce_ladder(normalized, cfg.pyramid_levels)
    bandpass = [b.to(sd) for b in bandpass]
    sdevs, max_bins = {}, {}
    for i in cfg.analysis_levels:
        sdevs[i] = img_sdev(bandpass[i].float())
        max_bins[i] = torch.argmax(noise_histogram(sdevs[i], cfg)).to(I32)
    cnr = img_cnr(sdevs[cfg.cnr_level], max_bins[cfg.cnr_level], cfg)
    bands_in = contrast_apply(bandpass, sdevs, max_bins, cnr, cfg)
    recon = expand_ladder(downs[-1], bands_in)
    grad_input = recon * recon if cfg.grad_with_linear_image else recon
    relevant = img_relevant(normalized, cnr, cfg)
    gpx, gpy = gradation_curve(gradation_histogram(grad_input, relevant, cfg), cfg)
    result = {}
    if cfg.enable_clahe:
        py = clahe_curves(clahe_histograms(recon, relevant, cfg), cfg)
        result["clahe_graded"] = clahe_apply(recon, py, cfg)
    m = cfg.out_margin
    graded = curve_get_y_general(gpx, gpy, grad_input)
    result["out_u8"] = curve_apply_u8(graded[m:n - m, m:n - m])
    return result
