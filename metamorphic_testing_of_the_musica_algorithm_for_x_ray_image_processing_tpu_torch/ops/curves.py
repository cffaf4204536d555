"""Piecewise quadratic-bezier curve LUTs and their evaluation.  Port of the
JAX package's ``ops/curves.py``.

Curve points are short float32 tensors on the image's device, derived from
0-d device tensors (histogram argmaxes), so generating and applying a curve
never waits for the host.
"""

from __future__ import annotations

import torch

from . import f32

F32 = torch.float32


def bezier_points(start, middle, end, inclusive: bool):
    """Quadratic bezier sampled at t = i/10 (double-lerp form); 11 points
    with ``inclusive`` (contrast curves), else 10 (gradation curve).
    start/middle/end are (x, y) pairs of 0-d float32 tensors on one device.
    Returns (px[k], py[k])."""
    sx, sy = start
    mx, my = middle
    ex, ey = end
    count = 11 if inclusive else 10
    t = torch.arange(count, dtype=F32, device=sx.device) / f32(10.0, sx)
    xa = sx + (mx - sx) * t
    ya = sy + (my - sy) * t
    xb = mx + (ex - mx) * t
    yb = my + (ey - my) * t
    return xa + (xb - xa) * t, ya + (yb - ya) * t


def contrast_curve(max_bin: torch.Tensor, low_contrast_factor: float,
                   high_contrast_factor: float, cfg):
    """Per-level contrast LUT (shaders/contrast_curve_generate.comp:56-90).

    ``low_contrast_factor == 1.0`` selects the flat 2-point line at the high
    contrast factor; otherwise 3 bezier segments (33 points) around
    maxBinPosition = maxBin / 2048 * 0.1, with products associated to the
    left as the GLSL writes them (QUIRKS #10)."""
    one = f32(1.0, max_bin)
    hcf = f32(high_contrast_factor, max_bin)
    if low_contrast_factor == 1.0:
        return torch.stack([one * 0.0, one]), torch.stack([hcf, hcf])
    lcf = f32(low_contrast_factor, max_bin)
    five = f32(5.0, max_bin)
    # stepwise f32 rounding: (maxBin * (1/2048)) * 0.1
    p = (max_bin.to(F32) * (1.0 / cfg.noise_histogram_bins)
         * cfg.max_noise_value)
    p45 = p * 4.0 / five
    p65 = p * 6.0 / five
    p75 = p * 7.0 / five
    l45 = lcf * 4.0 / five
    seg1 = bezier_points((one * 0.0, one), (p45, lcf), (p, lcf), True)
    seg2 = bezier_points((p, lcf), (p65, lcf), (p75, l45), True)
    seg3 = bezier_points((p75, l45), (p * 2.0, one), (one, one), True)
    return (torch.cat([seg1[0], seg2[0], seg3[0]]),
            torch.cat([seg1[1], seg2[1], seg3[1]]))


def curve_get_y_sorted(px: torch.Tensor, py: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """The GLSL first-match getY for non-decreasing px.

    For sorted px the scan's match is the LAST i with ``px[i] < x`` (its
    interval (px_i, px_{i+1}]); that index is ``searchsorted(px, x) - 1``.
    ``x == px[0]`` gives py[0], x outside (px_0, px_last] gives 0.0.  The
    selected (slope, px, py) triple and the single lerp are those of the
    JAX package's select chain, so the result is the same."""
    n = px.shape[0]
    ms = (py[1:] - py[:-1]) / (px[1:] - px[:-1])
    cnt = torch.searchsorted(px, x.contiguous())  # number of px[i] < x
    sel = (cnt - 1).clamp(0, n - 2)
    result = torch.take(ms, sel) * (x - torch.take(px, sel)) + torch.take(py, sel)
    result = torch.where(cnt > 0, result,
                         torch.where(x == px[0], py[0], 0.0))
    return torch.where(cnt == n, 0.0, result)


def curve_get_y_general(px: torch.Tensor, py: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """First-match getY for ARBITRARY px (the gradation curve's second bezier
    segment can fold back), as the JAX package's descending chain: the
    smallest matching interval wins; a non-increasing pair px[i+1] <= px[i]
    is a zero-width interval at px[i] with slope 0; no match gives 0.0.
    Nonfinite x is redirected to a finite sentinel that matches nothing.

    The chain selects an interval index; one gather per scalar and one lerp
    follow."""
    n = px.shape[0]
    zero = px.new_zeros(1)
    px_e = torch.cat([px, zero])
    py_e = torch.cat([py, zero])
    x = torch.where(torch.isfinite(x), x, 3.0e38)
    ms = (py_e[1:] - py_e[:-1]) / (px_e[1:] - px_e[:-1])
    nonmono = px_e[1:] <= px_e[:-1]
    m_tab = torch.cat([torch.where(nonmono, 0.0, ms), zero])  # [n] = no match
    px_hi = torch.where(nonmono, px_e[:-1], px_e[1:])
    sel = torch.full(x.shape, n, dtype=torch.int64, device=x.device)
    for i in range(n - 1, -1, -1):
        sel = torch.where((px_e[i] <= x) & (x <= px_hi[i]), i, sel)
    return (torch.take(m_tab, sel) * (x - torch.take(px_e, sel))
            + torch.take(py_e, sel))


def curve_apply_u8(g: torch.Tensor) -> torch.Tensor:
    """``clip(trunc(255 * y))`` as uint8, the truncating output quantization
    (QUIRKS #22)."""
    return torch.clamp(torch.trunc(255.0 * g), 0.0, 255.0).to(torch.uint8)


def contrast_curve_apply(bandpass: torch.Tensor, sdev: torch.Tensor,
                         px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """out = bandpass * curveY(sdev); contrast curves have sorted px."""
    return bandpass * curve_get_y_sorted(px, py, sdev)
