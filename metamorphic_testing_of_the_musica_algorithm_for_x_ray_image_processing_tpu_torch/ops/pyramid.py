"""Gaussian/Laplacian pyramid ops: 5x5 Burt-Adelson smoothing (a = 0.3),
decimation, zero-stuff upsampling.  Port of the JAX package's
``ops/pyramid.py`` (plain path; its split-plane relayout is a TPU
strided-slice workaround and bit-identical to this path).

Every stencil is a left-to-right sum of weighted slices, in the same tap
order as the JAX package (``pyramid.py:73-74``), accumulated in float64 and
rounded to float32 once per stencil -- the golden model's own accumulation
(a 2-D float64 sum rounded once).  A float32 accumulation without FMAs (what
PyTorch's eager ops give) drifts from both the golden model and the JAX
package's FMA-contracted XLA code: at 600 px pelvis its u8 output fell to
89.98 dB against the golden model, under the 90 dB parity bar, where float64
accumulation gives 91.94 dB (and 93.4 dB against the JAX package).
``F.conv2d`` would change the summation order, and on the GPU run in TF32 by
default.

Boundary handling matches the GLSL ``mirror()``: one reflection without edge
repeat; for axes of size <= 2 the reflected index can stay out of bounds,
and the Vulkan ``imageLoad`` then returns 0 (QUIRKS #4).
"""

from __future__ import annotations

import numpy as np
import torch


def smooth_weights() -> np.ndarray:
    """The 5 taps as float32, computed exactly as the JAX package does."""
    a = 0.3
    return np.array([0.25 - a / 2, 0.25, a, 0.25, 0.25 - a / 2],
                    dtype=np.float32)


# Python floats holding the float32 tap values exactly (also exact in the
# float64 accumulation)
_W = [float(w) for w in smooth_weights()]


def _mirror_idx(n: int):
    """Tap indices/validity for positions -2..n+1 (GLSL mirror())."""
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


def mirror_pad(img: torch.Tensor) -> torch.Tensor:
    """Pad both spatial axes by 2 with the mirror boundary (OOB -> 0).

    Built from slices and zeros on the image's device, so no index table is
    copied from the host."""
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


def smooth(img: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """Separable 5x5 smooth, mirror boundary; gain=4.0 is the zero-stuffing
    energy compensation of img_smooth_upsampled."""
    h, w = img.shape[-2], img.shape[-1]
    p = mirror_pad(img.double())
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


def smooth_downsample(img: torch.Tensor) -> torch.Tensor:
    """Smooth then decimate, evaluating the smooth only at even coordinates
    (bit-identical to decimating the full smooth)."""
    h, w = img.shape[-2], img.shape[-1]
    dh, dw = -(-h // 2), -(-w // 2)
    ra, ca = img.ndim - 2, img.ndim - 1
    x = img.double()
    if h < 8 or w < 8:
        p = mirror_pad(x)
        tmp = _W[0] * _slice(p, ra, 0, 2 * dh - 1, 2)
        for m in range(1, 5):
            tmp = tmp + _W[m] * _slice(p, ra, m, m + 2 * dh - 1, 2)
        out = _W[0] * _slice(tmp, ca, 0, 2 * dw - 1, 2)
        for n in range(1, 5):
            out = out + _W[n] * _slice(tmp, ca, n, n + 2 * dw - 1, 2)
        return out.to(img.dtype)

    def decimate_axis(a, axis, n, dn):
        idx, valid = _mirror_idx(n)  # taps for positions -2..n+1

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
            interior = interior + _W[m] * _slice(a, axis, m,
                                                 m + 2 * (dn - 2) - 1, 2)
        return torch.cat([first, interior, last], dim=axis)

    tmp = decimate_axis(x, ra, h, dh)
    return decimate_axis(tmp, ca, w, dw).to(img.dtype)


def upsample(img: torch.Tensor, out_size: int) -> torch.Tensor:
    """Zero-stuff x2: out[2x, 2y] = in[x, y]."""
    src = -(-out_size // 2)
    a = img[..., :src, :src]
    out = img.new_zeros(img.shape[:-2] + (2 * src, 2 * src))
    out[..., ::2, ::2] = a
    return out[..., :out_size, :out_size]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int,
                total: int) -> torch.Tensor:
    """a provides even positions along ``axis``, b odd; |a| >= |b|."""
    if b.shape[axis] < a.shape[axis]:
        pad_shape = list(b.shape)
        pad_shape[axis] = a.shape[axis] - b.shape[axis]
        b = torch.cat([b, b.new_zeros(pad_shape)], dim=axis)
    st = torch.stack([a, b], dim=axis + 1)
    shape = list(a.shape)
    shape[axis] = 2 * a.shape[axis]
    return _slice(st.reshape(shape), axis, 0, total)


def upsample_smooth(img: torch.Tensor, out_size: int) -> torch.Tensor:
    """Zero-stuff then smooth with x4 gain (the pyramid expand step), in
    polyphase form: three of every five taps land on stuffed zeros, so each
    output phase is a 3- or 2-tap stencil on the small image.  Bit-exact to
    ``smooth(upsample(img, n), 4.0)``: the skipped terms are exact ``w * 0``
    products and ``x + 0`` additions."""
    n = out_size
    src = -(-n // 2)
    if n < 6 or img.shape[-1] < 3 or img.shape[-2] < 3:
        return smooth(upsample(img, out_size), gain=4.0)
    r = img[..., :src, :src].double()
    we = (_W[0], _W[2], _W[4])  # taps hitting even (data) positions
    wo = (_W[1], _W[3])         # taps hitting odd (zero) positions
    n_even = -(-n // 2)
    n_odd = n // 2
    # boundary extension on the small grid: up-grid mirror(-2) = 2 -> r[1];
    # mirror(2j) for 2j > n-1 -> 2(n-1) - 2j, giving r[n-1-src] at j = src
    edge = n - 1 - src

    def phase_conv(a, axis):
        e = torch.cat([a.narrow(axis, 1, 1), a, a.narrow(axis, edge, 1)],
                      dim=axis)
        ph0 = (we[0] * e.narrow(axis, 0, n_even) + we[1] * e.narrow(axis, 1, n_even)
               + we[2] * e.narrow(axis, 2, n_even))
        ph1 = wo[0] * e.narrow(axis, 1, n_odd) + wo[1] * e.narrow(axis, 2, n_odd)
        return ph0, ph1

    ra, ca = r.ndim - 2, r.ndim - 1
    r0, r1 = phase_conv(r, ra)
    a00, a01 = phase_conv(r0, ca)
    a10, a11 = phase_conv(r1, ca)
    a00, a01, a10, a11 = (a.to(img.dtype) * 4.0 for a in (a00, a01, a10, a11))
    rows_even = _interleave(a00, a01, ca, n)
    rows_odd = _interleave(a10, a11, ca, n)
    return _interleave(rows_even, rows_odd, ra, n)


def reduce_ladder(normalized: torch.Tensor, levels: int):
    """The pyramid-reduce ladder: (bandpass list, downs list)."""
    bandpass, downs = [], []
    cur = normalized
    for _ in range(levels):
        dn = smooth_downsample(cur)
        bandpass.append(cur - upsample_smooth(dn, cur.shape[-1]))
        downs.append(dn)
        cur = dn
    return bandpass, downs
