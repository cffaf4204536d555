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

The ``*_rows`` forms compute a window of output rows of the whole-image op
from a window of its input rows (the spatial path's shards,
``parallel/spatial.py``): the same taps in the same order, with the mirror
taken at the image's true first and last rows, so the window equals the
whole op's rows bit for bit.  ``needed_rows`` says which input rows a
window reads.

The functions named ``*_plain`` are the plain versions.  The public names
(``smooth_downsample``, ``upsample_smooth``, their ``*_rows`` forms,
``reduce_ladder``, ``expand_ladder`` and the fused ``upsample_subtract`` /
``upsample_add``) dispatch by device through ``ops/cuda/pyramid.py``: a CPU
tensor runs the plain version, a CUDA tensor launches the hand-written
kernels of ``csrc/pyramid.cu`` (the same sums in the same order) or raises.
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


def mirror_pad(img: torch.Tensor, axes=None) -> torch.Tensor:
    """Pad both spatial axes (or ``axes``) by 2 with the mirror boundary
    (OOB -> 0).

    Built from slices and zeros on the image's device, so no index table is
    copied from the host."""
    out = img
    for axis in axes or (img.ndim - 2, img.ndim - 1):
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


def downsample(img: torch.Tensor) -> torch.Tensor:
    """out[x, y] = in[2x, 2y] (shaders/img_downsample.comp:15), a view."""
    return img[..., ::2, ::2]


def smooth_downsample_plain(img: torch.Tensor) -> torch.Tensor:
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

    tmp = _decimate_axis(x, ra, h, dh)
    return _decimate_axis(tmp, ca, w, dw).to(img.dtype)


def _decimate_axis(a: torch.Tensor, axis: int, n: int, dn: int) -> torch.Tensor:
    """``smooth_downsample``'s pass along one axis of size n >= 8: the first
    and last outputs through mirrored taps, the interior as strided
    slices."""
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


_WE = (_W[0], _W[2], _W[4])  # upsample taps hitting even (data) positions
_WO = (_W[1], _W[3])         # taps hitting odd (zero) positions


def _phase_conv(a: torch.Tensor, axis: int, n: int, edge: int):
    """The two output phases of the x2 upsample's smooth along ``axis`` of
    the small image ``a`` (``upsample_smooth``'s polyphase form)."""
    n_even, n_odd = -(-n // 2), n // 2
    e = torch.cat([a.narrow(axis, 1, 1), a, a.narrow(axis, edge, 1)], dim=axis)
    ph0 = (_WE[0] * e.narrow(axis, 0, n_even) + _WE[1] * e.narrow(axis, 1, n_even)
           + _WE[2] * e.narrow(axis, 2, n_even))
    ph1 = _WO[0] * e.narrow(axis, 1, n_odd) + _WO[1] * e.narrow(axis, 2, n_odd)
    return ph0, ph1


def polyphase(n: int) -> bool:
    """Whether the expand of a ceil(n/2)-px image to n px takes the
    polyphase form; below it, ``smooth(upsample(img, n), 4.0)``."""
    return n >= 6 and -(-n // 2) >= 3


def upsample_smooth_plain(img: torch.Tensor, out_size: int) -> torch.Tensor:
    """Zero-stuff then smooth with x4 gain (the pyramid expand step), in
    polyphase form: three of every five taps land on stuffed zeros, so each
    output phase is a 3- or 2-tap stencil on the small image.  Bit-exact to
    ``smooth(upsample(img, n), 4.0)``: the skipped terms are exact ``w * 0``
    products and ``x + 0`` additions."""
    n = out_size
    src = -(-n // 2)
    if not polyphase(n) or img.shape[-1] < 3 or img.shape[-2] < 3:
        return smooth(upsample(img, out_size), gain=4.0)
    r = img[..., :src, :src].double()
    # boundary extension on the small grid: up-grid mirror(-2) = 2 -> r[1];
    # mirror(2j) for 2j > n-1 -> 2(n-1) - 2j, giving r[n-1-src] at j = src
    edge = n - 1 - src
    ra, ca = r.ndim - 2, r.ndim - 1
    r0, r1 = _phase_conv(r, ra, n, edge)
    a00, a01 = _phase_conv(r0, ca, n, edge)
    a10, a11 = _phase_conv(r1, ca, n, edge)
    a00, a01, a10, a11 = (a.to(img.dtype) * 4.0 for a in (a00, a01, a10, a11))
    rows_even = _interleave(a00, a01, ca, n)
    rows_odd = _interleave(a10, a11, ca, n)
    return _interleave(rows_even, rows_odd, ra, n)


def reduce_ladder_plain(normalized: torch.Tensor, levels: int):
    """The pyramid-reduce ladder: (bandpass list, downs list)."""
    bandpass, downs = [], []
    cur = normalized
    for _ in range(levels):
        dn = smooth_downsample_plain(cur)
        bandpass.append(cur - upsample_smooth_plain(dn, cur.shape[-1]))
        downs.append(dn)
        cur = dn
    return bandpass, downs


def expand_ladder_plain(top: torch.Tensor, bands) -> torch.Tensor:
    """The pyramid-expand ladder: ``top`` (the reduce ladder's last down)
    expanded through ``bands`` (level 0 first, float32 or bf16), an expand
    and a float32 addition a level, the coarsest first."""
    recon = top
    for band in reversed(list(bands)):
        recon = upsample_smooth_plain(recon, band.shape[-1]) + band.float()
    return recon


# ----------------------------------------------------------------------
# row windows (the spatial path)
# ----------------------------------------------------------------------

def _down_map(h: int):
    """smooth_downsample's row taps: position -> (row, valid) (GLSL mirror())."""
    idx, valid = _mirror_idx(h)
    return lambda p: (int(idx[p + 2]), bool(valid[p + 2]))


def _up_map(n: int):
    """upsample_smooth's small-row taps: position -1..src -> row (the
    boundary extension of its polyphase form)."""
    src = -(-n // 2)
    return lambda p: (1 if p < 0 else n - 1 - src if p >= src else p, True)


def _span(p0: int, p1: int, size: int, tap) -> tuple:
    """[lo, hi): the rows that positions [p0, p1) read through ``tap``
    (positions inside [0, size) read themselves)."""
    rows = [r for p in (*range(p0, min(p1, 0)), *range(max(p0, size), p1))
            for r, ok in [tap(p)] if ok]
    inner = range(max(p0, 0), min(p1, size))
    if inner:
        rows += [inner[0], inner[-1]]
    return min(rows), max(rows) + 1


def _taps(x: torch.Tensor, x0: int, p0: int, p1: int, size: int, tap) -> torch.Tensor:
    """Rows for positions [p0, p1) from ``x``, the rows [x0, ...) of the
    image: the inner positions as one slice, each outer one through
    ``tap`` (a zero row where the tap is invalid)."""
    def one(p):
        r, ok = tap(p)
        return x.narrow(-2, r - x0, 1) if ok else torch.zeros_like(x.narrow(-2, 0, 1))

    lo, hi = max(p0, 0), min(p1, size)
    parts = [one(p) for p in range(p0, min(p1, 0))]
    if lo < hi:
        parts.append(x.narrow(-2, lo - x0, hi - lo))
    parts += [one(p) for p in range(max(p0, size), p1)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def needed_rows(op: str, size: int, r0: int, r1: int) -> tuple:
    """[lo, hi): the input rows that output rows [r0, r1) of ``op`` read.
    ``size`` is the op's input rows (``smooth_downsample``: the image's;
    ``img_sdev``: the image's; ``upsample_smooth``: the output's, the input
    being the ceil(size/2)-row small image)."""
    if op == "smooth_downsample":
        return _span(2 * r0 - 2, 2 * r1 + 1, size, _down_map(size))
    if op == "upsample_smooth":
        return _span(r0 // 2 - 1, (r1 - 1) // 2 + 2, -(-size // 2), _up_map(size))
    if op == "img_sdev":
        return max(r0 - 2, 0), min(r1 + 2, size)
    raise ValueError(op)


def smooth_downsample_rows_plain(x: torch.Tensor, x0: int, h: int, j0: int,
                                 j1: int) -> torch.Tensor:
    """Rows [j0, j1) of ``smooth_downsample`` of an [h, w] image, from ``x``,
    its rows [x0, x0 + x.shape[-2]) (at least ``needed_rows``), all its
    columns.  Bit-equal to the whole op's rows in either of its forms: the
    row taps are summed in its order with its weights, and its column pass
    is run on the window's row sums as it is run on the whole image's."""
    w = x.shape[-1]
    dw = -(-w // 2)
    p = _taps(x.double(), x0, 2 * j0 - 2, 2 * j1 + 1, h, _down_map(h))
    cnt = j1 - j0
    ra, ca = p.ndim - 2, p.ndim - 1
    tmp = _W[0] * _slice(p, ra, 0, 2 * cnt - 1, 2)
    for m in range(1, 5):
        tmp = tmp + _W[m] * _slice(p, ra, m, m + 2 * cnt - 1, 2)
    if h < 8 or w < 8:
        # the whole op's small form pads both axes before its row pass; a
        # padded column is a copy of a column (or zeros), and so is its sum
        q = mirror_pad(tmp, axes=(ca,))
        out = _W[0] * _slice(q, ca, 0, 2 * dw - 1, 2)
        for n in range(1, 5):
            out = out + _W[n] * _slice(q, ca, n, n + 2 * dw - 1, 2)
        return out.to(x.dtype)
    return _decimate_axis(tmp, ca, w, dw).to(x.dtype)


def upsample_smooth_rows_plain(small: torch.Tensor, s0: int, out_size: int, r0: int,
                               r1: int) -> torch.Tensor:
    """Rows [r0, r1) of ``upsample_smooth(img, out_size)``, from ``small``,
    the rows [s0, ...) of the ceil(out_size/2)-px small image (at least
    ``needed_rows``), all its columns.  Only the polyphase form (the whole
    op's at out_size >= 6 and a small image of >= 3 px): the spatial path
    shards no level below that."""
    n = out_size
    src = -(-n // 2)
    if not polyphase(n) or small.shape[-1] != src:
        raise ValueError(f"upsample_smooth_rows: out_size {n}, small width {small.shape[-1]}: "
                         "only the polyphase form takes row windows")
    edge = n - 1 - src
    ja, jb = r0 // 2, (r1 - 1) // 2
    cnt = jb - ja + 1
    e = _taps(small.double(), s0, ja - 1, jb + 2, src, _up_map(n))
    ra, ca = e.ndim - 2, e.ndim - 1
    ph0 = (_WE[0] * e.narrow(ra, 0, cnt) + _WE[1] * e.narrow(ra, 1, cnt)
           + _WE[2] * e.narrow(ra, 2, cnt))
    ph1 = _WO[0] * e.narrow(ra, 1, cnt) + _WO[1] * e.narrow(ra, 2, cnt)
    a00, a01 = _phase_conv(ph0, ca, n, edge)
    a10, a11 = _phase_conv(ph1, ca, n, edge)
    a00, a01, a10, a11 = (a.to(small.dtype) * 4.0 for a in (a00, a01, a10, a11))
    rows_even = _interleave(a00, a01, ca, n)
    rows_odd = _interleave(a10, a11, ca, n)
    return _interleave(rows_even, rows_odd, ra, 2 * cnt).narrow(ra, r0 - 2 * ja, r1 - r0)


def upsample_rows_plain(small: torch.Tensor, s0: int, n: int, r0: int, r1: int) -> torch.Tensor:
    """Rows [r0, r1) of ``upsample_smooth_plain(img, n)`` from ``small``,
    the rows [s0, ...) of img: the whole op for the whole image, else the
    polyphase form's window (``upsample_smooth_rows_plain``), else the
    whole op's rows, which needs the whole small image."""
    src = -(-n // 2)
    whole = s0 == 0 and small.shape[-2] >= src
    if whole and (r0, r1) == (0, n):
        return upsample_smooth_plain(small, n)
    if polyphase(n):
        return upsample_smooth_rows_plain(small, s0, n, r0, r1)
    if not whole:
        raise ValueError(f"upsample to {n} px below the polyphase form: the window needs the "
                         f"whole small image, got rows [{s0}, {s0 + small.shape[-2]})")
    return upsample_smooth_plain(small, n)[..., r0:r1, :]


def upsample_subtract_plain(cur: torch.Tensor, small: torch.Tensor, s0: int = 0,
                            r0: int = 0) -> torch.Tensor:
    """``cur`` less the same rows of the expand of ``small`` (as
    ``upsample_subtract``), unfused."""
    return cur - upsample_rows_plain(small, s0, cur.shape[-1], r0, r0 + cur.shape[-2])


def upsample_add_plain(small: torch.Tensor, band: torch.Tensor, s0: int = 0,
                       r0: int = 0) -> torch.Tensor:
    """The expand of ``small`` on band's rows plus ``band`` as float32 (as
    ``upsample_add``), unfused."""
    return upsample_rows_plain(small, s0, band.shape[-1], r0, r0 + band.shape[-2]) + band.float()


# ----------------------------------------------------------------------
# the public steps: the plain versions above on the CPU, the kernels of
# csrc/pyramid.cu on a CUDA device (ops/cuda/pyramid.py)
# ----------------------------------------------------------------------

def smooth_downsample(img: torch.Tensor) -> torch.Tensor:
    """Smooth then decimate: [h, w] -> [ceil(h/2), ceil(w/2)]."""
    from .cuda import pyramid as kp

    return kp.smooth_downsample(img)


def smooth_downsample_rows(x: torch.Tensor, x0: int, h: int, j0: int, j1: int) -> torch.Tensor:
    """Rows [j0, j1) of ``smooth_downsample`` of an [h, w] image from ``x``,
    its rows [x0, x0 + x.shape[-2]) (``smooth_downsample_rows_plain``)."""
    from .cuda import pyramid as kp

    return kp.smooth_downsample_rows(x, x0, h, j0, j1)


def upsample_smooth(img: torch.Tensor, out_size: int) -> torch.Tensor:
    """Zero-stuff x2 then smooth with x4 gain: the pyramid's expand of a
    ceil(out_size/2)-px image to [out_size, out_size]."""
    from .cuda import pyramid as kp

    return kp.upsample_smooth(img, out_size)


def upsample_smooth_rows(small: torch.Tensor, s0: int, out_size: int, r0: int,
                         r1: int) -> torch.Tensor:
    """Rows [r0, r1) of ``upsample_smooth(img, out_size)`` from ``small``,
    the small image's rows [s0, ...) (``upsample_smooth_rows_plain``)."""
    from .cuda import pyramid as kp

    return kp.upsample_smooth_rows(small, s0, out_size, r0, r1)


def upsample_subtract(cur: torch.Tensor, small: torch.Tensor, s0: int = 0,
                      r0: int = 0) -> torch.Tensor:
    """A band of the reduce ladder: ``cur`` less the expand of ``small``
    (the next level), on cur's rows [r0, r0 + cur.shape[-2]) of an image
    cur.shape[-1] px wide; ``small`` holds the small image's rows [s0, ...).
    One kernel launch on a CUDA device."""
    from .cuda import pyramid as kp

    return kp.upsample_subtract(cur, small, s0, r0)


def upsample_add(small: torch.Tensor, band: torch.Tensor, s0: int = 0,
                 r0: int = 0) -> torch.Tensor:
    """An expand step: the expand of ``small`` plus ``band`` (float32 or
    bf16, read as float32), on band's rows [r0, r0 + band.shape[-2]) of an
    image band.shape[-1] px wide; ``small`` holds the small image's rows
    [s0, ...).  One kernel launch on a CUDA device."""
    from .cuda import pyramid as kp

    return kp.upsample_add(small, band, s0, r0)


def reduce_ladder(normalized: torch.Tensor, levels: int):
    """The pyramid-reduce ladder: (bandpass list, downs list), equal to
    ``reduce_ladder_plain``'s; on a CUDA device one fused launch a level
    down to the coarse levels, which one more launch takes."""
    from .cuda import pyramid as kp

    return kp.reduce_ladder(normalized, levels)


def expand_ladder(top: torch.Tensor, bands) -> torch.Tensor:
    """The pyramid-expand ladder: ``top`` (the reduce ladder's last down)
    expanded through ``bands`` (level 0 first, float32 or bf16) into the
    reconstruction, equal to ``expand_ladder_plain``'s and to an
    ``upsample_add`` a level; on a CUDA device one launch for the coarse
    levels, then one a level."""
    from .cuda import pyramid as kp

    return kp.expand_ladder(top, bands)
