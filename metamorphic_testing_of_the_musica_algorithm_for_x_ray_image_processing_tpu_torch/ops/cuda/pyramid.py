"""Wrappers of the pyramid kernels in ``csrc/pyramid.cu``, each beside its
plain PyTorch version (``ops/pyramid.py``'s float64 stencils; launch
counters ``pyramid_down``, ``pyramid_up`` and ``pyramid_tail``; the fused
step's launches by their strip height in ``launch.GEOMETRY`` under
``("reduce_step", strip_rows(n))``).

==========================  =================================================
wrapper                     replaces (JAX package, XLA code in ops/pyramid.py)
==========================  =================================================
``reduce_step``             ``reduce_step_split`` (:213), a level's down and
                            band in one step: ``reduce_step_kernel<true>``
``smooth_downsample``,      ``smooth_downsample`` (:85):
``smooth_downsample_rows``  ``reduce_step_kernel<false>``
``upsample_smooth``,        ``upsample_smooth`` (:310):
``upsample_smooth_rows``    ``upsample_smooth_kernel<0>``
``upsample_subtract``       ``upsample_smooth`` with ``reduce_ladder``'s band
                            subtraction (:261): ``upsample_smooth_kernel<1>``
``upsample_add``            ``upsample_smooth`` with ``models/musica.py``'s
                            expand add (:155): ``upsample_smooth_kernel<2>``
``reduce_tail``             ``reduce_ladder``'s per-level tail (:261):
                            ``pyramid_tail_kernel<false>``
``expand_tail``             ``models/musica.py``'s expand loop (:150-157) on
                            the coarse levels: ``pyramid_tail_kernel<true>``
``reduce_ladder``,          the schedules: a fused step a level down to the
``expand_ladder``           tails' cut (``TAIL_CUT``), then one tail launch;
                            the expand the other way round
==========================  =================================================

These are counterparts of XLA code, not of Pallas kernels.  Each kernel
repeats its plain version's float64 sums operation by operation, so it
equals it bit for bit at every size (the source says how).  The down and
expand wrappers take a window of rows (the spatial path's shards,
``parallel/spatial.py``): the input holds rows [x0, ...) of its image,
which must include every row the window's taps read
(``pyramid.needed_rows``; below the expand's polyphase size, 6 px, the
whole small image), and the output is the window's rows of the whole op.  A
whole image is the window of all its rows.  The fused forms write ``cur -
up`` and ``up + band`` in one launch, where the plain path runs the expand
and a float32 subtraction or addition; a bf16 band is read as its exact
float32 value.

The tails hold every level from the cut down (the ladder) or up to it (the
expand) in one block's shared memory, in float64.  A tail takes a level of
up to ``TAIL_MAX`` px (128 on the H100's 227 KB: its image, its down and a
step's float64 sums); the schedules cut at ``TAIL_CUT`` = 48 px, where one
block through a level stops being faster than a fused step (48 px at
3072^2, 38 at 600^2).

Dispatch (``launch.py``): a CUDA tensor launches the kernel or raises; a
CPU tensor runs the plain version.  There is no fallback from one to the
other.  On the card the wrappers take 2-D contiguous float32 images (a band
may be bf16); the plain versions also take leading batch dimensions.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .. import pyramid
from . import launch

_MODES = {"up": 0, "subtract": 1, "add": 2}
MAX_TAIL_LEVELS = 16  # kMaxTail in csrc/pyramid.cu


def _ceil2(n: int) -> int:
    return -(-n // 2)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def tail_shared_bytes(size: int, expand: bool, band_bytes: int = 0) -> int:
    """Shared memory of a tail launch whose largest level is ``size`` px
    (csrc/pyramid.cu::tail_layout): the float64 sums of a step
    (ceil(size/2) x size), two float64 images (the ladder: size^2 and
    ceil(size/2)^2; the expand: ceil(size/2)^2 each), two levels' tap
    tables (780 bytes each) and, for the expand, its staged bands
    (``band_bytes``)."""
    ds = _ceil2(size)
    images = 8 * ds * size + 8 * (ds * ds if expand else size * size) + 8 * ds * ds
    return _round16(images + 2 * 780) + band_bytes


def _band_bytes(bands) -> int:
    return sum(_round16(b.numel() * b.element_size()) for b in bands)


# the largest level the ladder's tail (the larger of the two) holds
TAIL_MAX = max(s for s in range(1, 257) if tail_shared_bytes(s, False) <= launch.MAX_SHARED_BYTES)
# the schedules' cut: levels of TAIL_CUT px or less go to the tails.  Smaller
# than TAIL_MAX: from about 96 px on, one block through a level takes longer
# than a launch of the fused step over many blocks (the H100's times by level
# size: scripts/probe_pyramid.py, PERF.md)
TAIL_CUT = 48

# the fused step's warps (csrc/pyramid.cu::reduce_step_kernel<true>): each
# walks a strip of STRIP_COLS band columns down a run of strip_rows(n) down
# rows; STRIP_WARPS, the most warps a level's runs are cut into, is what the
# H100's 132 SMs hold at once (16 each)
STRIP_COLS = 120
STRIP_WARPS = 2112


def strip_rows(n: int) -> int:
    """Down rows a warp of the fused step walks at an ``n``-px level: the
    shortest run that cuts the level into at most ``STRIP_WARPS`` warps.
    Long runs at the large levels, where each run's halo rows cost; a
    row or two at the small levels, which then spread over hundreds of
    warps and cost about one warp's short walk."""
    strips = -(-n // STRIP_COLS)
    return -(-_ceil2(n) // max(1, STRIP_WARPS // strips))


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

smooth_downsample_plain = pyramid.smooth_downsample_plain
smooth_downsample_rows_plain = pyramid.smooth_downsample_rows_plain
upsample_rows_plain = pyramid.upsample_rows_plain
upsample_subtract_plain = pyramid.upsample_subtract_plain
upsample_add_plain = pyramid.upsample_add_plain
reduce_ladder_plain = reduce_tail_plain = pyramid.reduce_ladder_plain
expand_ladder_plain = expand_tail_plain = pyramid.expand_ladder_plain


def reduce_step_plain(cur: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(band, down) of one level: ``reduce_ladder_plain``'s step."""
    dn = smooth_downsample_plain(cur)
    return cur - pyramid.upsample_smooth_plain(dn, cur.shape[-1]), dn


# ----------------------------------------------------------------------
# kernels
# ----------------------------------------------------------------------

def _holds(rows: tuple, x0: int, n_rows: int, size: int, what: str) -> None:
    """Raise unless rows [x0, x0 + n_rows) of a ``size``-row image exist and
    hold ``rows`` ([lo, hi))."""
    lo, hi = rows
    if x0 < 0 or x0 + n_rows > size or lo < x0 or hi > x0 + n_rows:
        raise ValueError(f"{what}: input rows [{x0}, {x0 + n_rows}) of a {size}-row image "
                         f"do not hold the rows [{lo}, {hi}) the window reads")


def _launch_down(x: torch.Tensor, x0: int, h: int, j0: int, j1: int,
                 dev: torch.device) -> torch.Tensor:
    launch.check_rows(x, "x")
    rows, w = x.shape
    dh, dw = _ceil2(h), _ceil2(w)
    if not 0 <= j0 < j1 <= dh:
        raise ValueError(f"output rows [{j0}, {j1}) of a {dh}-row result")
    _holds(pyramid.needed_rows("smooth_downsample", h, j0, j1), x0, rows, h,
           "smooth_downsample")
    out = torch.empty((j1 - j0, dw), dtype=torch.float32, device=dev)
    launch.launch(launch.lib(), "musica_reduce_step", "pyramid_down", dev, x.data_ptr(),
                  x0, rows, h, w, out.data_ptr(), j0, j1, None, 0)
    return out


def _launch_step(cur: torch.Tensor, dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    launch.check_image(cur, "cur")
    n = cur.shape[0]
    if not pyramid.polyphase(n):
        raise ValueError(f"reduce_step: a {n}-px level is below the expand's polyphase size "
                         "(6 px); the tail takes it")
    dn = torch.empty((_ceil2(n), _ceil2(n)), dtype=torch.float32, device=dev)
    band = torch.empty((n, n), dtype=torch.float32, device=dev)
    rows = strip_rows(n)
    launch.launch(launch.lib(), "musica_reduce_step", "pyramid_down", dev, cur.data_ptr(),
                  0, n, n, n, dn.data_ptr(), 0, _ceil2(n), band.data_ptr(), rows)
    launch.count_geometry("reduce_step", rows)
    return band, dn


def _launch_up(small: torch.Tensor, s0: int, n: int, r0: int, r1: int, mode: str,
               other: Optional[torch.Tensor], dev: torch.device) -> torch.Tensor:
    launch.check_rows(small, "small")
    src = _ceil2(n)
    if small.shape[1] != src:
        raise ValueError(f"small: {small.shape[1]} columns, the expand to {n} px takes {src}")
    if not 0 <= r0 < r1 <= n:
        raise ValueError(f"output rows [{r0}, {r1}) of a {n}-row result")
    need = pyramid.needed_rows("upsample_smooth", n, r0, r1) if pyramid.polyphase(n) else (0, src)
    _holds(need, s0, small.shape[0], src, "upsample_smooth")
    if other is not None:
        launch.check_rows(other, mode, torch.float32 if mode == "subtract"
                          else (torch.float32, torch.bfloat16))
        if tuple(other.shape) != (r1 - r0, n):
            raise ValueError(f"{mode}: expected [{r1 - r0}, {n}], got {tuple(other.shape)}")
    out = torch.empty((r1 - r0, n), dtype=torch.float32, device=dev)
    launch.launch(launch.lib(), "musica_upsample_smooth", "pyramid_up", dev, small.data_ptr(),
                  s0, small.shape[0], n, out.data_ptr(), r0, r1, _MODES[mode],
                  None if other is None else other.data_ptr(),
                  int(other is not None and other.dtype == torch.bfloat16))
    return out


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launch_reduce_tail(cur: torch.Tensor, levels: int, dev: torch.device):
    launch.check_image(cur, "cur")
    size = cur.shape[0]
    if not 1 <= levels <= MAX_TAIL_LEVELS:
        raise ValueError(f"reduce_tail: {levels} levels, one launch takes 1 to "
                         f"{MAX_TAIL_LEVELS}")
    launch.check_shared(tail_shared_bytes(size, False), f"reduce_tail of a {size}-px level")
    bands, downs, s = [], [], size
    for _ in range(levels):
        bands.append(torch.empty((s, s), dtype=torch.float32, device=dev))
        s = _ceil2(s)
        downs.append(torch.empty((s, s), dtype=torch.float32, device=dev))
    launch.launch(launch.lib(), "musica_reduce_tail", "pyramid_tail", dev, cur.data_ptr(),
                  size, levels, _pointers(bands), _pointers(downs))
    return bands, downs


def _launch_expand_tail(top: torch.Tensor, bands: Sequence[torch.Tensor],
                        dev: torch.device) -> torch.Tensor:
    launch.check_image(top, "top")
    if not 1 <= len(bands) <= MAX_TAIL_LEVELS:
        raise ValueError(f"expand_tail: {len(bands)} bands, one launch takes 1 to "
                         f"{MAX_TAIL_LEVELS}")
    for i, b in enumerate(bands):
        launch.check_image(b, f"bands[{i}]", (torch.float32, torch.bfloat16))
        if i and b.shape[0] != _ceil2(bands[i - 1].shape[0]):
            raise ValueError(f"bands[{i}]: {b.shape[0]} px, the level below "
                             f"{bands[i - 1].shape[0]} px takes {_ceil2(bands[i - 1].shape[0])}")
    if top.shape[0] != _ceil2(bands[-1].shape[0]):
        raise ValueError(f"top: {top.shape[0]} px, the expand to {bands[-1].shape[0]} px takes "
                         f"{_ceil2(bands[-1].shape[0])}")
    size = bands[0].shape[0]
    launch.check_shared(tail_shared_bytes(size, True, _band_bytes(bands)),
                        f"expand_tail to {size} px")
    mask = sum(1 << i for i, b in enumerate(bands) if b.dtype == torch.bfloat16)
    out = torch.empty((size, size), dtype=torch.float32, device=dev)
    launch.launch(launch.lib(), "musica_expand_tail", "pyramid_tail", dev, top.data_ptr(),
                  size, len(bands), _pointers(bands), mask, out.data_ptr())
    return out


# ----------------------------------------------------------------------
# wrappers: plain on the CPU, the kernel on a CUDA device
# ----------------------------------------------------------------------

def smooth_downsample(img: torch.Tensor) -> torch.Tensor:
    """img [h, w] float32 -> [ceil(h/2), ceil(w/2)]: the down step alone on
    the whole image."""
    dev = launch.device_of([img])
    if dev.type == "cpu":
        return smooth_downsample_plain(img)
    return _launch_down(img, 0, img.shape[0], 0, _ceil2(img.shape[0]), dev)


def smooth_downsample_rows(x: torch.Tensor, x0: int, h: int, j0: int, j1: int) -> torch.Tensor:
    """Rows [j0, j1) of ``smooth_downsample`` of an [h, w] image from ``x``
    [rows, w], its rows [x0, x0 + rows)."""
    dev = launch.device_of([x])
    if dev.type == "cpu":
        return smooth_downsample_rows_plain(x, x0, h, j0, j1)
    return _launch_down(x, x0, h, j0, j1, dev)


def reduce_step(cur: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(band, down) of a square level cur [n, n] float32 (n >= 6): the down
    image and cur less its expand, one launch."""
    dev = launch.device_of([cur])
    if dev.type == "cpu":
        return reduce_step_plain(cur)
    return _launch_step(cur, dev)


def upsample_smooth(img: torch.Tensor, out_size: int) -> torch.Tensor:
    """img [src, src] float32 (src = ceil(out_size/2)) -> [out_size,
    out_size]: the expand (mode 0) on the whole image."""
    dev = launch.device_of([img])
    if dev.type == "cpu":
        return pyramid.upsample_smooth_plain(img, out_size)
    launch.check_image(img, "img")
    return _launch_up(img, 0, out_size, 0, out_size, "up", None, dev)


def upsample_smooth_rows(small: torch.Tensor, s0: int, out_size: int, r0: int,
                         r1: int) -> torch.Tensor:
    """Rows [r0, r1) of ``upsample_smooth(img, out_size)`` from ``small``
    [rows, ceil(out_size/2)], the rows [s0, s0 + rows) of img."""
    dev = launch.device_of([small])
    if dev.type == "cpu":
        return upsample_rows_plain(small, s0, out_size, r0, r1)
    return _launch_up(small, s0, out_size, r0, r1, "up", None, dev)


def upsample_subtract(cur: torch.Tensor, small: torch.Tensor, s0: int = 0,
                      r0: int = 0) -> torch.Tensor:
    """cur [rows, n], the rows [r0, r0 + rows) of a level, less the same
    rows of the expand of ``small`` (rows [s0, ...) of the next level):
    mode 1."""
    dev = launch.device_of([cur, small])
    if dev.type == "cpu":
        return upsample_subtract_plain(cur, small, s0, r0)
    launch.check_rows(cur, "cur")
    return _launch_up(small, s0, cur.shape[1], r0, r0 + cur.shape[0], "subtract", cur, dev)


def upsample_add(small: torch.Tensor, band: torch.Tensor, s0: int = 0,
                 r0: int = 0) -> torch.Tensor:
    """The rows [r0, r0 + rows) of the expand of ``small`` (rows [s0, ...)
    of the coarser level) plus band [rows, n] (float32 or bf16): mode 2."""
    dev = launch.device_of([small, band])
    if dev.type == "cpu":
        return upsample_add_plain(small, band, s0, r0)
    launch.check_rows(band, "add", (torch.float32, torch.bfloat16))
    return _launch_up(small, s0, band.shape[1], r0, r0 + band.shape[0], "add", band, dev)


def reduce_tail(cur: torch.Tensor, levels: int):
    """(bands, downs) of ``levels`` levels from cur [s, s] float32 (s <=
    ``TAIL_MAX``, levels <= ``MAX_TAIL_LEVELS``), one launch."""
    dev = launch.device_of([cur])
    if dev.type == "cpu":
        return reduce_tail_plain(cur, levels)
    return _launch_reduce_tail(cur, levels, dev)


def expand_tail(top: torch.Tensor, bands: Sequence[torch.Tensor]) -> torch.Tensor:
    """``top`` expanded through ``bands`` (the largest first, each
    ceil-halved to the next, float32 or bf16; the largest <= ``TAIL_MAX``),
    one launch."""
    dev = launch.device_of([top, *bands])
    if dev.type == "cpu":
        return expand_tail_plain(top, bands)
    return _launch_expand_tail(top, bands, dev)


def reduce_ladder(normalized: torch.Tensor, levels: int):
    """(bands, downs) of the ``levels``-level ladder, equal to
    ``reduce_ladder_plain``'s: on a CUDA device a fused step a level while
    the level is larger than ``TAIL_CUT``, then one tail launch for the
    rest (more where a tail would exceed ``MAX_TAIL_LEVELS``)."""
    dev = launch.device_of([normalized])
    if dev.type == "cpu":
        return reduce_ladder_plain(normalized, levels)
    launch.check_image(normalized, "normalized")
    bands: List[torch.Tensor] = []
    downs: List[torch.Tensor] = []
    cur = normalized
    while len(bands) < levels:
        if cur.shape[0] > TAIL_CUT:
            band, dn = _launch_step(cur, dev)
            bands.append(band)
            downs.append(dn)
        else:
            b, d = _launch_reduce_tail(cur, min(levels - len(bands), MAX_TAIL_LEVELS), dev)
            bands += b
            downs += d
        cur = downs[-1]
    return bands, downs


def expand_ladder(top: torch.Tensor, bands: Sequence[torch.Tensor]) -> torch.Tensor:
    """``top`` (the ladder's last down) expanded through ``bands`` (level 0
    first, float32 or bf16) to the reconstruction, equal to
    ``expand_ladder_plain``'s: on a CUDA device one tail launch for the
    bands of ``TAIL_CUT`` px or less (more where they exceed
    ``MAX_TAIL_LEVELS``), then an expand step a band."""
    dev = launch.device_of([top, *bands])
    if dev.type == "cpu":
        return expand_ladder_plain(top, bands)
    recon = top
    k = len(bands)
    small = sum(b.shape[-1] <= TAIL_CUT for b in bands)
    while k > len(bands) - small:
        lo = max(len(bands) - small, k - MAX_TAIL_LEVELS)
        recon = _launch_expand_tail(recon, bands[lo:k], dev)
        k = lo
    for b in reversed(bands[:k]):
        recon = _launch_up(recon, 0, b.shape[1], 0, b.shape[0], "add", b, dev)
    return recon
