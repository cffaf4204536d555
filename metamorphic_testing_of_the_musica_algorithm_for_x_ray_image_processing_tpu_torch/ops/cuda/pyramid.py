"""Wrappers of the pyramid kernels in ``csrc/pyramid.cu``, each beside its
plain PyTorch version (``ops/pyramid.py``'s float64 stencils; launch
counters ``pyramid_down`` and ``pyramid_up``).

=========================  ==================================================
wrapper                    replaces (JAX package, XLA code in ops/pyramid.py)
=========================  ==================================================
``smooth_downsample``,     ``smooth_downsample`` (:85) and the down half of
``smooth_downsample_rows`` ``reduce_step_split`` (:213):
                           ``smooth_downsample_kernel``
``upsample_smooth``,       ``upsample_smooth`` (:310):
``upsample_smooth_rows``   ``upsample_smooth_kernel<0>``
``upsample_subtract``      ``upsample_smooth`` with ``reduce_ladder``'s band
                           subtraction (:261): ``upsample_smooth_kernel<1>``
``upsample_add``           ``upsample_smooth`` with ``models/musica.py``'s
                           expand add (:155): ``upsample_smooth_kernel<2>``
=========================  ==================================================

These are counterparts of XLA code, not of Pallas kernels.  Each kernel
repeats its plain version's float64 sums operation by operation, so it
equals it bit for bit at every size (the source says how).  Every wrapper
takes a window of rows (the spatial path's shards, ``parallel/spatial.py``):
the input holds rows [x0, ...) of its image, which must include every row
the window's taps read (``pyramid.needed_rows``; below the expand's
polyphase size, 6 px, the whole small image), and the output is the
window's rows of the whole op.  A whole image is the window of all its
rows.  The fused forms write ``cur - up`` and ``up + band`` in one launch,
where the plain path runs the expand and a float32 subtraction or addition;
a bf16 band is read as its exact float32 value.

Dispatch (``launch.py``): a CUDA tensor launches the kernel or raises; a
CPU tensor runs the plain version.  There is no fallback from one to the
other.  On the card the wrappers take 2-D contiguous float32 images (a band
may be bf16); the plain versions also take leading batch dimensions.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import pyramid
from . import launch

_MODES = {"up": 0, "subtract": 1, "add": 2}


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

smooth_downsample_plain = pyramid.smooth_downsample_plain
smooth_downsample_rows_plain = pyramid.smooth_downsample_rows_plain
upsample_rows_plain = pyramid.upsample_rows_plain
upsample_subtract_plain = pyramid.upsample_subtract_plain
upsample_add_plain = pyramid.upsample_add_plain


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
    dh, dw = -(-h // 2), -(-w // 2)
    if not 0 <= j0 < j1 <= dh:
        raise ValueError(f"output rows [{j0}, {j1}) of a {dh}-row result")
    _holds(pyramid.needed_rows("smooth_downsample", h, j0, j1), x0, rows, h,
           "smooth_downsample")
    out = torch.empty((j1 - j0, dw), dtype=torch.float32, device=dev)
    launch.launch(launch.lib(), "musica_smooth_downsample", "pyramid_down", dev, x.data_ptr(),
                  x0, rows, h, w, out.data_ptr(), j0, j1)
    return out


def _launch_up(small: torch.Tensor, s0: int, n: int, r0: int, r1: int, mode: str,
               other: Optional[torch.Tensor], dev: torch.device) -> torch.Tensor:
    launch.check_rows(small, "small")
    src = -(-n // 2)
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


# ----------------------------------------------------------------------
# wrappers: plain on the CPU, the kernel on a CUDA device
# ----------------------------------------------------------------------

def smooth_downsample(img: torch.Tensor) -> torch.Tensor:
    """img [h, w] float32 -> [ceil(h/2), ceil(w/2)]: KP1 on the whole image."""
    dev = launch.device_of([img])
    if dev.type == "cpu":
        return smooth_downsample_plain(img)
    return _launch_down(img, 0, img.shape[0], 0, -(-img.shape[0] // 2), dev)


def smooth_downsample_rows(x: torch.Tensor, x0: int, h: int, j0: int, j1: int) -> torch.Tensor:
    """Rows [j0, j1) of ``smooth_downsample`` of an [h, w] image from ``x``
    [rows, w], its rows [x0, x0 + rows)."""
    dev = launch.device_of([x])
    if dev.type == "cpu":
        return smooth_downsample_rows_plain(x, x0, h, j0, j1)
    return _launch_down(x, x0, h, j0, j1, dev)


def upsample_smooth(img: torch.Tensor, out_size: int) -> torch.Tensor:
    """img [src, src] float32 (src = ceil(out_size/2)) -> [out_size,
    out_size]: KP2 (mode 0) on the whole image."""
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
    KP2 (mode 1)."""
    dev = launch.device_of([cur, small])
    if dev.type == "cpu":
        return upsample_subtract_plain(cur, small, s0, r0)
    launch.check_rows(cur, "cur")
    return _launch_up(small, s0, cur.shape[1], r0, r0 + cur.shape[0], "subtract", cur, dev)


def upsample_add(small: torch.Tensor, band: torch.Tensor, s0: int = 0,
                 r0: int = 0) -> torch.Tensor:
    """The rows [r0, r0 + rows) of the expand of ``small`` (rows [s0, ...)
    of the coarser level) plus band [rows, n] (float32 or bf16): KP2
    (mode 2)."""
    dev = launch.device_of([small, band])
    if dev.type == "cpu":
        return upsample_add_plain(small, band, s0, r0)
    launch.check_rows(band, "add", (torch.float32, torch.bfloat16))
    return _launch_up(small, s0, band.shape[1], r0, r0 + band.shape[0], "add", band, dev)
