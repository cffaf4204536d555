"""Wrapper of the tone-map kernel KT in ``csrc/tonemap.cu``, beside its plain
PyTorch version (launch counter: ``launch.LAUNCHES["tone_map"]``).

KT replaces no Pallas kernel: it is the counterpart of the JAX package's
``ops/curves.py::curve_get_y_general`` (:151) with ``curve_apply_u8_adaptive``
(:221), as its ``models/musica.py:186-190`` calls them, which XLA fuses into
one elementwise pass.  The port's plain version, ``curves.curve_get_y_general``
then ``curves.curve_apply_u8`` on the margin crop, is over 100 launches over
the whole frame on the card; KT is one, with the same bits: ``graded`` and
``out_u8`` equal the plain version's, NaN included.

The kernel builds the curve's tables (``curves.general_tables``) in each
block from the curve points on the device, so nothing waits for the host and
a captured graph replays it with each run's curve.  Bound: bytes, the image
read once, ``graded`` and the cropped ``out_u8`` written once (84.8 MB at
3072^2).

A window of rows (the spatial path's shards, ``parallel/spatial.py``):
``row0`` places the window in the [n, n] image, and ``out_u8`` holds the
window's rows inside the crop.  A whole image is the window of all its rows.

Dispatch (``launch.py``): a CUDA tensor launches the kernel or raises; a CPU
tensor runs the plain version.  There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import curves
from . import launch

MAX_POINTS = 63  # csrc/tonemap.cu: kMaxPoints


def crop_rows(n: int, row0: int, rows: int, m: int) -> Tuple[int, int]:
    """The image rows [a, b) of the window [row0, row0 + rows) of an [n, n]
    image inside the crop of margin ``m`` (a == b: none)."""
    a, b = max(row0, m), min(row0 + rows, n - m)
    return a, max(a, b)


def tone_map_plain(x: torch.Tensor, gpx: torch.Tensor, gpy: torch.Tensor, m: int,
                   row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``tone_map``: ``curves.curve_get_y_general`` of the
    window, then ``curves.curve_apply_u8`` of its rows and columns inside
    the crop."""
    rows, n = x.shape[-2], x.shape[-1]
    graded = curves.curve_get_y_general(gpx, gpy, x)
    a, b = crop_rows(n, row0, rows, m)
    return graded, curves.curve_apply_u8(graded[a - row0:b - row0, m:n - m])


def tone_map(x: torch.Tensor, gpx: torch.Tensor, gpy: torch.Tensor, m: int,
             row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(graded, out_u8) of ``x`` [rows, n] float32, the rows [row0, row0 +
    rows) of an [n, n] image, under the gradation curve ``gpx``, ``gpy``
    (float32 [k]): ``graded`` [rows, n] float32 = ``curve_get_y_general``;
    ``out_u8`` [b - a, n - 2m] uint8, its rows [a, b) = ``crop_rows`` and
    columns [m, n - m) quantized by ``curve_apply_u8``.  One launch."""
    dev = launch.device_of([x, gpx, gpy])
    if dev.type == "cpu":
        return tone_map_plain(x, gpx, gpy, m, row0)
    return _launch_tone_map(x, gpx, gpy, m, row0)[:2]


def tone_tables(x: torch.Tensor, gpx: torch.Tensor, gpy: torch.Tensor, m: int, row0: int = 0):
    """``tone_map`` on a CUDA window that also returns the tables its first
    block built, float32 [4, k + 1] (px_e, py_e, m_tab, px_hi with a 0
    appended): the card's check that they equal ``curves.general_tables``."""
    return _launch_tone_map(x, gpx, gpy, m, row0, tables=True)


def _launch_tone_map(x, gpx, gpy, m: int, row0: int, tables: bool = False):
    dev = launch.device_of([x, gpx, gpy])
    launch.check_rows(x, "x")
    for name, t in (("gpx", gpx), ("gpy", gpy)):
        if t.dtype != torch.float32 or t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 [k], got {t.dtype} "
                             f"{tuple(t.shape)}")
    k = gpx.shape[0]
    if gpy.shape[0] != k or not 1 <= k <= MAX_POINTS:
        raise ValueError(f"a curve of {k} and {gpy.shape[0]} points; 1 to {MAX_POINTS} "
                         f"points each")
    rows, n = x.shape
    if not (0 <= row0 <= n - rows and 0 <= 2 * m < n):
        raise ValueError(f"rows [{row0}, {row0 + rows}) and margin {m} of a {n}-row image")
    a, b = crop_rows(n, row0, rows, m)
    graded = torch.empty_like(x)
    out = torch.empty((b - a, n - 2 * m), dtype=torch.uint8, device=dev)
    tab = torch.empty((4, k + 1), dtype=torch.float32, device=dev) if tables else None
    launch.launch(launch.lib(), "musica_tone_map", "tone_map", dev, x.data_ptr(),
                  graded.data_ptr(), out.data_ptr(), gpx.data_ptr(), gpy.data_ptr(), k, rows, n,
                  row0, m, None if tab is None else tab.data_ptr())
    return graded, out, tab
