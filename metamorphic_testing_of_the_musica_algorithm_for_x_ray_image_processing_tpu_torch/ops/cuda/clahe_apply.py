"""Wrapper of the CLAHE apply kernel in ``csrc/clahe_apply.cu``, beside its
plain PyTorch version.

=================  =======================================================
wrapper            replaces (JAX package)
=================  =======================================================
``clahe_apply``    ``ops/pallas/clahe_apply.py::clahe_apply_fused``
                   (``_kernel``): the bilinear blend of up to 4 tile LUTs
=================  =======================================================

The kernel builds, once per block of a one-wave grid, a table in shared
memory of each tile's segment starts and slopes (8 bytes per LUT entry: 32
KB at 4x4 tiles of 256 bins, 128 KB at 8x8) with the plain version's own
divisions, computes the blend attributes of ``ops.clahe.axis_attrs`` itself,
and then reads one pixel and up to 4 table entries per pixel, with no
division; it is bound by one read and one write of the image.  So the
wrapper launches one kernel and allocates its output, and the kernel equals
the plain version exactly (NaN tiles included).  It runs at every size:
there is no block-shape condition as on the TPU.  It takes a window of rows
(the spatial path's shards, ``parallel/spatial.py``): ``row0``, the window's
first global row, places the row blend attributes; a whole image is the
window of all its rows.
"""

from __future__ import annotations

import torch

from .. import clahe
from . import launch

_ROW_BATCH = 32  # kBatch in csrc/clahe_apply.cu
_AXIS_BYTES = 20  # sizeof(Axis) in csrc/clahe_apply.cu


def shared_bytes(t: int, bins: int) -> int:
    """Shared memory of a block of the kernel: the {y1, slope} table of
    every tile and segment, the segments' starts and widths, and a batch of
    rows' blend attributes."""
    return 8 * t * t * bins + 8 * bins + _AXIS_BYTES * _ROW_BATCH


def clahe_apply_plain(recon: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                      cfg, row0: int = 0) -> torch.Tensor:
    """Plain version: ``ops.clahe.clahe_apply_rows`` (the JAX package's XLA
    formulation, gathers into the flattened LUTs)."""
    return clahe.clahe_apply_rows(recon, px, py, row0, recon.shape[-1], cfg)


def clahe_apply(recon: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                cfg, row0: int = 0) -> torch.Tensor:
    """recon [n, n] float32 + per-tile CDF LUTs py [t, t, bins] -> the
    blended CLAHE image [n, n].  ``px`` is the LUTs' x grid from
    ``clahe_curves`` (i / bins, the last point 1.0), which the kernel
    implies.  A window: recon [rows, n] holds the rows [row0, row0 + rows)
    of an [n, n] image, and the result is those rows of the whole apply."""
    dev = launch.device_of([recon, py])
    if dev.type == "cpu":
        return clahe_apply_plain(recon, px, py, cfg, row0)
    t, bins = cfg.clahe_tiles, cfg.clahe_bins
    launch.check_rows(recon, "recon")
    if py.dtype != torch.float32 or tuple(py.shape) != (t, t, bins) or not py.is_contiguous():
        raise ValueError(f"py: expected contiguous float32 [{t}, {t}, {bins}], got "
                         f"{py.dtype} {tuple(py.shape)}")
    if bins < 2:
        raise ValueError(f"clahe_bins={bins}: at least 2")
    launch.check_shared(shared_bytes(t, bins), f"clahe_tiles={t}, clahe_bins={bins}")
    rows, n = recon.shape
    if n < t:
        raise ValueError(f"image size {n} < {t} tiles")
    if rows < 1 or not 0 <= row0 <= n - rows:
        raise ValueError(f"rows [{row0}, {row0 + rows}) of a {n}-row image")
    out = torch.empty_like(recon)
    lib = launch.lib()
    launch.launch(lib, "musica_clahe_apply", "clahe_apply", dev, recon.data_ptr(),
                  out.data_ptr(), py.data_ptr(), n, row0, rows, t, bins)
    return out
