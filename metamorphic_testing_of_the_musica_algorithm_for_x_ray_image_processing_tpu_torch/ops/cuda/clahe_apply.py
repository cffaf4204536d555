"""Wrapper of the CLAHE apply kernel in ``csrc/clahe_apply.cu``, beside its
plain PyTorch version.

=================  =======================================================
wrapper            replaces (JAX package)
=================  =======================================================
``clahe_apply``    ``ops/pallas/clahe_apply.py::clahe_apply_fused``
                   (``_kernel``): the bilinear blend of up to 4 tile LUTs
=================  =======================================================

The kernel holds the t*t LUTs in shared memory (16 KB at the defaults) and
reads one pixel, its row's and its column's blend attributes, and up to 8
LUT entries per pixel; it is bound by one read and one write of the image.
The per-axis attributes come from ``ops.clahe.axis_attrs``, the same code
the plain version runs, so the kernel equals the plain version exactly
(NaN tiles included).  It runs at every size: there is no block-shape
condition as on the TPU.
"""

from __future__ import annotations

import torch

from .. import clahe
from . import launch


def clahe_apply_plain(recon: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                      cfg) -> torch.Tensor:
    """Plain version: ``ops.clahe.clahe_apply`` (the JAX package's XLA
    formulation, gathers into the flattened LUTs)."""
    return clahe.clahe_apply(recon, px, py, cfg)


def clahe_apply(recon: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                cfg) -> torch.Tensor:
    """recon [n, n] float32 + per-tile CDF LUTs py [t, t, bins] -> the
    blended CLAHE image [n, n].  ``px`` is the LUTs' x grid from
    ``clahe_curves`` (i / bins, the last point 1.0), which the kernel
    implies."""
    dev = launch.device_of([recon, py])
    if dev.type == "cpu":
        return clahe_apply_plain(recon, px, py, cfg)
    t, bins = cfg.clahe_tiles, cfg.clahe_bins
    launch.check_image(recon, "recon")
    if py.dtype != torch.float32 or tuple(py.shape) != (t, t, bins):
        raise ValueError(f"py: expected float32 [{t}, {t}, {bins}], got "
                         f"{py.dtype} {tuple(py.shape)}")
    if bins < 2:
        raise ValueError(f"clahe_bins={bins}: at least 2")
    launch.check_bins(t * t * bins)  # the LUTs live in 48 KB of shared memory
    n = recon.shape[-1]
    if n < t:
        raise ValueError(f"image size {n} < {t} tiles")
    base_i, nb_i, w_base, w_nb, zero = clahe.axis_attrs(n, cfg, recon)
    ax_tile = torch.stack([base_i, nb_i, zero.to(torch.int32)])
    ax_w = torch.stack([w_base, w_nb])
    luts = py.contiguous()
    out = torch.empty_like(recon)
    lib = launch.lib()
    with torch.cuda.device(dev):
        launch.launch(lib, "musica_clahe_apply", "clahe_apply",
                      recon.data_ptr(), out.data_ptr(), luts.data_ptr(),
                      ax_tile.data_ptr(), ax_w.data_ptr(), n, t, bins,
                      launch.stream(dev))
    return out
