"""Wrapper of the CLAHE joint-histogram kernel KH in ``csrc/clahe_hist.cu``,
beside its plain PyTorch version (launch counter:
``launch.LAUNCHES["clahe_hist"]``).

==============  ============================================================
wrapper         replaces (JAX package, XLA code)
==============  ============================================================
``clahe_hist``  ``ops/noise.py::img_relevant`` with
                ``ops/clahe.py::clahe_histograms`` (its joint bins, then the
                histogram kernel of ``ops/pallas/histogram.py``, K6 here), as
                ``models/musica.py:166-172`` calls them on the CLAHE path
==============  ============================================================

The plain version makes the full-size relevance image
(``noise.img_relevant``), the joint bins and their histogram
(``clahe.clahe_histograms_rows``): about 50 operations on the card, some
35 of them over every pixel.  KH decides each pixel's relevance from the
small CNR map itself (K3's block weight: relevant where it is 100, or -1
and normalized <= max_pixel), reads normalized only where a CNR block is
solid and recon only where a pixel is relevant, and counts into
histograms privatised in shared memory (a block's, of the tiles it
reaches), so the counts equal the plain version's exactly.  Where the ramp's exponent is no integer in 1..8
(``noise.chain_exponent``) the plain version takes pow, which the card need
not round alike: the wrapper then hands KH the weights of
``fused_hist.relevance_weight_plane`` instead of the CNR map, one explicit
branch of the launch.  A weight of 100 is a ramp value of 1.0 only while
that value is at most 1, so a CUDA call refuses a rule with
``relevant_cnr_low`` or ``relevant_k`` below 0.

A window of rows (the spatial path's shards): recon and normalized [rows,
n] hold the rows [row0, row0 + rows) of an [n, n] image, cnr the CNR rows
[cnr_row0, ...) that they read (``noise.cnr_rows``), so the histograms of a
partition of the rows sum to the whole image's.

Dispatch (``launch.py``): a CUDA tensor launches the kernel or raises; a
CPU tensor runs the plain version.
"""

from __future__ import annotations

import torch

from .. import f32, noise
from . import launch
from .fused_hist import relevance_rule, relevance_weight_plane


def shared_bytes(cfg) -> int:
    """The most shared memory a block of KH takes: the joint histograms of
    the tiles it reaches, at most every tile."""
    return 4 * cfg.clahe_tiles * cfg.clahe_tiles * cfg.clahe_bins


def clahe_hist_plain(recon, normalized, cnr, cfg, row0: int = 0, cnr_row0: int = 0):
    """Plain version: the relevance image (``noise.img_relevant``), then
    ``clahe.clahe_histograms_rows``."""
    from .. import clahe

    rel = noise.img_relevant(normalized, cnr, cfg, row0, cnr_row0)
    return clahe.clahe_histograms_rows(recon, rel, row0, recon.shape[-1], cfg)


def clahe_hist(recon: torch.Tensor, normalized: torch.Tensor, cnr: torch.Tensor, cfg,
               row0: int = 0, cnr_row0: int = 0) -> torch.Tensor:
    """int32 [tiles, tiles, bins] joint histogram of the pixels of recon
    whose relevance (``noise.img_relevant`` of normalized and the CNR map)
    is 1.0, bins ``int(recon * (bins - 1) + 0.5)``, one launch."""
    dev = launch.device_of([recon, normalized, cnr])
    if dev.type == "cpu":
        return clahe_hist_plain(recon, normalized, cnr, cfg, row0, cnr_row0)
    t, bins = cfg.clahe_tiles, cfg.clahe_bins
    if cfg.relevant_cnr_low < 0 or cfg.relevant_k < 0:
        raise ValueError(f"KH takes a ramp value of at most 1: relevant_cnr_low "
                         f"{cfg.relevant_cnr_low} and relevant_k {cfg.relevant_k} must be >= 0")
    launch.check_rows(recon, "recon")
    launch.check_rows(normalized, "normalized")
    launch.check_rows(cnr, "cnr")
    if normalized.shape != recon.shape:
        raise ValueError(f"normalized {tuple(normalized.shape)} != recon {tuple(recon.shape)}")
    launch.check_shared(shared_bytes(cfg), f"clahe_tiles={t}, clahe_bins={bins}")
    rows, n = recon.shape
    if rows < 1 or not 0 <= row0 <= n - rows:
        raise ValueError(f"rows [{row0}, {row0 + rows}) of a {n}-row image")
    lo, hi = noise.cnr_rows(cnr.shape[-1], n, row0, row0 + rows)
    if not cnr_row0 <= lo < hi <= cnr_row0 + cnr.shape[-2]:
        raise ValueError(f"cnr holds CNR rows [{cnr_row0}, {cnr_row0 + cnr.shape[-2]}), "
                         f"the window reads [{lo}, {hi})")
    k = noise.chain_exponent(cfg.relevant_k)
    wplane = None if k else relevance_weight_plane(cnr, cfg).contiguous()
    hist = torch.zeros((t, t, bins), dtype=torch.int32, device=dev)
    launch.launch(launch.lib(), "musica_clahe_hist", "clahe_hist", dev, recon.data_ptr(),
                  normalized.data_ptr(), n, row0, rows, cnr.data_ptr() if k else None,
                  None if k else wplane.data_ptr(), cnr.shape[-1], cnr_row0, cnr.shape[-2],
                  cfg.relevant_border, *relevance_rule(cfg), k, t, bins, hist.data_ptr())
    return hist
