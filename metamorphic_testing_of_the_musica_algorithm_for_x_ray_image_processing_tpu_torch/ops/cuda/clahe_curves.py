"""Wrapper of the CLAHE LUT kernel KC in ``csrc/clahe_curves.cu`` (launch
counter: ``launch.LAUNCHES["clahe_curves"]``).

KC replaces no Pallas kernel: it is the counterpart of the JAX package's
``ops/clahe.py::clahe_curves`` (:52, XLA code).  The plain version is
``ops/clahe.py::clahe_curves_plain``, about 20 small operations on the
[tiles, tiles, bins] histograms, each a launch on the card; KC is one
launch, a warp a tile, with the same bits (its float64 sums are exact in
any order, ``ops/clahe.py``'s docstring).  Bound: one block's latency.

``ops/clahe.py::clahe_curves`` dispatches on the device (a CPU histogram
runs the plain version); there is no fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import launch


def clahe_curves(hists: torch.Tensor, cfg):
    """(px [bins], py [t, t, bins]) float32 of CUDA int32 histograms [t, t,
    bins]: views of one tensor on their device, one launch."""
    dev = launch.device_of([hists])
    t, bins = cfg.clahe_tiles, cfg.clahe_bins
    if hists.dtype != torch.int32 or tuple(hists.shape) != (t, t, bins) \
            or not hists.is_contiguous():
        raise ValueError(f"clahe_curves: expected contiguous int32 [{t}, {t}, {bins}], got "
                         f"{hists.dtype} {tuple(hists.shape)}")
    if bins < 2:
        raise ValueError(f"clahe_bins={bins}: at least 2")
    out = torch.empty(bins + t * t * bins, dtype=torch.float32, device=dev)
    px, py = out[:bins], out[bins:].view(t, t, bins)
    launch.launch(launch.lib(), "musica_clahe_curves", "clahe_curves", dev, hists.data_ptr(),
                  t * t, bins, np.float32(cfg.clahe_clip_limit), px.data_ptr(), py.data_ptr())
    return px, py
