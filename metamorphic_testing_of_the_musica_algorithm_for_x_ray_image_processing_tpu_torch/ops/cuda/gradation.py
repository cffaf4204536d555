"""Wrapper of the gradation-curve kernel KG in ``csrc/gradation_curve.cu``
(launch counter: ``launch.LAUNCHES["gradation_curve"]``).

KG replaces no Pallas kernel: it is the counterpart of the JAX package's
``ops/gradation.py::gradation_curve`` (:119) with ``ops/curves.py``'s
``bezier_points``, as its ``models/musica.py:179`` calls them (XLA code).
The plain version is ``ops/gradation.py::gradation_curve_plain``, ~140 small
operations on the 1,024 bins, each a launch on the card; KG is one launch
of one block, with the same bits.  It writes the curve on the device, so a
captured graph replays it with each run's histogram, and the tone map KT
reads the points where KG left them.  Bound: one block's latency (4 KB
read, 188 bytes written).

``ops/gradation.py::gradation_curve`` dispatches on the device (a CPU
histogram runs the plain version); there is no fallback from one to the
other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import launch

MAX_BINS = 4096  # csrc/gradation_curve.cu: kThreads x kPerThread
POINTS = 22


def gradation_curve(hist: torch.Tensor, cfg):
    """(px[22], py[22], (t0, ta, t1)) of a CUDA int32 histogram [bins]:
    float32 views of one [47] tensor on its device.  One launch."""
    dev = launch.device_of([hist])
    bins = cfg.grad_histogram_bins
    if hist.dtype != torch.int32 or tuple(hist.shape) != (bins,) or not hist.is_contiguous():
        raise ValueError(f"gradation_curve: expected a contiguous int32 [{bins}] histogram, "
                         f"got {hist.dtype} {tuple(hist.shape)}")
    if not 1 <= bins <= MAX_BINS or cfg.grad_lowest_relevant_bin < 0:
        raise ValueError(f"gradation_curve: {bins} bins (1 to {MAX_BINS}), lowest relevant "
                         f"bin {cfg.grad_lowest_relevant_bin}")
    out = torch.empty(2 * POINTS + 3, dtype=torch.float32, device=dev)
    f = np.float32  # the configuration's values as the plain chain's float32 operands
    launch.launch(launch.lib(), "musica_gradation_curve", "gradation_curve", dev,
                  hist.data_ptr(), bins, cfg.grad_lowest_relevant_bin,
                  f(cfg.grad_low_threshold_frac), f(1.0 / bins), f(cfg.grad_t0_backoff),
                  f(cfg.grad_slope), f(cfg.grad_y_mid), out.data_ptr())
    t = 2 * POINTS
    return out[:POINTS], out[POINTS:t], (out[t], out[t + 1], out[t + 2])
