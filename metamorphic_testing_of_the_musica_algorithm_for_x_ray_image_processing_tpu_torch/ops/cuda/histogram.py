"""Wrapper of the generic histogram kernel in ``csrc/histogram.cu``, beside
its plain PyTorch version, which every histogram of the port shares.

=============  ===========================================================
wrapper        replaces (JAX package)
=============  ===========================================================
``histogram``  ``ops/pallas/histogram.py::factorized_histogram_pallas``
               (``_hist_kernel``): exact int32 counts of (bin, weight)
               pairs; the CLAHE joint histogram (16 tiles x 256 bins)
=============  ===========================================================

The Pallas kernel builds the counts as a factorised one-hot matrix product
because the TPU has no scatter.  Here a grid-stride loop reads the int32
(bin, weight) pairs once (8 bytes per pair: the kernel is bound by that
read) and adds into a histogram privatised in shared memory with integer
atomics; one global atomic per non-zero bin flushes a block.  Integer
atomics give the same counts in every order, so the kernel equals the plain
version exactly.

Weights are integers.  They may arrive as float32 integers, as in the JAX
package: the wrapper converts them to int32 once (truncation, as the JAX
package's ``scatter`` method does).  Pairs whose bin lies outside
``[0, n_bins)`` are dropped: the plain version zeroes their weights and
clamps their bins, as the JAX package's ``fixed_histogram`` does; the kernel
skips them.
"""

from __future__ import annotations

import torch

from . import launch


def histogram_plain(bins: torch.Tensor, weights: torch.Tensor,
                    n_bins: int) -> torch.Tensor:
    """Plain version: an int64 ``scatter_add_`` of the integer weights,
    returned as exact int32 counts [n_bins]."""
    b = bins.reshape(-1).to(torch.int64)
    w = weights.reshape(-1).to(torch.int64)
    in_range = (b >= 0) & (b < n_bins)
    h = torch.zeros(n_bins, dtype=torch.int64, device=bins.device)
    h.scatter_add_(0, b.clamp(0, n_bins - 1), torch.where(in_range, w, 0))
    return h.to(torch.int32)


def histogram(bins: torch.Tensor, weights: torch.Tensor,
              n_bins: int) -> torch.Tensor:
    """Exact int32 histogram [n_bins] of integer ``bins`` (any shape) with
    integer-valued ``weights`` of the same shape."""
    dev = launch.device_of([bins, weights])
    if bins.shape != weights.shape:
        raise ValueError(f"bins {tuple(bins.shape)} != weights {tuple(weights.shape)}")
    if dev.type == "cpu":
        return histogram_plain(bins, weights, n_bins)
    launch.check_bins(n_bins)
    if bins.dtype != torch.int32:
        raise TypeError(f"bins: expected torch.int32, got {bins.dtype}")
    hist = torch.zeros(n_bins, dtype=torch.int32, device=dev)
    if bins.numel() == 0:
        return hist
    b = bins.reshape(-1).contiguous()
    w = weights.reshape(-1).to(torch.int32).contiguous()
    lib = launch.lib()
    launch.launch(lib, "musica_histogram", "histogram", dev, b.data_ptr(), w.data_ptr(),
                  b.numel(), hist.data_ptr(), n_bins)
    return hist
