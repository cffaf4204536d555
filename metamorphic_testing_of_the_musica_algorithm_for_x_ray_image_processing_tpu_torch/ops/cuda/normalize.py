"""Wrapper of the normalize kernel KN in ``csrc/normalize.cu`` (launch counter:
``launch.LAUNCHES["normalize"]``, one count for each of its two passes).

KN replaces no Pallas kernel: it is the counterpart of the JAX package's
``ops/normalize.py::normalize_from_u16`` (:56) with ``img_normalize`` (:78),
as its ``models/musica.py:80`` calls them (XLA code).  The plain version is
``ops/normalize.py::normalize_from_u16_plain``, some 17 launches over the
whole frame on the card; KN is two (the extrema pass, then the apply pass)
with the same bits, NaN included.  Nothing waits for the host: the apply
pass reduces the extrema pass's partials on the device, so a captured graph
replays both.  Bound: bytes, the integer image read once and the float32
image written once (56.6 MB at 3072^2 in uint16); the extrema pass's second
read is the two-pass design's own cost.

Input types (any other raises on the card):

* uint16: the radiographs, as ``models/musica.py::to_device`` uploads them
  (``process``, ``process_batch``, ``timed_process``, ``cli process``,
  ``report`` and ``view``, the campaign's runner, the bench);
* int32: ``process_jit`` of an int32 image (tests/test_torch_cuda.py's graph
  tests), which the port takes as the JAX package does.

These functions take CUDA tensors; ``ops/normalize.py`` dispatches on the
device (a CPU tensor runs the plain version).  There is no fallback from one
to the other.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import launch

DTYPES = {torch.uint16: 0, torch.int32: 1}  # csrc/normalize.cu: Dtype
MAX_PARTIALS = 264  # extrema blocks: two a streaming multiprocessor of an H100 SXM
_EXTREMA_CHUNK = 512 * 8  # a block's pixels in one step (kExtremaThreads x 16 bytes of uint16)


def _check(x: torch.Tensor) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"normalize: expected {' or '.join(map(str, DTYPES))}, got {x.dtype}")
    if x.ndim != 2 or x.numel() == 0:
        raise ValueError(f"normalize: expected a non-empty [rows, n] image, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("normalize: the image must be contiguous")


def extrema_partials(x: torch.Tensor) -> torch.Tensor:
    """float32 [k, 2]: (max, min) of each of the extrema pass's blocks over
    ``x`` (a CUDA [rows, n] integer image); the column max and min are the
    image's.  One launch."""
    dev = launch.device_of([x])
    _check(x)
    k = max(1, min(MAX_PARTIALS, math.ceil(x.numel() / _EXTREMA_CHUNK)))
    partials = torch.empty((k, 2), dtype=torch.float32, device=dev)
    launch.launch(launch.lib(), "musica_normalize_extrema", "normalize", dev, x.data_ptr(),
                  DTYPES[x.dtype], x.numel(), partials.data_ptr(), k)
    return partials


def normalize(x: torch.Tensor, quirks: bool, zero_min: bool,
              extrema: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """(normalized float32 [rows, n], vmax, vmin) of a CUDA integer image:
    the extrema pass (unless ``extrema``, the (max, min) float32 0-d tensors
    of the image the window ``x`` belongs to, is given), then the apply
    pass.  ``zero_min``: quirks mode's misaligned chain (vmin = +0)."""
    dev = launch.device_of([x] + list(extrema or ()))
    _check(x)
    if extrema is None:
        partials = extrema_partials(x)
        his, los, n_ext, stride = partials, partials[:, 1], partials.shape[0], 2
    else:
        his, los = extrema
        for t in (his, los):
            if t.dtype != torch.float32 or t.numel() != 1:
                raise ValueError(f"extrema: expected float32 scalars, got {t.dtype} "
                                 f"{tuple(t.shape)}")
        n_ext, stride = 1, 1
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    scalars = torch.empty(2, dtype=torch.float32, device=dev)
    launch.launch(launch.lib(), "musica_normalize_apply", "normalize", dev, x.data_ptr(),
                  DTYPES[x.dtype], x.numel(), out.data_ptr(), his.data_ptr(), los.data_ptr(),
                  n_ext, stride, int(quirks), int(zero_min), scalars.data_ptr())
    return out, scalars[0], scalars[1]
