"""Input normalization: sqrt transform + global max/min + rescale.

Port of the JAX package's ``ops/normalize.py``.  In quirks mode the
reference's 8x8 reduce ladders leave two artifacts, both reproduced here:

* every reduce step stores through ``uvec4(value)``, a float -> uint
  truncation, so the global max is ``trunc(max)`` (QUIRKS #1);
* out-of-bounds reads return 0 and the ceil(n/8) chain misaligns for most
  sizes (3072 -> 384 -> 48 -> 6 -> 1), so the min chain absorbs a zero and
  the global min is 0 (QUIRKS #2);
* the reference's clamp is a discarded no-op, so quirks mode does not clamp
  (QUIRKS #3).
"""

from __future__ import annotations

import torch


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt on every device: PyTorch's CUDA float32
    sqrt is not (on an H100 it differed from the CPU's in 0.5 % of the pixels
    of a 3072^2 radiograph); float64 sqrt is, and rounding it to float32 gives
    the correctly rounded float32 result."""
    return torch.sqrt(x.double()).to(torch.float32)


def _chain_misaligned(n: int, area: int = 8) -> bool:
    """True when some step of the ceil(n/8) reduce chain reads out of bounds
    (the min chain then absorbs zeros).  3072 -> 384 -> 48 -> 6(!) -> 1."""
    while n > 1:
        if n % area != 0:
            return True
        n = -(-n // area)
    return False


def normalize_from_u16(img_u16: torch.Tensor, quirks: bool = True):
    """(normalized, vmax, vmin) from an integer image [..., n, n].

    sqrt is monotone, so the global max/min commute with it: the reductions
    run on the input values and the sqrt is applied to the two scalars.
    vmax and vmin stay 0-d (or batch-shaped) tensors on the input's device.
    """
    x = img_u16.to(torch.float32)  # u16 -> f32 is exact
    vmax = _sqrt(x.amax(dim=(-2, -1)))
    vmin = _sqrt(x.amin(dim=(-2, -1)))
    if quirks:
        vmax = torch.trunc(vmax)
        if (_chain_misaligned(img_u16.shape[-1])
                or _chain_misaligned(img_u16.shape[-2])):
            vmin = torch.zeros_like(vmin)
        else:
            vmin = torch.trunc(vmin)
    out = (_sqrt(x) - vmin[..., None, None]) / (vmax - vmin)[..., None, None]
    if not quirks:
        out = out.clamp(0.0, 1.0)
    return out, vmax, vmin
