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


def _zero_min(shape, windowed: bool, quirks: bool) -> bool:
    """Whether quirks mode pins vmin to 0 (QUIRKS #2) for an integer image
    of ``shape`` [..., rows, n]: its chain misaligns along either side.  A
    window (``windowed``: the spatial path's rows, with given extrema)
    stands for the whole [n, n] image."""
    h = shape[-1] if windowed else shape[-2]
    return quirks and (_chain_misaligned(shape[-1]) or _chain_misaligned(h))


def img_sqrt(img_u16: torch.Tensor) -> torch.Tensor:
    """Variance-stabilizing sqrt (shaders/img_sqrt.comp:15-18), correctly
    rounded float32."""
    return _sqrt(img_u16.to(torch.float32))


def global_max(sqrt_img: torch.Tensor, quirks: bool = True) -> torch.Tensor:
    """The max reduce chain: trunc is monotone, so its per-step
    truncations equal one trunc of the global max (QUIRKS #1), and the
    out-of-bounds zeros never raise a max of nonnegative values."""
    m = sqrt_img.amax(dim=(-2, -1))
    return torch.trunc(m) if quirks else m


def global_min(sqrt_img: torch.Tensor, quirks: bool = True) -> torch.Tensor:
    """The min reduce chain: as ``global_max``, except that a misaligned
    chain pins the result to 0 (QUIRKS #2, decided from the image size)."""
    if not quirks:
        return sqrt_img.amin(dim=(-2, -1))
    if _zero_min(sqrt_img.shape, False, quirks):
        return sqrt_img.new_zeros(sqrt_img.shape[:-2])
    return torch.trunc(sqrt_img.amin(dim=(-2, -1)))


def img_normalize(sqrt_img: torch.Tensor, vmax, vmin, quirks: bool = True) -> torch.Tensor:
    """(x - min) / (max - min), divided by a tensor; quirks mode does not
    clamp (QUIRKS #3).  ``vmax``/``vmin``: numbers or (batch-shaped)
    tensors."""
    vmax = torch.as_tensor(vmax, dtype=torch.float32, device=sqrt_img.device)[..., None, None]
    vmin = torch.as_tensor(vmin, dtype=torch.float32, device=sqrt_img.device)[..., None, None]
    out = (sqrt_img - vmin) / (vmax - vmin)
    if not quirks:
        out = out.clamp(0.0, 1.0)
    return out


def normalize_from_u16(img_u16: torch.Tensor, quirks: bool = True, extrema=None):
    """(normalized, vmax, vmin) from an integer image [..., n, n].

    vmax and vmin stay 0-d (or batch-shaped) tensors on the input's device.
    ``extrema``: the image's (max, min) as float32 tensors, reduced
    elsewhere; ``img_u16`` is then a window of rows [rows, n] of an [n, n]
    image (the spatial path's shard) and is normalized as the whole.

    A CUDA image [rows, n] launches the kernel KN (``ops/cuda/normalize.py``:
    the extrema pass unless ``extrema`` is given, then the apply pass) or
    raises; a CPU image runs ``normalize_from_u16_plain``."""
    from .cuda import launch

    dev = launch.device_of([img_u16, *(extrema or ())])
    if dev.type == "cpu":
        return normalize_from_u16_plain(img_u16, quirks, extrema)
    from .cuda import normalize as kn
    return kn.normalize(img_u16, quirks, _zero_min(img_u16.shape, extrema is not None, quirks),
                        extrema)


def extrema_partials(img_u16: torch.Tensor) -> torch.Tensor:
    """float32 [k, 2] whose columns' max and min are the integer image's max
    and min as float32: KN's extrema pass on a CUDA image (a pair a block),
    one pair on the CPU.  The spatial path reduces its shards' partials
    into the whole image's ``extrema``."""
    from .cuda import launch

    if launch.device_of([img_u16]).type == "cpu":
        x = img_u16.to(torch.float32)
        return torch.stack([x.amax(), x.amin()])[None]
    from .cuda import normalize as kn
    return kn.extrema_partials(img_u16)


def normalize_from_u16_plain(img_u16: torch.Tensor, quirks: bool = True, extrema=None):
    """Plain version of ``normalize_from_u16``.

    sqrt is monotone, so the global max/min commute with it: the reductions
    run on the input values and the sqrt is applied to the two scalars."""
    x = img_u16.to(torch.float32)  # u16 -> f32 is exact
    if extrema is None:
        hi, lo = x.amax(dim=(-2, -1)), x.amin(dim=(-2, -1))
    else:
        hi, lo = extrema
    vmax = _sqrt(hi)
    vmin = _sqrt(lo)
    if quirks:
        vmax = torch.trunc(vmax)
        if _zero_min(img_u16.shape, extrema is not None, quirks):
            vmin = torch.zeros_like(vmin)
        else:
            vmin = torch.trunc(vmin)
    out = (_sqrt(x) - vmin[..., None, None]) / (vmax - vmin)[..., None, None]
    if not quirks:
        out = out.clamp(0.0, 1.0)
    return out, vmax, vmin
