"""Synthetic 16-bit radiographs made on the device from a seed: a copy of
the port's ``testing/phantoms.py`` (a NumPy generator, ~2 s an image at
3072^2 on the host) rewritten in PyTorch, so that a pool of 3072^2 images
takes a fraction of a second on the card.

Each image has the NumPy generator's structure and distributions: a soft
tissue ellipse, 4 to 8 bone ellipses with sharp edges, an 8-px trabecular
texture inside dense regions, the heel-effect falloff, Beer-Lambert
transmission at a dose (``full_well``), a collimated border at 2 % and
Poisson-like quantum noise.  The draws come from one ``torch.Generator``
on the device, seeded with the run's seed, so the same seed gives the same
pool on the same card.  The values differ from the NumPy generator's.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

MAX_BONES = 8


def _u(g: torch.Generator, lo: float, hi: float, k: int = 1) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(k, generator=g, device=g.device)


def radiograph(g: torch.Generator, size: int, full_well: float) -> torch.Tensor:
    """One [size, size] uint16 image on ``g``'s device."""
    dev = g.device
    c = torch.arange(size, dtype=torch.float32, device=dev) / size
    x, y = c[None, :], c[:, None]
    cx, cy = _u(g, 0.35, 0.65, 2)
    rx, ry = _u(g, 0.25, 0.42, 2)
    atten = 1.2 * torch.clamp(1.0 - ((x - cx) / rx) ** 2 - ((y - cy) / ry) ** 2, min=0.0)
    n_bones = torch.randint(4, MAX_BONES + 1, (1,), generator=g, device=dev)
    b = torch.rand((MAX_BONES, 5), generator=g, device=dev)
    bx, by = 0.2 + 0.6 * b[:, 0], 0.2 + 0.6 * b[:, 1]
    brx, bry = 0.02 + 0.10 * b[:, 2], 0.02 + 0.10 * b[:, 3]
    ang = math.pi * b[:, 4]
    ca, sa = torch.cos(ang), torch.sin(ang)
    for i in range(MAX_BONES):
        dx, dy = x - bx[i], y - by[i]
        xr, yr = dx * ca[i] + dy * sa[i], dy * ca[i] - dx * sa[i]
        bd2 = (xr / brx[i]) ** 2 + (yr / bry[i]) ** 2
        bone = 1.8 * torch.sqrt(torch.clamp(1.0 - bd2, min=0.0))
        atten = atten + bone * (i < n_bones).to(torch.float32)
    k = size // 8 + 1
    tex = torch.randn((k, k), generator=g, device=dev)
    tex = tex.repeat_interleave(8, 0).repeat_interleave(8, 1)[:size, :size]
    atten = atten + 0.05 * tex * (atten > 0.5)
    falloff = 1.0 - 0.15 * ((x - 0.5) ** 2 + (y - 0.5) ** 2)
    intensity = full_well * falloff * torch.exp(-atten)
    border = int(0.03 * size)
    edge = torch.ones(size, dtype=torch.float32, device=dev)
    edge[:border] = 0.02
    edge[size - border:] = 0.02
    # rows outside the border band, and columns outside it within the band
    inner = torch.ones(size, dtype=torch.bool, device=dev)
    inner[:border] = False
    inner[size - border:] = False
    col = torch.where(inner[:, None], edge[None, :], torch.ones_like(edge)[None, :])
    intensity = intensity * edge[:, None] * col
    noise = torch.randn((size, size), generator=g, device=dev)
    noisy = intensity + noise * torch.sqrt(torch.clamp(intensity, min=1.0))
    return torch.clamp(noisy, 0.0, 65535.0).to(torch.int32).to(torch.uint16)


def pool(seed: int, count: int, size: int, dose: Sequence[float],
         device: torch.device) -> torch.Tensor:
    """[count, size, size] uint16 on ``device``: ``count`` phantoms, each
    with its own geometry, at doses drawn from ``dose`` = [lo, hi] photons.
    (The NumPy generator's six anatomies differ only in their seed.)"""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    out = torch.empty((count, size, size), dtype=torch.uint16, device=device)
    fw = dose[0] + (dose[1] - dose[0]) * torch.rand(count, generator=g, device=device)
    for j in range(count):
        out[j] = radiograph(g, size, fw[j])
    return out
