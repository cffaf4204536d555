"""Synthetic X-ray phantoms (the port's copy of the JAX package's
``testing/phantoms.py``; equal arrays for every anatomy and seed,
``tests/test_torch_standalone.py``).

The reference repository ships its six anatomy raws (foot/hand/head/knee/
pelvis/thorax) as large binaries that are absent from the snapshot
(``.MISSING_LARGE_BLOBS``).  To keep the metamorphic campaign and parity
tests runnable, this module synthesizes radiograph-like 16-bit images:
smooth anatomical "bone" ellipses over soft-tissue background, an exposure
falloff, collimated dark borders, and Poisson-like quantum noise -- enough
structure that every pipeline stage (noise estimation, contrast curves,
relevance masking, gradation windowing) operates in its intended regime.
"""

from __future__ import annotations

import numpy as np


_ANATOMY_SEEDS = {
    "foot": 11, "hand": 22, "head": 33, "knee": 44, "pelvis": 55, "thorax": 66,
}

ANATOMIES = tuple(_ANATOMY_SEEDS)


def synthetic_radiograph(size: int = 3072, anatomy: str = "thorax",
                         seed: int | None = None,
                         full_well: float = 40000.0) -> np.ndarray:
    """Generate a [size, size] uint16 synthetic radiograph.

    High values = high transmission (air), matching the raws the reference
    processes (vendor DICOM ground truth is inverted before comparison,
    ``test/metamorphic_test/script.py:396-405``).
    """
    if seed is None:
        seed = _ANATOMY_SEEDS.get(anatomy, 7)
    rng = np.random.default_rng(seed)
    F = np.float32
    # broadcastable coordinate vectors instead of full-size mgrid planes
    # (f32 throughout: halves the memory traffic; the generator is host-side
    # fixture code on the campaign's critical path)
    c = (np.arange(size, dtype=F) / F(size))
    x = c[None, :]
    y = c[:, None]

    # attenuation map (line integral of density)
    # soft tissue: one large smooth blob
    cx, cy = rng.uniform(0.35, 0.65, 2)
    rx, ry = rng.uniform(0.25, 0.42, 2)
    d2 = ((x - F(cx)) / F(rx)) ** 2 + ((y - F(cy)) / F(ry)) ** 2
    atten = F(1.2) * np.maximum(F(1.0) - d2, F(0.0))

    # bones: several dense ellipses with sharper edges
    n_bones = rng.integers(4, 9)
    for _ in range(n_bones):
        bx, by = rng.uniform(0.2, 0.8, 2)
        brx = rng.uniform(0.02, 0.12)
        bry = rng.uniform(0.02, 0.12)
        ang = rng.uniform(0, np.pi)
        ca_, sa = F(np.cos(ang)), F(np.sin(ang))
        dx = x - F(bx)
        dy = y - F(by)
        xr = dx * ca_ + dy * sa
        yr = dy * ca_ - dx * sa
        bd2 = (xr / F(brx)) ** 2 + (yr / F(bry)) ** 2
        atten += F(1.8) * np.sqrt(np.maximum(F(1.0) - bd2, F(0.0)))

    # fine trabecular texture inside dense regions
    tex = rng.normal(0.0, 1.0, (size // 8 + 1, size // 8 + 1)).astype(F)
    tex = np.repeat(np.repeat(tex, 8, 0), 8, 1)[:size, :size]
    atten += F(0.05) * tex * (atten > F(0.5))

    # exposure heel-effect falloff
    falloff = F(1.0) - F(0.15) * ((x - F(0.5)) ** 2 + (y - F(0.5)) ** 2)

    # transmitted intensity (Beer-Lambert), collimated border
    intensity = F(full_well) * falloff * np.exp(-atten)
    border = int(0.03 * size)
    intensity[:border, :] *= F(0.02)
    intensity[-border:, :] *= F(0.02)
    intensity[border:-border, :border] *= F(0.02)
    intensity[border:-border, -border:] *= F(0.02)

    # quantum (Poisson) noise; normal approximation is fine at these counts
    noisy = intensity + rng.standard_normal((size, size), dtype=F) * np.sqrt(
        np.maximum(intensity, F(1.0)))
    return np.clip(noisy, 0, 65535).astype(np.uint16)
