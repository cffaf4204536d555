"""Adversarial inputs for the histogram scans (the noise histogram's 16-px
group ``break`` and the gradation histogram's 16x16 tile ``return``), used
by ``chip_smoke.py`` and the tests to hold the CUDA kernels to their plain
versions where the scans' decisions are hardest."""

from __future__ import annotations

import numpy as np

# (row, column) of the 0.0 within a 16x16 tile, one tile pattern each
ZERO_AT = ((0, 0), (0, 15), (1, 0), (2, 0), (15, 15), (0, 4))
PATTERNS = len(ZERO_AT) + 6


def adversarial_image(rng, n: int, lo: float, hi: float, above, special: float,
                      tiny: float) -> np.ndarray:
    """A [n, n] float32 image, uniform in [lo, hi), whose 16x16 tiles carry in
    turn the break and range cases of the histogram scans: a 0.0 at tile
    pixel (0, 0), (0, 15), (1, 0) (the gradation scan's half-warp
    boundary), (2, 0) (its step boundary), (15, 15) and (0, 4) (the noise
    scan's lane boundary); a constant tile; values drawn from ``above`` (out
    of range); negative values; and 30 % of the pixels at ``special`` (the
    exact top edge, bin == n_bins) or at ``tiny`` (bin 0)."""
    img = rng.uniform(lo, hi, (n, n)).astype(np.float32)
    t = -(-n // 16)
    pattern = np.add.outer(np.arange(t) * 7, np.arange(t) * 3) % PATTERNS
    pid = np.kron(pattern, np.ones((16, 16), np.int64))[:n, :n]
    r = np.arange(n)[:, None] % 16
    c = np.arange(n)[None, :] % 16
    for k, (zr, zc) in enumerate(ZERO_AT, 1):
        img[(pid == k) & (r == zr) & (c == zc)] = 0.0
    k = len(ZERO_AT)
    img[pid == k + 1] = np.float32((lo + hi) / 2)
    img[pid == k + 2] = rng.uniform(*above, int((pid == k + 2).sum())).astype(np.float32)
    img[pid == k + 3] = -img[pid == k + 3]
    pick = rng.uniform(size=(n, n)) < 0.3
    img[(pid == k + 4) & pick] = np.float32(special)
    img[(pid == k + 5) & pick] = np.float32(tiny)
    return img


def noise_levels(rng, sizes):
    """Adversarial noise-histogram levels (sdev images): 0.1 maps to
    adjusted == 1 (bin n_bins, dropped), 1e-6 to bin 0 (a break), values
    above 0.1 break."""
    return [adversarial_image(rng, m, 0.0005, 0.099, (0.1001, 0.2), 0.1, 1e-6)
            for m in sizes]


def gradation_image(rng, n: int) -> np.ndarray:
    """An adversarial gradation-histogram input: 1.0 maps to bin 1024
    (dropped), values in [1, 2) are out of range, 1e-6 maps to bin 0."""
    return adversarial_image(rng, n, 0.0, 1.0, (1.0, 2.0), 1.0, 1e-6)


def tie_levels(sizes):
    """Noise levels whose histograms tie: each [m, m] level is 0.0 but for
    its first three rows, row i wholly at the value that maps to bin 1500, 7
    or 2047 (of 2,048, max_noise 0.1), so each of those bins gets one count
    per scanned column and the first maximum, the smallest bin, must win
    though a larger one comes first in the image."""
    out = []
    for m in sizes:
        sd = np.zeros((m, m), np.float32)
        for i, b in enumerate((1500, 7, 2047)[:m]):
            sd[i] = np.float32(b / 2048 * 0.1)
        out.append(sd)
    return out
