"""Adversarial inputs for the kernels that compute the relevance mask
(``shaders/img_relevant.comp``) themselves: K3's block weights and the CLAHE
joint histogram KH, and the CLAHE LUTs KC.  ``chip_smoke.py`` [3j] and the
tests hold the kernels to their plain versions on them, where the mask's and
the bins' decisions are hardest."""

from __future__ import annotations

import numpy as np


def dense_cnr(rng, cfg, m: int) -> np.ndarray:
    """An [m, m] float32 CNR map (stored divided by max_cnr) that holds, in
    random places, every float32 within 64 ulps of the relevance rule's lo,
    top (lo + ramp) and max_cnr, each divided by max_cnr, and 0, NaN and
    +-inf."""
    vals = []
    for x in (cfg.relevant_cnr_low, cfg.relevant_cnr_low + cfg.relevant_cnr_ramp,
              cfg.max_cnr_value):
        down = up = np.float32(x)
        vals.append(up)
        for _ in range(64):
            down = np.nextafter(down, np.float32(-np.inf))
            up = np.nextafter(up, np.float32(np.inf))
            vals += [down, up]
    vals = np.array(vals + [0.0, np.nan, np.inf, -np.inf], np.float32)
    vals /= np.float32(cfg.max_cnr_value)  # a power of two: exact
    return rng.permutation(np.resize(vals, m * m)).reshape(m, m)


def pixel_tests(rng, n: int, cfg) -> np.ndarray:
    """A normalized image [n, n]: uniform in [0, 1.01), a third of its
    pixels at max_pixel or one ulp either side of it, a few NaN."""
    x = rng.uniform(0.0, 1.01, (n, n)).astype(np.float32)
    m = np.float32(cfg.relevant_max_pixel)
    pool = np.float32([np.nextafter(m, np.float32(0)), m, np.nextafter(m, np.float32(2)), m,
                       np.nan])
    pick = rng.uniform(size=(n, n)) < 1 / 3
    x[pick] = rng.choice(pool, int(pick.sum()))
    return x


def clahe_recon(rng, n: int, bins: int) -> np.ndarray:
    """A recon image [n, n] for KH: half its pixels drawn from every bin
    edge (k + 0.5) / (bins - 1) and one ulp either side, NaN, +-inf, +-0,
    1.0, negatives (bin 0 and below), values past 1, a denormal and one past
    int32."""
    edges = ((np.arange(-1, bins) + 0.5) / (bins - 1)).astype(np.float32)
    special = np.float32([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, -1e-3, -0.5 / (bins - 1),
                          -1.0, 1.001, 2.0, 1e-40, 3e9])
    pool = np.concatenate([edges, np.nextafter(edges, np.float32(-1)),
                           np.nextafter(edges, np.float32(2)), special])
    x = rng.uniform(-0.05, 1.05, (n, n)).astype(np.float32)
    pick = rng.uniform(size=(n, n)) < 0.5
    x[pick] = rng.choice(pool, int(pick.sum()))
    return x


def random_clahe_hists(rng, cfg) -> np.ndarray:
    """int32 [tiles, tiles, bins] CLAHE histograms: up to 2^21 / bins counts
    a bin (fewer than 2^21 pixels a tile, the domain in which the LUTs'
    float64 sums are exact, ``ops/clahe.py``), a random share of empty bins
    and a fifth of the tiles empty (NaN LUTs)."""
    t, bins = cfg.clahe_tiles, cfg.clahe_bins
    h = rng.integers(0, 2 ** 21 // bins, (t, t, bins))
    h[rng.uniform(size=h.shape) < rng.uniform(0, 0.9)] = 0
    h[rng.uniform(size=(t, t)) < 0.2] = 0
    return h.astype(np.int32)
