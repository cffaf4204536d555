"""Inputs and row windows on which ``chip_smoke.py`` and the tests hold the
pyramid kernels (``csrc/pyramid.cu``) to their plain versions bit for bit:
data where the float64 sums' order and the one rounding show, and every
window the spatial path asks of them."""

from __future__ import annotations

import numpy as np

from ..config import MusicaConfig
from ..ops import pyramid
from ..parallel import spatial

# the constant planes: -0.0 (a sign a sum started at 0.0 would lose), 1e30
# and a denormal (the small expand's gain before its rounding shows there)
CASES = ("mixed", "-0.0", "1e30", "3.0", "3e-39")


def level_sizes(n: int) -> list:
    """The level sizes of an n-px ladder down to 1 px."""
    out = [n]
    while out[-1] > 1:
        out.append(-(-out[-1] // 2))
    return out


def adversarial(rng, shape, case: str = "mixed") -> np.ndarray:
    """float32 data of ``shape``: "mixed" (normal values with +-0,
    denormals and +-1e30 among them, each an eighth of the pixels), or a
    constant plane of ``float(case)``."""
    if case != "mixed":
        return np.full(shape, np.float32(case), np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    sign = np.where(rng.uniform(size=shape) < 0.5, np.float32(-1), np.float32(1))
    pick = rng.integers(0, 8, shape)
    x[pick == 0] = 0.0
    x[pick == 1] = -0.0
    x[pick == 2] = (np.float32(3e-39) * sign)[pick == 2]
    x[pick == 3] = (np.float32(1e30) * sign)[pick == 3]
    return x


def shard_windows(n: int, tile: int, space: int = 4) -> list:
    """Every window the spatial path (``parallel/spatial.py``) asks of the
    pyramid kernels on an n-px image over ``space`` shards:
    ``(op, level size, input rows, output rows)``, op "down" (KP1: the
    next level's rows of a shard) or "up" (KP2: a shard's rows of its level,
    the last sharded level's from the whole next level)."""
    plan = spatial.row_plan(n, space, MusicaConfig(image_size=n, histogram_area_size=tile))
    out = []
    for k in range(plan.replicated):
        h = plan.sizes[k]
        for i in range(space):
            r0, r1 = plan.rows(k, i)
            if k + 1 < plan.replicated:
                j0, j1 = plan.rows(k + 1, i)
                out.append(("down", h, pyramid.needed_rows("smooth_downsample", h, j0, j1),
                            (j0, j1)))
                out.append(("up", h, pyramid.needed_rows("upsample_smooth", h, r0, r1), (r0, r1)))
            else:
                out.append(("up", h, (0, -(-h // 2)), (r0, r1)))
    return out
