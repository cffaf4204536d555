"""Curves and images on which ``chip_smoke.py`` and the tests hold the tone
map kernel (``csrc/tonemap.cu``, KT) to its plain version bit for bit:
curves whose selection and slopes are hard (fold-backs, duplicate points,
a positive interval of denormal width, the most points the kernel takes)
and images that hit every knot, its 1-ulp neighbours and every special
value."""

from __future__ import annotations

import numpy as np

F32 = np.float32


def _curve(px, py):
    return np.ascontiguousarray(px, F32), np.ascontiguousarray(py, F32)


def adversarial_curves(rng) -> dict:
    """name -> (px, py) float32 [k] curves that the descending chain (and,
    on a strictly increasing curve, the binary search) must get right."""
    t = np.linspace(0.0, 1.0, 22, dtype=F32)
    out = {}
    # the gradation curve's shape with its second segment folding back past
    # its end (ts > t1), then the last point at 1.0
    px = np.concatenate([t[:12], (t[12:21] * F32(1.3) - F32(0.25)).astype(F32)[::-1], [1.0]])
    out["fold-back"] = _curve(px, np.sqrt(t))
    # duplicate points (a zero-width interval met by its exact test), a
    # repeated x with other y, and equal neighbours at both ends
    px = np.array([0.0, 0.0, 0.1, 0.1, 0.1, 0.25, 0.4, 0.4, 0.55, 0.7, 0.7, 0.85, 1.0, 1.0], F32)
    out["duplicates"] = _curve(px, rng.uniform(0.0, 1.0, px.shape[0]))
    # a positive interval of denormal width at 0 (its slope near the float32
    # limit) beside normal ones; the interval's end is a knot of its own
    out["denormal width"] = _curve([0.0, 1e-40, 2e-38, 0.5, 1.0], [0.0, 1e-6, 0.25, 0.5, 1.0])
    # the same with a slope past the float32 range: inf * 0.0 gives NaN at
    # the interval's start, inf inside it
    out["infinite slope"] = _curve([0.0, 1e-40, 0.5, 1.0], [0.1, 0.35, 0.5, 1.0])
    # descending points: every pair non-increasing (zero-width intervals)
    px = np.sort(rng.uniform(-0.2, 1.2, 22).astype(F32))[::-1]
    out["descending"] = _curve(px, rng.uniform(-1.0, 2.0, 22))
    # one point; and the most points the kernel takes, in random order
    out["one point"] = _curve([0.5], [0.75])
    out["63 random"] = _curve(rng.uniform(-0.1, 1.1, 63), rng.uniform(-0.5, 1.5, 63))
    # a strictly increasing 22-point gradation curve from 0 to 1 (the
    # kernel's binary search); its own generator leaves the others as they
    # were
    px = np.sort(np.random.default_rng(22).uniform(0.0, 1.0, 20).astype(F32))
    out["increasing 22"] = _curve(np.concatenate([[0.0], px, [1.0]]),
                                  np.sqrt(np.linspace(0.0, 1.0, 22)))
    return out


def flushed(x, px) -> np.ndarray:
    """Where a float32 ``x`` meets a computation that flushes denormals to
    0 otherwise than one that keeps them (XLA on the CPU): x denormal, or
    within the largest denormal knot of ``px`` (its interval's ends and
    slope change when the knot reads as 0)."""
    x, px = np.asarray(x, F32), np.asarray(px, F32)
    tiny = np.finfo(F32).tiny
    sub = px[(px != 0) & (np.abs(px) < tiny)]
    reach = float(np.abs(sub).max()) if sub.size else -1.0
    return ((x != 0) & (np.abs(x) < tiny)) | (np.abs(x) <= reach)


def knot_values(px) -> np.ndarray:
    """Every knot (and the appended 0.0) and its two 1-ulp neighbours."""
    k = np.concatenate([np.asarray(px, F32), np.zeros(1, F32)])
    inf = np.array(np.inf, F32)
    return np.concatenate([k, np.nextafter(k, inf), np.nextafter(k, -inf)]).astype(F32)


SPECIAL = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 3.0e38, -3.0e38,
                    np.finfo(F32).max, -np.finfo(F32).max, 1.0, 2.0, -1.0, 0.5], F32)


def image(rng, shape, px, denormals: bool = True) -> np.ndarray:
    """float32 data of ``shape``: uniform values around the curve's domain
    with every knot value, its 1-ulp neighbours and the special values
    (NaN, +-inf, +-0, +-3e38, +-max) spread over it, an eighth of the
    pixels each; with ``denormals`` also denormal values (XLA on the CPU
    flushes them to 0, so a comparison with the JAX package leaves them
    out)."""
    px = np.asarray(px, F32)
    lo, hi = float(min(px.min(), 0.0)), float(max(px.max(), 1.0))
    span = hi - lo
    x = rng.uniform(lo - 0.1 * span, hi + 0.1 * span, shape).astype(F32)
    pick = rng.integers(0, 8, shape)
    knots = knot_values(px)
    x[pick == 0] = rng.choice(knots, int((pick == 0).sum()))
    x[pick == 1] = rng.choice(SPECIAL, int((pick == 1).sum()))
    if denormals:
        d = (rng.uniform(-1.0, 1.0, int((pick == 2).sum())) * 1e-39).astype(F32)
        x[pick == 2] = d
    return x
