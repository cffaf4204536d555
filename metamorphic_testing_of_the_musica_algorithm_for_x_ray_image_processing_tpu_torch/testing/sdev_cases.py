"""Sums of squares on which ``chip_smoke.py`` and the tests hold the sdev
kernels' per-output tail (``csrc/sdev_noise.cu``: ``div25`` and
``sqrt_to_f32``) to the plain chain, ``sqrt(s / 25)`` in float64 rounded to
float32: the sums where each of its two roundings is hardest.

* ``division_edges``: s next to 25 times a midpoint between two float64
  neighbours q and q' (where RN(s / 25) changes), also below and above a
  power of two, where the spacing halves.
* ``midpoint_squares``: q = m^2 for float32 midpoints m (where the float64
  square root can land on m and round to even) and its float64
  neighbours, each as the sum s that divides to it (and s's neighbours);
  the q themselves are returned too.
* ``SPECIAL``: 0, -0, the smallest float32 square (2^-149) and its float64
  square, 25 (float32 max)^2, +-inf, NaN, the fast path's ends 2^-240 and
  2^240 and their neighbours, subnormal and the largest float64, negative
  sums.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

F64 = np.float64
FLT_MAX = float(np.finfo(np.float32).max)


def _step(x: np.ndarray, k: int) -> np.ndarray:
    """The float64 ``k`` steps above positive ``x`` (below for k < 0)."""
    return (np.asarray(x, F64).view(np.int64) + k).view(F64)


def _log_uniform(rng, count: int, lo: float, hi: float) -> np.ndarray:
    """Positive float64 spread evenly over the binades [2^lo, 2^hi)."""
    return np.exp2(rng.uniform(lo, hi, count)) * rng.uniform(1.0, 2.0, count)


def division_edges(rng, count: int = 2000) -> np.ndarray:
    """s at and next to RN(25 (q +- half a spacing)) for random q in the
    sums' range and for powers of two (the spacing below is half)."""
    q = np.concatenate([_log_uniform(rng, count, -154.0, 133.0),
                        np.exp2(rng.integers(-154, 133, count // 4).astype(F64))])
    out = []
    for v in q:
        v = float(v)
        for other in (_step(v, 1), _step(v, -1)):
            mid = (Fraction(v) + Fraction(float(other))) / 2
            s0 = float(25 * mid)  # correctly rounded
            out.append(_step(np.array([s0] * 5), np.arange(-2, 3)))
    return np.concatenate(out)


def _f32_midpoints(rng, count: int) -> np.ndarray:
    """float64 midpoints between random positive float32 values in the
    roots' range [2^-77, 2^67) and their float32 successors; also at the
    top of binades (the successor a power of two)."""
    f = _log_uniform(rng, count, -77.0, 67.0).astype(np.float32)
    tops = (np.exp2(rng.integers(-76, 67, count // 4).astype(F64)).astype(np.float32)
            .view(np.int32) - 1).view(np.float32)
    f = np.concatenate([f, tops])
    nxt = (f.view(np.int32) + 1).view(np.float32)
    return (f.astype(F64) + nxt.astype(F64)) / 2  # exact: 25 significant bits


def midpoint_squares(rng, count: int = 2000):
    """(s, q): q = m^2 for float32 midpoints m and q's float64 neighbours
    (+-1, +-2); s = RN(25 q) and its neighbours, the sums that divide to q
    or next to it."""
    m = _f32_midpoints(rng, count)
    sq = m * m  # exact: 50 significant bits
    q = np.concatenate([_step(sq, k) for k in (-2, -1, 0, 1, 2)])
    s = np.concatenate([_step(q * 25.0, k) for k in (-1, 0, 1)])
    return s, q


SPECIAL = np.array(
    [0.0, -0.0, 2.0 ** -149, 2.0 ** -298, 25.0 * FLT_MAX * FLT_MAX, 25.0 * FLT_MAX, np.inf,
     -np.inf, np.nan, -np.nan, 2.0 ** -240, float(_step(2.0 ** -240, -1)),
     float(_step(2.0 ** -240, 1)), 2.0 ** 240, float(_step(2.0 ** 240, -1)),
     float(_step(2.0 ** 240, 1)), 5e-324, 2.2250738585072014e-308, np.finfo(F64).max,
     -1.0, -2.0 ** -149, 25.0, 1.0, 100.0, 0.04], F64)


def adversarial_sums(rng, count: int = 2000) -> np.ndarray:
    """``division_edges``, ``midpoint_squares``' sums and ``SPECIAL``."""
    return np.concatenate([division_edges(rng, count), midpoint_squares(rng, count)[0],
                           SPECIAL])


def random_doubles(rng, count: int) -> np.ndarray:
    """Half uniform float64 bit patterns (every sign, exponent and NaN),
    half spread evenly over the sums' binades [2^-149, 2^133)."""
    bits = rng.integers(0, 2 ** 63, count // 2, dtype=np.int64, endpoint=False)
    bits |= rng.integers(0, 2, count // 2, dtype=np.int64) << 63
    return np.concatenate([bits.view(F64), _log_uniform(rng, count - count // 2, -149.0, 133.0)])
