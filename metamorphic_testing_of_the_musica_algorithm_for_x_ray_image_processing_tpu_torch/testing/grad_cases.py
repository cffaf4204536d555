"""Gradation histograms on which the tests and ``chip_smoke.py`` hold the
gradation curve (``ops/gradation.py::gradation_curve``: its plain version
against the JAX package's, and the kernel ``csrc/gradation_curve.cu``, KG,
against the plain version) bit for bit: every branch of the curve's
synthesis (an empty histogram, no peak, ties, the peak at both ends of its
range, counts at the threshold, runs to bins 1 and 1023, the clipped
slope and its infinite case) and histograms that int32 atomics have wrapped
(negative bins, read as uint32 counts; the mean's uint32 sums wrapping
round to a divisor of 1).

Every histogram is int32 [1024], counts x 100 as the gradation histogram
kernels write them (``cfg.grad_histogram_bins`` 1024, lowest relevant bin
10, the defaults)."""

from __future__ import annotations

import numpy as np

BINS = 1024
LOWEST = 10
_U32 = 1 << 32


def _hist(counts) -> np.ndarray:
    """int32 histogram whose uint32 bins // 100 are ``counts`` (each below
    2^32 / 100): a count past 2^31 / 100 lands on a negative bin."""
    c = np.asarray(counts, np.int64)
    return (c * 100).astype(np.uint32).view(np.int32)


def _peak(p: int, height: int, width: float) -> np.ndarray:
    i = np.arange(BINS)
    return np.rint(height * np.exp(-((i - p) / width) ** 2)).astype(np.int64)


def _wrapped_unit_sum(seed: int) -> np.ndarray:
    """Counts whose uint32 sum over the relevant bins is 2^32 + 1 (the
    mean's divisor wraps round to 1) and whose weighted sum modulo 2^32 is
    at least 2^31: a mean bin past the int32 range."""
    rng = np.random.default_rng(seed)
    each = 42_500_000
    full, rest = divmod(_U32 + 1, each)  # 101 bins of 42.5M and one of 2,467,297
    idx = np.arange(BINS, dtype=np.int64)
    for _ in range(64):  # each draw meets the weighted sum's condition about half the time
        c = np.zeros(BINS, np.int64)
        at = rng.choice(np.arange(LOWEST, BINS), full + 1, replace=False)
        c[at[:-1]] = each
        c[at[-1]] = rest
        if int((c * idx).sum()) % _U32 >= 1 << 31:
            return c
    raise AssertionError("no draw met the condition")


def cases() -> dict:
    """name -> (int32 [1024] histogram, whether a bin is negative)."""
    out = {}
    rng = np.random.default_rng(0)
    z = np.zeros(BINS, np.int64)
    out["empty"] = z
    below = z.copy()
    below[:LOWEST] = 12345
    out["all mass below the lowest bin"] = below
    # test_ops_golden.py's wrap-around: sum(count * i) far past 2^32
    out["uint32 wrap-around"] = np.full(BINS, 9_000_000, np.int64)
    # all mass on the lowest bin: the peak's range [10, 10) is empty, so
    # no peak, ta == tf == 0 and the slope's 0.5 / 0 is inf
    at10 = z.copy()
    at10[LOWEST] = 777
    out["all mass on the lowest bin"] = at10
    ties = _peak(300, 2000, 60)
    ties[280] = ties[320] = ties[300]  # three equal maxima: the first wins
    out["ties for the peak"] = ties
    # the peak on the lowest bin (its run down to bin 1)
    low = _peak(500, 900, 200)
    low[LOWEST] = 5000
    low[1:LOWEST] = 4000
    out["peak on the lowest bin"] = low
    # only bins 400 and 402: the mean bin 401, the peak at mean_limit - 1
    edge = z.copy()
    edge[400] = edge[402] = 1000
    out["peak at mean_limit - 1"] = edge
    # counts equal to the threshold (trunc(1000 * 0.05f) = 50) on the run
    # down from the peak, then one below it; the run up ends on a zero
    thr = _peak(600, 300, 80)
    thr[450] = 1000
    thr[440:450] = 50
    thr[439] = 49
    thr[451:460] = 50
    thr[460] = 0
    out["counts equal to the threshold"] = thr
    # runs that reach bin 1 and bin 1023 (bin 0 below the threshold)
    full = _peak(350, 3000, 250) + 400
    full[0] = 0
    out["runs to bin 1 and bin 1023"] = full
    # a peak near 0: tf = max(ta - 1/6, t0) clips to t0, the slope recomputed
    out["tf clipped to t0"] = _peak(90, 4000, 30) + _peak(700, 100, 200)
    # random shapes as K3 writes them
    for k in range(3):
        h = (rng.gamma(2.0, 200.0, BINS) *
             np.exp(-((np.arange(BINS) - rng.integers(150, 700)) / 150.0) ** 2)).astype(np.int64)
        h[:LOWEST] = rng.integers(0, 20000)
        out[f"random {k}"] = h
    hist = {k: (_hist(v), False) for k, v in out.items()}
    # negative bins (int32 atomics wrapped): five below 400 in a random
    # histogram, read as counts near 2^32 / 100 that win the peak
    neg = _hist(out["random 0"])
    at = rng.choice(np.arange(LOWEST, 400), 5, replace=False)
    neg[at] = -rng.integers(1, 2_000_000_000, 5).astype(np.int32)
    hist["negative bins"] = (neg, True)
    one = _hist(_peak(500, 2000, 120))
    one[640] = -100  # one bin of count 42,949,671 above the mean
    hist["one negative bin"] = (one, True)
    hist["negative bins, mean past int32"] = (_hist(_wrapped_unit_sum(17)), True)
    assert all(h.dtype == np.int32 and h.shape == (BINS,) for h, _ in hist.values())
    assert all(neg == bool((h < 0).any()) for h, neg in hist.values())
    return hist
