"""Statistical post-analysis tools of the PyTorch port.

The port's own copy of the JAX package's ``testing/analysis.py`` (NumPy
only), held equal to it by ``tests/test_torch_harness.py``; BMPs are read
with the port's ``utils/io.py``.

* ``slope_analysis`` -- port of ``test/reg_vs_dir_delta/script.py:11-46``:
  per metric column, per alteration family (groups of 5 intensity steps),
  linear-regression slope over the metric deltas; criterion |slope| > 0.01.
* ``wilcoxon_analysis`` -- port of the commented-out Wilcoxon branch of the
  same script (``test/reg_vs_dir_delta/script.py:30-33``): per group of 5,
  one-sample signed-rank test of the deltas against their mean.  The
  implementation is self-contained (exact distribution for small untied
  samples, normal approximation otherwise, mirroring scipy.stats.wilcoxon's
  ``method='auto'``) and cross-checked against scipy in
  tests/test_reference_artifacts.py.
* ``mean_cnr_dir`` -- port of ``test/mean_cnr/script.py``: mean pixel of CNR
  debug BMPs scaled to CNR units (x256 / 2^8).
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SLOPE_CRITERION = 0.01
GROUP = 5  # intensity steps per alteration family


def _linregress_slope(y: np.ndarray) -> float:
    t = np.arange(len(y), dtype=np.float64)
    t_mean = t.mean()
    y = np.asarray(y, np.float64)
    denom = np.sum((t - t_mean) ** 2)
    return float(np.sum((t - t_mean) * (y - y.mean())) / denom)


def _rankdata(v: np.ndarray) -> np.ndarray:
    """Average ranks (1-based) with midranks for ties."""
    order = np.argsort(v, kind="stable")
    ranks = np.empty(len(v), np.float64)
    sv = v[order]
    i = 0
    while i < len(sv):
        j = i
        while j + 1 < len(sv) and sv[j + 1] == sv[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def wilcoxon_signed_rank(d: np.ndarray) -> Tuple[float, float]:
    """Two-sided one-sample Wilcoxon signed-rank test of ``d`` against 0.

    Matches ``scipy.stats.wilcoxon(d)`` defaults (zero_method='wilcox',
    correction=False, method='auto'): zeros are discarded; the statistic is
    ``min(T+, T-)``; for small n the p-value is the exact sign-flip
    enumeration over the (mid)ranks -- with ties this is the permutation
    distribution modern scipy uses -- else the normal approximation with
    the tie-corrected variance.
    """
    d = np.asarray(d, np.float64)
    d = d[d != 0.0]
    n = len(d)
    if n == 0:
        return float("nan"), float("nan")
    absd = np.abs(d)
    ranks = _rankdata(absd)
    t_plus = float(ranks[d > 0].sum())
    t_minus = float(ranks[d < 0].sum())
    stat = min(t_plus, t_minus)
    if n <= 25:
        # exact: distribution of T+ over all 2^n sign assignments of the
        # midranks, via the polynomial counting recurrence.  Midranks are
        # multiples of 1/2, so scale by 2 to count over integers; by the
        # symmetry T+ <-> W - T+ the two-sided p is 2*P(T+ <= min(T+,T-)).
        r2 = np.round(ranks * 2.0).astype(np.int64)
        max_t = int(r2.sum())
        counts = np.zeros(max_t + 1, np.float64)
        counts[0] = 1.0
        for r in r2:
            counts[r:] += counts[:max_t + 1 - r].copy()
        total = 2.0 ** n
        thresh = int(np.round(stat * 2.0))
        p = 2.0 * counts[:thresh + 1].sum() / total
        return stat, min(p, 1.0)
    # normal approximation (scipy's large-n path)
    mn = n * (n + 1) / 4.0
    var = n * (n + 1) * (2 * n + 1) / 24.0
    # tie correction: sum(t^3 - t) / 48 over tie groups of |d|
    _, tie_counts = np.unique(absd, return_counts=True)
    var -= (tie_counts.astype(np.float64) ** 3 - tie_counts).sum() / 48.0
    if var <= 0:
        return stat, 1.0
    import math
    z = (stat - mn) / math.sqrt(var)
    p = math.erfc(abs(z) / math.sqrt(2.0))
    return stat, min(p, 1.0)


def wilcoxon_analysis(rows: List[List[str]]
                      ) -> List[Tuple[str, str, float, float]]:
    """Per metric column, per group of 5: Wilcoxon signed-rank test of the
    deltas against their group mean (test/reg_vs_dir_delta/script.py:30-33,
    the reference's commented-out branch).  Returns
    (metric, last-alteration-of-group, statistic, p-value)."""
    out = []
    header = rows[0]
    for c in range(1, len(header)):
        data = []
        i = 0
        for r in range(1, len(rows)):
            data.append(float(rows[r][c]))
            i += 1
            if i % GROUP == 0:
                arr = np.asarray(data, np.float64)
                stat, p = wilcoxon_signed_rank(arr - arr.mean())
                out.append((header[c], rows[i][0], stat, p))
                data = []
    return out


def slope_analysis(rows: List[List[str]], delimiter_hint: str = ";"
                   ) -> List[Tuple[str, str, float, bool]]:
    """rows[0] is the header; column 0 names the alteration.  Returns
    (metric, last-alteration-of-group, slope, |slope| > 0.01) per group of 5."""
    out = []
    header = rows[0]
    for c in range(1, len(header)):
        data = []
        i = 0
        for r in range(1, len(rows)):
            data.append(float(rows[r][c]))
            i += 1
            if i % GROUP == 0:
                slope = _linregress_slope(np.array(data))
                out.append((header[c], rows[i][0], slope,
                            abs(slope) > SLOPE_CRITERION))
                data = []
    return out


def slope_analysis_file(csv_path: str, out_file: Optional[str] = None,
                        delimiter: Optional[str] = None,
                        wilcoxon: bool = False) -> List[str]:
    with open(csv_path, newline="", encoding="utf-8-sig") as f:
        head = f.read(4096)
        f.seek(0)
        delim = delimiter or (";" if head.count(";") > head.count(",") else ",")
        rows = [line for line in csv.reader(f, delimiter=delim)]
    lines = []
    results = slope_analysis(rows)
    wres = wilcoxon_analysis(rows) if wilcoxon else [None] * len(results)
    for (metric, alteration, slope, flag), w in zip(results, wres):
        line = f"{metric} \t {alteration} \t slope={slope} \t slope test={flag}"
        if w is not None:
            # mirrors the reference's commented print format
            # ("Test Statistic: {stat}, p-value: {p}", script.py:33)
            line += f" \t Test Statistic: {w[2]}, p-value: {w[3]}"
        lines.append(line)
    if out_file:
        Path(out_file).write_text("\n".join(
            f"{m} \t {a} \t {s}" for m, a, s, _ in results) + "\n")
    return lines


_DELTA_HEADER = [
    "Alteration",
    "delta altered vs original mse", "delta altered vs original ssim",
    "delta altered vs original histogram distance",
    "delta altered vs reference mse", "delta altered vs reference ssim",
    "delta altered vs reference histogram distance",
    "delta normalized altered vs reference mse",
    "delta normalized altered vs reference ssim",
    "delta normalized altered vs reference histogram distance",
]


def build_delta_table(robustness_rows: List[List]) -> List[List]:
    """Campaign robustness CSV -> the delta table consumed by the slope
    analysis (the committed ``test/reg_vs_dir_delta/results.csv`` format:
    one row per alteration, 9 delta metrics averaged over anatomies).

    Delta convention (inferred from the committed table): deviation from the
    unaltered case's value -- 1 - value for the similarity metrics and the
    normalized ratios, -value for the histogram distances (whose unaltered
    baseline is 0), matching the sign pattern of results.csv.
    """
    from collections import defaultdict
    groups = defaultdict(list)
    order = []
    for row in robustness_rows[1:]:
        alteration = row[1]
        if alteration not in groups:
            order.append(alteration)
        groups[alteration].append([float(v) for v in row[2:11]])
    baselines = [1, 1, 0, 1, 1, 0, 1, 1, 0]
    out = [_DELTA_HEADER]
    for alteration in order:
        mean = np.mean(np.array(groups[alteration]), axis=0)
        deltas = [b - v for b, v in zip(baselines, mean)]
        out.append([alteration, *deltas])
    return out


def mean_cnr_dir(in_dir: str, out_file: Optional[str] = None,
                 max_cnr: float = 256.0, margin: int = 0):
    """Mean CNR per BMP in a directory (test/mean_cnr/script.py)."""
    from ..utils.io import load_bmp
    results = []
    for name in sorted(os.listdir(in_dir)):
        p = Path(in_dir) / name
        if not p.is_file():
            continue
        img = load_bmp(p).astype(np.float64)
        if margin:
            img = img[margin:img.shape[0] - margin, margin:img.shape[1] - margin]
        mean = (img.mean() / 2 ** 8) * max_cnr
        results.append((name, mean))
    if out_file:
        Path(out_file).write_text(
            "".join(f"{n} \t {v}\n" for n, v in results))
    return results
