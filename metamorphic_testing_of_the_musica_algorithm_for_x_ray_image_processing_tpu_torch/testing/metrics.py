"""Similarity metrics for the metamorphic campaign, on PyTorch.

The port of the JAX package's ``testing/metrics.py``
(``test/metamorphic_test/script.py:143-198``):

* the float64 host oracles, copies of the JAX package's:
  ``mse_similarity`` = 1 - RMSE/255 over uint8 images (:143-145);
  ``ssim_similarity`` -- scikit-image's default ``structural_similarity``
  re-implemented (7x7 uniform windows, K1=0.01, K2=0.03, data_range=255,
  sample covariance normalization) with scipy's ``uniform_filter``;
  ``hist_similarity`` -> (intersection, euclidean, bhattacharyya) over
  256-bin histograms with np.histogram's default *data-dependent* range per
  image (:154-198); ``_euclid_from_counts``; ``psnr``;
* the device path: ``measure_row`` gives a campaign row's six numbers in
  one pass on the device of the reference images, the counterpart of the
  JAX package's ``measure_row_device``.  Its 256-value counts go through
  ``ops.stats.fixed_histogram``, which launches the generic histogram
  kernel (``csrc/histogram.cu``) on a CUDA device.

The JAX package's ``measure_row_cpu_jax`` only avoided TPU compiles of the
registration crops' shapes; here every row, direct or cropped, goes through
``measure_row``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import stats


def _as_gray(img) -> np.ndarray:
    a = np.asarray(img)
    if a.ndim == 3:
        # PIL 'L' conversion weights
        a = (a[..., 0] * 299 + a[..., 1] * 587 + a[..., 2] * 114) / 1000
    return a


def mse_similarity(image_a, image_b) -> float:
    a = np.asarray(image_a, dtype=np.int32)
    b = np.asarray(image_b, dtype=np.int32)
    errors = np.abs(a - b) / 255.0
    return 1.0 - math.sqrt(float(np.mean(np.square(errors))))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Mean filter with 'reflect' boundary (scipy.ndimage.uniform_filter
    default mode), separable."""
    from scipy.ndimage import uniform_filter
    return uniform_filter(x, size=size, mode="reflect")


def ssim_similarity(image_a, image_b, win_size: int = 7,
                    data_range: float = 255.0) -> float:
    """Mean SSIM in float64, matching skimage.metrics.structural_similarity
    defaults (uniform 7x7 window, crop pad, sample covariance with
    N/(N-1)): the JAX package's ``method="numpy"`` oracle."""
    x = _as_gray(image_a).astype(np.float64)
    y = _as_gray(image_b).astype(np.float64)
    assert x.shape == y.shape
    k1, k2 = 0.01, 0.03
    np_ = win_size ** 2
    cov_norm = np_ / (np_ - 1)
    ux = _uniform_filter(x, win_size)
    uy = _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux ** 2 + uy ** 2 + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    pad = (win_size - 1) // 2
    return float(s[pad:s.shape[0] - pad, pad:s.shape[1] - pad].mean())


def _box7(m: torch.Tensor) -> torch.Tensor:
    """Mean over 7x7 windows of a reflect-padded [h, w] float32 image: the
    7 vertical then the 7 horizontal taps summed in order, times 1/49, as
    the JAX package's device SSIM.  Its "reflect" (no edge repeat) differs
    from scipy's at the 3-px edge, which the SSIM mean crops."""
    w, r = 7, 3
    h, wd = m.shape
    p = F.pad(m[None, None], (r, r, r, r), mode="reflect")[0, 0]
    t = sum(p[i:i + h, :] for i in range(w))
    s = sum(t[:, j:j + wd] for j in range(w))
    return s * (1.0 / (w * w))


def ssim_mse_pair(af: torch.Tensor, bf: torch.Tensor):
    """float32 (mse-similarity, ssim) of one pair of float32 images, 0-d
    tensors on their device: the port of the JAX package's
    ``_ssim_mse_pair`` (|delta| ~1e-6 against the float64 oracles)."""
    err = (af - bf).abs() * float(np.float32(1.0 / 255.0))
    mse_sim = 1.0 - torch.sqrt(torch.mean(err * err))
    w, r = 7, 3
    cov_norm = (w * w) / (w * w - 1)
    ux, uy = _box7(af), _box7(bf)
    uxx, uyy, uxy = _box7(af * af), _box7(bf * bf), _box7(af * bf)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * 255.0) ** 2
    c2 = (0.03 * 255.0) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    ssim = torch.mean(s[r:s.shape[0] - r, r:s.shape[1] - r])
    return mse_sim, ssim


def counts256(img_u8: torch.Tensor) -> torch.Tensor:
    """Exact per-value counts (int32 [256]) of a uint8 image, through
    ``stats.fixed_histogram`` (one launch of the generic histogram kernel on
    a CUDA device)."""
    bins = img_u8.to(torch.int32)
    return stats.fixed_histogram(bins, torch.ones_like(bins), 256)


def measure_row(alt, unalt_t: torch.Tensor, ref_t: torch.Tensor):
    """(mse, ssim, hist-euclid) of alt-vs-unalt and alt-vs-ref as 6 floats.

    ``unalt_t`` and ``ref_t`` are uint8 tensors that stay on their device
    (the campaign uploads them once per anatomy); only ``alt`` (a uint8
    numpy array) crosses to it.  mse and ssim are float32 on the device; the
    histogram metric is finished on the host in float64 from the exact value
    counts, which is bit-equal to the np.histogram oracle (QUIRKS #26: the
    data-dependent range depends only on the value multiset, and a uint8
    image's multiset is its bincount)."""
    a = torch.from_numpy(np.array(alt, np.uint8)).to(unalt_t.device)  # a writable copy
    af = a.float()
    m1 = ssim_mse_pair(af, unalt_t.float())
    m2 = ssim_mse_pair(af, ref_t.float())
    out = torch.cat([torch.stack(m1 + m2).double(),
                     *(counts256(x).double() for x in (a, unalt_t, ref_t))]).cpu().numpy()
    vals = out[:4]
    ca, cu, cr = (out[4 + 256 * i:4 + 256 * (i + 1)].astype(np.int64) for i in range(3))
    return [float(vals[0]), float(vals[1]), _euclid_from_counts(ca, cu),
            float(vals[2]), float(vals[3]), _euclid_from_counts(ca, cr)]


def measure_row_device(alt, unalt_t: torch.Tensor, ref_t: torch.Tensor):
    """The JAX package's name for ``measure_row``: the same 6 floats, mse
    and SSIM on ``unalt_t``'s device."""
    return measure_row(alt, unalt_t, ref_t)


def _euclid_from_counts(ca: np.ndarray, cb: np.ndarray) -> float:
    """hist_similarity's normalized euclidean metric from exact per-value
    counts -- bit-equal to np.histogram on the images (quirk #26 range)."""
    def hist(c):
        nz = np.nonzero(c)[0]
        mn, mx = int(nz[0]), int(nz[-1])
        if mn == mx:
            # np.histogram auto-expands a constant image's range to
            # (v-0.5, v+0.5): all mass lands in bin 128
            h = np.zeros(256, np.float64)
            h[128] = c.sum()
            return h
        h, _ = np.histogram(np.arange(256, dtype=np.float64), bins=256,
                            range=(mn, mx), weights=c.astype(np.float64))
        return h
    pa = hist(ca)
    pb = hist(cb)
    pa = pa / pa.sum()
    pb = pb / pb.sum()
    return float(np.sqrt(np.sum((pa - pb) ** 2)) / np.sqrt(2))


def hist_similarity(image_a, image_b, bins: int = 256):
    """(normalized intersection, normalized euclidean distance,
    bhattacharyya coefficient); euclidean is the metric the campaign reports."""
    a = _as_gray(image_a).reshape(-1)
    b = _as_gray(image_b).reshape(-1)
    hist_a, _ = np.histogram(a, bins=bins)
    hist_b, _ = np.histogram(b, bins=bins)

    inter = float(np.sum(np.minimum(hist_a, hist_b))
                  / min(np.sum(hist_a), np.sum(hist_b)))

    pa = hist_a / np.sum(hist_a)
    pb = hist_b / np.sum(hist_b)
    e_distance = float(np.sqrt(np.sum((pa - pb) ** 2)) / np.sqrt(2))
    b_coeff = float(np.sum(np.sqrt(pa * pb)))
    return inter, e_distance, b_coeff


def psnr(a, b, peak: float = 255.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(peak ** 2 / mse))
