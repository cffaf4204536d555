"""A NaN pixel in the histograms' plain bins, held to the JAX package.

XLA (and the card's ``cvt.rzi``) convert a float32 NaN to the int32 0;
PyTorch's CPU conversion gives INT_MIN.  So the port's plain bins map NaN to
0 before they convert:

* the gradation bins (``ops/gradation.py::gradation_bins``, the plain
  version of K3 and K4): a NaN recon pixel is counted in bin 0 with its
  weight, as ``tpu/``'s ``gradation_bins`` counts it, here inside a tile
  before the tile's first 0.0 (the whole-tile return) and in tiles with no
  0.0;
* the noise bins (``ops/stats.py::noise_bins_view``, the plain version of
  K1): a NaN sdev is bin 0, which breaks its 16-lane group, so it and the
  rest of its group are not counted, as in ``tpu/``'s ``noise_bins``.

The JAX package runs on the CPU as its own tests run it: its plain ops
(``"fact"``) and its Pallas kernels in interpret mode.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import (
    gradation as j_gradation, stats as j_stats)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import gradation, stats
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh

torch.set_num_threads(2)

F32 = np.float32
N, BORDER = 64, 2


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfg():
    return MusicaConfig(image_size=N, relevant_border=BORDER)


@functools.lru_cache(maxsize=None)
def _gradation_inputs():
    """recon [N, N] in (0.05, 0.95) with NaN pixels: in tile (0, 0) at rows
    3-4 before the tile's first 0.0 (row 5), and in tiles (1, 2) and (3, 3),
    which hold no 0.0; relevance 0.3-1.0 (weights 30-100); for K3 a
    normalized image <= 0.9 and a CNR map of solid blocks (c = 100), so every
    pixel inside the border is relevant (weight 100)."""
    rng = np.random.default_rng(19)
    recon = rng.uniform(0.05, 0.95, (N, N)).astype(F32)
    recon[5, 7] = 0.0
    for r, c in ((3, 3), (4, 14), (20, 40), (23, 41), (60, 61)):
        recon[r, c] = np.nan
    relevant = rng.uniform(0.3, 1.0, (N, N)).astype(F32)
    normalized = rng.uniform(0.0, 0.9, (N, N)).astype(F32)
    cnr = np.full((N // 8, N // 8), 100.0 / 256.0, F32)
    return recon, relevant, normalized, cnr


def test_gradation_bins_count_a_nan_pixel_in_bin_0():
    recon, relevant, _, _ = _gradation_inputs()
    cfg = _cfg()
    bins, w = gradation.gradation_bins(T(recon), T(relevant), cfg)
    j_bins, j_w = (np.asarray(a) for a in j_gradation.gradation_bins(
        jnp.asarray(recon), jnp.asarray(relevant), cfg))
    np.testing.assert_array_equal(bins.numpy(), j_bins)
    np.testing.assert_array_equal(w.numpy(), j_w.astype(np.int64))
    nan = np.isnan(recon).reshape(-1)
    assert (bins.numpy()[nan] == 0).all()
    # the NaN pixels before tile (0, 0)'s first 0.0 and in the tiles
    # without one are counted with their weights
    assert (w.numpy()[nan] > 0).sum() == 5


def test_k4_plain_counts_a_nan_pixel_as_jax():
    """K4's plain version (``fused_hist.grad_hist_plain``) against ``tpu/``'s
    ``gradation_histogram``: its plain ops and its Pallas kernel
    (``grad_hist_fused``) in interpret mode."""
    recon, relevant, _, _ = _gradation_inputs()
    cfg = _cfg()
    got = fh.grad_hist_plain(T(recon), T(relevant), cfg).numpy()
    for method in ("fact", "fused_interpret"):
        want = np.asarray(j_gradation.gradation_histogram(
            jnp.asarray(recon), jnp.asarray(relevant), cfg, method))
        np.testing.assert_array_equal(got, want, err_msg=method)
    assert got[0] > 0


def test_k3_plain_counts_a_nan_pixel_as_jax():
    """K3's plain version (``fused_hist.grad_hist_relevant_plain``: the
    relevance image, then the gradation bins) against ``tpu/``'s
    ``gradation_histogram_fused_relevance``: its plain ops and its Pallas
    kernel (``grad_hist_relevant_fused``) in interpret mode."""
    recon, _, normalized, cnr = _gradation_inputs()
    cfg = _cfg()
    got = fh.grad_hist_relevant_plain(T(recon), T(normalized), T(cnr), cfg).numpy()
    for method in ("fact", "fused_interpret"):
        want = np.asarray(j_gradation.gradation_histogram_fused_relevance(
            jnp.asarray(recon), jnp.asarray(normalized), jnp.asarray(cnr), cfg, method))
        np.testing.assert_array_equal(got, want, err_msg=method)
    # five NaN pixels inside the border, each with weight 100, and no
    # finite recon value in bin 0
    assert got[0] == 500


@functools.lru_cache(maxsize=None)
def _noise_sdev():
    """An sdev [N, N] in (0.001, 0.09) with NaN at lanes 3 and 15 of two
    16-lane groups (the rest of the first group finite and non-zero) and at
    lane 0 of a third."""
    rng = np.random.default_rng(23)
    sd = rng.uniform(0.001, 0.09, (N, N)).astype(F32)
    sd[4, 16 + 3] = np.nan
    sd[9, 32 + 15] = np.nan
    sd[30, 0] = np.nan
    return sd


def test_noise_bins_break_a_group_at_a_nan_sdev():
    sd = _noise_sdev()
    cfg = MusicaConfig(image_size=N, quirks=False)
    bins, w = stats.noise_bins(T(sd), cfg)
    j_bins, j_w = (np.asarray(a) for a in j_stats.noise_bins(jnp.asarray(sd), cfg))
    np.testing.assert_array_equal(bins.numpy(), j_bins)
    np.testing.assert_array_equal(w.numpy(), j_w.astype(np.int64))
    w = w.numpy().reshape(N, N)
    # the group ends at its NaN: lanes 0-2 counted, 3-15 not
    assert w[4, 16:19].all() and not w[4, 19:32].any()
    assert w[9, 32:47].all() and not w[9, 47]
    assert not w[30, :16].any()


def test_noise_histogram_plain_breaks_at_a_nan_sdev_as_jax():
    """K1's plain version (``stats.noise_histogram`` on the CPU) against
    ``tpu/``'s ``noise_histogram``: its plain ops and its Pallas kernel
    (``noise_hist_fused``) in interpret mode."""
    sd = _noise_sdev()
    cfg = MusicaConfig(image_size=N, quirks=False)
    got = stats.noise_histogram(T(sd), cfg).numpy()
    for method in ("fact", "fused_interpret"):
        want = np.asarray(j_stats.noise_histogram(jnp.asarray(sd), cfg, method))
        np.testing.assert_array_equal(got, want, err_msg=method)
    assert int(got.sum()) == N * N - 13 - 1 - 16
