"""PyTorch port, op by op, against the JAX package's ops and the NumPy golden
model, on the CPU.

Each test makes its inputs with numpy from its own seed and hands the same
arrays to every implementation.  Exact equality is required where the
arithmetic is the same operation sequence (integer logic, curve points,
elementwise chains without FMAs).  The 5-tap stencils accumulate in float64
in the port (as golden does) and in float32 with FMA contraction in XLA, so
those compare within the tolerances tests/test_pipeline.py uses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import (
    curves as j_curves, gradation as j_gradation, noise as j_noise,
    normalize as j_normalize, pyramid as j_pyramid, stats as j_stats)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import (
    curves, gradation, noise, normalize, pyramid, stats)

torch.set_num_threads(2)

F32 = np.float32


def rand_img(rng, n, lo=0.0, hi=1.0):
    return rng.uniform(lo, hi, (n, n)).astype(F32)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def normal_or_zero(x):
    """XLA on the CPU flushes float32 denormals to zero; PyTorch, NumPy and
    the CUDA kernels keep them.  Comparisons with the JAX package skip
    denormal inputs."""
    return (x == 0) | ~(np.abs(x) < np.finfo(F32).tiny)


# ----------------------------------------------------------------------
# normalize
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [96, 100, 384, 512])
@pytest.mark.parametrize("quirks", [True, False])
def test_normalize_matches_jax_and_golden(n, quirks):
    rng = np.random.default_rng(n)
    img = rng.uniform(0, 65535, (n, n)).astype(np.uint16)
    got, vmax, vmin = normalize.normalize_from_u16(T(img), quirks)
    jn, jmax, jmin = j_normalize.normalize_from_u16(jnp.asarray(img), quirks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jn))
    assert float(vmax) == float(jmax) and float(vmin) == float(jmin)
    s = golden.img_sqrt(img)
    gmax, gmin = golden.global_max(s, quirks), golden.global_min(s, quirks)
    assert float(vmax) == gmax and float(vmin) == gmin
    np.testing.assert_array_equal(got.numpy(), golden.img_normalize(s, gmax, gmin, quirks))


@pytest.mark.parametrize("n", [8, 64, 512, 3072, 600, 1000, 4096])
def test_chain_misaligned_matches_jax(n):
    assert normalize._chain_misaligned(n) == j_normalize._chain_misaligned(n)


# ----------------------------------------------------------------------
# pyramid
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [200, 64, 37])
def test_reduce_ladder_matches_jax_and_golden(n):
    """200 -> 100 -> 50 -> 25 -> 13 -> 7 -> 4 -> 2 -> 1: the tail reaches the
    2- and 1-px levels where mirror reads fall out of bounds (QUIRKS #4)."""
    rng = np.random.default_rng(n)
    img = rand_img(rng, n)
    levels = MusicaConfig(image_size=n).pyramid_levels
    bands, downs = pyramid.reduce_ladder(T(img), levels)
    jb, jd = jax.jit(j_pyramid.reduce_ladder, static_argnums=1)(jnp.asarray(img), levels)
    assert [b.shape[-1] for b in bands] == [b.shape[-1] for b in jb]
    assert downs[-1].shape[-1] == 1
    cur = img
    for i in range(levels):
        np.testing.assert_allclose(bands[i].numpy(), np.asarray(jb[i]), rtol=0,
                                   atol=5e-5, err_msg=f"band {i}")
        np.testing.assert_allclose(downs[i].numpy(), np.asarray(jd[i]), rtol=0,
                                   atol=5e-5, err_msg=f"down {i}")
        dn = golden.img_downsample(golden.img_smooth(cur))
        gb = cur - golden.img_smooth(golden.img_upsample(dn, cur.shape[0]), 4.0)
        np.testing.assert_allclose(bands[i].numpy(), gb, rtol=0, atol=5e-5)
        cur = dn


@pytest.mark.parametrize("n", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("gain", [1.0, 4.0])
def test_smooth_tiny_sizes_match_jax(n, gain):
    rng = np.random.default_rng(10 * n + int(gain))
    img = rand_img(rng, n)
    got = pyramid.smooth(T(img), gain).numpy()
    np.testing.assert_allclose(got, np.asarray(j_pyramid.smooth(jnp.asarray(img), gain)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, golden.img_smooth(img, gain), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_out", [6, 7, 9, 12, 33, 64, 97])
def test_upsample_smooth_polyphase_exact(n_out):
    """The polyphase expand equals smooth(upsample(...)) bit for bit (the
    skipped taps are exact zeros), and the JAX package within 1e-6."""
    rng = np.random.default_rng(n_out)
    img = rand_img(rng, -(-n_out // 2))
    got = pyramid.upsample_smooth(T(img), n_out)
    ref = pyramid.smooth(pyramid.upsample(T(img), n_out), gain=4.0)
    assert torch.equal(got, ref)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_pyramid.upsample_smooth(jnp.asarray(img), n_out)),
        rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# stats
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 64, 77])
def test_img_sdev_matches_golden_and_jax(n):
    rng = np.random.default_rng(n)
    band = rand_img(rng, n, -0.1, 0.1)
    got = stats.img_sdev(T(band)).numpy()
    np.testing.assert_allclose(got, golden.img_sdev(band), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got, np.asarray(j_stats.img_sdev(jnp.asarray(band))),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("n,image_size,quirks", [
    (600, 600, True), (300, 600, True), (75, 600, True), (256, 256, True),
    (75, 600, False)])
def test_coverage_view_matches_jax(n, image_size, quirks):
    """Coverage crop/pad (QUIRKS #8): 600 crops to 512, ragged levels pad to
    the 16-px tile, and a sub-512 quirks config covers nothing."""
    cfg = MusicaConfig(image_size=image_size, quirks=quirks)
    sd = rand_img(np.random.default_rng(n), n)
    got = stats.coverage_view(T(sd), cfg)
    ref = j_stats.coverage_view(jnp.asarray(sd), cfg)
    if ref is None:
        assert got is None and stats.coverage(n, cfg) == 0
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert stats.coverage(n, cfg) == got.shape[-1]


def test_histogram_max_first_occurrence():
    """torch.argmax returns the FIRST maximum (the GLSL strict >, QUIRKS #9),
    and an all-zero histogram gives bin 0 -- pinned here because the port
    relies on it."""
    h = torch.tensor([0, 3, 7, 7, 1], dtype=torch.int32)
    mx, mb = stats.histogram_max(h)
    assert (int(mx), int(mb)) == golden.histogram_max(h.numpy()) == (7, 2)
    assert int(stats.histogram_max(torch.zeros(2048, dtype=torch.int32))[1]) == 0
    rng = np.random.default_rng(9)
    for _ in range(20):
        hv = rng.integers(0, 4, 2048).astype(np.int32)  # many ties
        assert int(stats.histogram_max(T(hv))[1]) == golden.histogram_max(hv)[1]
    # boolean masks go through uint8 (torch.argmax rejects bool)
    mask = torch.tensor([False, False, True, True])
    assert int(torch.argmax(mask.to(torch.uint8))) == 2


# ----------------------------------------------------------------------
# curves
# ----------------------------------------------------------------------

@pytest.mark.parametrize("max_bin", [0, 1, 57, 555, 2047])
def test_contrast_curve_matches_golden_and_jax(max_bin):
    """Curve points exactly equal for every level (fine 33-point curves and
    flat 2-point ones); the JAX side runs op by op, since XLA's fused jit
    contracts the bezier lerps into FMAs (1 ulp, QUIRKS #29)."""
    cfg = MusicaConfig(image_size=512)
    for lvl, (lcf, hcf) in enumerate(cfg.contrast_factors):
        px, py = curves.contrast_curve(torch.tensor(max_bin, dtype=torch.int32),
                                       lcf, hcf, cfg)
        gpx, gpy = golden.contrast_curve_generate(max_bin, lcf, hcf, cfg)
        jpx, jpy = j_curves.contrast_curve(jnp.int32(max_bin), lcf, hcf, cfg)
        for a, g, j in ((px, gpx, jpx), (py, gpy, jpy)):
            np.testing.assert_array_equal(a.numpy(), g, err_msg=f"level {lvl}")
            np.testing.assert_array_equal(a.numpy(), np.asarray(j), err_msg=f"level {lvl}")


def test_curve_get_y_sorted_matches_first_match_scan():
    rng = np.random.default_rng(304)
    cfg = MusicaConfig(image_size=512)
    for max_bin in [0, 1, 57, 555, 2047]:
        for lvl in [0, 1, 2, 5]:
            lcf, hcf = cfg.contrast_factors[lvl]
            gpx, gpy = golden.contrast_curve_generate(max_bin, lcf, hcf, cfg)
            xs = np.concatenate([
                gpx, np.nextafter(gpx, 2, dtype=F32), np.nextafter(gpx, -1, dtype=F32),
                rng.uniform(0, 1, 400).astype(F32),
                np.array([0.0, 1.0, 1.0000001, 2.0, -0.5, np.nan, np.inf], F32)])
            got = curves.curve_get_y_sorted(T(gpx), T(gpy), T(xs)).numpy()
            np.testing.assert_array_equal(got, golden.curve_get_y(gpx, gpy, xs))
            ref = np.asarray(j_curves.curve_get_y_sorted(
                jnp.asarray(gpx), jnp.asarray(gpy), jnp.asarray(xs)))
            ok = normal_or_zero(xs)
            np.testing.assert_array_equal(got[ok], ref[ok])


def test_curve_get_y_general_adversarial():
    """The general (fold-back safe) getY against the GLSL first-match scan,
    bit for bit: sorted, fold-back tails, duplicate points, exact boundary
    hits and their 1-ulp neighbours, out-of-range and nonfinite x (NaN/inf
    must give 0.0, not 0*inf = NaN)."""
    rng = np.random.default_rng(376)
    for trial in range(80):
        n = int(rng.integers(2, 34))
        pxs = np.sort(rng.uniform(0, 1, n)).astype(F32)
        if trial % 3 == 1 and n > 4:  # fold-back tail, re-rise to 1.0
            k = int(rng.integers(1, n - 1))
            pxs[k:] = (pxs[k] - np.abs(pxs[k:] - pxs[k]) * 0.5).astype(F32)
            pxs[-1] = 1.0
        if trial % 5 == 2 and n > 3:  # zero-width duplicate interval
            pxs[n // 2] = pxs[n // 2 - 1]
        if trial % 7 == 3:
            pxs[0] = 0.0
        pys = rng.uniform(0, 1, n).astype(F32)
        xs = np.concatenate([
            rng.uniform(-0.1, 1.1, 64).astype(F32), pxs,
            np.nextafter(pxs, 2, dtype=F32), np.nextafter(pxs, -1, dtype=F32),
            np.array([0.0, 1.0, pxs[-1], np.nan, np.inf, -np.inf], F32)])
        got = curves.curve_get_y_general(T(pxs), T(pys), T(xs)).numpy()
        np.testing.assert_array_equal(got, golden.curve_get_y(pxs, pys, xs))
        assert not np.isnan(got).any()
        if trial % 10 == 0:
            ref = np.asarray(j_curves.curve_get_y_general(
                jnp.asarray(pxs), jnp.asarray(pys), jnp.asarray(xs)))
            ok = normal_or_zero(xs)
            np.testing.assert_array_equal(got[ok], ref[ok])


def test_curve_apply_u8_truncates():
    """x255 truncation, clipped to [0, 255] (QUIRKS #22)."""
    g = torch.tensor([0.0, 0.5, 1.0 / 255 - 1e-7, 1.0 / 255, 1.0, 1.2, -0.1])
    assert curves.curve_apply_u8(g).tolist() == [0, 127, 0, 1, 255, 255, 0]
    px = torch.tensor([0.0, 0.5, 1.0])
    py = torch.tensor([0.0, 0.25, 1.0])
    x = torch.tensor([0.25, 0.75, 1.5])
    assert curves.curve_apply_u8(curves.curve_get_y_general(px, py, x)).tolist() == \
        np.asarray(j_curves.curve_apply_u8_adaptive(
            jnp.asarray(px.numpy()), jnp.asarray(py.numpy()), jnp.asarray(x.numpy()))).tolist()


# ----------------------------------------------------------------------
# noise / relevance
# ----------------------------------------------------------------------

@pytest.mark.parametrize("max_bin", [0, 3, 100])
def test_img_cnr_matches_golden(max_bin):
    cfg = MusicaConfig(image_size=512)
    sd = rand_img(np.random.default_rng(213), 64, 0, 0.05)
    got = noise.img_cnr(T(sd), torch.tensor(max_bin, dtype=torch.int32), cfg).numpy()
    np.testing.assert_array_equal(got, golden.img_cnr(sd, max_bin, cfg))


@pytest.mark.parametrize("target,size", [(512, 64), (75, 38), (600, 75), (7, 7)])
def test_nearest_upsample_matches_golden(target, size):
    small = rand_img(np.random.default_rng(target), size)
    np.testing.assert_array_equal(noise.nearest_upsample(T(small), target).numpy(),
                                  golden._nearest_upsample(small, target))


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_noise_reduction_matches_jax_and_golden(lvl):
    """Absolute-cnr ramp (QUIRKS #13, #14); cnr*256 spans 0..20 so both
    clamps and the ramp are hit."""
    cfg = MusicaConfig(image_size=512)
    rng = np.random.default_rng(223 + lvl)
    lo_c, lo_f, hi_c, hi_f = cfg.noise_reduction_params[lvl]
    band = rand_img(rng, 512 >> lvl, -0.3, 0.3)
    cnr = rand_img(rng, 64, 0, 0.08)
    got = noise.noise_reduction(T(band), T(cnr), lo_c, lo_f, hi_c, hi_f, cfg).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_noise.noise_reduction(
        jnp.asarray(band), jnp.asarray(cnr), lo_c, lo_f, hi_c, hi_f, cfg)))
    np.testing.assert_allclose(
        got, golden.noise_reduction(band, cnr, lo_c, lo_f, hi_c, hi_f, cfg),
        rtol=0, atol=3e-6)


def test_noise_reduction_ramp_is_anchored_at_zero():
    cfg = MusicaConfig(image_size=512)
    band = torch.ones((8, 8))
    cnr = torch.full((8, 8), 6.0 / 256.0)  # cnr = 6, mid-ramp
    out = noise.noise_reduction(band, cnr, 3.0, 0.6, 9.0, 1.2, cfg).numpy()
    np.testing.assert_allclose(out, 0.1 * 6.0 + 0.6, rtol=1e-6)


@pytest.mark.parametrize("border", [20, 100])
def test_img_relevant_matches_golden_and_jax(border):
    """The (cnr/6)^5 ramp is a multiply chain (QUIRKS #24), so all three agree
    bit for bit."""
    cfg = MusicaConfig(image_size=512, relevant_border=border)
    rng = np.random.default_rng(244 + border)
    norm = rand_img(rng, 256, 0, 1.0)
    cnr = rand_img(rng, 32, 0, 0.1)
    got = noise.img_relevant(T(norm), T(cnr), cfg).numpy()
    np.testing.assert_array_equal(got, golden.img_relevant(norm, cnr, cfg))
    np.testing.assert_array_equal(got, np.asarray(j_noise.img_relevant(
        jnp.asarray(norm), jnp.asarray(cnr), cfg)))


# ----------------------------------------------------------------------
# gradation
# ----------------------------------------------------------------------

def _grad_hists():
    rng = np.random.default_rng(270)
    smooth = (rng.gamma(2.0, 200.0, 1024)
              * np.exp(-((np.arange(1024) - 400) / 150.0) ** 2)).astype(np.int64) * 100
    smooth[:10] = 12345  # below the lowest relevant bin: ignored
    sparse = np.zeros(1024, np.int64)
    sparse[[40, 41, 300, 302, 700]] = [500, 800, 100, 20000, 300]
    return {
        "smooth": smooth,
        "empty": np.zeros(1024, np.int64),
        # sum(count * i) >> 2^32: the uint32 accumulators wrap (QUIRKS #18)
        "uint32_wrap": np.full(1024, 9_000_000 * 100, np.int64),
        "sparse": sparse,
        "single_bin": np.where(np.arange(1024) == 512, 74_000_000, 0).astype(np.int64),
    }


@pytest.mark.parametrize("name", list(_grad_hists()))
def test_gradation_curve_matches_golden_and_jax(name):
    cfg = MusicaConfig(image_size=512)
    hist = _grad_hists()[name]
    px, py, tv = gradation.gradation_curve(T(hist.astype(np.int32)), cfg)
    gpx, gpy, gt = golden.gradation_curve_generate(hist, cfg)
    np.testing.assert_array_equal(px.numpy(), gpx)
    np.testing.assert_array_equal(py.numpy(), gpy)
    assert tuple(float(t) for t in tv) == gt
    jpx, jpy, jt = j_gradation.gradation_curve(jnp.asarray(hist, jnp.int32), cfg)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jpy))
    assert tuple(float(t) for t in tv) == tuple(float(t) for t in jt)
    assert len(gpx) == 22


@pytest.mark.parametrize("n", [256, 75])
def test_gradation_bins_return_semantics(n):
    """Whole-tile return at the first 0.0 (QUIRKS #16, #17), ragged n padded
    with zeros: the plain histogram equals golden's scan exactly."""
    cfg = MusicaConfig(image_size=n)
    rng = np.random.default_rng(258 + n)
    recon = rng.uniform(-0.1, 1.2, (n, n)).astype(F32)
    recon[rng.uniform(size=(n, n)) < 0.02] = 0.0
    relevant = (rng.uniform(0, 1, (n, n)) ** 2).astype(F32)
    bins, w = gradation.gradation_bins(T(recon), T(relevant), cfg)
    hist = torch.zeros(1024, dtype=torch.int64).scatter_add_(
        0, bins.clamp(0, 1023).to(torch.int64), w)
    np.testing.assert_array_equal(hist.numpy(), golden.gradation_histogram(recon, relevant, cfg))
