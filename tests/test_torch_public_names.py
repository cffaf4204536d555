"""The JAX package's public names that the port exposes as thin functions
beside the forms its pipeline uses: ``curves.curve_get_y`` (the GLSL
first-match scan), ``curve_get_y_adaptive``, ``curve_apply_u8_adaptive``,
``normalize.img_sqrt``, ``global_max``, ``global_min``, ``img_normalize``,
``pyramid.downsample``, ``stats.sdev_and_noise_histogram`` and
``metrics.measure_row_device``, each against the JAX package's function on
the same inputs: integers and u8 exactly, float32 bit for bit where the two
packages compute in one order (each stated tolerance says why not).  XLA on
the CPU flushes float32 denormals, so no input here is denormal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig as JConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import curves as j_curves
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import normalize as j_normalize
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import pyramid as j_pyramid
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import stats as j_stats
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing import metrics as j_metrics
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import (
    curves, normalize, pyramid, stats)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import metrics
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
    synthetic_radiograph)

torch.set_num_threads(2)

# control points: a sorted contrast-like curve, a gradation-like curve whose
# second segment folds back (non-monotone px), and one with ties (repeated
# px, a zero-width interval)
CURVES = {
    "sorted": ([0.0, 0.1, 0.25, 0.5, 0.75, 1.0], [1.0, 1.8, 1.8, 1.4, 1.1, 1.0]),
    "non-monotone": ([0.0, 0.2, 0.45, 0.4, 0.35, 0.6, 0.9, 1.0],
                     [0.0, 0.1, 0.3, 0.5, 0.6, 0.7, 0.95, 1.0]),
    "ties": ([0.0, 0.3, 0.3, 0.3, 0.7, 0.7, 1.0], [0.0, 0.2, 0.4, 0.6, 0.8, 0.9, 1.0]),
}


def _xs(px: np.ndarray, seed: int = 0) -> np.ndarray:
    """x over and beyond the curve's range, every control point itself,
    its float32 neighbours (but the denormal ones of 0), and NaN/inf."""
    rng = np.random.default_rng(seed)
    near = np.concatenate([np.nextafter(px, np.float32(2)), np.nextafter(px, np.float32(-2))])
    near = near[np.abs(near) >= np.finfo(np.float32).tiny]
    x = np.concatenate([rng.uniform(-0.2, 1.2, 4000).astype(np.float32), px, near,
                        np.array([np.nan, np.inf, -np.inf, 0.0, 1.0], np.float32)])
    return x.astype(np.float32)


def _glsl_get_y(px, py, x) -> np.float32:
    """The GLSL loop on one float32 x, transcribed with NumPy scalars."""
    px_e = list(px) + [np.float32(0)]
    py_e = list(py) + [np.float32(0)]
    for i in range(len(px)):
        if px_e[i] == x:
            return py_e[i]
        if px_e[i] <= x <= px_e[i + 1]:
            m = (py_e[i + 1] - py_e[i]) / (px_e[i + 1] - px_e[i])
            return m * (x - px_e[i]) + py_e[i]
    return np.float32(0)


def _curve(name):
    px, py = (np.array(v, np.float32) for v in CURVES[name])
    return px, py, _xs(px)


@pytest.mark.parametrize("name", sorted(CURVES))
def test_curve_get_y_is_the_first_match_scan(name):
    """``curve_get_y`` against the JAX package's scan, bit for bit, and at
    every control point and its neighbours against the GLSL loop itself:
    on a folded or tied curve an earlier interval can take x before the
    exact match of a later point."""
    px, py, x = _curve(name)
    got = curves.curve_get_y(torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(x))
    want = np.asarray(j_curves.curve_get_y(jnp.asarray(px), jnp.asarray(py), jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    with np.errstate(divide="ignore", invalid="ignore"):
        loop = np.array([_glsl_get_y(px, py, v) for v in x[4000:]], np.float32)
    np.testing.assert_array_equal(got.numpy()[4000:].view(np.uint32), loop.view(np.uint32))


@pytest.mark.parametrize("name", sorted(CURVES))
def test_adaptive_aliases_equal_the_jax_package(name):
    """``curve_get_y_adaptive`` (float32, bit for bit) and
    ``curve_apply_u8_adaptive`` (u8, exactly) against the JAX package's,
    which are its general chain as here."""
    px, py, x = _curve(name)
    tp, ty, tx = (torch.from_numpy(a) for a in (px, py, x))
    jp, jy, jx = (jnp.asarray(a) for a in (px, py, x))
    got = curves.curve_get_y_adaptive(tp, ty, tx).numpy()
    want = np.asarray(j_curves.curve_get_y_adaptive(jp, jy, jx))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    fin = np.isfinite(x)
    got8 = curves.curve_apply_u8_adaptive(tp, ty, tx[fin]).numpy()
    want8 = np.asarray(j_curves.curve_apply_u8_adaptive(jp, jy, jx[fin]))
    assert got8.dtype == want8.dtype == np.uint8
    np.testing.assert_array_equal(got8, want8)


@pytest.mark.parametrize("n", [64, 100, 144])
@pytest.mark.parametrize("quirks", [True, False])
def test_normalize_names_equal_the_jax_package(n, quirks):
    """``img_sqrt``, ``global_max``, ``global_min`` (pinned to 0 on a
    misaligned chain in quirks mode: 100 and 144; 64 is aligned) and
    ``img_normalize``, chained as the JAX package's, bit for bit; the chain
    equals ``normalize_from_u16``."""
    img = synthetic_radiograph(n, "hand")
    s = normalize.img_sqrt(torch.from_numpy(img))
    js = j_normalize.img_sqrt(jnp.asarray(img))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    vmax, vmin = normalize.global_max(s, quirks), normalize.global_min(s, quirks)
    jmax, jmin = j_normalize.global_max(js, quirks), j_normalize.global_min(js, quirks)
    assert float(vmax) == float(jmax) and float(vmin) == float(jmin)
    if quirks:
        assert (float(vmin) == 0.0) == (n != 64)
    out = normalize.img_normalize(s, vmax, vmin, quirks)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(j_normalize.img_normalize(js, jmax, jmin, quirks)))
    fused, fmax, fmin = normalize.normalize_from_u16(torch.from_numpy(img), quirks)
    assert torch.equal(out, fused) and torch.equal(vmax, fmax) and torch.equal(vmin, fmin)
    batch = torch.stack([s, s.flip(0)])
    np.testing.assert_array_equal(
        normalize.img_normalize(batch, normalize.global_max(batch, quirks),
                                normalize.global_min(batch, quirks), quirks).numpy(),
        np.asarray(j_normalize.img_normalize(
            jnp.asarray(batch.numpy()), j_normalize.global_max(jnp.asarray(batch.numpy()), quirks),
            j_normalize.global_min(jnp.asarray(batch.numpy()), quirks), quirks)))
    # plain numbers for the extrema, as the JAX package takes them
    np.testing.assert_array_equal(
        normalize.img_normalize(s, 200.0, 3.0, quirks).numpy(),
        np.asarray(j_normalize.img_normalize(js, 200.0, 3.0, quirks)))


@pytest.mark.parametrize("shape", [(9, 9), (64, 64), (3, 17, 17)])
def test_downsample_equals_the_jax_package(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = pyramid.downsample(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_pyramid.downsample(jnp.asarray(x))))
    assert got.shape[-1] == -(-shape[-1] // 2)


@pytest.mark.parametrize("band", ["phantom level 0", "random 256", "random 128", "random 33"])
@pytest.mark.parametrize("fused_sdev", [False, True])
def test_sdev_and_noise_histogram_equals_the_jax_package(band, fused_sdev):
    """One level's (sdev, histogram) against the JAX package's (its CPU
    default): the histogram exactly; the sdev bit for bit against golden's,
    which the port's float64 taps follow, and within 2e-6 of the JAX
    package's XLA float32 sums (``test_torch_ops.py``'s bar for
    ``img_sdev``: one ulp here).  At 256 the quirks-mode dispatch covers
    no pixel (an empty histogram); the random bands take the default 3072
    configuration's 512-px coverage."""
    n = 256 if band.startswith("phantom") else 3072
    cfg, jcfg = MusicaConfig(image_size=n), JConfig(image_size=n)
    if band.startswith("phantom"):
        norm = normalize.normalize_from_u16(torch.from_numpy(synthetic_radiograph(n, "thorax")))[0]
        b = pyramid.reduce_ladder(norm, cfg.pyramid_levels)[0][0].float()
    else:
        m = int(band.split()[1])
        b = torch.from_numpy((np.random.default_rng(m).standard_normal((m, m)) * 0.01)
                             .astype(np.float32))
    sd, h = stats.sdev_and_noise_histogram(b, cfg, fused_sdev)
    j_sd, j_h = j_stats.sdev_and_noise_histogram(jnp.asarray(b.numpy()), jcfg)
    np.testing.assert_array_equal(sd.numpy(), golden.img_sdev(b.numpy()))
    np.testing.assert_allclose(sd.numpy(), np.asarray(j_sd), rtol=0, atol=2e-6)
    assert h.dtype == torch.int32 and h.shape == (cfg.noise_histogram_bins,)
    np.testing.assert_array_equal(h.numpy(), np.asarray(j_h))
    assert (int(h.sum()) > 0) == band.startswith("random")


@pytest.mark.parametrize("case", ["random", "shifted", "identity"])
def test_measure_row_device_equals_the_jax_package(case):
    """The 6 floats of a row against the JAX package's
    ``measure_row_device``: the histogram distances exactly (both finish
    them on the host in float64 from exact counts), mse and SSIM within
    2e-5, the bar both packages' device rows meet against the float64
    oracles (the JAX row's jitted box filters sum in another order)."""
    rng = np.random.default_rng(3)
    unalt = rng.integers(0, 256, (96, 80)).astype(np.uint8)
    alt = {"random": rng.integers(0, 256, (96, 80)).astype(np.uint8),
           "shifted": np.clip(unalt.astype(int) + 7, 0, 255).astype(np.uint8),
           "identity": unalt.copy()}[case]
    ref = np.clip(unalt.astype(int) - 5, 0, 255).astype(np.uint8)
    got = metrics.measure_row_device(alt, torch.from_numpy(unalt), torch.from_numpy(ref))
    want = j_metrics.measure_row_device(alt, jnp.asarray(unalt), jnp.asarray(ref))
    assert len(got) == len(want) == 6
    assert got == metrics.measure_row(alt, torch.from_numpy(unalt), torch.from_numpy(ref))
    assert [got[2], got[5]] == [want[2], want[5]]
    np.testing.assert_allclose([got[i] for i in (0, 1, 3, 4)], [want[i] for i in (0, 1, 3, 4)],
                               rtol=0, atol=2e-5)
