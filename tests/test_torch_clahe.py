"""The CLAHE variant of the PyTorch port (``ops/clahe.py``, the histogram
wrapper ``ops/cuda/histogram.py`` behind ``stats.fixed_histogram`` and the
apply wrapper ``ops/cuda/clahe_apply.py``) on the CPU, against the JAX
package (Pallas kernels in interpret mode, XLA elsewhere) and the golden
model.

Histograms are integers and must be exactly equal.  The CDFs are float32
sums: the port sums in float64 and rounds once (exact at these sizes), XLA
and golden round at every step, so they are compared within 1e-6 (XLA) and
1e-4 (golden, the JAX package's own bound, tests/test_clahe.py).  The apply
is held to 5e-7 against XLA and the Pallas kernel (the bound of
tests/test_clahe.py::test_clahe_apply_fused_matches_xla), with equal NaN
masks: a tile without relevant pixels has a NaN LUT (0/0, as the GLSL).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import clahe as j_clahe
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import stats as j_stats
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops.pallas import histogram as j_phist
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops.pallas.clahe_apply import clahe_apply_fused
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import clahe, stats
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import clahe_apply as k_clahe
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import histogram as k_hist
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch

torch.set_num_threads(2)

F32 = np.float32


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def clahe_inputs(seed, n, nan_tile=True):
    """recon in [-0.1, 1.1] with exact 1.0 and exact 0.0 pixels; a random
    relevance mask, empty over tile (1, 2) when ``nan_tile``."""
    rng = np.random.default_rng(seed)
    recon = rng.uniform(-0.1, 1.1, (n, n)).astype(F32)
    recon[rng.uniform(size=(n, n)) < 0.01] = 1.0
    recon[rng.uniform(size=(n, n)) < 0.005] = 0.0
    relevant = (rng.uniform(size=(n, n)) < 0.6).astype(F32)
    relevant[rng.uniform(size=(n, n)) < 0.05] = 0.5  # ramp weights: not 1.0
    if nan_tile:
        ts = n // 4
        relevant[ts:2 * ts, 2 * ts:3 * ts] = 0.0
    return recon, relevant


# ----------------------------------------------------------------------
# fixed_histogram (K6's plain version)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_bins,n", [(4096, 50000), (256, 20000), (4096, 16384)])
def test_fixed_histogram_matches_jax_exactly(n_bins, n):
    """Out-of-range bins carry zero weight in the Pallas kernel's input (the
    caller's contract) and arbitrary weight in fixed_histogram's (which
    zeroes them); float32 integer weights as the JAX package passes them."""
    rng = np.random.default_rng(n_bins + n)
    b = rng.integers(-50, n_bins + 50, n).astype(np.int32)
    w = rng.integers(0, 3, n).astype(F32)
    got = stats.fixed_histogram(T(b), T(w), n_bins)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_bins,)
    in_range = (b >= 0) & (b < n_bins)
    pal = j_phist.factorized_histogram_pallas(
        jnp.asarray(np.clip(b, 0, n_bins - 1)), jnp.asarray(np.where(in_range, w, 0)),
        n_bins, block=8192, interpret=True)
    fact = j_stats.fixed_histogram(jnp.asarray(b), jnp.asarray(w), n_bins, "fact")
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
    np.testing.assert_array_equal(got.numpy(), np.asarray(fact))
    ref = np.bincount(b[in_range], weights=w[in_range], minlength=n_bins)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))


def test_fixed_histogram_integer_weights_and_empty_input():
    b = torch.tensor([[0, 1], [1, 5]], dtype=torch.int32)
    w = torch.tensor([[2, 3], [4, 7]], dtype=torch.int32)
    assert stats.fixed_histogram(b, w, 4).tolist() == [2, 7, 0, 0]
    empty = torch.zeros(0, dtype=torch.int32)
    assert stats.fixed_histogram(empty, empty, 8).tolist() == [0] * 8
    with pytest.raises(ValueError):
        stats.fixed_histogram(b, w[:1], 4)


# ----------------------------------------------------------------------
# clahe_histograms, clahe_curves, _lut_eval
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [128, 256])
def test_clahe_histograms_match_jax_and_golden(n):
    cfg = MusicaConfig(image_size=n, enable_clahe=True)
    recon, relevant = clahe_inputs(n, n)
    got = clahe.clahe_histograms(T(recon), T(relevant), cfg)
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, 4, 256)
    jax_h = j_clahe.clahe_histograms(jnp.asarray(recon), jnp.asarray(relevant), cfg, "fact")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_h))
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  golden.clahe_histograms(recon, relevant, cfg))
    assert int(got[1, 2].sum()) == 0  # the empty tile


def _curve_hists(seed):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 500, (4, 4, 256)).astype(np.int64)
    h[0, 3] = 0                       # a tile without relevant pixels
    h[2, 1] = 0
    h[2, 1, 40] = 9000                # one spike: most mass clipped
    return h


def test_clahe_curves_match_jax_and_golden():
    cfg = MusicaConfig(image_size=128, enable_clahe=True)
    h = _curve_hists(7)
    px, py = clahe.clahe_curves(T(h.astype(np.int32)), cfg)
    jpx, jpy = j_clahe.clahe_curves(jnp.asarray(h, jnp.int32), cfg)
    gpx, gpy = golden.clahe_curves(h, cfg)
    jpy, py_np = np.asarray(jpy), py.numpy()
    np.testing.assert_array_equal(px.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(px.numpy(), gpx)
    np.testing.assert_array_equal(np.isnan(py_np), np.isnan(jpy))
    np.testing.assert_array_equal(np.isnan(py_np), np.isnan(gpy))
    assert np.isnan(py_np[0, 3]).all() and np.isfinite(py_np[2, 1]).all()
    finite = np.isfinite(py_np)
    np.testing.assert_allclose(py_np[finite], jpy[finite], rtol=0, atol=1e-6)
    np.testing.assert_allclose(py_np[finite], gpy[finite], rtol=0, atol=1e-4)


def test_clahe_curves_cdf_is_the_exact_sum_rounded_once():
    """The CDF is the float64 sum of the float32 terms rounded to float32
    once: numpy's sequential float64 cumsum gives the same bits, so no
    summation order (the card's scan included) can change it."""
    cfg = MusicaConfig(image_size=3072, enable_clahe=True)
    rng = np.random.default_rng(11)
    # 3072's tile size: up to 768^2 pixels per tile
    h = rng.integers(0, 4600, (4, 4, 256)).astype(np.int32)
    _, py = clahe.clahe_curves(T(h), cfg)
    counts = h.astype(F32)
    norm = counts / h.astype(np.int64).sum(-1, keepdims=True).astype(F32)
    clipped = np.minimum(norm, F32(cfg.clahe_clip_limit))
    excess = (norm - clipped).astype(np.float64).sum(-1, keepdims=True).astype(F32)
    redist = clipped + excess / F32(256)
    np.testing.assert_array_equal(
        py.numpy(), np.cumsum(redist.astype(np.float64), -1).astype(F32))
    # every prefix summed backwards, pairwise (numpy's sum): the same bits
    r64 = redist.astype(np.float64)
    backwards = np.stack([r64[..., k::-1].sum(-1) for k in range(256)], -1)
    np.testing.assert_array_equal(py.numpy(), backwards.astype(F32))


def test_lut_eval_matches_jax_and_golden_get_y():
    cfg = MusicaConfig(image_size=128, enable_clahe=True)
    h = _curve_hists(3)
    px, py = golden.clahe_curves(h, cfg)
    rng = np.random.default_rng(5)
    xs = np.concatenate([rng.uniform(0, 1, 300),
                         [0.0, -0.0, 1.0, 0.5, 255 / 256, 254 / 256, -0.2, 1.3,
                          np.nan, np.inf, -np.inf]]).astype(F32)
    for tile in (2 * 4 + 1, 0 * 4 + 3):  # a finite tile and the NaN tile
        idx = np.full(xs.shape, tile, np.int32)
        got = clahe._lut_eval(T(px), T(py.reshape(-1)), T(idx), T(xs), 256).numpy()
        jax_v = np.asarray(j_clahe._lut_eval(
            jnp.asarray(px), jnp.asarray(py).reshape(-1), jnp.asarray(idx),
            jnp.asarray(xs), 256))
        np.testing.assert_array_equal(got, jax_v)
        ref = golden.curve_get_y(px, py.reshape(16, 256)[tile], xs)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        finite = np.isfinite(ref)
        np.testing.assert_allclose(got[finite], ref[finite], rtol=0, atol=2e-5)


# ----------------------------------------------------------------------
# clahe_apply (K5's plain version)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [256, 600, 3072])
def test_axis_attrs_use_true_division(n):
    """The tile coordinate i / tile_size is a true float32 division (numpy's)
    and the tile of the histogram's i / n * 4 as well, at every index."""
    cfg = MusicaConfig(image_size=n, enable_clahe=True)
    like = torch.zeros(1)
    base_i, nb_i, w_base, w_nb, zero = clahe.axis_attrs(n, cfg, like)
    coord = np.arange(n, dtype=F32) / F32(n // 4)
    base = np.floor(coord).astype(F32) + F32(0.5)
    sgn = np.sign(coord - base).astype(np.int64)
    np.testing.assert_array_equal(base_i.numpy(), np.clip(np.floor(base), 0, 3))
    np.testing.assert_array_equal(nb_i.numpy(), np.clip(np.floor(base) + sgn, 0, 3))
    np.testing.assert_array_equal(w_base.numpy(), F32(1) - np.abs(base - coord))
    np.testing.assert_array_equal(zero.numpy(), coord == base)
    assert w_nb.dtype == torch.float32 and bool((w_nb >= 0).all())


@pytest.mark.parametrize("n", [256])
def test_clahe_apply_matches_jax_and_pallas_interpret(n):
    """Exact-1.0 pixels, out-of-range pixels and a NaN tile; the same LUTs go
    into every implementation."""
    cfg = MusicaConfig(image_size=n, enable_clahe=True)
    recon, relevant = clahe_inputs(100 + n, n)
    px, py = clahe.clahe_curves(clahe.clahe_histograms(T(recon), T(relevant), cfg), cfg)
    got = clahe.clahe_apply(T(recon), px, py, cfg).numpy()
    jpx, jpy = jnp.asarray(px.numpy()), jnp.asarray(py.numpy())
    ref = np.asarray(j_clahe.clahe_apply(jnp.asarray(recon), jpx, jpy, cfg))
    pal = np.asarray(clahe_apply_fused(jnp.asarray(recon), jpy, t=4, bins=256,
                                       interpret=True))
    assert np.isnan(got).any() and np.isfinite(got).mean() > 0.5
    for other, what in ((ref, "XLA"), (pal, "Pallas interpret")):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(other), what)
        finite = np.isfinite(other)
        np.testing.assert_allclose(got[finite], other[finite], rtol=0, atol=5e-7,
                                   err_msg=what)
    # pixels outside [0, 1] map to 0 wherever no NaN tile takes part
    out_of_range = ((recon < 0) | (recon > 1)) & ~np.isnan(got)
    assert (got[out_of_range] == 0).all()


def test_clahe_grade_matches_golden_and_jax():
    cfg = MusicaConfig(image_size=128, enable_clahe=True)
    recon, relevant = clahe_inputs(21, 128)
    got = clahe.clahe_grade(T(recon), T(relevant), cfg).numpy()
    ref = golden.clahe_grade(recon, relevant, cfg)
    jax_v = np.asarray(j_clahe.clahe_grade(jnp.asarray(recon), jnp.asarray(relevant),
                                           cfg, "fact"))
    for other, what in ((ref, "golden"), (jax_v, "JAX")):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(other), what)
        finite = np.isfinite(other)
        np.testing.assert_allclose(got[finite], other[finite], rtol=0, atol=1e-4,
                                   err_msg=what)


def test_clahe_center_pixel_is_the_single_tile_lut():
    cfg = MusicaConfig(image_size=128, enable_clahe=True)
    recon, _ = clahe_inputs(4, 128, nan_tile=False)
    recon = np.clip(recon, 0, 1)
    px, py = clahe.clahe_curves(clahe.clahe_histograms(
        T(recon), torch.ones((128, 128)), cfg), cfg)
    out = clahe.clahe_apply(T(recon), px, py, cfg)
    c = 16  # 16 / 32 = 0.5: a tile centre on both axes
    idx = torch.tensor([0], dtype=torch.int32)
    assert out[c, c] == clahe._lut_eval(px, py.reshape(-1), idx, T(recon)[c, c:c + 1], 256)[0]


# ----------------------------------------------------------------------
# wrappers on the CPU: plain versions, no launch
# ----------------------------------------------------------------------

def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    cfg = MusicaConfig(image_size=64, enable_clahe=True)
    recon, relevant = clahe_inputs(2, 64)
    launch.reset_launch_counts()
    h = clahe.clahe_histograms(T(recon), T(relevant), cfg)
    px, py = clahe.clahe_curves(h, cfg)
    out = k_clahe.clahe_apply(T(recon), px, py, cfg)
    torch.testing.assert_close(out, k_clahe.clahe_apply_plain(T(recon), px, py, cfg),
                               rtol=0, atol=0, equal_nan=True)
    assert torch.equal(k_hist.histogram(h.reshape(-1), h.reshape(-1), 9),
                       k_hist.histogram_plain(h.reshape(-1), h.reshape(-1), 9))
    assert launch.LAUNCHES == {k: 0 for k in launch.LAUNCHES}
    with pytest.raises(ValueError):
        k_clahe.clahe_apply(T(recon), px, py.to("meta"), cfg)  # mixed devices
