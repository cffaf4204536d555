"""The PyTorch port's metamorphic harness modules against the JAX package's:
the perturbations (byte-equal raws from one seed), the Pillow-free
rotations (bit-equal to Pillow), the analysis copies, the float64 host
oracles, and ``metrics.measure_row`` against those oracles."""

import os

import numpy as np
import pytest
import torch

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing import analysis as j_analysis
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing import metrics as j_metrics
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing import perturb as j_perturb
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import io as j_io
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import analysis, metrics, perturb
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import synthetic_radiograph
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.utils import io

torch.set_num_threads(2)

ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "artifacts", "mt_campaign_3072")


# ----------------------------------------------------------------------
# perturbations
# ----------------------------------------------------------------------

def _family(mod, name, size):
    """[(step, fn(raw, rng) -> altered raw)] of one MR family of ``mod``."""
    shutters = mod._scaled(mod.COLLIMATOR_SHUTTERS, size)
    trans = mod._scaled(mod.TRANSLATIONS, size)
    return {
        "quantum": [(f, lambda r, g, f=f: mod.apply_quantum_noise(r, f, g))
                    for f in mod.QUANTUM_FACTORS],
        "gaussian": [(s, lambda r, g, s=s: mod.add_gaussian_noise(r, 0.0, s, g))
                     for s in mod.GAUSSIAN_SIGMAS],
        "collimator": [(s, lambda r, g, s=s: mod.apply_collimator(r, s, s, g)) for s in shutters],
        "translation_x": [(t, lambda r, g, t=t: mod.clamp_translation(r, x_shift=t))
                          for t in trans],
        "translation_y": [(t, lambda r, g, t=t: mod.clamp_translation(r, y_shift=t))
                          for t in trans],
        "rotation": [(d, lambda r, g, d=d: mod.clamp_rotate(r, d)) for d in mod.ROTATIONS],
    }[name]


@pytest.mark.parametrize("family", ["quantum", "gaussian", "collimator", "translation_x",
                                    "translation_y", "rotation"])
@pytest.mark.parametrize("size", [256, 512])
def test_perturbations_byte_equal_to_jax_packages(size, family):
    """Every step of the family, drawn in turn from one generator per
    package seeded alike: the same bytes, and the generators end in the
    same state."""
    pytest.importorskip("PIL")  # the JAX package rotates with Pillow
    raw = synthetic_radiograph(size, "knee")
    g_port, g_jax = np.random.default_rng(11), np.random.default_rng(11)
    for (step, mine), (_, theirs) in zip(_family(perturb, family, size),
                                         _family(j_perturb, family, size)):
        a, b = mine(raw, g_port), theirs(raw, g_jax)
        assert a.dtype == b.dtype == np.uint16 and a.shape == raw.shape
        assert a.tobytes() == b.tobytes(), (family, step)
    assert g_port.bit_generator.state == g_jax.bit_generator.state
    assert perturb.inner_rect_after_rotation(size, size - 7, 27) == \
        j_perturb.inner_rect_after_rotation(size, size - 7, 27)


ANGLES = (9, 18, 27, 36, 45, 1, 123.4, -33.3, 90, 180, 270, 360)


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("shape", [(56, 56), (236, 236), (600, 600), (3052, 3052), (57, 91)],
                         ids=["56", "236", "600", "3052", "57x91"])
def test_rotations_bit_equal_to_pillow(shape, bits):
    """``rotate_nearest_u16`` (mode ``I;16``, with a fill colour) and
    ``rotate_nearest_u8`` (mode ``L``) against ``Image.rotate`` at the
    campaign's angles, three others, and the multiples of 90 degrees that
    Pillow transposes (square) or maps (not square)."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(shape[0] + bits)
    if bits == 16:
        img = rng.integers(0, 65536, shape).astype(np.uint16)
        for deg in ANGLES:
            want = np.array(Image.fromarray(img).rotate(deg, fillcolor=4321), dtype=np.uint16)
            np.testing.assert_array_equal(perturb.rotate_nearest_u16(img, deg, 4321), want,
                                          err_msg=f"{deg} degrees")
    else:
        img = rng.integers(0, 256, shape).astype(np.uint8)
        for deg in ANGLES:
            want = np.array(Image.fromarray(img).rotate(deg))
            np.testing.assert_array_equal(perturb.rotate_nearest_u8(img, deg), want,
                                          err_msg=f"{deg} degrees")


# ----------------------------------------------------------------------
# analysis
# ----------------------------------------------------------------------

def _rows(path, delimiter):
    import csv
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter=delimiter))


def test_delta_table_and_slopes_equal_jax_packages():
    """On the committed 3072 campaign: the delta table, the slopes and the
    Wilcoxon tests equal the JAX package's."""
    rows = _rows(f"{ARTIFACT}/direct_robustness.csv", ",")
    assert analysis.build_delta_table(rows) == j_analysis.build_delta_table(rows)
    deltas = _rows(f"{ARTIFACT}/deltas.csv", ";")
    assert analysis.slope_analysis(deltas) == j_analysis.slope_analysis(deltas)
    mine, theirs = analysis.wilcoxon_analysis(deltas), j_analysis.wilcoxon_analysis(deltas)
    assert len(mine) == len(theirs) == 54
    np.testing.assert_array_equal(np.array([m[2:] for m in mine]),
                                  np.array([t[2:] for t in theirs]))
    assert [m[:2] for m in mine] == [t[:2] for t in theirs]
    d = np.random.default_rng(4).normal(size=30)
    assert analysis.wilcoxon_signed_rank(d) == j_analysis.wilcoxon_signed_rank(d)


@pytest.mark.parametrize("wilcoxon", [False, True])
def test_slope_analysis_file_text_equals_jax_packages(tmp_path, wilcoxon):
    """The printed lines and the written file, on the committed deltas:
    the same text, 54 lines, and the flags of ``slope_out.txt``."""
    src = f"{ARTIFACT}/deltas.csv"
    mine = analysis.slope_analysis_file(src, out_file=str(tmp_path / "a.txt"), wilcoxon=wilcoxon)
    theirs = j_analysis.slope_analysis_file(src, out_file=str(tmp_path / "b.txt"),
                                            wilcoxon=wilcoxon)
    assert mine == theirs and len(mine) == 54
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    committed = [ln.split(" \t ") for ln in open(f"{ARTIFACT}/slope_out.txt").read().splitlines()]
    flags = [abs(float(s)) > analysis.SLOPE_CRITERION for _, _, s in committed]
    assert [("slope test=True" in ln) for ln in mine] == flags


def test_mean_cnr_equals_jax_packages(tmp_path):
    rng = np.random.default_rng(8)
    bmps = tmp_path / "bmps"
    for i in range(3):
        io.save_bmp8(bmps / f"cnr_{i}.bmp", rng.integers(0, 256, (40, 56)).astype(np.uint8))
    for margin in (0, 5):
        assert analysis.mean_cnr_dir(str(bmps), margin=margin) == \
            j_analysis.mean_cnr_dir(str(bmps), margin=margin)
    analysis.mean_cnr_dir(str(bmps), out_file=str(tmp_path / "a.out"))
    j_analysis.mean_cnr_dir(str(bmps), out_file=str(tmp_path / "b.out"))
    assert (tmp_path / "a.out").read_text() == (tmp_path / "b.out").read_text()


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "RGBA"])
def test_load_bmp_reads_what_pillow_reads(tmp_path, mode):
    """The port's NumPy BMP reader against the JAX package's (Pillow's
    ``convert("L")``) on 24-, 8- (palette) and 32-bit files, bottom-up."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(len(mode))
    shape = (37, 53) + ((3,) if mode == "RGB" else (4,) if mode == "RGBA" else ())
    arr = rng.integers(0, 256, shape).astype(np.uint8)
    im = Image.fromarray(arr, "L") if mode == "L" else Image.fromarray(arr)
    (im.convert("P") if mode == "P" else im).save(tmp_path / "x.bmp")
    np.testing.assert_array_equal(io.load_bmp(tmp_path / "x.bmp"),
                                  j_io.load_bmp(tmp_path / "x.bmp"))


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------

def _pairs():
    rng = np.random.default_rng(21)
    a = rng.integers(0, 256, (173, 211)).astype(np.uint8)
    yield "random", a, np.clip(a.astype(int) + rng.integers(-25, 25, a.shape), 0, 255).astype(np.uint8)
    g = (np.linspace(0, 255, 120)[:, None] * np.ones((1, 90))).astype(np.uint8)
    yield "gradient", g, np.clip(g.astype(int) + rng.integers(-5, 5, g.shape), 0, 255).astype(np.uint8)
    yield "constant", np.full((40, 40), 100, np.uint8), np.full((40, 40), 110, np.uint8)
    c = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    yield "narrow range", c // 64 + 100, c


@pytest.mark.parametrize("case", ["random", "gradient", "constant", "narrow range"])
def test_host_oracles_equal_jax_packages(case):
    name, a, b = next(p for p in _pairs() if p[0] == case)
    assert metrics.mse_similarity(a, b) == j_metrics.mse_similarity(a, b)
    assert metrics.ssim_similarity(a, b) == j_metrics.ssim_similarity(a, b, method="numpy")
    assert metrics.hist_similarity(a, b) == j_metrics.hist_similarity(a, b)
    assert metrics.psnr(a, b) == j_metrics.psnr(a, b)
    assert metrics.psnr(a, a) == j_metrics.psnr(a, a) == float("inf")
    ca, cb = np.bincount(a.reshape(-1), minlength=256), np.bincount(b.reshape(-1), minlength=256)
    assert metrics._euclid_from_counts(ca, cb) == j_metrics._euclid_from_counts(ca, cb)
    assert metrics._euclid_from_counts(ca, cb) == metrics.hist_similarity(a, b)[1]


@pytest.mark.parametrize("case", ["random", "gradient", "constant", "narrow range"])
def test_measure_row_matches_host_oracles(case):
    """The port's one-pass row (float32 mse and SSIM, exact value counts
    through ``stats.fixed_histogram``) on CPU tensors against the float64
    oracles, within 2e-5 as the JAX package's device row
    (tests/test_metamorphic.py); the identity row is [1, 1, 0, 1, 1, 0]."""
    _, alt, unalt = next(p for p in _pairs() if p[0] == case)
    ref = np.clip(alt.astype(int) + 3, 0, 255).astype(np.uint8)
    vals = metrics.measure_row(alt, torch.from_numpy(unalt), torch.from_numpy(ref))
    want = [metrics.mse_similarity(alt, unalt), metrics.ssim_similarity(alt, unalt),
            metrics.hist_similarity(alt, unalt)[1],
            metrics.mse_similarity(alt, ref), metrics.ssim_similarity(alt, ref),
            metrics.hist_similarity(alt, ref)[1]]
    np.testing.assert_allclose(vals, want, rtol=0, atol=2e-5)
    t = torch.from_numpy(alt)
    np.testing.assert_allclose(metrics.measure_row(alt, t, t), [1, 1, 0, 1, 1, 0],
                               rtol=0, atol=1e-6)


def test_measure_row_on_strided_crops():
    """A registration row measures crops (views) of the device-resident
    images: the same numbers as on contiguous copies."""
    rng = np.random.default_rng(5)
    big = rng.integers(0, 256, (96, 96)).astype(np.uint8)
    alt = rng.integers(0, 256, (60, 50)).astype(np.uint8)
    t = torch.from_numpy(big)
    sl = (slice(10, 70), slice(30, 80))
    assert metrics.measure_row(alt, t[sl], t[sl]) == \
        metrics.measure_row(alt, torch.from_numpy(big[sl].copy()), torch.from_numpy(big[sl].copy()))
