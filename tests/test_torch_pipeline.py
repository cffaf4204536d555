"""The PyTorch port's main path end to end on the CPU, against the JAX
package's ``musica_forward`` (hist_method="fact") and the golden model, and
its host surface (``process``, ``process_batch``, the CLI).

The bar is the one docs/PARITY.md sets for the JAX package against golden:
noise argmax bins, curve points and t0/ta/t1 exactly equal; u8 output at
>= 90 dB PSNR, > 99.99 % bit-exact, max |du8| <= 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu import cli as j_cli
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica as j_musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import (
    curves as j_curves, gradation as j_gradation)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import synthetic_radiograph
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import io as uio
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import cli
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica

torch.set_num_threads(2)


def assert_u8_parity(a, b, what):
    a = np.asarray(a).astype(np.int64)
    b = np.asarray(b).astype(np.int64)
    assert a.shape == b.shape, what
    d = np.abs(a - b)
    mse = np.mean(d.astype(np.float64) ** 2)
    psnr = np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    assert psnr >= 90.0, f"{what}: PSNR {psnr:.2f} dB"
    assert np.mean(d == 0) > 0.9999, f"{what}: bit-exact {np.mean(d == 0)}"
    assert d.max() <= 1, f"{what}: max |du8| {d.max()}"


@pytest.mark.parametrize("size,anatomy,quirks", [(512, "thorax", True),
                                                 (600, "pelvis", True),
                                                 (600, "pelvis", False)])
def test_slice_matches_jax_and_golden(size, anatomy, quirks):
    """512 takes the in-kernel-relevance histogram and the full-coverage
    noise histograms; 600 is ragged (coverage crop to 512, padded levels,
    the relevance-image gradation branch, mirror OOB reads at 2 px); the
    clean-math mode (`--no-quirks`) covers every level and clamps."""
    img = synthetic_radiograph(size, anatomy)
    cfg = MusicaConfig(image_size=size, quirks=quirks)
    res = musica.musica_forward(torch.from_numpy(img), cfg, want_intermediates=True)
    ti = res["intermediates"]
    jres = jax.jit(lambda im: j_musica.musica_forward(
        im, cfg, "fact", want_intermediates=True))(jnp.asarray(img))
    ji = jres["intermediates"]
    g_out, gi = golden.process(img, cfg, return_intermediates=True)

    assert set(ti) == set(ji)
    for i in cfg.analysis_levels:
        mb = int(ti[f"noise_max_bin_{i}"])
        assert mb == int(ji[f"noise_max_bin_{i}"]) == gi["noise_max_bins"][i], f"level {i}"
        # curve points: exact against golden and the JAX ops (op by op: the
        # fused jit contracts the bezier lerps into FMAs, QUIRKS #29)
        lcf, hcf = cfg.contrast_factors[i]
        px, py = ti[f"contrast_curve_{i}"]
        gpx, gpy = golden.contrast_curve_generate(mb, lcf, hcf, cfg)
        jpx, jpy = j_curves.contrast_curve(jnp.int32(mb), lcf, hcf, cfg)
        for a, g, j in ((px, gpx, jpx), (py, gpy, jpy)):
            np.testing.assert_array_equal(a.numpy(), g)
            np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    tv = tuple(float(t) for t in ti["grad_curve"][2])
    assert tv == tuple(float(t) for t in ji["grad_curve"][2]) == gi["grad_curve"][2]
    gpx, gpy, gt = golden.gradation_curve_generate(ti["grad_hist"].numpy().astype(np.int64), cfg)
    np.testing.assert_array_equal(ti["grad_curve"][0].numpy(), gpx)
    np.testing.assert_array_equal(ti["grad_curve"][1].numpy(), gpy)
    jpx, jpy, _ = j_gradation.gradation_curve(jnp.asarray(ti["grad_hist"].numpy()), cfg)
    np.testing.assert_array_equal(ti["grad_curve"][0].numpy(), np.asarray(jpx))

    out = res["out_u8"].numpy()
    assert out.shape == (size - 20, size - 20) and out.dtype == np.uint8
    assert_u8_parity(out, np.asarray(jres["out_u8"]), "vs JAX")
    assert_u8_parity(out, g_out, "vs golden")
    np.testing.assert_allclose(res["recon"].numpy(), gi["recon"], rtol=0, atol=2e-4)
    np.testing.assert_allclose(res["cnr"].numpy(), gi["cnr"], rtol=0, atol=5e-5)
    # the main path (no intermediates) takes the other gradation branch on
    # the same integer histogram
    fast = musica.musica_forward(torch.from_numpy(img), cfg)
    assert torch.equal(fast["out_u8"], res["out_u8"])
    assert "intermediates" not in fast


def test_process_and_batch_entry_points():
    cfg = MusicaConfig(image_size=128)
    imgs = np.stack([synthetic_radiograph(128, a) for a in ("hand", "knee", "foot")])
    single = [musica.process(im, cfg, "cpu") for im in imgs]
    batch = musica.process_batch(imgs, cfg, "cpu")
    assert batch.shape == (3, 108, 108) and batch.dtype == np.uint8
    for s, b in zip(single, batch):
        np.testing.assert_array_equal(s, b)
    # cfg=None derives the config from the image size, as the JAX process does
    np.testing.assert_array_equal(musica.process(imgs[0], None, "cpu"), single[0])
    with pytest.raises(ValueError):
        musica.musica_forward(torch.from_numpy(imgs[0]), MusicaConfig(image_size=256))


@pytest.mark.parametrize("kw", [dict(enable_clahe=True), dict(storage="bfloat16"),
                                dict(grad_with_linear_image=True)])
def test_variants_not_ported_raise(kw):
    cfg = MusicaConfig(image_size=64, **kw)
    with pytest.raises(NotImplementedError):
        musica.musica_forward(torch.zeros((64, 64), dtype=torch.uint16), cfg)


def test_cli_process_cpu_matches_jax_cli(tmp_path):
    """`cli process --device cpu` on a 256^2 raw: a BMP of the cropped size
    meeting the parity bar against the JAX package's CLI output, and a
    --debug-dump with the same file names as the JAX package's dump."""
    raw = tmp_path / "in.raw"
    uio.save_raw(raw, synthetic_radiograph(256, "knee"))
    j_dump, t_dump = tmp_path / "dump_jax", tmp_path / "dump_torch"
    assert j_cli.main(["process", "--size", "256", "--debug-dump", str(j_dump),
                       str(raw), str(tmp_path / "jax.bmp")]) == 0
    assert cli.main(["process", "--size", "256", "--device", "cpu", str(raw),
                     str(tmp_path / "torch.bmp")]) == 0
    assert cli.main(["process", "--size", "256", "--device", "cpu", "--debug-dump",
                     str(t_dump), str(raw), str(tmp_path / "torch_dbg.bmp")]) == 0
    got = uio.load_bmp(tmp_path / "torch.bmp")
    assert got.shape == (236, 236)
    assert_u8_parity(got, uio.load_bmp(tmp_path / "jax.bmp"), "CLI vs JAX CLI")
    np.testing.assert_array_equal(uio.load_bmp(tmp_path / "torch_dbg.bmp"), got)
    names = sorted(p.name for p in t_dump.iterdir())
    assert names == sorted(p.name for p in j_dump.iterdir())
    assert "relevant.bmp" in names and "grad_hist.bmp" in names


def test_cli_batch_cpu(tmp_path):
    imgs = {a: synthetic_radiograph(128, a) for a in ("hand", "head", "pelvis")}
    for a, im in imgs.items():
        uio.save_raw(tmp_path / f"{a}.raw", im)
    out = tmp_path / "out"
    assert cli.main(["batch", "--size", "128", "--device", "cpu", "--batch", "2",
                     "--no-transpose", str(tmp_path / "*.raw"), str(out)]) == 0
    cfg = MusicaConfig(image_size=128)
    for a, im in imgs.items():
        np.testing.assert_array_equal(uio.load_bmp(out / f"{a}.bmp"),
                                      musica.process(im, cfg, "cpu"))


def test_cli_cuda_without_gpu_raises(tmp_path):
    """--device cuda on a machine without a GPU raises; it never falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    raw = tmp_path / "in.raw"
    uio.save_raw(raw, synthetic_radiograph(64, "hand"))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["process", "--size", "64", str(raw), str(tmp_path / "o.bmp")])
    assert not (tmp_path / "o.bmp").exists()
