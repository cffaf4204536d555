"""The PyTorch port's main path, its CLAHE and linear-gradation variants and
bf16 band storage end to end on the CPU, against the JAX package's
``musica_forward`` (hist_method="fact") and the golden model, the JAX
package's config sweep (tests/test_config_fuzz.py), and the host surface
(``process``, ``process_batch``, ``timed_process``, the CLI).

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
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import clahe

from test_config_fuzz import CASES as FUZZ_CASES, _psnr

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


def test_unsupported_storage_raises():
    """float16 storage: the shared config refuses it, and so does the port
    for a config forced past that check."""
    with pytest.raises(AssertionError):
        MusicaConfig(image_size=64, storage="float16")
    cfg = MusicaConfig(image_size=64)
    object.__setattr__(cfg, "storage", "float16")
    with pytest.raises(NotImplementedError, match="float16"):
        musica.musica_forward(torch.zeros((64, 64), dtype=torch.uint16), cfg)


# ----------------------------------------------------------------------
# bf16 band storage (cfg.storage="bfloat16")
# ----------------------------------------------------------------------

def assert_bf16_contract(o32, o16, size):
    """tests/test_bf16.py's contract for bf16 against float32 storage: at
    256 (test_bf16_tracks_f32_parity_mode) <= 2 % of pixels differ, <= 0.1 %
    by more than 1, knife-edge flips (> 32) aside every difference <= 1,
    inlier PSNR >= 60 dB; from 512 (test_bf16_contract_512) knife-edge flips
    <= 3e-4, inliers within 16, inlier PSNR >= 38 dB."""
    d = np.abs(np.asarray(o32).astype(np.int32) - np.asarray(o16).astype(np.int32))
    knife = d > 32
    inlier = d[~knife].astype(np.float64)
    mse = (inlier ** 2).mean()
    psnr = np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    if size < 512:
        assert float((d > 0).mean()) <= 0.02
        assert float((d > 1).mean()) <= 1e-3
        assert ((d <= 1) | knife).all()
        assert psnr >= 60.0, psnr
    else:
        assert float(knife.mean()) <= 3e-4, knife.mean()
        assert inlier.max() <= 16, inlier.max()
        assert psnr >= 38.0, psnr


@pytest.mark.parametrize("size,anatomy", [(256, "thorax"), (512, "head"),
                                          (512, "thorax"), (512, "hand")])
def test_bf16_tracks_f32(size, anatomy):
    """The port in bf16 against the port in float32, to tests/test_bf16.py's
    contract at its sizes and anatomies."""
    cfg = MusicaConfig(image_size=size)
    x = torch.from_numpy(synthetic_radiograph(size, anatomy))
    o32 = musica.musica_forward(x, cfg)["out_u8"].numpy()
    o16 = musica.musica_forward(x, cfg.with_(storage="bfloat16"))["out_u8"].numpy()
    assert_bf16_contract(o32, o16, size)


def _leaves(v):
    return [x for e in v for x in _leaves(e)] if isinstance(v, tuple) else [v]


@pytest.mark.parametrize("anatomy,reference", [("thorax", "process_jit"), ("hand", "process_jit"),
                                               ("head", "op by op")])
def test_bf16_matches_jax_bf16(anatomy, reference):
    """512 in bf16 against the JAX package in bf16: the u8 output at the
    parity bar, equal argmax bins and t0/ta/t1, and every intermediate in
    the JAX package's dtype (the bands bf16; sdev, recon, cnr, normalized
    float32).

    Thorax and hand are held to the JAX package's ``process_jit``.  Head is
    held to its ``musica_forward(img, cfg, "fact")`` run op by op
    (``jax.disable_jit()``, ~30 s on one core): the JAX package's own bf16
    output moves with XLA's fusion -- at 512 head ``process_jit`` and the op-by-
    op run differ at 11 of 262,144 px (91.56 dB, max 1), the port and
    ``process_jit`` at 17 (89.67 dB, below the 90 dB bar), the port and the
    op-by-op run at 14 (90.51 dB).  The port computes op by op, so that run
    is the reference it is comparable with."""
    cfg = MusicaConfig(image_size=512, storage="bfloat16")
    img = synthetic_radiograph(512, anatomy)
    res = musica.musica_forward(torch.from_numpy(img), cfg, want_intermediates=True)
    if reference == "process_jit":
        want = np.asarray(j_musica.process_jit(jnp.asarray(img), cfg))
    else:
        with jax.disable_jit():
            want = np.asarray(j_musica.musica_forward(jnp.asarray(img), cfg, "fact")["out_u8"])
    assert_u8_parity(res["out_u8"].numpy(), want, f"bf16 vs JAX bf16 ({reference})")
    jres = jax.jit(lambda im: j_musica.musica_forward(
        im, cfg, "fact", want_intermediates=True))(jnp.asarray(img))
    ti, ji = res["intermediates"], jres["intermediates"]
    assert set(ti) == set(ji)
    for k, v in ti.items():
        got = [str(t.dtype).removeprefix("torch.") for t in _leaves(v)]
        assert got == [str(j.dtype) for j in _leaves(ji[k])], k
    for k in ("red_bandpass_0", "contrast_bandpass_0", "nr_bandpass_0"):
        assert ti[k].dtype == torch.bfloat16, k
    for k in ("sdev_0", "normalized", "exp_lowpass_0"):
        assert ti[k].dtype == torch.float32, k
    assert res["recon"].dtype == res["cnr"].dtype == res["graded"].dtype == torch.float32
    for i in cfg.analysis_levels:
        assert int(ti[f"noise_max_bin_{i}"]) == int(ji[f"noise_max_bin_{i}"]), f"level {i}"
    assert (tuple(float(t) for t in ti["grad_curve"][2])
            == tuple(float(t) for t in ji["grad_curve"][2]))


def test_bf16_host_entry_points():
    """bf16 through process_batch (equal to single images), timed_process
    (equal to the untimed output bit for bit: eager PyTorch has no partition
    boundaries to move a rounding) and the fused-sdev analysis."""
    cfg = MusicaConfig(image_size=256, storage="bfloat16")
    img = synthetic_radiograph(256, "thorax")
    single = musica.process(img, cfg, "cpu")
    np.testing.assert_array_equal(musica.process_batch(np.stack([img] * 3), cfg, "cpu"),
                                  np.stack([single] * 3))
    out, times = musica.timed_process(img, cfg, "cpu")
    np.testing.assert_array_equal(out, single)
    assert set(times) == {"norm", "red", "anly", "aply", "exp", "grad", "tot"}
    np.testing.assert_array_equal(musica.process(img, cfg, "cpu", fused_sdev=True), single)
    assert not np.array_equal(single, musica.process(img, cfg.with_(storage="float32"), "cpu"))


@pytest.mark.parametrize("flags", [["--bf16"], ["--bf16", "--debug-dump"],
                                   ["--bf16", "--timing", "--clahe", "--linear-gradation"]])
def test_cli_process_bf16(tmp_path, flags):
    """`cli process --bf16` alone and with the other flags: the BMP equals
    musica.process on the transposed raw in bf16; --debug-dump writes the
    JAX package's file names (bf16 bands upcast for the dump)."""
    size = 256
    img = synthetic_radiograph(size, "thorax")
    raw = tmp_path / "in.raw"
    uio.save_raw(raw, img)
    args = ["process", "--size", str(size), "--device", "cpu", *flags]
    dump = tmp_path / "dump_torch"
    if "--debug-dump" in flags:
        args.insert(args.index("--debug-dump") + 1, str(dump))
    assert cli.main(args + [str(raw), str(tmp_path / "torch.bmp")]) == 0
    cfg = MusicaConfig(image_size=size, storage="bfloat16", enable_clahe="--clahe" in flags,
                       grad_with_linear_image="--linear-gradation" in flags)
    want = musica.process(np.ascontiguousarray(img.T), cfg, "cpu")
    np.testing.assert_array_equal(uio.load_bmp(tmp_path / "torch.bmp"), want)
    if "--debug-dump" in flags:
        j_dump = tmp_path / "dump_jax"
        assert j_cli.main(["process", "--size", str(size), "--bf16", "--debug-dump", str(j_dump),
                           str(raw), str(tmp_path / "jax.bmp")]) == 0
        names = sorted(p.name for p in dump.iterdir())
        assert names == sorted(p.name for p in j_dump.iterdir())
        assert "red_bandpass_0.bmp" in names and "nr_bandpass_0.bmp" in names


def test_cli_batch_bf16(tmp_path):
    imgs = {a: synthetic_radiograph(128, a) for a in ("hand", "knee")}
    for a, im in imgs.items():
        uio.save_raw(tmp_path / f"{a}.raw", im)
    out = tmp_path / "out"
    assert cli.main(["batch", "--size", "128", "--device", "cpu", "--bf16", "--no-transpose",
                     str(tmp_path / "*.raw"), str(out)]) == 0
    cfg = MusicaConfig(image_size=128, storage="bfloat16")
    for a, im in imgs.items():
        np.testing.assert_array_equal(uio.load_bmp(out / f"{a}.bmp"),
                                      musica.process(im, cfg, "cpu"))


VARIANTS = {"clahe": dict(enable_clahe=True),
            "linear": dict(grad_with_linear_image=True),
            "clahe+linear": dict(enable_clahe=True, grad_with_linear_image=True)}


def assert_clahe_close(got, want, atol, what):
    """Equal NaN masks (tiles without relevant pixels), ``atol`` elsewhere."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("size,anatomy,border", [(256, "thorax", 100),
                                                 (144, "pelvis", 10)])
def test_variants_match_jax_and_golden(size, anatomy, border, variant):
    """CLAHE, linear gradation and both at 256 (the reference's 100-px
    relevance border) and at 144 with the config sweep's border of 10."""
    cfg = MusicaConfig(image_size=size, relevant_border=border, **VARIANTS[variant])
    img = synthetic_radiograph(size, anatomy)
    res = musica.musica_forward(torch.from_numpy(img), cfg, want_intermediates=True)
    jres = jax.jit(lambda im: j_musica.musica_forward(
        im, cfg, "fact", want_intermediates=True))(jnp.asarray(img))
    g_out, gi = golden.process(img, cfg, return_intermediates=True)

    assert set(res["intermediates"]) == set(jres["intermediates"])
    assert ("linear" in res["intermediates"]) == cfg.grad_with_linear_image
    assert ("clahe_graded" in res) == cfg.enable_clahe == ("clahe_graded" in jres)
    out = res["out_u8"].numpy()
    assert out.shape == (size - 20, size - 20) and out.dtype == np.uint8
    assert_u8_parity(out, np.asarray(jres["out_u8"]), "vs JAX")
    assert_u8_parity(out, g_out, "vs golden")
    tv = tuple(float(t) for t in res["intermediates"]["grad_curve"][2])
    assert tv == gi["grad_curve"][2]
    if cfg.grad_with_linear_image:
        recon = res["recon"]
        assert torch.equal(res["intermediates"]["linear"], recon * recon)
    if cfg.enable_clahe:
        cg = res["clahe_graded"].numpy()
        assert cg.shape == (size, size) and cg.dtype == np.float32
        assert_clahe_close(cg, gi["clahe_graded"], 1e-4, "clahe_graded vs golden")
        assert_clahe_close(cg, np.asarray(jres["clahe_graded"]), 1e-4,
                           "clahe_graded vs JAX")
    # the main path (no intermediates) gives the same outputs
    fast = musica.musica_forward(torch.from_numpy(img), cfg)
    assert torch.equal(fast["out_u8"], res["out_u8"])
    if cfg.enable_clahe:
        torch.testing.assert_close(fast["clahe_graded"], res["clahe_graded"],
                                   rtol=0, atol=0, equal_nan=True)


def test_clahe_with_linear_gradation_interaction():
    """As tests/test_clahe.py's interaction test: CLAHE grades the
    reconstruction, the gradation histograms and maps its square, and the
    two do not leak into each other.  A random relevance image gives every
    CLAHE tile relevant pixels."""
    cfg = MusicaConfig(image_size=256, enable_clahe=True, grad_with_linear_image=True,
                       relevant_border=10)
    x = torch.from_numpy(synthetic_radiograph(256, "knee"))
    res = musica.musica_forward(x, cfg, want_intermediates=True)
    recon, relevant = res["recon"], res["intermediates"]["relevant"]
    # (a) clahe_graded is clahe_grade(recon, relevant), not of recon^2
    expected = clahe.clahe_grade(recon, relevant, cfg)
    torch.testing.assert_close(res["clahe_graded"], expected, rtol=0, atol=0,
                               equal_nan=True)
    assert not torch.equal(res["clahe_graded"].nan_to_num(),
                           clahe.clahe_grade(recon * recon, relevant, cfg).nan_to_num())
    assert bool(torch.isfinite(res["clahe_graded"]).any())
    # (b) the tone-mapped output does not depend on CLAHE
    base = musica.musica_forward(x, cfg.with_(enable_clahe=False))
    assert torch.equal(res["out_u8"], base["out_u8"])
    assert "clahe_graded" not in base
    # (c) and it is the linear-domain gradation
    nonlin = musica.musica_forward(x, cfg.with_(enable_clahe=False,
                                                grad_with_linear_image=False))
    assert not torch.equal(res["out_u8"], nonlin["out_u8"])


def _sweep_cases():
    """tests/test_config_fuzz.py's 8 cases as given, and each once more with
    quirks=False (case 4 is clean-math already)."""
    cases = []
    for i, kw in enumerate(FUZZ_CASES):
        cases.append(pytest.param(kw, id=f"case{i}"))
        if kw.get("quirks", True):
            cases.append(pytest.param(dict(kw, quirks=False), id=f"case{i}-noquirks"))
    return cases


@pytest.mark.parametrize("kw", _sweep_cases())
def test_config_sweep_matches_golden(kw):
    """The port on the JAX package's config sweep, against golden at its
    thresholds (PSNR > 55 dB, > 98 % of u8 pixels equal, clahe_graded to
    1e-5 with equal NaN masks)."""
    cfg = MusicaConfig(**kw)
    img = synthetic_radiograph(cfg.image_size, "pelvis")
    res = musica.musica_forward(torch.from_numpy(img), cfg)
    g_out, gi = golden.process(img, cfg, return_intermediates=True)
    out = res["out_u8"].numpy()
    m = cfg.out_margin
    assert out.shape == g_out.shape == (cfg.image_size - 2 * m,) * 2
    assert _psnr(out, g_out) > 55.0, kw
    assert np.mean(out == g_out) > 0.98, kw
    if cfg.enable_clahe:
        assert_clahe_close(res["clahe_graded"].numpy(), gi["clahe_graded"], 1e-5,
                           "clahe_graded vs golden")


@pytest.mark.parametrize("variant", ["default", "clahe+linear"])
def test_timed_process_matches_forward(variant):
    cfg = MusicaConfig(image_size=128, **VARIANTS.get(variant, {}))
    img = synthetic_radiograph(128, "hand")
    out, times, extras = musica.timed_process(img, cfg, "cpu", want_extras=True)
    res = musica.musica_forward(torch.from_numpy(img), cfg)
    np.testing.assert_array_equal(out, res["out_u8"].numpy())
    assert list(times) == ["norm", "red", "anly", "aply", "exp", "grad", "tot"]
    assert all(v >= 0.0 for v in times.values())
    assert times["tot"] == pytest.approx(sum(v for k, v in times.items() if k != "tot"))
    if cfg.enable_clahe:
        np.testing.assert_array_equal(extras["clahe_graded"], res["clahe_graded"].numpy())
    else:
        assert extras == {}
    out2, times2 = musica.timed_process(img, cfg, "cpu")
    np.testing.assert_array_equal(out2, out)


@pytest.mark.parametrize("flags", [["--clahe", "--linear-gradation"],
                                   ["--clahe", "--linear-gradation", "--timing"]])
def test_cli_process_variants_match_jax_cli(tmp_path, flags, capsys):
    """`cli process --clahe --linear-gradation [--timing] --device cpu`
    against the JAX package's CLI with the same flags; --debug-dump carries
    the `linear` intermediate, as the JAX package's dump does."""
    raw = tmp_path / "in.raw"
    uio.save_raw(raw, synthetic_radiograph(192, "pelvis"))
    common = ["process", "--size", "192", *flags]
    assert j_cli.main(common + [str(raw), str(tmp_path / "jax.bmp")]) == 0
    assert cli.main(common + ["--device", "cpu", str(raw), str(tmp_path / "torch.bmp")]) == 0
    printed = capsys.readouterr().out
    assert ("norm:" in printed) == ("--timing" in flags)
    got = uio.load_bmp(tmp_path / "torch.bmp")
    assert got.shape == (172, 172)
    assert_u8_parity(got, uio.load_bmp(tmp_path / "jax.bmp"), "CLI vs JAX CLI")
    if "--timing" in flags:
        return
    j_dump, t_dump = tmp_path / "dump_jax", tmp_path / "dump_torch"
    assert j_cli.main(common + ["--debug-dump", str(j_dump), str(raw),
                                str(tmp_path / "jax_dbg.bmp")]) == 0
    assert cli.main(common + ["--device", "cpu", "--debug-dump", str(t_dump), str(raw),
                              str(tmp_path / "torch_dbg.bmp")]) == 0
    np.testing.assert_array_equal(uio.load_bmp(tmp_path / "torch_dbg.bmp"), got)
    names = sorted(p.name for p in t_dump.iterdir())
    assert names == sorted(p.name for p in j_dump.iterdir())
    assert "linear.bmp" in names


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
