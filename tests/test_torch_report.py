"""The PyTorch port's host surface beyond ``process`` against the JAX
package, on the CPU: the render helpers (``utils/render.py``,
``utils/debug.py``), the BMP reader and in-memory encoder (``utils/io.py``),
``StageTimer``, ``utils/report.py::write_report`` and the CLI's
``process --save-last-raw/--cnr-out/--profile`` and ``report``.

The renders and the BMP reader must give equal arrays.  The report's
``out.bmp`` is held to the parity bar (``assert_u8_parity``); its ``cnr.bmp``
must be equal except where ``cnr * 255`` lies within 0.02 of an integer,
since the port's CNR map is within 5e-5 of the JAX package's
(``tests/test_torch_pipeline.py``), and the truncation to u8 may round such
a pixel either way; the stats rows of ``index.html`` must be equal.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu import cli as j_cli
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig as JConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing import analysis as j_analysis
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import debug as j_debug
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import io as j_io
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import render as j_render
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import report as j_report
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import viewer as j_viewer
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig, cli
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import analysis
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
    synthetic_radiograph)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.utils import (
    debug, io, render, report)

from test_torch_pipeline import assert_u8_parity

torch.set_num_threads(2)

SIZE = 256
CNR_EDGE = 0.02  # |cnr * 255 - round(cnr * 255)| below which cnr.bmp may differ


def _hist(seed, n_bins):
    """Histograms with an empty, a sparse, a dense and a one-peak case."""
    rng = np.random.default_rng(seed)
    if seed == 0:
        return np.zeros(n_bins, np.int64)
    if seed == 1:
        h = np.zeros(n_bins, np.int64)
        h[rng.integers(0, n_bins, 5)] = rng.integers(1, 50, 5)
        return h
    if seed == 2:
        return rng.integers(0, 5000, n_bins).astype(np.int64)
    h = rng.integers(0, 10, n_bins).astype(np.int64)
    h[rng.integers(0, n_bins)] = 1 << 24  # the barHeight == H quirk
    return h


def _curve(seed):
    rng = np.random.default_rng(100 + seed)
    m = int(rng.integers(2, 23))
    px = np.sort(rng.uniform(0, 1, m)).astype(np.float32)
    px[0], px[-1] = 0.0, 1.0
    return px, np.sort(rng.uniform(0, 1, m)).astype(np.float32)


T_CASES = [(-1.0, -1.0, -1.0), (0.1, 0.5, 0.9), (-1.0, 128 / 512, -1.0),
           (200.5 / 512, 300 / 512, 0.999)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_histogram_renders_equal_jax(seed):
    for mine, ref, nb in ((render.render_noise_hist, j_render.render_noise_hist, 2048),
                          (render.render_img_histogram, j_render.render_img_histogram, 1024)):
        h = _hist(seed, nb)
        mb = int(h.argmax())
        np.testing.assert_array_equal(mine(h, int(h[mb]), mb), ref(h, int(h[mb]), mb))
    bg = np.random.default_rng(seed).integers(0, 256, (render.H, render.W, 4)).astype(np.uint8)
    h = _hist(seed, 1024)
    np.testing.assert_array_equal(render.render_img_histogram(h, 7, 3, background=bg),
                                  j_render.render_img_histogram(h, 7, 3, background=bg))
    np.testing.assert_array_equal(debug.render_histogram(h), j_debug.render_histogram(h))


@pytest.mark.parametrize("t", T_CASES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_curve_renders_equal_jax(seed, t):
    """The gradation renders with t0/ta/t1 inside and outside [0, 1] (-1:
    no marker), the contrast-curve render and the two quick panels."""
    px, py = _curve(seed)
    h = _hist(seed + 1, 1024)
    mb = int(h.argmax())
    np.testing.assert_array_equal(render.render_gradation_curve(px, py, *t),
                                  j_render.render_gradation_curve(px, py, *t))
    np.testing.assert_array_equal(
        render.render_gradation_curve_debug(h, int(h[mb]), mb, px, py, *t),
        j_render.render_gradation_curve_debug(h, int(h[mb]), mb, px, py, *t))
    np.testing.assert_array_equal(render.render_contrast_curve(px, 3 * py),
                                  j_render.render_contrast_curve(px, 3 * py))
    np.testing.assert_array_equal(debug.render_curve(px, 3 * py), j_debug.render_curve(px, 3 * py))
    np.testing.assert_array_equal(debug.render_histogram(h, curve=(px, py), markers=t),
                                  j_debug.render_histogram(h, curve=(px, py), markers=t))
    assert render.YELLOW == j_render.YELLOW


@pytest.mark.parametrize("shape", [(37, 53), (128, 512), (1, 3)])
def test_bmp_readers_and_encoder(tmp_path, shape):
    """``load_bmp_rgb`` reads what both packages' writers and Pillow (the
    JAX viewer's encoder) wrote as the JAX package's reader does;
    ``bmp_bytes`` decodes to its input (gray, rgb, rgba)."""
    rng = np.random.default_rng(sum(shape))
    u8 = rng.integers(0, 256, shape).astype(np.uint8)
    rgb = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    rgba = rng.integers(0, 256, shape + (4,)).astype(np.uint8)
    files = []
    for pkg_io, tag in ((io, "mine"), (j_io, "ref")):
        pkg_io.save_bmp8(tmp_path / f"{tag}_g.bmp", u8)
        pkg_io.save_bmp_rgb(tmp_path / f"{tag}_c.bmp", rgb)
        files += [tmp_path / f"{tag}_g.bmp", tmp_path / f"{tag}_c.bmp"]
    for i, img in enumerate((u8, rgb, rgba)):
        (tmp_path / f"pil_{i}.bmp").write_bytes(j_viewer._bmp_bytes(img))
        (tmp_path / f"enc_{i}.bmp").write_bytes(io.bmp_bytes(img))
        files.append(tmp_path / f"pil_{i}.bmp")
        want = np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img[..., :3]
        np.testing.assert_array_equal(io.load_bmp_rgb(tmp_path / f"enc_{i}.bmp"), want)
        np.testing.assert_array_equal(io.load_bmp_rgb(tmp_path / f"pil_{i}.bmp"), want)
    for f in files:
        got = io.load_bmp_rgb(f)
        assert got.dtype == np.uint8 and got.shape == shape + (3,), f
        np.testing.assert_array_equal(got, j_io.load_bmp_rgb(f))
        np.testing.assert_array_equal(io.load_bmp(f), j_io.load_bmp(f))
    assert io.bmp_bytes(u8) == (tmp_path / "mine_g.bmp").read_bytes()
    assert io.bmp_bytes(rgb) == (tmp_path / "mine_c.bmp").read_bytes()


def test_stage_timer_marks_cpu_tensors():
    t = debug.StageTimer()
    x = torch.ones(4)
    t.mark("a", x, x + 1, np.zeros(2))
    t.mark("b")
    assert list(t.stages) == ["a", "b"] and all(v >= 0 for v in t.stages.values())
    s = t.summary()
    assert s.startswith("a: ") and "b: " in s and s.endswith("(ms)") and "tot" in s


def _stats_rows(index):
    return re.findall(r"<tr><td>(.*?)</td><td>(.*?)</td></tr>", index.read_text())


def _cnr_near_integer(img_u16):
    """Pixels of the port's CNR map whose cnr * 255 lies within CNR_EDGE of
    an integer in [0, 255] (the u8 truncation may go either way there;
    beyond 255 + CNR_EDGE both clip to 255)."""
    cnr = musica.musica_forward(torch.from_numpy(img_u16), MusicaConfig(image_size=SIZE))["cnr"]
    v = cnr.numpy().astype(np.float64) * 255.0
    return (np.abs(v - np.round(v)) < CNR_EDGE) & (v > -CNR_EDGE) & (v < 255.0 + CNR_EDGE)


def _check_report(mine, ref, img_u16):
    """The two report directories: same files, out.bmp within the parity
    bar, cnr.bmp equal off the near-integer pixels, stats rows equal.
    Returns the number of near-integer pixels."""
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(mine)) == names
    assert_u8_parity(io.load_bmp(mine / "out.bmp"), j_io.load_bmp(ref / "out.bmp"), "out.bmp")
    edge = _cnr_near_integer(img_u16)
    a, b = io.load_bmp(mine / "cnr.bmp"), j_io.load_bmp(ref / "cnr.bmp")
    assert a.shape == b.shape == edge.shape
    np.testing.assert_array_equal(a[~edge], b[~edge])
    assert _stats_rows(mine / "index.html") == _stats_rows(ref / "index.html")
    assert len(_stats_rows(ref / "index.html")) == 8
    html_mine = (mine / "index.html").read_text()
    for n in ("out.bmp", "grad_hist.bmp", "red_bandpass_3.bmp", "nr_bandpass_2.bmp"):
        assert n in html_mine
    return int(edge.sum())


def test_write_report_equals_jax(tmp_path):
    """write_report at 256 against the JAX package's.  On this phantom no
    pixel of the 32x32 CNR map lies within 0.02 of a step (1,002 of the
    1,024 are >= 1 and clip to 255; the hand of the CLI tests: 0 and
    1,018), so cnr.bmp is compared at every pixel."""
    img = synthetic_radiograph(SIZE, "knee")
    index = report.write_report(img, str(tmp_path / "mine"), MusicaConfig(image_size=SIZE),
                                title="knee", device="cpu")
    assert index == tmp_path / "mine" / "index.html"
    j_report.write_report(img, str(tmp_path / "ref"), JConfig(image_size=SIZE), title="knee")
    assert _check_report(tmp_path / "mine", tmp_path / "ref", img) == 0


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs' ``process`` with ``--save-last-raw --cnr-out`` on one
    raw (the port's also with ``--profile``), the port's plain ``process``,
    and both CLIs' ``report``."""
    d = tmp_path_factory.mktemp("cli")
    img = synthetic_radiograph(SIZE, "hand")
    j_io.save_raw(d / "in.raw", img)
    for tag in ("mine", "ref"):
        (d / tag / "cnr").mkdir(parents=True)
    common = ["--size", str(SIZE)]
    assert cli.main(["process", *common, "--device", "cpu", "--save-last-raw", str(d / "mine/last.raw"),
                     "--cnr-out", str(d / "mine/cnr/case.bmp"), "--profile", str(d / "mine/prof"),
                     str(d / "in.raw"), str(d / "mine/out.bmp")]) == 0
    assert cli.main(["process", *common, "--device", "cpu", str(d / "in.raw"),
                     str(d / "mine/plain.bmp")]) == 0
    assert j_cli.main(["process", *common, "--save-last-raw", str(d / "ref/last.raw"),
                       "--cnr-out", str(d / "ref/cnr/case.bmp"), str(d / "in.raw"),
                       str(d / "ref/out.bmp")]) == 0
    assert cli.main(["report", *common, "--device", "cpu", str(d / "in.raw"),
                     str(d / "mine/rep")]) == 0
    assert j_cli.main(["report", *common, str(d / "in.raw"), str(d / "ref/rep")]) == 0
    return d, img


def test_cli_save_last_raw_equals_jax(cli_runs):
    d, img = cli_runs
    assert (d / "mine/last.raw").read_bytes() == (d / "ref/last.raw").read_bytes()
    np.testing.assert_array_equal(io.load_raw(d / "mine/last.raw", SIZE, transpose=False), img.T)
    assert_u8_parity(io.load_bmp(d / "mine/out.bmp"), j_io.load_bmp(d / "ref/out.bmp"), "process")


def test_cli_cnr_out_feeds_mean_cnr(cli_runs):
    """``--cnr-out`` as the JAX package's test drives it
    (tests/test_debug.py::test_cli_cnr_out_feeds_mean_cnr), and against the
    JAX CLI's map: equal off the near-integer pixels, mean CNR within a
    u8 step's share of them."""
    d, img = cli_runs
    res = analysis.mean_cnr_dir(str(d / "mine/cnr"))
    ref = j_analysis.mean_cnr_dir(str(d / "ref/cnr"))
    assert [n for n, _ in res] == [n for n, _ in ref] == ["case.bmp"]
    assert 0.0 <= res[0][1] <= 256.0
    edge = _cnr_near_integer(np.ascontiguousarray(img.T))
    a, b = io.load_bmp(d / "mine/cnr/case.bmp"), j_io.load_bmp(d / "ref/cnr/case.bmp")
    np.testing.assert_array_equal(a[~edge], b[~edge])
    assert abs(res[0][1] - ref[0][1]) <= edge.mean() * 256.0 / 2 ** 8 + 1e-9
    # with --timing the CNR map takes a run of its own: the same file
    assert cli.main(["process", "--size", str(SIZE), "--device", "cpu", "--timing",
                     "--cnr-out", str(d / "timed_cnr.bmp"), str(d / "in.raw"),
                     str(d / "timed.bmp")]) == 0
    assert (d / "timed_cnr.bmp").read_bytes() == (d / "mine/cnr/case.bmp").read_bytes()
    assert (d / "timed.bmp").read_bytes() == (d / "mine/plain.bmp").read_bytes()


def test_cli_profile_trace(cli_runs):
    """``--profile`` writes a Chrome trace holding the musica.<phase> spans
    and leaves the BMP as it is without the flag."""
    d, _ = cli_runs
    trace = json.loads((d / "mine/prof/trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    for phase in ("normalize", "reduce", "analysis", "apply", "expand", "gradation", "tonemap"):
        assert f"musica.{phase}" in names, phase
    assert (d / "mine/out.bmp").read_bytes() == (d / "mine/plain.bmp").read_bytes()


def test_cli_report_equals_jax_cli(cli_runs):
    d, img = cli_runs
    _check_report(d / "mine/rep", d / "ref/rep", np.ascontiguousarray(img.T))
    assert (d / "mine/rep/out.bmp").read_bytes() == (d / "mine/plain.bmp").read_bytes()
