"""The PyTorch port's metamorphic-testing campaign against the JAX
package's, on the CPU: with one runner for both (the metrics alone
differ), with each package's own runner (the pipelines differ too), the
CLI's ``campaign`` -> ``slope-analysis`` loop and ``mean-cnr``, and the
campaign with the JAX package, JAX and Pillow blocked."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing import analysis as j_analysis
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing import campaign as j_campaign
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import cli
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import analysis, campaign
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.utils import io

torch.set_num_threads(2)

PKG = "metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch"
JAX_PKG = PKG[:-len("_torch")]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSVS = (campaign.R_CSV, campaign.NR_CSV, campaign.S_CSV)
# the CSV values of the port's own campaign against the JAX package's own,
# at 512 knee, seed 3 (both on the CPU): the pipelines' u8 outputs differ at
# up to 13 of 240,100 pixels of a case (within the parity bar); the largest
# difference of a CSV value measured there is 4.3e-6
OWN_RUNNER_ATOL = 1e-3


def _values(rows, csv_name):
    first = 1 if csv_name == campaign.S_CSV else 2
    return [r[:first] for r in rows[1:]], np.array([[float(v) for v in r[first:]]
                                                   for r in rows[1:]])


def _max_diff(a, b):
    """(max |a - b| over every CSV's values, after checking the row names)"""
    worst = 0.0
    for name in CSVS:
        names_a, va = _values(a[name], name)
        names_b, vb = _values(b[name], name)
        assert names_a == names_b, name
        assert va.shape == vb.shape and np.isfinite(va).all(), name
        worst = max(worst, float(np.abs(va - vb).max()))
    return worst


@pytest.fixture(scope="module")
def jax_runner():
    return j_campaign.default_runner(256)


@pytest.fixture(scope="module")
def jax_own(tmp_path_factory, jax_runner):
    out = tmp_path_factory.mktemp("jax_own")
    return out, j_campaign.run_campaign(out_dir=str(out), image_size=256, anatomies=["knee"],
                                        seed=3, runner=jax_runner, save_images=True)


def test_port_campaign_with_jax_runner_matches_jax_campaign(tmp_path, jax_runner, jax_own):
    """One runner for both: the same rows, every value within 2e-5 (the
    port's float32 metrics against the JAX package's float64 oracles on
    the CPU), and with ``save_images`` byte-equal altered raws and BMPs."""
    out_j, res_j = jax_own
    res = campaign.run_campaign(out_dir=str(tmp_path), image_size=256, anatomies=["knee"],
                                seed=3, runner=jax_runner, save_images=True, device="cpu")
    assert _max_diff(res, res_j) <= 2e-5
    names = sorted(p.name for p in out_j.iterdir() if p.suffix in (".raw", ".bmp"))
    assert len(names) == 61 and sorted(
        p.name for p in tmp_path.iterdir() if p.suffix in (".raw", ".bmp")) == names
    for n in names:
        assert (tmp_path / n).read_bytes() == (out_j / n).read_bytes(), n


def test_port_campaign_with_own_runner_matches_jax_campaign(tmp_path):
    """Each package's own runner (the port's ``process`` on the CPU) at 512,
    where the parity bar's 90 dB allows the dozen pixels by which the eager
    port and the JAX package's jit differ (at 256 one case differs at 5 of
    55,696 pixels, 88.6 dB): every case's u8 output meets the bar against
    the JAX package's, the CSV values agree within 1e-3 and the slope flags
    are equal."""
    out_j = tmp_path / "jax"
    res_j = j_campaign.run_campaign(out_dir=str(out_j), image_size=512, anatomies=["knee"],
                                    seed=3, save_images=True)
    res = campaign.run_campaign(out_dir=str(tmp_path), image_size=512, anatomies=["knee"],
                                seed=3, save_images=True, device="cpu")
    bmps = sorted(p.name for p in out_j.iterdir() if p.suffix == ".bmp")
    assert len(bmps) == 31
    for n in bmps:
        a, b = io.load_bmp(tmp_path / n).astype(np.int64), io.load_bmp(out_j / n).astype(np.int64)
        d = np.abs(a - b)
        mse = float(np.mean(d.astype(np.float64) ** 2))
        assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) >= 90.0, n
        assert np.mean(d == 0) > 0.9999 and d.max() <= 1, n
    diff = _max_diff(res, res_j)
    print(f"max |port - JAX package| over the CSV values: {diff}")
    assert diff <= OWN_RUNNER_ATOL
    mine = analysis.slope_analysis(res["deltas.csv"])
    theirs = j_analysis.slope_analysis(res_j["deltas.csv"])
    assert len(mine) == 54 and [m[3] for m in mine] == [t[3] for t in theirs]


def test_cli_campaign_then_slope_analysis_and_mean_cnr(tmp_path, capsys):
    """``campaign`` writes the CSVs and ``deltas.csv``; ``slope-analysis``
    prints 54 lines (6 families x 9 metrics), the JAX package's text for
    the same file; ``mean-cnr`` prints the mean CNR of each BMP."""
    out = tmp_path / "mt"
    assert cli.main(["campaign", "--device", "cpu", "--size", "256", "--anatomies", "foot",
                     "--seed", "7", "--out-dir", str(out)]) == 0
    for name in CSVS + ("deltas.csv",):
        assert (out / name).exists(), name
    capsys.readouterr()
    assert cli.main(["slope-analysis", str(out / "deltas.csv"), "--out",
                     str(tmp_path / "slopes.txt")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 54 and any("slope test=True" in ln for ln in lines)
    assert lines == j_analysis.slope_analysis_file(str(out / "deltas.csv"))
    rng = np.random.default_rng(2)
    for i in range(2):
        io.save_bmp8(tmp_path / "cnr" / f"{i}.bmp", rng.integers(0, 256, (30, 30)).astype(np.uint8))
    assert cli.main(["mean-cnr", str(tmp_path / "cnr")]) == 0
    want = j_analysis.mean_cnr_dir(str(tmp_path / "cnr"))
    assert capsys.readouterr().out.splitlines() == [f"{n} \t {v}" for n, v in want]


def test_campaign_input_dir_and_dicom_reference(tmp_path, monkeypatch):
    """Raws from ``<input_dir>/<anatomy>/image.raw`` with a vendor DICOM
    reference (pydicom stubbed): the reference row measures against it,
    and the normalized columns divide by that row; without pydicom the
    reference is the unaltered output."""
    import types
    size, anat = 256, "hand"
    d = tmp_path / "in" / anat
    raw = np.random.default_rng(1).integers(1000, 60000, (size, size)).astype(np.uint16)
    io.save_raw(d / "image.raw", raw)
    ref16 = np.random.default_rng(2).integers(0, 65536, (size, size)).astype(np.uint16)
    (d / "proc").write_bytes(ref16.tobytes())
    stub = types.ModuleType("pydicom")
    stub.dcmread = lambda p: types.SimpleNamespace(
        pixel_array=np.frombuffer(open(p, "rb").read(), np.uint16).reshape(size, size))
    monkeypatch.setitem(sys.modules, "pydicom", stub)
    res = campaign.run_campaign(out_dir=str(tmp_path / "out"), image_size=size,
                                anatomies=[anat], input_dir=str(tmp_path / "in"), device="cpu")
    row = res[campaign.S_CSV][1]
    assert row[0] == anat and float(row[1]) < 0.999 and float(row[2]) < 0.999
    r = res[campaign.R_CSV][1]
    np.testing.assert_allclose(float(r[8]), float(r[5]) / float(row[1]), rtol=1e-9)
    np.testing.assert_array_equal(campaign.dicom_to_reference(ref16),
                                  j_campaign.dicom_to_reference(ref16))
    monkeypatch.setitem(sys.modules, "pydicom", None)
    assert campaign.load_reference_image(str(d / "proc"), size) is None


def _cropping_runner(raw):
    """A stand-in system under test: the raw's high byte, transposed and
    margin-cropped as the pipeline's output is."""
    return np.ascontiguousarray((raw.T >> 8).astype(np.uint8)[10:-10, 10:-10])


def test_advance_rng_lets_a_campaign_start_at_its_last_anatomy(tmp_path):
    """``advance_rng`` draws what the campaign draws for the anatomies
    before thorax: a thorax-only campaign given that generator writes the
    whole campaign's thorax rows."""
    whole = campaign.run_campaign(out_dir=str(tmp_path / "all"), image_size=256, seed=4,
                                  runner=_cropping_runner, device="cpu")
    rng = campaign.advance_rng(np.random.default_rng(4), 256, campaign.ANATOMIES[:-1])
    last = campaign.run_campaign(out_dir=str(tmp_path / "thorax"), image_size=256,
                                 anatomies=["thorax"], runner=_cropping_runner, device="cpu",
                                 rng=rng)
    for name in CSVS:
        rows = [r for r in whole[name][1:] if r[0] == "thorax"]
        assert len(rows) == {campaign.S_CSV: 1, campaign.R_CSV: 30, campaign.NR_CSV: 20}[name]
        assert last[name][1:] == rows, name


def test_transposed_raw_reaches_the_kernels_contiguous():
    """The default runner passes the raw transposed (a strided view); every
    image of the forward pass is contiguous all the same, as the kernels on
    the card require."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        synthetic_radiograph)
    raw = synthetic_radiograph(256, "knee")
    x = torch.from_numpy(raw).T
    assert not x.is_contiguous()
    res = musica.musica_forward(x, MusicaConfig(image_size=256), want_intermediates=True)
    images = {k: v for k, v in res["intermediates"].items()
              if isinstance(v, torch.Tensor) and v.ndim == 2}
    assert "normalized" in images and all(v.is_contiguous() for v in images.values()), \
        [k for k, v in images.items() if not v.is_contiguous()]
    assert torch.equal(res["out_u8"],
                       musica.musica_forward(x.contiguous(), MusicaConfig(image_size=256))["out_u8"])


def test_campaign_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        campaign.run_campaign(out_dir=str(tmp_path), image_size=256, anatomies=["knee"],
                              device="cuda")


def test_campaign_runs_with_jax_and_pillow_blocked(tmp_path):
    """With the JAX package, JAX and Pillow blocked in ``sys.modules``, the
    port's campaign, ``slope-analysis`` and ``mean-cnr`` run on the CPU, and
    none of the three is loaded."""
    code = (
        "import sys\n"
        f"for m in ({JAX_PKG!r}, 'jax', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        f"from {PKG} import cli\n"
        f"out = {str(tmp_path / 'mt')!r}\n"
        "assert cli.main(['campaign', '--device', 'cpu', '--size', '256', '--anatomies',\n"
        "                 'thorax', '--out-dir', out]) == 0\n"
        "assert cli.main(['slope-analysis', out + '/deltas.csv']) == 0\n"
        f"assert cli.main(['process', '--device', 'cpu', '--size', '256', '--no-transpose',\n"
        f"                 {str(tmp_path / 'in.raw')!r}, {str(tmp_path / 'cnr' / 'a.bmp')!r}]) == 0\n"
        f"assert cli.main(['mean-cnr', {str(tmp_path / 'cnr')!r}]) == 0\n"
        f"for m in ({JAX_PKG!r}, 'jax', 'PIL'):\n"
        "    assert sys.modules[m] is None, m\n"
        "assert not any(k.startswith(('jax.', 'PIL.')) for k in sys.modules)\n"
        "print('ok')\n")
    io.save_raw(tmp_path / "in.raw", np.random.default_rng(3).integers(0, 60000, (256, 256)))
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]
    assert len(r.stdout.splitlines()) >= 54
    assert (tmp_path / "mt" / "deltas.csv").exists()


def _imported_names(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("where", [PKG, "chip_smoke.py"])
def test_no_file_imports_pillow(where):
    """The machines with the card have no Pillow: no file of the port, nor
    chip_smoke.py, imports it (at any depth)."""
    base = pathlib.Path(REPO) / where
    files = sorted(base.rglob("*.py")) if base.is_dir() else [base]
    for f in files:
        for name in _imported_names(f):
            assert name.split(".")[0] != "PIL", (f, name)
