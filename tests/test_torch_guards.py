"""Guards on the PyTorch port's boundaries: it imports neither JAX nor the
JAX package, builds nothing at import, and its configuration and static
tables equal the JAX package's."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu import config as j_config
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import pyramid as j_pyramid
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import curves, pyramid

torch.set_num_threads(2)

PKG = "metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch"
JAX_PKG = PKG[:-len("_torch")]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    root = pathlib.Path(REPO) / PKG
    return sorted(".".join((PKG,) + p.relative_to(root).with_suffix("").parts)
                  .removesuffix(".__init__") for p in root.rglob("*.py"))


def test_port_imports_no_jax(tmp_path):
    """With the JAX package and Pillow blocked in ``sys.modules``, every
    module of the port imports and ``cli process --device cpu`` runs on a
    raw written here; neither JAX nor the JAX package is loaded, nothing is
    built."""
    raw, bmp = tmp_path / "in.raw", tmp_path / "out.bmp"
    img = np.random.default_rng(5).integers(0, 60000, (256, 256)).astype("<u2")
    raw.write_bytes(b"\x00" * 256 + img.tobytes())
    code = (
        "import importlib, sys\n"
        f"sys.modules[{JAX_PKG!r}] = None\n"
        "sys.modules['PIL'] = None\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"from {PKG} import cli\n"
        f"from {PKG}.ops.cuda import build\n"
        "assert build._LIB is None\n"
        f"assert cli.main(['process', '--device', 'cpu', '--size', '256', "
        f"{str(raw)!r}, {str(bmp)!r}]) == 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        f"assert sys.modules[{JAX_PKG!r}] is None\n"
        "assert build._LIB is None\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr
    assert bmp.stat().st_size == 54 + 236 * 236 * 3  # margin-10 crop, 24-bit rows


def _imported_names(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("where", [PKG, "chip_smoke.py", "scripts/profile_torch.py",
                                   "scripts/bench_torch.py", "scripts/probe_contrast.py",
                                   "scripts/probe_clahe_hist.py"])
def test_no_file_imports_the_jax_package(where):
    """No file of the port, nor the port's scripts, imports JAX, the JAX
    package or Pillow (``import`` and ``from ... import`` statements, at
    any depth): the machines with the card have neither JAX nor Pillow."""
    base = pathlib.Path(REPO) / where
    files = sorted(base.rglob("*.py")) if base.is_dir() else [base]
    assert files
    for f in files:
        for name in _imported_names(f):
            top = name.split(".")[0]
            assert top not in (JAX_PKG, "jax", "jaxlib", "musica_tpu", "PIL"), (f, name)


def test_config_equals_the_jax_packages():
    """The port's own ``MusicaConfig`` has the JAX package's fields, in the
    same order, with the same defaults (the derived properties are compared
    in tests/test_torch_standalone.py)."""
    assert MusicaConfig is not j_config.MusicaConfig
    mine = [(f.name, f.default) for f in dataclasses.fields(MusicaConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(j_config.MusicaConfig)]
    assert mine == theirs
    assert MusicaConfig.__dataclass_params__.frozen
    assert MusicaConfig() == MusicaConfig() and hash(MusicaConfig()) == hash(MusicaConfig())


def test_smooth_weights_equal_jax():
    np.testing.assert_array_equal(pyramid.smooth_weights(), j_pyramid.smooth_weights())
    assert [np.float32(w) for w in pyramid._W] == list(j_pyramid.smooth_weights())


@pytest.mark.parametrize("size", [512, 600, 3072])
def test_per_level_schedules_equal_jax(size):
    """The port's config gives the JAX package's per-level schedules; the
    flat contrast curves it builds carry exactly the high-contrast factors."""
    cfg = MusicaConfig(image_size=size)
    ref = j_config.MusicaConfig(image_size=size)
    assert cfg.contrast_factors == ref.contrast_factors
    assert cfg.noise_reduction_params == ref.noise_reduction_params
    assert cfg.analysis_levels == ref.analysis_levels == (0, 1, 2, 3)
    assert cfg.level_sizes == ref.level_sizes
    for lcf, hcf in cfg.contrast_factors:
        if lcf == 1.0:
            px, py = curves.contrast_curve(torch.tensor(0, dtype=torch.int32), lcf, hcf, cfg)
            assert px.tolist() == [0.0, 1.0]
            assert py.tolist() == [float(np.float32(hcf))] * 2
