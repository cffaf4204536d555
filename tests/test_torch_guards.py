"""Guards on the PyTorch port's boundaries: it imports no JAX, builds nothing
at import, and shares the JAX package's configuration and static tables."""

import os
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
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        f"import {PKG}, {PKG}.models.musica, {PKG}.cli, {PKG}.ops.cuda.fused_hist\n"
        f"import {PKG}.ops.clahe, {PKG}.ops.cuda.histogram, {PKG}.ops.cuda.clahe_apply\n"
        f"import {PKG}.ops.stats, {PKG}.ops.cuda.launch\n"
        f"from {PKG}.ops.cuda import build\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert build._LIB is None\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_config_is_the_jax_packages():
    assert MusicaConfig is j_config.MusicaConfig


def test_smooth_weights_equal_jax():
    np.testing.assert_array_equal(pyramid.smooth_weights(), j_pyramid.smooth_weights())
    assert [np.float32(w) for w in pyramid._W] == list(j_pyramid.smooth_weights())


@pytest.mark.parametrize("size", [512, 600, 3072])
def test_per_level_schedules_equal_jax(size):
    """The port reads the per-level schedules from the shared config; the
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
