"""The PyTorch port's own copies of the JAX package's NumPy modules against
the originals: ``config.MusicaConfig``, ``testing.phantoms``, ``utils.io``
and the debug dump (``utils.debug`` with ``utils.render``).  The port
imports none of the originals; these tests hold the copies equal to them."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu import config as j_config
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing import phantoms as j_phantoms
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import debug as j_debug
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import io as j_io
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import config
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import phantoms
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.utils import debug, io

torch.set_num_threads(2)

DERIVED = ("pyramid_levels", "level_sizes", "contrast_factors", "noise_reduction_params",
           "analysis_levels", "hist_coverage")


@pytest.mark.parametrize("quirks", [True, False], ids=["quirks", "clean"])
@pytest.mark.parametrize("size", [144, 256, 512, 600, 3072])
def test_config_equals_jax_config(size, quirks):
    """Field by field, in every derived schedule and in the module-level
    helpers, at the suite's sizes; ``with_`` stays inside each package."""
    mine = config.MusicaConfig(image_size=size, quirks=quirks)
    ref = j_config.MusicaConfig(image_size=size, quirks=quirks)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for prop in DERIVED:
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert config.pyramid_level_sizes(size) == j_config.pyramid_level_sizes(size)
    assert config.num_pyramid_levels(size) == j_config.num_pyramid_levels(size)
    var = mine.with_(enable_clahe=True, storage="bfloat16")
    assert type(var) is config.MusicaConfig
    assert dataclasses.asdict(var) == dataclasses.asdict(
        ref.with_(enable_clahe=True, storage="bfloat16"))
    assert config.DEFAULT_CONFIG == config.MusicaConfig()


@pytest.mark.parametrize("kw", [dict(image_size=2), dict(cnr_level=0),
                                dict(storage="float16")])
def test_config_refuses_what_jax_config_refuses(kw):
    for cls in (config.MusicaConfig, j_config.MusicaConfig):
        with pytest.raises(AssertionError):
            cls(**kw)


@pytest.mark.parametrize("seed", [None, 7])
@pytest.mark.parametrize("anatomy", j_phantoms.ANATOMIES)
@pytest.mark.parametrize("size", [128, 600])
def test_phantoms_equal_jax_phantoms(size, anatomy, seed):
    assert phantoms.ANATOMIES == j_phantoms.ANATOMIES
    a = phantoms.synthetic_radiograph(size, anatomy, seed=seed)
    b = j_phantoms.synthetic_radiograph(size, anatomy, seed=seed)
    assert a.dtype == b.dtype == np.uint16
    np.testing.assert_array_equal(a, b)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("shape", [(37, 53), (64, 64), (1, 3)])
def test_writers_write_identical_bytes(tmp_path, shape):
    """``save_bmp8`` (the JAX package's may take its C++ codec),
    ``save_bmp_rgb`` and ``save_raw`` (transposed and not) give the same
    files as the JAX package's."""
    rng = np.random.default_rng(sum(shape))
    u8 = rng.integers(0, 256, shape).astype(np.uint8)
    rgb = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    u16 = rng.integers(0, 65536, shape).astype(np.uint16)
    for name, mine, ref, arg in [("g.bmp", io.save_bmp8, j_io.save_bmp8, (u8,)),
                                 ("c.bmp", io.save_bmp_rgb, j_io.save_bmp_rgb, (rgb,)),
                                 ("r.raw", io.save_raw, j_io.save_raw, (u16,)),
                                 ("t.raw", io.save_raw, j_io.save_raw, (u16, True))]:
        mine(tmp_path / "mine" / name, *arg)
        ref(tmp_path / "ref" / name, *arg)
        assert _bytes(tmp_path / "mine" / name) == _bytes(tmp_path / "ref" / name), name
    np.testing.assert_array_equal(io.load_bmp(tmp_path / "mine" / "g.bmp"),
                                  j_io.load_bmp(tmp_path / "ref" / "g.bmp"))


@pytest.mark.parametrize("transpose", [True, False])
def test_raw_readers_read_equal_arrays(tmp_path, transpose):
    img = np.random.default_rng(3).integers(0, 65536, (96, 96)).astype(np.uint16)
    img[0, 1] = 7  # not symmetric
    j_io.save_raw(tmp_path / "a.raw", img)
    got = io.load_raw(tmp_path / "a.raw", 96, transpose=transpose)
    np.testing.assert_array_equal(got, j_io.load_raw(tmp_path / "a.raw", 96, transpose=transpose))
    np.testing.assert_array_equal(got, img.T if transpose else img)
    np.testing.assert_array_equal(
        io.load_raw_batch([tmp_path / "a.raw"] * 2, 96, transpose),
        j_io.load_raw_batch([tmp_path / "a.raw"] * 2, 96, transpose))
    with pytest.raises(ValueError):
        io.load_raw(tmp_path / "a.raw", 97)


def test_dump_intermediates_equals_jax_dump(tmp_path):
    """On a 256 run of the port, the port's dump and the JAX package's write
    the same file set with identical bytes."""
    cfg = config.MusicaConfig(image_size=256)
    img = phantoms.synthetic_radiograph(256, "thorax")
    res = musica.musica_forward(torch.from_numpy(img), cfg, want_intermediates=True)
    inter = {k: debug.numpy_tree(v) for k, v in res["intermediates"].items()}
    debug.dump_intermediates(inter, str(tmp_path / "mine"))
    j_debug.dump_intermediates(inter, str(tmp_path / "ref"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "mine")) == names
    assert {"noise_hist.bmp", "grad_hist.bmp", "normalized.bmp"} <= set(names)
    assert any(n.startswith("contrast_curve_") for n in names)
    for n in names:
        assert _bytes(tmp_path / "mine" / n) == _bytes(tmp_path / "ref" / n), n
