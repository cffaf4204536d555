"""The PyTorch port at histogram tiles other than the shaders' 16 px and at
8x8 CLAHE tiles, on the CPU, against the JAX package's ``musica_forward``
(hist_method="fact") and the golden model.

Since the CUDA kernels take every histogram tile and opt into more than 48
KB of shared memory, these configurations run on the card too
(tests/test_torch_cuda.py holds the card to the CPU path there); this file
holds the CPU path to the references.  The bar is docs/PARITY.md's: noise
argmax bins, the gradation histogram and t0/ta/t1 exactly equal; u8 output
at >= 90 dB PSNR, > 99.99 % bit-exact, max |du8| <= 1; clahe_graded within
1e-4 with equal NaN masks (tests/test_clahe.py's bound).

In quirks mode below 512 px the noise histograms cover nothing, so the tile
cases run in the clean-math mode (``--no-quirks``), which covers every
level; tile 12 also runs in quirks mode, where only the gradation
histogram sees the tile.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica as j_musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import synthetic_radiograph
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica

from test_torch_pipeline import assert_clahe_close, assert_u8_parity

torch.set_num_threads(2)


def _run_all(cfg, anatomy):
    img = synthetic_radiograph(cfg.image_size, anatomy)
    res = musica.musica_forward(torch.from_numpy(img), cfg, want_intermediates=True)
    jres = jax.jit(lambda im: j_musica.musica_forward(
        im, cfg, "fact", want_intermediates=True))(jnp.asarray(img))
    g_out, gi = golden.process(img, cfg, return_intermediates=True)
    return img, res, jres, g_out, gi


@pytest.mark.parametrize("tile,quirks", [(8, False), (12, False), (32, False), (12, True)])
def test_main_path_at_other_histogram_tiles(tile, quirks):
    cfg = MusicaConfig(image_size=256, quirks=quirks, histogram_area_size=tile)
    img, res, jres, g_out, gi = _run_all(cfg, "thorax")
    ti, ji = res["intermediates"], jres["intermediates"]
    for i in cfg.analysis_levels:
        mb = int(ti[f"noise_max_bin_{i}"])
        assert mb == int(ji[f"noise_max_bin_{i}"]) == gi["noise_max_bins"][i], f"level {i}"
    np.testing.assert_array_equal(ti["grad_hist"].numpy(), np.asarray(ji["grad_hist"]))
    tv = tuple(float(t) for t in ti["grad_curve"][2])
    assert tv == tuple(float(t) for t in ji["grad_curve"][2]) == gi["grad_curve"][2]
    out = res["out_u8"].numpy()
    assert_u8_parity(out, np.asarray(jres["out_u8"]), "vs JAX")
    assert_u8_parity(out, g_out, "vs golden")
    # the fused-sdev analysis and the main path without intermediates agree
    x = torch.from_numpy(img)
    assert torch.equal(musica.musica_forward(x, cfg)["out_u8"], res["out_u8"])
    assert torch.equal(musica.musica_forward(x, cfg, fused_sdev=True)["out_u8"], res["out_u8"])


def test_clahe_linear_at_8x8_clahe_tiles():
    """CLAHE + linear gradation with 8x8 CLAHE tiles (16,384 joint bins, 8x8
    LUTs): at 256 px about one tile in eight has relevant pixels, the others
    have NaN LUTs."""
    cfg = MusicaConfig(image_size=256, enable_clahe=True, grad_with_linear_image=True,
                       clahe_tiles=8, relevant_border=10)
    img, res, jres, g_out, gi = _run_all(cfg, "knee")
    out = res["out_u8"].numpy()
    assert_u8_parity(out, np.asarray(jres["out_u8"]), "vs JAX")
    assert_u8_parity(out, g_out, "vs golden")
    cg = res["clahe_graded"].numpy()
    assert cg.shape == (256, 256) and np.isfinite(cg).any() and np.isnan(cg).any()
    assert_clahe_close(cg, gi["clahe_graded"], 1e-4, "clahe_graded vs golden")
    assert_clahe_close(cg, np.asarray(jres["clahe_graded"]), 1e-4, "clahe_graded vs JAX")
