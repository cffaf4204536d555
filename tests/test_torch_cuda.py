"""CUDA kernels of the PyTorch port against their plain PyTorch versions, on
the card, at small sizes (chip_smoke.py makes the same comparisons at the
main path's full shapes).

These tests need a CUDA device: they carry the ``gpu`` marker and skip
without one.  This file imports no JAX, so on a machine without JAX run it
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import synthetic_radiograph
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import noise, normalize, pyramid, stats
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _levels(img, cfg, dev):
    x = torch.from_numpy(img).to(dev)
    nrm, _, _ = normalize.normalize_from_u16(x, cfg.quirks)
    bands, _ = pyramid.reduce_ladder(nrm, cfg.pyramid_levels)
    return [stats.img_sdev(bands[i]) for i in cfg.analysis_levels]


def _random_levels(seed, sizes, dev):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        sd = rng.uniform(0.0, 0.12, (n, n)).astype(np.float32)
        sd[rng.uniform(size=(n, n)) < 0.05] = 0.0
        sd[rng.uniform(size=(n, n)) < 0.01] = 1e-6
        out.append(torch.from_numpy(sd).to(dev))
    return out


@pytest.mark.parametrize("size,source", [(512, "thorax"), (600, "pelvis"),
                                         (1024, "random"), (600, "random")])
def test_noise_kernel_matches_plain(dev, size, source):
    """One launch over all analysis levels (covs cropped at 600, padded at
    ragged levels) equals the per-level plain version exactly."""
    cfg = MusicaConfig(image_size=size)
    if source == "random":
        levels = _random_levels(size, [-(-size // 2 ** i) for i in cfg.analysis_levels], dev)
    else:
        levels = _levels(synthetic_radiograph(size, source), cfg, dev)
    h = fh.noise_hists(levels, cfg)
    assert torch.equal(h, fh.noise_hists_plain(levels, cfg))
    assert torch.equal(fh.hist_argmax(h), fh.hist_argmax_plain(h))
    assert int(h.sum()) > 0


def test_argmax_kernel_first_max_and_zero_rows(dev):
    h = torch.zeros((3, 2048), dtype=torch.int32, device=dev)
    h[0, 7] = h[0, 1500] = 9      # tie: the first maximum wins
    h[2, 2047] = 1
    assert fh.hist_argmax(h).tolist() == [7, 0, 2047]


@pytest.mark.parametrize("n,cnr_n", [(512, 64), (256, 32), (768, 96)])
def test_grad_relevant_kernel_matches_plain(dev, n, cnr_n):
    rng = np.random.default_rng(n)
    cfg = MusicaConfig(image_size=n)
    recon = rng.uniform(-0.1, 1.2, (n, n)).astype(np.float32)
    recon[rng.uniform(size=(n, n)) < 0.02] = 0.0
    nrm = rng.uniform(0.0, 1.01, (n, n)).astype(np.float32)
    cnr = rng.uniform(0.0, 0.1, (cnr_n, cnr_n)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (recon, nrm, cnr)]
    assert torch.equal(fh.grad_hist_relevant(*args, cfg),
                       fh.grad_hist_relevant_plain(*args, cfg))


@pytest.mark.parametrize("n", [600, 256, 75])
def test_grad_kernel_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    cfg = MusicaConfig(image_size=n)
    recon = rng.uniform(-0.1, 1.2, (n, n)).astype(np.float32)
    recon[rng.uniform(size=(n, n)) < 0.02] = 0.0
    rel = (rng.uniform(0, 1, (n, n)) ** 2).astype(np.float32)
    r, w = torch.from_numpy(recon).to(dev), torch.from_numpy(rel).to(dev)
    assert torch.equal(fh.grad_hist(r, w, cfg), fh.grad_hist_plain(r, w, cfg))


def test_relevance_paths_agree_on_pipeline_data(dev):
    """The in-kernel relevance histogram equals the relevance-image one on
    the main path's own recon/normalized/CNR."""
    cfg = MusicaConfig(image_size=512)
    x = torch.from_numpy(synthetic_radiograph(512, "hand")).to(dev)
    res = musica.musica_forward(x, cfg, want_intermediates=True)
    inter = res["intermediates"]
    a = fh.grad_hist_relevant(res["recon"], inter["normalized"], res["cnr"], cfg)
    rel = noise.img_relevant(inter["normalized"], res["cnr"], cfg)
    assert torch.equal(a, fh.grad_hist(res["recon"], rel, cfg))
    assert torch.equal(a, inter["grad_hist"])


@pytest.mark.parametrize("size,anatomy", [(512, "thorax"), (600, "pelvis")])
def test_pipeline_on_card_matches_cpu_and_launches_kernels(dev, size, anatomy):
    img = synthetic_radiograph(size, anatomy)
    cfg = MusicaConfig(image_size=size)
    fh.reset_launch_counts()
    out = musica.process(img, cfg, "cuda")
    counts = dict(fh.LAUNCHES)
    assert counts["noise_hist"] == 1 and counts["hist_argmax"] == 1
    # 512 takes the in-kernel relevance; 600 is ragged (relevance image)
    key = "grad_hist_relevant" if size % 16 == 0 else "grad_hist"
    assert counts[key] == 1
    # every op on the path is correctly rounded on both devices (float64
    # sqrt, true divisions), so the card reproduces the CPU path bit for bit
    np.testing.assert_array_equal(out, musica.process(img, cfg, "cpu"))


def test_wrapper_rejects_bad_input(dev):
    cfg = MusicaConfig(image_size=64)
    x = torch.rand((64, 64), device=dev)
    with pytest.raises(ValueError):
        fh.grad_hist(x.t(), x, cfg)          # not contiguous
    with pytest.raises(TypeError):
        fh.grad_hist(x.double(), x, cfg)     # wrong dtype
    with pytest.raises(ValueError):
        fh.noise_hists([x, x.cpu()], cfg)     # mixed devices


@pytest.mark.parametrize("size,want_intermediates", [(512, False), (600, False),
                                                     (512, True)])
def test_forward_never_waits_for_the_host(dev, size, want_intermediates):
    """No host synchronisation inside musica_forward: argmax bins, curve
    points and t0/ta/t1 stay on the device."""
    cfg = MusicaConfig(image_size=size)
    x = torch.from_numpy(synthetic_radiograph(size, "knee")).to(dev)
    musica.musica_forward(x, cfg, want_intermediates)  # build the kernels first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        musica.musica_forward(x, cfg, want_intermediates)
    finally:
        torch.cuda.set_sync_debug_mode("default")
