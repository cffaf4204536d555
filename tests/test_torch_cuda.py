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

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import graphs, musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import clahe, curves, noise, normalize, pyramid, stats
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import clahe_apply as k_clahe
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import contrast_apply as k_ka
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import histogram as k_hist
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import pyramid as k_pyr
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import tonemap as k_tone
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import hist_cases, pyramid_cases, tone_cases
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import synthetic_radiograph

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
    h, mb = fh.noise_hists(levels, cfg)
    assert torch.equal(h, fh.noise_hists_plain(levels, cfg))
    assert torch.equal(mb, fh.hist_argmax_plain(h))
    assert int(h.sum()) > 0


def _level_of_bins(n, groups):
    """An [n, n] noise level that is 0.0 but for whole 16-px groups of row 0
    at the value that maps to each given bin (each group adds 16 counts)."""
    sd = np.zeros((n, n), np.float32)
    for g, b in enumerate(groups):
        sd[0, 16 * g:16 * g + 16] = np.float32(b / 2048 * 0.1)
    return sd


def test_argmax_kernel_first_max_and_zero_rows(dev):
    """The argmax folded into K1's last block: a tie (the first maximum wins,
    though the larger bin comes first in the image), an all-zero level (bin
    0) and a maximum at the last bin."""
    cfg = MusicaConfig(image_size=512, quirks=False)
    levels = [torch.from_numpy(a).to(dev) for a in
              (_level_of_bins(64, [1500, 7]), _level_of_bins(64, []),
               _level_of_bins(64, [2047]))]
    h, mb = fh.noise_hists(levels, cfg)
    assert torch.equal(h, fh.noise_hists_plain(levels, cfg))
    assert int(h[0, 7]) == int(h[0, 1500]) == 16 and int(h[2, 2047]) == 16
    assert mb.tolist() == [7, 0, 2047]


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


@pytest.mark.parametrize("size,quirks", [(144, False), (600, True), (512, True), (1024, True)])
def test_noise_kernel_adversarial_and_constant_levels(dev, size, quirks):
    """K1 on adversarial levels (breaks at a group's first and last pixel and
    at the lane boundary, adjusted == 1, bin 0, values above 0.1, negative
    values) and on constant levels (one bin: the warp's single atomic)."""
    cfg = MusicaConfig(image_size=size, quirks=quirks)
    sizes = [-(-size // 2 ** i) for i in cfg.analysis_levels]
    rng = np.random.default_rng(size)
    for levels in ([torch.from_numpy(a).to(dev) for a in hist_cases.noise_levels(rng, sizes)],
                   [torch.full((m, m), 0.05, device=dev) for m in sizes]):
        launch.reset_launch_counts()
        h, mb = fh.noise_hists(levels, cfg)
        assert launch.LAUNCHES["noise_hist"] == 1
        assert torch.equal(h, fh.noise_hists_plain(levels, cfg))
        assert torch.equal(mb, fh.hist_argmax_plain(h))
        assert int(h.sum()) > 0


@pytest.mark.parametrize("n", [144, 600, 75, 256])
def test_grad_kernels_adversarial_and_constant(dev, n):
    """K4 (every n) and K3 (n a multiple of 16) on an adversarial recon
    (the tile return at its first and last pixel, at row 1 col 0 and row 2
    col 0, bin 1024, values >= 1, negative values, bin 0) and on a constant
    one (one bin everywhere)."""
    rng = np.random.default_rng(n + 1)
    cfg = MusicaConfig(image_size=n, relevant_border=min(100, n // 8))
    rel = torch.from_numpy(rng.uniform(0, 1, (n, n)).astype(np.float32)).to(dev)
    nrm = torch.from_numpy(rng.uniform(0, 1.01, (n, n)).astype(np.float32)).to(dev)
    cnr = torch.from_numpy(rng.uniform(0, 0.1, (-(-n // 8),) * 2).astype(np.float32)).to(dev)
    for recon in (torch.from_numpy(hist_cases.gradation_image(rng, n)).to(dev),
                  torch.full((n, n), 0.5, device=dev)):
        assert torch.equal(fh.grad_hist(recon, rel, cfg), fh.grad_hist_plain(recon, rel, cfg))
        if n % 16 == 0:
            assert torch.equal(fh.grad_hist_relevant(recon, nrm, cnr, cfg),
                               fh.grad_hist_relevant_plain(recon, nrm, cnr, cfg))


def test_sdev_noise_kernel_exact_on_adversarial_bands(dev):
    """K7 shares K1's per-pixel bin decision (csrc/noise_scan.cuh): still
    exact on bands whose sdev has zeros, constant tiles and values above
    0.1."""
    cfg = MusicaConfig(image_size=600)
    rng = np.random.default_rng(9)
    bands = [torch.from_numpy(a).to(dev) for a in hist_cases.noise_levels(rng, [600, 300, 150, 75])]
    sds, h, mb = fh.sdev_noise_hists(bands, cfg)
    want_sd, want_h = fh.sdev_noise_hists_plain(bands, cfg)
    assert all(torch.equal(a, b) for a, b in zip(sds, want_sd))
    assert torch.equal(h, want_h) and int(h.sum()) > 0
    assert torch.equal(mb, fh.hist_argmax_plain(want_h))


def test_histogram_wrappers_reject_what_the_kernels_do_not_take(dev):
    """Only what no kernel takes raises: K3 with a CNR scale that does not
    divide the tile, more levels than the prefix tables hold, and
    histograms or CLAHE tables larger than a block's 227 KB of shared
    memory."""
    cfg = MusicaConfig(image_size=96)
    x = torch.rand((96, 96), device=dev)
    with pytest.raises(ValueError, match="CNR scale"):
        fh.grad_hist_relevant(x, x, torch.rand((32, 32), device=dev), cfg)  # scale 3
    with pytest.raises(ValueError, match="levels"):
        fh.noise_hists([x] * 17, cfg)
    with pytest.raises(ValueError, match="n_bins"):
        k_hist.histogram(torch.zeros(8, dtype=torch.int32, device=dev),
                         torch.ones(8, device=dev), launch.MAX_SHARED_BINS + 1)
    with pytest.raises(ValueError, match="shared memory"):
        fh.sdev_noise_hists([x], cfg.with_(noise_histogram_bins=launch.MAX_SHARED_BINS))
    big = cfg.with_(enable_clahe=True, clahe_tiles=12, clahe_bins=256)  # 288 KB of tables
    with pytest.raises(ValueError, match="shared memory"):
        k_clahe.clahe_apply(x, None, torch.zeros((12, 12, 256), device=dev), big)


@pytest.mark.parametrize("tile", [4, 5, 8, 12, 32])
def test_histogram_kernels_take_every_tile(dev, tile):
    """K1, K3, K4 and K7 at histogram tiles other than the shaders' 16: the
    warp layouts at 4, 8 and 32 px, the serial kernels at 5 and 12 px (and
    K3/K4 at 4 px), each exactly equal to its plain version, on adversarial
    and random inputs at 600 (ragged: cropped and padded coverage) and 144
    (clean math: every level padded)."""
    rng = np.random.default_rng(tile)
    for size, quirks in ((600, True), (144, False)):
        cfg = MusicaConfig(image_size=size, quirks=quirks, histogram_area_size=tile)
        sizes = [-(-size // 2 ** i) for i in cfg.analysis_levels]
        for levels in ([torch.from_numpy(a).to(dev) for a in hist_cases.noise_levels(rng, sizes)],
                       _random_levels(size + tile, sizes, dev)):
            h, mb = fh.noise_hists(levels, cfg)
            assert torch.equal(h, fh.noise_hists_plain(levels, cfg))
            assert torch.equal(mb, fh.hist_argmax_plain(h))
            sds, h7, mb7 = fh.sdev_noise_hists(levels, cfg)
            want_sd, want_h = fh.sdev_noise_hists_plain(levels, cfg)
            assert all(torch.equal(a, b) for a, b in zip(sds, want_sd))
            assert torch.equal(h7, want_h)
            assert torch.equal(mb7, fh.hist_argmax_plain(want_h))
        recon = torch.from_numpy(hist_cases.gradation_image(rng, size)).to(dev)
        rel = torch.from_numpy(rng.uniform(0, 1, (size, size)).astype(np.float32)).to(dev)
        assert torch.equal(fh.grad_hist(recon, rel, cfg), fh.grad_hist_plain(recon, rel, cfg))
    # K3: n a multiple of the tile, a CNR scale (4, or 1 at 5 px) dividing it
    n = 160 * tile if tile in (4, 5) else 192
    scale = 4 if tile % 4 == 0 else 1
    cfg = MusicaConfig(image_size=n, histogram_area_size=tile, relevant_border=10)
    recon = torch.from_numpy(hist_cases.gradation_image(rng, n)).to(dev)
    nrm = torch.from_numpy(rng.uniform(0, 1.01, (n, n)).astype(np.float32)).to(dev)
    cnr = torch.from_numpy(rng.uniform(0, 0.1, (n // scale,) * 2).astype(np.float32)).to(dev)
    assert torch.equal(fh.grad_hist_relevant(recon, nrm, cnr, cfg),
                       fh.grad_hist_relevant_plain(recon, nrm, cnr, cfg))


@pytest.mark.parametrize("tile", [8, 12, 32])
def test_pipeline_on_card_at_other_histogram_tiles(dev, tile):
    """process() with histogram_area_size 8, 12 and 32 runs through the
    hand-written kernels (no ValueError) and equals the CPU path bit for
    bit, on the default analysis and the fused-sdev one."""
    img = synthetic_radiograph(512, "thorax")
    cfg = MusicaConfig(image_size=512, histogram_area_size=tile)
    musica.process(img, cfg, "cuda")  # captures the graph
    launch.reset_launch_counts()
    out = musica.process(img, cfg, "cuda")
    counts = dict(launch.LAUNCHES)
    assert counts["noise_hist"] == 1 and counts["hist_argmax"] == 0
    # the CNR scale (8 at 512) divides 8 and 32, not 12
    assert counts["grad_hist_relevant" if tile % 8 == 0 else "grad_hist"] == 1
    np.testing.assert_array_equal(out, musica.process(img, cfg, "cpu"))
    np.testing.assert_array_equal(musica.process(img, cfg, "cuda", fused_sdev=True), out)


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
    musica.process(img, cfg, "cuda")  # captures the graph
    launch.reset_launch_counts()
    out = musica.process(img, cfg, "cuda")
    counts = dict(launch.LAUNCHES)
    assert counts["noise_hist"] == 1 and counts["hist_argmax"] == 0
    # 512 takes the in-kernel relevance; 600 is ragged (relevance image)
    key = "grad_hist_relevant" if size % 16 == 0 else "grad_hist"
    assert counts[key] == 1
    # KS: every analysis level's sdev; KT: the tone map; KA: the contrast stage
    assert counts["sdev"] == counts["tone_map"] == counts["contrast_apply"] == 1
    assert counts["sdev_noise_hist"] == 0
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


@pytest.mark.parametrize("size,want_intermediates,variant",
                         [(512, False, {}), (600, False, {}), (512, True, {}),
                          (512, False, dict(enable_clahe=True, grad_with_linear_image=True)),
                          (600, True, dict(enable_clahe=True))])
def test_forward_never_waits_for_the_host(dev, size, want_intermediates, variant):
    """No host synchronisation inside musica_forward: argmax bins, curve
    points, t0/ta/t1 and the CLAHE LUTs stay on the device."""
    cfg = MusicaConfig(image_size=size, **variant)
    x = torch.from_numpy(synthetic_radiograph(size, "knee")).to(dev)
    musica.musica_forward(x, cfg, want_intermediates)  # build the kernels first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        musica.musica_forward(x, cfg, want_intermediates)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# ----------------------------------------------------------------------
# K6 (generic histogram) and K5 (CLAHE apply)
# ----------------------------------------------------------------------

def _clahe_inputs(seed, n, dev):
    """recon in [-0.1, 1.1] with exact 1.0 pixels, a random relevance mask
    that leaves tile (1, 2) empty (its LUT is NaN)."""
    rng = np.random.default_rng(seed)
    recon = rng.uniform(-0.1, 1.1, (n, n)).astype(np.float32)
    recon[rng.uniform(size=(n, n)) < 0.01] = 1.0
    relevant = (rng.uniform(size=(n, n)) < 0.6).astype(np.float32)
    ts = n // 4
    relevant[ts:2 * ts, 2 * ts:3 * ts] = 0.0
    return torch.from_numpy(recon).to(dev), torch.from_numpy(relevant).to(dev)


@pytest.mark.parametrize("n_bins,n", [(4096, 3072 * 3072), (256, 600 * 600),
                                      (4096, 144 * 144), (256, 1)])
def test_histogram_kernel_matches_plain(dev, n_bins, n):
    rng = np.random.default_rng(n)
    b = torch.from_numpy(rng.integers(-20, n_bins + 20, n).astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.integers(0, 3, n).astype(np.float32)).to(dev)
    assert torch.equal(k_hist.histogram(b, w, n_bins),
                       k_hist.histogram_plain(b, w, n_bins))


@pytest.mark.parametrize("n", [3072, 600, 144])
def test_clahe_histograms_kernel_matches_plain(dev, n):
    cfg = MusicaConfig(image_size=n, enable_clahe=True)
    recon, relevant = _clahe_inputs(n, n, dev)
    launch.reset_launch_counts()
    h = clahe.clahe_histograms(recon, relevant, cfg)
    assert launch.LAUNCHES["histogram"] == 1
    assert torch.equal(h.cpu(), clahe.clahe_histograms(recon.cpu(), relevant.cpu(), cfg))
    assert int(h[1, 2].sum()) == 0


@pytest.mark.parametrize("n", [3072, 600, 144])
def test_clahe_apply_kernel_matches_plain_exactly(dev, n):
    """Same LUTs on both sides, a NaN tile among them: equal NaN masks and
    max |kernel - plain| = 0 on the finite pixels."""
    cfg = MusicaConfig(image_size=n, enable_clahe=True)
    recon, relevant = _clahe_inputs(n + 1, n, dev)
    px, py = clahe.clahe_curves(clahe.clahe_histograms(recon, relevant, cfg), cfg)
    assert bool(torch.isnan(py).any())
    launch.reset_launch_counts()
    got = k_clahe.clahe_apply(recon, px, py, cfg)
    assert launch.LAUNCHES["clahe_apply"] == 1
    want = k_clahe.clahe_apply_plain(recon, px, py, cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(got).any()) and bool(torch.isfinite(got).any())


@pytest.mark.parametrize("n", [3072, 600, 144])
def test_clahe_kernels_at_8x8_tiles(dev, n):
    """clahe_tiles = 8: 16,384 joint bins (64 KB) and 128 KB of K5 tables,
    above the 48 KB a block gets without the shared-memory opt-in."""
    cfg = MusicaConfig(image_size=n, enable_clahe=True, clahe_tiles=8)
    recon, relevant = _clahe_inputs(n + 2, n, dev)
    relevant[: n // 8, : n // 8] = 0.0  # tile (0, 0) without relevant pixels: a NaN LUT
    launch.reset_launch_counts()
    h = clahe.clahe_histograms(recon, relevant, cfg)
    assert torch.equal(h.cpu(), clahe.clahe_histograms(recon.cpu(), relevant.cpu(), cfg))
    px, py = clahe.clahe_curves(h, cfg)
    got = k_clahe.clahe_apply(recon, px, py, cfg)
    assert launch.LAUNCHES["histogram"] == launch.LAUNCHES["clahe_apply"] == 1
    torch.testing.assert_close(got, k_clahe.clahe_apply_plain(recon, px, py, cfg),
                               rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(got).any()) and bool(torch.isfinite(got).any())


def _edge_recon(rng, n, bins):
    """recon with x at segment edges i / bins (true float32 divisions), 1.0,
    -0.0, 0.0, below 0, above 1, denormals and their negatives."""
    edges = np.arange(bins + 1, dtype=np.float32) / np.float32(bins)
    special = np.float32([1.0, -0.0, 0.0, -1e-3, 1.001, 1e-40, -1e-40, 1e-45, 2.0])
    pool = np.concatenate([edges, np.nextafter(edges, np.float32(2)), special])
    x = rng.uniform(-0.05, 1.05, (n, n)).astype(np.float32)
    pick = rng.uniform(size=(n, n)) < 0.5
    x[pick] = rng.choice(pool, int(pick.sum()))
    return x


@pytest.mark.parametrize("n,t,bins", [(17, 4, 256), (600, 4, 256), (3072, 4, 256),
                                      (600, 8, 64), (144, 2, 256)])
def test_clahe_apply_kernel_on_random_luts_and_segment_edges(dev, n, t, bins):
    """K5 on random LUTs (one NaN tile) with x at every segment edge, 1.0,
    -0.0, out of range and denormal: equal to the plain version, NaN masks
    included, and one kernel launch with nothing else on the card.  The
    profiler may record no CUDA event for a call (it did in 1 of 5 runs at
    3072): a second call is profiled then, and the check fails only if
    neither recorded the kernel or either recorded another kernel."""
    rng = np.random.default_rng(n + t)
    cfg = MusicaConfig(image_size=n, enable_clahe=True, clahe_tiles=t, clahe_bins=bins)
    py = np.sort(rng.uniform(0, 1, (t, t, bins)).astype(np.float32), axis=-1)
    py[t - 1, 0] = np.nan
    py = torch.from_numpy(py).to(dev)
    px = torch.cat([torch.arange(bins - 1, device=dev) / torch.tensor(float(bins), device=dev),
                    torch.ones(1, device=dev)])
    recon = torch.from_numpy(_edge_recon(rng, n, bins)).to(dev)
    got = k_clahe.clahe_apply(recon, px, py, cfg)
    torch.testing.assert_close(got, k_clahe.clahe_apply_plain(recon, px, py, cfg),
                               rtol=0, atol=0, equal_nan=True)
    torch.cuda.synchronize()
    profiled = []
    for _ in range(2):
        before = launch.LAUNCHES["clahe_apply"]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            k_clahe.clahe_apply(recon, px, py, cfg)
            torch.cuda.synchronize()
        assert launch.LAUNCHES["clahe_apply"] == before + 1
        profiled.append([e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA])
        if profiled[-1]:
            break
    assert any(profiled), profiled
    assert all("clahe_apply" in k for kernels in profiled for k in kernels), profiled


def test_clahe_tile_coordinates_are_true_divisions(dev):
    """i / 768 and i / 3072 on the card equal numpy's float32 division."""
    cfg = MusicaConfig(image_size=3072, enable_clahe=True)
    like = torch.zeros(1, device=dev)
    base_i, nb_i, w_base, w_nb, zero = clahe.axis_attrs(3072, cfg, like)
    cpu = clahe.axis_attrs(3072, cfg, like.cpu())
    for a, b in zip((base_i, nb_i, w_base, w_nb, zero), cpu):
        assert torch.equal(a.cpu(), b)
    coord = np.arange(3072, dtype=np.float32) / np.float32(768)
    np.testing.assert_array_equal(w_base.cpu().numpy(),
                                  np.float32(1) - np.abs(np.floor(coord) + np.float32(0.5) - coord))


@pytest.mark.parametrize("size,anatomy,variant", [
    (512, "thorax", dict(enable_clahe=True, grad_with_linear_image=True)),
    (600, "pelvis", dict(enable_clahe=True)),
    (512, "knee", dict(grad_with_linear_image=True)),
    (512, "hand", dict(enable_clahe=True, grad_with_linear_image=True, clahe_tiles=8))])
def test_variant_pipeline_on_card_matches_cpu(dev, size, anatomy, variant):
    img = synthetic_radiograph(size, anatomy)
    cfg = MusicaConfig(image_size=size, relevant_border=20, **variant)
    launch.reset_launch_counts()
    res = musica.musica_forward(torch.from_numpy(img).to(dev), cfg)
    counts = dict(launch.LAUNCHES)
    ref = musica.musica_forward(torch.from_numpy(img), cfg)
    assert torch.equal(res["out_u8"].cpu(), ref["out_u8"])
    assert torch.equal(res["recon"].cpu(), ref["recon"])
    # K3 where the CNR scale divides the tile and the tile divides n (512),
    # else the relevance image and K4 (600)
    assert counts["grad_hist_relevant" if size % 16 == 0 else "grad_hist"] == 1
    if cfg.enable_clahe:
        # the joint histogram with its relevance test (KH), the LUTs (KC)
        assert counts["clahe_hist"] == counts["clahe_curves"] == counts["clahe_apply"] == 1
        assert counts["histogram"] == 0
        torch.testing.assert_close(res["clahe_graded"].cpu(), ref["clahe_graded"],
                                   rtol=0, atol=0, equal_nan=True)


def test_timed_process_on_card_matches_forward(dev):
    cfg = MusicaConfig(image_size=512, enable_clahe=True, grad_with_linear_image=True,
                       relevant_border=20)
    img = synthetic_radiograph(512, "hand")
    out, times, extras = musica.timed_process(img, cfg, "cuda", want_extras=True)
    res = musica.musica_forward(torch.from_numpy(img).to(dev), cfg)
    np.testing.assert_array_equal(out, res["out_u8"].cpu().numpy())
    torch.testing.assert_close(torch.from_numpy(extras["clahe_graded"]),
                               res["clahe_graded"].cpu(), rtol=0, atol=0, equal_nan=True)
    assert list(times) == ["norm", "red", "anly", "aply", "exp", "grad", "tot"]


# ----------------------------------------------------------------------
# K7 (sdev + noise histogram), the fused-sdev path and bf16 storage
# ----------------------------------------------------------------------

def _bands(img, cfg, dev):
    x = torch.from_numpy(img).to(dev)
    nrm, _, _ = normalize.normalize_from_u16(x, cfg.quirks)
    bands, _ = pyramid.reduce_ladder(nrm, cfg.pyramid_levels)
    return [bands[i] for i in cfg.analysis_levels]


def _random_bands(seed, sizes, dev):
    """Bands whose sdev has every break kind: 8x8 patches scaled to zero
    (sdev 0.0), to ~1e-6 (bin 0) and by 6 (sdev above 0.1)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        b = rng.normal(0.0, 0.03, (n, n)).astype(np.float32)
        nb = -(-n // 8)
        scale = rng.choice(np.float32([0.0, 1e-4, 6.0, 1.0]), size=(nb, nb), p=[0.1, 0.1, 0.1, 0.7])
        b *= np.kron(scale, np.ones((8, 8), np.float32))[:n, :n]
        out.append(torch.from_numpy(b).to(dev))
    return out


@pytest.mark.parametrize("size,source", [(512, "thorax"), (600, "pelvis"), (144, "hand"),
                                         (1024, "random"), (600, "random")])
def test_sdev_noise_kernel_matches_plain(dev, size, source):
    """One launch over all analysis levels: every level's sdev and histogram
    equal the plain version bit for bit (600: cropped coverage and padded
    levels; 144: levels down to 18 px, smaller than one block)."""
    cfg = MusicaConfig(image_size=size)
    if source == "random":
        bands = _random_bands(size, [-(-size // 2 ** i) for i in cfg.analysis_levels], dev)
    else:
        bands = _bands(synthetic_radiograph(size, source), cfg, dev)
    launch.reset_launch_counts()
    sds, h, mb = fh.sdev_noise_hists(bands, cfg)
    assert launch.LAUNCHES["sdev_noise_hist"] == 1
    want_sd, want_h = fh.sdev_noise_hists_plain(bands, cfg)
    for got, want in zip(sds, want_sd):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(h, want_h)
    assert torch.equal(mb, fh.hist_argmax_plain(want_h))
    assert (int(h.sum()) > 0) == (size >= 512)


@pytest.mark.parametrize("sizes", [[40], [75, 38, 19, 10], [1, 2, 3, 5, 17, 33]])
def test_sdev_noise_kernel_ragged_levels(dev, sizes):
    """Padded coverage (cov > n) and levels far smaller than a block, with
    every row and column at a level's edge."""
    cfg = MusicaConfig(image_size=512)
    bands = _random_bands(sum(sizes), sizes, dev)
    sds, h, mb = fh.sdev_noise_hists(bands, cfg)
    want_sd, want_h = fh.sdev_noise_hists_plain(bands, cfg)
    assert all(torch.equal(a, b) for a, b in zip(sds, want_sd))
    assert torch.equal(h, want_h)
    assert torch.equal(mb, fh.hist_argmax_plain(want_h))


@pytest.mark.parametrize("grid", [1, 2, 5, 33])
def test_sdev_noise_kernel_ranges_cross_levels(dev, grid):
    """A grid of a few blocks: each block's range of tasks spans levels, so
    it flushes its histogram where the range crosses into the next level."""
    cfg = MusicaConfig(image_size=600)
    bands = _random_bands(grid, [600, 300, 150, 75], dev)
    sds, h, mb = fh.sdev_noise_hists(bands, cfg, grid=grid)
    want_sd, want_h = fh.sdev_noise_hists_plain(bands, cfg)
    assert all(torch.equal(a, b) for a, b in zip(sds, want_sd))
    assert torch.equal(h, want_h) and int(h.sum()) > 0
    assert torch.equal(mb, fh.hist_argmax_plain(want_h))


@pytest.mark.parametrize("size,anatomy,storage", [(512, "thorax", "float32"),
                                                  (600, "pelvis", "float32"),
                                                  (512, "knee", "bfloat16")])
def test_fused_sdev_pipeline_on_card(dev, size, anatomy, storage):
    """The fused-sdev path launches K7 (which takes the argmaxes) instead of
    K1, and its output equals the default path on the card and the CPU
    path."""
    img = synthetic_radiograph(size, anatomy)
    cfg = MusicaConfig(image_size=size, storage=storage)
    x = torch.from_numpy(img).to(dev)
    launch.reset_launch_counts()
    res = musica.musica_forward(x, cfg, fused_sdev=True)
    counts = dict(launch.LAUNCHES)
    assert counts["sdev_noise_hist"] == 1 and counts["hist_argmax"] == 0
    assert counts["noise_hist"] == 0
    assert torch.equal(res["out_u8"], musica.musica_forward(x, cfg)["out_u8"])
    assert torch.equal(res["out_u8"].cpu(),
                       musica.musica_forward(torch.from_numpy(img), cfg, fused_sdev=True)["out_u8"])


@pytest.mark.parametrize("size,anatomy", [(512, "thorax"), (600, "pelvis")])
def test_bf16_pipeline_on_card_matches_cpu(dev, size, anatomy):
    """bf16 rounding is round-to-nearest-even on both devices and every
    consumer upcasts explicitly, so the card reproduces the CPU path."""
    img = synthetic_radiograph(size, anatomy)
    cfg = MusicaConfig(image_size=size, storage="bfloat16")
    res = musica.musica_forward(torch.from_numpy(img).to(dev), cfg, want_intermediates=True)
    ref = musica.musica_forward(torch.from_numpy(img), cfg, want_intermediates=True)
    assert torch.equal(res["out_u8"].cpu(), ref["out_u8"])
    assert torch.equal(res["recon"].cpu(), ref["recon"])
    for k in ("red_bandpass_0", "contrast_bandpass_1", "nr_bandpass_2"):
        assert res["intermediates"][k].dtype == torch.bfloat16
        assert torch.equal(res["intermediates"][k].cpu(), ref["intermediates"][k]), k
    np.testing.assert_array_equal(musica.process_batch(np.stack([img] * 2), cfg, "cuda"),
                                  np.stack([ref["out_u8"].numpy()] * 2))


@pytest.mark.parametrize("size,want_intermediates,storage,fused_sdev",
                         [(512, False, "float32", True), (600, True, "float32", True),
                          (512, False, "bfloat16", False), (512, True, "bfloat16", True)])
def test_fused_sdev_and_bf16_never_wait_for_the_host(dev, size, want_intermediates, storage,
                                                     fused_sdev):
    cfg = MusicaConfig(image_size=size, storage=storage)
    x = torch.from_numpy(synthetic_radiograph(size, "knee")).to(dev)
    musica.musica_forward(x, cfg, want_intermediates, fused_sdev)  # build the kernels first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        musica.musica_forward(x, cfg, want_intermediates, fused_sdev)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_timed_process_on_card_fused_sdev_bf16(dev):
    cfg = MusicaConfig(image_size=512, storage="bfloat16")
    img = synthetic_radiograph(512, "hand")
    out, times = musica.timed_process(img, cfg, "cuda", fused_sdev=True)
    res = musica.musica_forward(torch.from_numpy(img).to(dev), cfg)
    np.testing.assert_array_equal(out, res["out_u8"].cpu().numpy())
    assert list(times) == ["norm", "red", "anly", "aply", "exp", "grad", "tot"]


def _u8_pair(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    return a, np.clip(a.astype(int) + rng.integers(-25, 25, shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(173, 211), (600, 600), (40, 40)])
def test_measure_row_on_card_matches_host_oracles(dev, shape):
    """A campaign row on the card (float32 mse and SSIM, the value counts
    through the histogram kernel) against the float64 host oracles within
    2e-5; the identity row is [1, 1, 0, 1, 1, 0]; the counts equal
    ``np.bincount``."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import metrics
    alt, unalt = _u8_pair(shape[0], shape)
    ref = np.clip(alt.astype(int) + 3, 0, 255).astype(np.uint8)
    unalt_t, ref_t = torch.from_numpy(unalt).to(dev), torch.from_numpy(ref).to(dev)
    launch.reset_launch_counts()
    vals = metrics.measure_row(alt, unalt_t, ref_t)
    assert launch.LAUNCHES["histogram"] == 3
    want = [metrics.mse_similarity(alt, unalt), metrics.ssim_similarity(alt, unalt),
            metrics.hist_similarity(alt, unalt)[1],
            metrics.mse_similarity(alt, ref), metrics.ssim_similarity(alt, ref),
            metrics.hist_similarity(alt, ref)[1]]
    np.testing.assert_allclose(vals, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(metrics.measure_row(unalt, unalt_t, unalt_t), [1, 1, 0, 1, 1, 0],
                               rtol=0, atol=1e-6)
    assert metrics.counts256(ref_t).cpu().numpy().tolist() == \
        np.bincount(ref.reshape(-1), minlength=256).tolist()


def test_campaign_on_card_matches_cpu(dev, tmp_path):
    """The port's campaign at 512 (knee) on the card against the same
    campaign on the CPU: the same rows, every value within 1e-5, and the
    card's run launched K1 (with the folded argmax), a gradation histogram
    and the histogram kernel of the rows' value counts."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import campaign
    # the runner's graph, captured before the counted run
    campaign.default_runner(512, device="cuda")(synthetic_radiograph(512, "knee"))
    launch.reset_launch_counts()
    captures = graphs.capture_count()
    res = campaign.run_campaign(out_dir=str(tmp_path / "card"), image_size=512,
                                anatomies=["knee"], seed=3, device="cuda")
    counts = dict(launch.LAUNCHES)
    assert graphs.capture_count() == captures, "the campaign captured another graph"
    assert counts["noise_hist"] == counts["grad_hist_relevant"] == 31, counts
    assert counts["histogram"] == 3 * (1 + 30 + 20), counts
    want = campaign.run_campaign(out_dir=str(tmp_path / "cpu"), image_size=512,
                                 anatomies=["knee"], seed=3, device="cpu")
    for name in (campaign.R_CSV, campaign.NR_CSV, campaign.S_CSV, "deltas.csv"):
        first = 2 if name in (campaign.R_CSV, campaign.NR_CSV) else 1
        assert [r[:first] for r in res[name]] == [r[:first] for r in want[name]], name
        got = np.array([[float(v) for v in r[first:]] for r in res[name][1:]])
        np.testing.assert_allclose(got, [[float(v) for v in r[first:]] for r in want[name][1:]],
                                   rtol=0, atol=1e-5, err_msg=name)


def _k1_k3(dev, cfg, seed):
    """K1's histograms and first-max bins and K3's histogram on ``dev``."""
    n = cfg.image_size
    rng = np.random.default_rng(seed)
    levels = _random_levels(seed, [-(-n // 2 ** i) for i in cfg.analysis_levels], dev)
    recon = rng.uniform(-0.1, 1.2, (n, n)).astype(np.float32)
    recon[rng.uniform(size=(n, n)) < 0.02] = 0.0
    nrm = rng.uniform(0.0, 1.01, (n, n)).astype(np.float32)
    cnr = rng.uniform(0.0, 0.1, (n // 8, n // 8)).astype(np.float32)
    h, mb = fh.noise_hists(levels, cfg)
    g = fh.grad_hist_relevant(*[torch.from_numpy(a).to(dev) for a in (recon, nrm, cnr)], cfg)
    return [t.cpu() for t in (h, mb, g)]


@pytest.mark.parametrize("index", [0, 1])
def test_kernels_from_a_worker_thread_run_on_their_tensors_device(dev, index):
    """K1 and K3 launched from a worker thread, whose current device is
    cuda:0 whatever the tensors' device, give the main thread's results and
    their plain versions' (on cuda:1 where a second card exists)."""
    import threading
    if index >= torch.cuda.device_count():
        pytest.skip(f"needs {index + 1} cards")
    card = torch.device("cuda", index)
    cfg = MusicaConfig(image_size=512)
    launch.reset_launch_counts()
    main = _k1_k3(card, cfg, 7)
    box = {}
    t = threading.Thread(target=lambda: box.update(r=_k1_k3(card, cfg, 7)))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "r" in box
    for a, b in zip(main, box["r"]):
        assert torch.equal(a, b)
    plain = _k1_k3(torch.device("cpu"), cfg, 7)
    for a, b in zip(main, plain):
        assert torch.equal(a, b)
    assert launch.LAUNCHES["noise_hist"] == launch.LAUNCHES["grad_hist_relevant"] == 2


@pytest.mark.parametrize("copies", [1, 2])
def test_process_sharded_on_card_equals_forward_batch(dev, copies):
    """The data-parallel path on every card (and with each card twice in
    the mesh: two worker threads and streams on one card) equals
    forward_batch bit for bit; its checksum equals the outputs' sum."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
    cfg = MusicaConfig(image_size=512)
    mesh = sharding.make_mesh() * copies
    imgs = np.stack([synthetic_radiograph(512, a) for a in ("thorax", "hand", "knee", "foot")]
                    * len(mesh))
    out, cnr = sharding.process_sharded(imgs, cfg, mesh, outputs=("out_u8", "cnr"))
    x = torch.from_numpy(imgs).to(dev)
    assert out.device == mesh[0] and torch.equal(out, musica.forward_batch(x, cfg))
    assert torch.equal(cnr, torch.stack([musica.musica_forward(im, cfg)["cnr"] for im in x]))
    step, example = sharding.throughput_step(cfg, mesh, batch_per_device=2)
    want = sum(int(musica.forward_batch(e.to(dev), cfg).sum(dtype=torch.int64)) for e in example)
    assert int(step(example)) == want


# ----------------------------------------------------------------------
# the compiled entries: musica_forward as captured CUDA graphs
# ----------------------------------------------------------------------

GRAPH_VARIANTS = {"main": ({}, False), "clahe_linear": (dict(enable_clahe=True,
                                                             grad_with_linear_image=True), False),
                  "fused_sdev": ({}, True), "bf16": (dict(storage="bfloat16"), False)}


@pytest.mark.parametrize("variant", sorted(GRAPH_VARIANTS))
@pytest.mark.parametrize("size,anatomy,quirks", [(144, "hand", False), (256, "thorax", True),
                                                 (600, "pelvis", True)])
def test_graph_replays_equal_eager(dev, variant, size, anatomy, quirks):
    """process_jit (a replay) equals eager musica_forward bit for bit, also
    the other outputs the graph keeps; process_batch_jit equals
    forward_batch; the launches counted are the warm-up's and one tally a
    replay."""
    kw, fused = GRAPH_VARIANTS[variant]
    cfg = MusicaConfig(image_size=size, quirks=quirks, **kw)
    x = torch.from_numpy(synthetic_radiograph(size, anatomy)).to(dev)
    graphs.release_graphs()
    launch.reset_launch_counts()
    out = musica.process_jit(x, cfg, fused)
    warm = dict(launch.LAUNCHES)
    (g,) = graphs.cached_graphs()
    assert g.tally and all(warm[k] == 2 * n for k, n in g.tally.items()), (warm, g.tally)
    want = musica.musica_forward(x, cfg, fused_sdev=fused)
    assert torch.equal(out, want["out_u8"])
    for k, v in g.outputs.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, equal_nan=True)
    xs = torch.stack([x] + [torch.from_numpy(synthetic_radiograph(size, a)).to(dev)
                            for a in ("knee", "foot")])
    assert torch.equal(musica.process_batch_jit(xs, cfg, fused),
                       musica.forward_batch(xs, cfg, fused))
    assert graphs.capture_count() and len(graphs.cached_graphs()) == 1


def test_graph_alternating_images_and_strided_input(dev):
    """Two images replayed in turns, each result kept: a stale static buffer
    or an output overwritten by the next replay shows; a transposed (strided)
    input and an int32 image (a graph of its own) equal eager."""
    cfg = MusicaConfig(image_size=512)
    a, b = (torch.from_numpy(synthetic_radiograph(512, k)).to(dev) for k in ("thorax", "hand"))
    want = {k: musica.musica_forward(x, cfg)["out_u8"] for k, x in (("a", a), ("b", b))}
    kept = [(k, musica.process_jit(x, cfg)) for _ in range(3) for k, x in (("a", a), ("b", b))]
    for k, out in kept:
        assert torch.equal(out, want[k]), k
    assert not torch.equal(want["a"], want["b"])
    assert torch.equal(musica.process_jit(a.T, cfg), musica.musica_forward(a.T, cfg)["out_u8"])
    assert torch.equal(musica.process_jit(a.to(torch.int32), cfg), want["a"])


def test_graph_capture_and_replay_never_wait_for_the_host(dev):
    """A capture (after its eager warm-up) and replays under
    set_sync_debug_mode("error")."""
    cfg = MusicaConfig(image_size=600, enable_clahe=True)
    x = torch.from_numpy(synthetic_radiograph(600, "knee")).to(dev)
    graphs.release_graphs()
    want = musica.musica_forward(x, cfg)["out_u8"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = musica.process_jit(x, cfg)
        second = musica.process_jit(x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(first, want) and torch.equal(second, want)


def test_graph_captured_under_the_profiler_replays_exactly(dev):
    """musica_forward's record_function spans are inside the capture: a
    graph captured while a profiler runs replays bit-identical, after the
    profiler has stopped too."""
    cfg = MusicaConfig(image_size=256)
    x = torch.from_numpy(synthetic_radiograph(256, "head")).to(dev)
    graphs.release_graphs()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        inside = musica.process_jit(x, cfg)
        torch.cuda.synchronize()
    after = musica.process_jit(x, cfg)
    want = musica.musica_forward(x, cfg)["out_u8"]
    assert torch.equal(inside, want) and torch.equal(after, want)
    assert graphs.capture_count() and len(graphs.cached_graphs()) == 1


# ----------------------------------------------------------------------
# the spatial path: K1, K3, K4 on row windows, K2 as its own launch
# ----------------------------------------------------------------------

def _plan_rows(plan, k, i):
    """Shard i's rows of level k; a level past the sharded ones is scanned
    whole by the first shard (as spatial.forward does)."""
    if k < plan.replicated:
        return plan.rows(k, i)
    return (0, plan.sizes[k]) if i == 0 else (0, 0)


@pytest.mark.parametrize("tile", [8, 12, 16, 32])
@pytest.mark.parametrize("n,quirks", [(600, True), (256, False)])
def test_window_kernels_match_plain(dev, tile, n, quirks):
    """Every shard's K1, K3 and K4 window equals its plain version exactly,
    the windows sum to the whole image's histograms, and K2's launch on the
    sum equals the plain argmax and K1's folded one."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    cfg = MusicaConfig(image_size=n, quirks=quirks, histogram_area_size=tile)
    plan = spatial.row_plan(n, 4, cfg)
    rng = np.random.default_rng(tile)
    lv = list(cfg.analysis_levels)
    levels = [torch.from_numpy(a).to(dev)
              for a in hist_cases.noise_levels(rng, [plan.sizes[k] for k in lv])]
    recon = torch.from_numpy(hist_cases.gradation_image(rng, n)).to(dev)
    rel = torch.from_numpy(rng.uniform(0.0, 1.0, (n, n)).astype(np.float32)).to(dev)
    nrm = torch.from_numpy(rng.uniform(0.0, 1.01, (n, n)).astype(np.float32)).to(dev)
    cs = -(-n // 8)
    cnr = torch.from_numpy(rng.uniform(0.0, 0.1, (cs, cs)).astype(np.float32)).to(dev)
    h1 = torch.zeros((len(lv), cfg.noise_histogram_bins), dtype=torch.int32, device=dev)
    h3 = torch.zeros(cfg.grad_histogram_bins, dtype=torch.int32, device=dev)
    h4 = torch.zeros_like(h3)
    for i in range(4):
        rows = [_plan_rows(plan, k, i) for k in lv]
        wins = [sd[a:b] for sd, (a, b) in zip(levels, rows)]
        r0s = [a for a, _ in rows]
        got = fh.noise_hists_rows(wins, r0s, cfg)
        want = fh.noise_hists_rows_plain([w.cpu() for w in wins], r0s, cfg)
        if got is None:
            assert not want.any()
        else:
            assert torch.equal(got.cpu(), want)
            h1 += got
        a, b = plan.rows(0, i)
        assert torch.equal(fh.grad_hist(recon[a:b], rel[a:b], cfg, a).cpu(),
                           fh.grad_hist_plain(recon[a:b].cpu(), rel[a:b].cpu(), cfg, a))
        h4 += fh.grad_hist(recon[a:b], rel[a:b], cfg, a)
        if tile % 8 == 0:
            c0, c1 = noise.cnr_rows(cs, n, a, b)
            got3 = fh.grad_hist_relevant(recon[a:b], nrm[a:b], cnr[c0:c1], cfg, a, c0)
            assert torch.equal(got3.cpu(), fh.grad_hist_relevant_plain(
                recon[a:b].cpu(), nrm[a:b].cpu(), cnr[c0:c1].cpu(), cfg, a, c0))
            h3 += got3
    whole, mb = fh.noise_hists(levels, cfg)
    assert torch.equal(h1, whole)
    launch.reset_launch_counts()
    k2 = fh.hist_argmax(h1)
    assert launch.LAUNCHES["hist_argmax"] == 1
    assert torch.equal(k2, mb) and torch.equal(k2.cpu(), fh.hist_argmax_plain(whole.cpu()))
    assert torch.equal(h4, fh.grad_hist(recon, rel, cfg))
    if tile % 8 == 0:
        assert torch.equal(h3, fh.grad_hist_relevant(recon, nrm, cnr, cfg))


def test_hist_argmax_kernel_ties_and_zero_rows(dev):
    """K2's own launch: the first maximum wins, an all-zero row gives 0."""
    h = torch.zeros((4, 2048), dtype=torch.int32)
    h[0, [7, 1500, 2047]] = 5
    h[2, 2047] = 1
    h[3] = torch.arange(2048, dtype=torch.int32) % 17
    got = fh.hist_argmax(h.to(dev)).cpu()
    assert got.tolist() == [7, 0, 2047, 16]
    assert torch.equal(got, fh.hist_argmax_plain(h))


@pytest.mark.parametrize("n,shape", [(512, (1, 4)), (512, (2, 2)), (600, (1, 4))])
def test_spatial_path_on_card_equals_eager(dev, n, shape):
    """process_sharded over mesh entries that are all this card equals the
    unsharded eager path bit for bit, with K1 once per shard that holds
    covered rows, K2 once per image and K3 (or K4 at 600), KS, KA and KT
    once per shard."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import (
        sharding, spatial)
    cfg = MusicaConfig(image_size=n)
    plan = spatial.row_plan(n, shape[1], cfg)
    covered = sum(any(_plan_rows(plan, k, i)[0] < min(_plan_rows(plan, k, i)[1],
                                                      stats.coverage(plan.sizes[k], cfg))
                      for k in cfg.analysis_levels) for i in range(shape[1]))
    imgs = np.stack([synthetic_radiograph(n, a) for a in ("thorax", "pelvis")])
    mesh = sharding.make_mesh(n_data=shape[0], n_space=shape[1], devices=[dev] * 4)
    want = musica.forward_batch(torch.from_numpy(imgs).to(dev), cfg)
    # the first call captures (the outputs are part of the graph's key)
    sharding.process_sharded(imgs, cfg, mesh, outputs=("out_u8", "recon"))
    launch.reset_launch_counts()
    out, recon = sharding.process_sharded(imgs, cfg, mesh, outputs=("out_u8", "recon"))
    torch.cuda.synchronize()
    counts = dict(launch.LAUNCHES)
    assert torch.equal(out.to(dev), want)
    for i, im in enumerate(imgs):
        assert torch.equal(recon[i].to(dev),
                           musica.musica_forward(torch.from_numpy(im).to(dev), cfg)["recon"])
    s = shape[1]
    grad = "grad_hist_relevant" if n % 16 == 0 else "grad_hist"
    assert counts["hist_argmax"] == 2 and counts[grad] == 2 * s, counts
    assert counts["noise_hist"] == 2 * covered > 0, counts
    assert counts["sdev"] == counts["tone_map"] == counts["contrast_apply"] == 2 * s, counts


def test_spatial_path_over_every_card(dev):
    """One image's rows over n_space = every visible card (the halo rows and
    the histogram partials cross cards) equal the unsharded path; a 2 x 2
    mesh where there are four cards."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    cfg = MusicaConfig(image_size=512)
    imgs = np.stack([synthetic_radiograph(512, a) for a in ("thorax", "pelvis")])
    want = musica.forward_batch(torch.from_numpy(imgs).to(dev), cfg)
    out = sharding.process_sharded(imgs[:1], cfg, sharding.make_mesh(n_data=1, n_space=cards))
    assert out.device == dev and torch.equal(out, want[:1])
    if cards >= 4:
        out = sharding.process_sharded(imgs, cfg, sharding.make_mesh(n_data=2, n_space=2))
        assert torch.equal(out, want)


def _odd_bounds(n, space):
    """A partition of n rows into ``space`` windows, the inner ones
    starting on odd rows."""
    return [0] + [i * n // space + (1 - i * n // space % 2) for i in range(1, space)] + [n]


@pytest.mark.parametrize("n,tiles", [(600, 4), (512, 8), (144, 4)])
def test_clahe_window_kernels_match_plain(dev, n, tiles):
    """K5 on each window of rows (inner windows starting on odd rows, which
    at 600 keep the rows 16-byte aligned) equals its plain version and the
    whole apply's rows exactly, NaN masks included; K6 on each window's
    joint bins equals the plain histogram and the partials sum to the whole
    image's."""
    cfg = MusicaConfig(image_size=n, enable_clahe=True, clahe_tiles=tiles)
    rng = np.random.default_rng(n + tiles)
    recon = torch.from_numpy(rng.uniform(-0.05, 1.05, (n, n)).astype(np.float32)).to(dev)
    relevant = torch.from_numpy((rng.uniform(size=(n, n)) < 0.7).astype(np.float32)).to(dev)
    relevant[: n // 3, : n // 3] = 0.0  # a tile without relevant pixels: NaN LUT
    whole_h = clahe.clahe_histograms(recon, relevant, cfg)
    px, py = clahe.clahe_curves(whole_h, cfg)
    whole = k_clahe.clahe_apply(recon, px, py, cfg)
    total = torch.zeros_like(whole_h)
    b = _odd_bounds(n, 4)
    for r0, r1 in zip(b, b[1:]):
        win = recon[r0:r1]
        got = k_clahe.clahe_apply(win, px, py, cfg, r0)
        torch.testing.assert_close(got, whole[r0:r1], rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(got.cpu(), k_clahe.clahe_apply_plain(
            win.cpu(), px.cpu(), py.cpu(), cfg, r0), rtol=0, atol=0, equal_nan=True)
        part = clahe.clahe_histograms_rows(win, relevant[r0:r1], r0, n, cfg)
        assert torch.equal(part.cpu(), clahe.clahe_histograms_rows(
            win.cpu(), relevant[r0:r1].cpu(), r0, n, cfg))
        total += part
    assert torch.equal(total, whole_h)
    with pytest.raises(ValueError, match="rows"):
        k_clahe.clahe_apply(recon[:10], px, py, cfg, n - 5)


@pytest.mark.parametrize("tile", [8, 12, 16, 32])
@pytest.mark.parametrize("n,quirks", [(600, True), (256, False)])
def test_sdev_noise_window_kernel_matches_plain(dev, tile, n, quirks):
    """K7 on every shard's windows of a 4-shard plan (band rows with the
    2-row halos, a replicated level counted by the first shard alone), also
    with a few blocks whose task ranges cross levels: the sdev rows and the
    histograms equal the plain version exactly, the sdev rows equal the
    whole-image K7's, and the histograms sum to the whole image's."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    cfg = MusicaConfig(image_size=n, quirks=quirks, histogram_area_size=tile)
    plan = spatial.row_plan(n, 4, cfg)
    lv = list(cfg.analysis_levels)
    rng = np.random.default_rng(3 * tile + n)
    bands = [torch.from_numpy(a - 0.05).to(dev)
             for a in hist_cases.noise_levels(rng, [plan.sizes[k] for k in lv])]
    whole_sd, whole_h, _ = fh.sdev_noise_hists(bands, cfg)
    for grid in (0, 3):
        total = torch.zeros_like(whole_h)
        for i in range(4):
            rows = [plan.rows(k, i) if k < plan.replicated else (0, plan.sizes[k]) for k in lv]
            need = [pyramid.needed_rows("img_sdev", b.shape[-1], *r) for b, r in zip(bands, rows)]
            wins = [b[lo:hi] for b, (lo, hi) in zip(bands, need)]
            counted = [k < plan.replicated or i == 0 for k in lv]
            args = (wins, [lo for lo, _ in need], rows, cfg, counted)
            sds, h = fh.sdev_noise_hists_rows(*args, grid=grid)
            psds, ph = fh.sdev_noise_hists_rows_plain([w.cpu() for w in wins], *args[1:])
            assert torch.equal(h.cpu(), ph)
            for sd, p, w, (r0, r1) in zip(sds, psds, whole_sd, rows):
                assert torch.equal(sd.cpu(), p) and torch.equal(sd, w[r0:r1])
            total += h
        assert torch.equal(total, whole_h)
    with pytest.raises(ValueError, match="window holds"):
        fh.sdev_noise_hists_rows([bands[0][4:20]], [4], [(4, 20)], cfg)


@pytest.mark.parametrize("variant", ["clahe_linear", "fused_sdev"])
def test_spatial_variants_on_card_equal_eager(dev, variant):
    """process_sharded over 1x4 entries on this card in the CLAHE + linear
    variant (clahe_graded gathered whole) and with fused_sdev equals the
    unsharded eager path bit for bit; per image K1 once per shard with
    covered rows, KS, K3, KH and K5 once per shard, KC once per entry and K2
    once (CLAHE), or
    K7 once per shard, K2 once and K3 once per shard (fused-sdev), and KT,
    KA and KG once per shard and KN's two passes on each shard in both."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
    fused = variant == "fused_sdev"
    cfg = MusicaConfig(image_size=512, enable_clahe=not fused, grad_with_linear_image=not fused)
    names = ("out_u8",) if fused else ("out_u8", "clahe_graded")
    imgs = np.stack([synthetic_radiograph(512, a) for a in ("thorax", "pelvis")])
    mesh = sharding.make_mesh(n_data=1, n_space=4, devices=[dev] * 4)
    sharding.process_sharded(imgs, cfg, mesh, outputs=names, fused_sdev=fused)
    launch.reset_launch_counts()
    got = sharding.process_sharded(imgs, cfg, mesh, outputs=names, fused_sdev=fused)
    torch.cuda.synchronize()
    counts = dict(launch.LAUNCHES)
    got = got if isinstance(got, tuple) else (got,)
    for i, im in enumerate(imgs):
        want = musica.musica_forward(torch.from_numpy(im).to(dev), cfg, fused_sdev=fused)
        for name, g in zip(names, got):
            torch.testing.assert_close(g[i].to(dev), want[name], rtol=0, atol=0, equal_nan=True)
    if fused:
        want_counts = {"sdev_noise_hist": 8, "hist_argmax": 2, "grad_hist_relevant": 8}
    else:
        want_counts = {"noise_hist": 8, "hist_argmax": 2, "grad_hist_relevant": 8,
                       "clahe_hist": 8, "clahe_curves": 8, "clahe_apply": 8, "sdev": 8}
    want_counts["tone_map"] = want_counts["contrast_apply"] = 8  # KT and KA on each shard's rows
    want_counts["gradation_curve"], want_counts["normalize"] = 8, 16  # KG; KN's two passes
    # per image over 1x4 (R = 7 sharded levels of L = 9): the down step and
    # a band on each shard at the 7 sharded levels, an expand step on each
    # at the 7 on the way back; the 2 coarse levels (4 and 2 px) one ladder
    # tail and one expand tail on each entry
    want_counts.update({"pyramid_down": 2 * 4 * 7, "pyramid_up": 2 * 2 * 4 * 7,
                        "pyramid_tail": 2 * 2 * 4})
    assert counts == {k: want_counts.get(k, 0) for k in counts}, counts


def test_spatial_variants_over_every_card(dev):
    """One 512^2 image of each variant over n_space = every visible card
    equals the unsharded path."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    img = synthetic_radiograph(512, "thorax")
    mesh = sharding.make_mesh(n_data=1, n_space=cards)
    for cfg, fused, names in ((MusicaConfig(image_size=512, enable_clahe=True,
                                            grad_with_linear_image=True), False,
                               ("out_u8", "clahe_graded")),
                              (MusicaConfig(image_size=512), True, ("out_u8",))):
        got = sharding.process_sharded(img[None], cfg, mesh, outputs=names, fused_sdev=fused)
        got = got if isinstance(got, tuple) else (got,)
        want = musica.musica_forward(torch.from_numpy(img).to(dev), cfg, fused_sdev=fused)
        for name, g in zip(names, got):
            torch.testing.assert_close(g[0], want[name], rtol=0, atol=0, equal_nan=True)


SPATIAL_VARIANTS = {
    "main": ({}, False, ("out_u8", "recon")),
    "clahe_linear": (dict(enable_clahe=True, grad_with_linear_image=True), False,
                     ("out_u8", "clahe_graded")),
    "fused_sdev": ({}, True, ("out_u8", "cnr")),
    "bf16": (dict(storage="bfloat16"), False, ("out_u8",)),
}


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def _same(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w.to(g.device), rtol=0, atol=0, equal_nan=True,
                                   msg=f"{what}: output {k}")


@pytest.mark.parametrize("variant", sorted(SPATIAL_VARIANTS))
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_spatial_graph_replays_equal_eager_and_process_batch_jit(dev, variant, shape):
    """process_sharded over entries that are all this card replays one
    captured graph per mesh row (one segment each): bit-equal to the eager
    spatial path and to process_batch_jit; a second call captures nothing
    and its launches are twice the graph's tally."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
    over, fused, names = SPATIAL_VARIANTS[variant]
    cfg = MusicaConfig(image_size=512, **over)
    imgs = np.stack([synthetic_radiograph(512, a) for a in ("thorax", "pelvis")])
    mesh = sharding.make_mesh(n_data=shape[0], n_space=shape[1], devices=[dev] * 4)
    graphs.release_graphs()  # earlier tests may have cached these keys
    before = graphs.capture_count()
    first = _tup(sharding.process_sharded(imgs, cfg, mesh, outputs=names, fused_sdev=fused))
    assert graphs.capture_count() == before + shape[0]
    new = graphs.cached_graphs()[-shape[0]:]
    assert all(isinstance(g, graphs.SpatialGraph) and g.segments == 1 for g in new)
    launch.reset_launch_counts()
    got = _tup(sharding.process_sharded(imgs, cfg, mesh, outputs=names, fused_sdev=fused))
    torch.cuda.synchronize()
    assert graphs.capture_count() == before + shape[0]
    tally = {k: sum(g.tally.get(k, 0) for g in new) for k in launch.LAUNCHES}
    per_row = 2 // shape[0]
    assert launch.LAUNCHES == {k: per_row * n for k, n in tally.items()}
    eager = _tup(sharding.process_sharded_eager(imgs, cfg, mesh, outputs=names, fused_sdev=fused))
    _same(first, eager, f"{variant} {shape}: first call")
    _same(got, eager, f"{variant} {shape}: replay")
    x = torch.from_numpy(imgs).to(dev)
    assert torch.equal(got[0], musica.process_batch_jit(x, cfg, fused))
    for i, im in enumerate(x):
        want = musica.musica_forward(im, cfg, fused_sdev=fused)
        _same([g[i] for g in got], [want[k] for k in names], f"{variant} {shape}: image {i}")


def test_spatial_graph_cut_at_every_exchange_on_card(dev):
    """The segmented replay on one card (a cut at every exchange between
    entries, as between cards): bit-equal to the eager spatial path."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import (
        sharding, spatial)
    for over, fused, names in SPATIAL_VARIANTS.values():
        cfg = MusicaConfig(image_size=512, **over)
        imgs = torch.from_numpy(np.stack([synthetic_radiograph(512, a)
                                          for a in ("hand", "knee")])).to(dev)
        mesh = sharding.make_mesh(n_data=1, n_space=4, devices=[dev] * 4)

        def on_row(i, entries, imgs=imgs, cfg=cfg, fused=fused, names=names):
            return graphs.run_spatial(spatial.forward, imgs, cfg, entries,
                                      spatial.row_plan(512, 4, cfg).bounds[0], fused, names,
                                      cut_every=True)
        (got,) = sharding._on_rows(mesh, on_row)
        g = graphs.cached_graphs()[-1]
        assert isinstance(g, graphs.SpatialGraph) and g.segments > 4
        want = _tup(sharding.process_sharded_eager(imgs, cfg, mesh, outputs=names,
                                                   fused_sdev=fused))
        _same(got, want, f"{over} {fused}: cut at every exchange")


def test_spatial_graph_over_every_card(dev):
    """One image's rows over n_space = every visible card: the graph's
    segments (cut at the exchanges between cards) replay bit-equal to the
    eager spatial path and to process_batch_jit, in every variant, without
    a recapture."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    mesh = sharding.make_mesh(n_data=1, n_space=cards)
    img = synthetic_radiograph(512, "thorax")[None]
    for over, fused, names in SPATIAL_VARIANTS.values():
        cfg = MusicaConfig(image_size=512, **over)
        got = _tup(sharding.process_sharded(img, cfg, mesh, outputs=names, fused_sdev=fused))
        g = graphs.cached_graphs()[-1]
        assert g.segments > cards and len(g.devices) == cards
        before = graphs.capture_count()
        again = _tup(sharding.process_sharded(img, cfg, mesh, outputs=names, fused_sdev=fused))
        assert graphs.capture_count() == before
        eager = _tup(sharding.process_sharded_eager(img, cfg, mesh, outputs=names,
                                                    fused_sdev=fused))
        _same(got, eager, f"{over} {fused} over {cards} cards")
        _same(again, eager, f"{over} {fused} over {cards} cards, again")
        assert torch.equal(got[0], musica.process_batch_jit(torch.from_numpy(img).to(dev), cfg,
                                                            fused))


# ----------------------------------------------------------------------
# the pyramid kernels KP1 and KP2 (csrc/pyramid.cu)
# ----------------------------------------------------------------------

def _pyramid_data(rng, shape, case, dev):
    return torch.from_numpy(pyramid_cases.adversarial(rng, shape, case)).to(dev)


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("n", [3072, 600, 144])
def test_pyramid_kernels_equal_plain_at_every_level(dev, n):
    """KP1 and KP2 in each mode (a bf16 band too) equal their plain versions
    bit for bit (-0.0 is not +0.0) at every level of an n-px ladder, on
    data with +-0, denormals and 1e30 and on constant planes (a denormal one
    too)."""
    rng = np.random.default_rng(n)
    for h in pyramid_cases.level_sizes(n):
        src = -(-h // 2)
        for case in pyramid_cases.CASES:
            x = _pyramid_data(rng, (h, h), case, dev)
            small = _pyramid_data(rng, (src, src), case, dev)
            assert _same_bits(k_pyr.smooth_downsample(x), k_pyr.smooth_downsample_plain(x)), (h, case)
            assert _same_bits(k_pyr.upsample_smooth(small, h),
                              pyramid.upsample_smooth_plain(small, h)), (h, case)
            assert _same_bits(k_pyr.upsample_subtract(x, small),
                              k_pyr.upsample_subtract_plain(x, small)), (h, case)
            for band in (x, x.to(torch.bfloat16)):
                assert _same_bits(k_pyr.upsample_add(small, band),
                                  k_pyr.upsample_add_plain(small, band)), (h, case, band.dtype)


@pytest.mark.parametrize("n,tile", [(3072, 16), (600, 16), (144, 12)])
def test_pyramid_kernels_equal_plain_on_spatial_windows(dev, n, tile):
    """KP1 and KP2 (each mode) on every row window of the spatial plan over
    4 shards, from the rows the window reads, equal the plain row-window
    versions bit for bit; some windows start on odd rows."""
    rng = np.random.default_rng(n + tile)
    wins = pyramid_cases.shard_windows(n, tile)
    assert any(r[0] % 2 for *_, r in wins)
    images = {}
    for op, h, (lo, hi), (a, b) in wins:
        if h not in images:
            src = -(-h // 2)
            images[h] = (_pyramid_data(rng, (h, h), "mixed", dev),
                         _pyramid_data(rng, (src, src), "mixed", dev))
        x, small = images[h]
        if op == "down":
            assert _same_bits(k_pyr.smooth_downsample_rows(x[lo:hi], lo, h, a, b),
                              k_pyr.smooth_downsample_rows_plain(x[lo:hi], lo, h, a, b)), (h, a)
            continue
        s = small[lo:hi]
        assert _same_bits(k_pyr.upsample_smooth_rows(s, lo, h, a, b),
                          k_pyr.upsample_rows_plain(s, lo, h, a, b)), (h, a)
        assert _same_bits(k_pyr.upsample_subtract(x[a:b], s, lo, a),
                          k_pyr.upsample_subtract_plain(x[a:b], s, lo, a)), (h, a)
        band = x[a:b].to(torch.bfloat16)
        assert _same_bits(k_pyr.upsample_add(s, band, lo, a),
                          k_pyr.upsample_add_plain(s, band, lo, a)), (h, a)


def _pyramid_counts():
    return tuple(launch.LAUNCHES[k] for k in ("pyramid_down", "pyramid_up", "pyramid_tail"))


def test_pyramid_kernels_on_the_main_path(dev):
    """At 512 (9 levels) a replay launches the fused step at 512 .. 64 px,
    one ladder tail from 32 px, one expand tail up to 32 px and an expand
    step at 64 .. 512; the intermediates path the ladder's five and an
    expand and an expand step a level; the ladder and the expand equal
    their plain versions on the thorax."""
    cfg = MusicaConfig(image_size=512)
    L = cfg.pyramid_levels
    x = torch.from_numpy(synthetic_radiograph(512, "thorax")).to(dev)
    musica.process_jit(x, cfg)
    launch.reset_launch_counts()
    musica.process_jit(x, cfg)
    torch.cuda.synchronize()
    assert _pyramid_counts() == (4, 4, 2)
    launch.reset_launch_counts()
    res = musica.musica_forward(x, cfg, want_intermediates=True)
    assert _pyramid_counts() == (4, 18, 1)
    nrm = res["intermediates"]["normalized"]
    bands, downs = pyramid.reduce_ladder(nrm, L)
    p_bands, p_downs = pyramid.reduce_ladder_plain(nrm, L)
    for got, want in zip(bands + downs, p_bands + p_downs):
        assert _same_bits(got, want)
    for b in (bands, [t.to(torch.bfloat16) for t in bands]):
        assert _same_bits(pyramid.expand_ladder(downs[-1], b),
                          pyramid.expand_ladder_plain(downs[-1], b))


@pytest.mark.parametrize("n", [3072, 600, 144])
def test_fused_step_and_tails_equal_plain_at_every_level(dev, n):
    """The fused step (reduce_step_kernel<true>) at every level of an
    n-px ladder at the expand's polyphase size, and both tails
    (pyramid_tail_kernel) from every level they hold down through 1 px and
    back (f32 and bf16 bands), equal their plain versions bit for bit on
    the adversarial inputs and constant planes."""
    rng = np.random.default_rng(n + 1)
    sizes = pyramid_cases.level_sizes(n)
    for i, h in enumerate(sizes):
        for case in pyramid_cases.CASES:
            x = _pyramid_data(rng, (h, h), case, dev)
            if pyramid.polyphase(h):
                for got, want in zip(k_pyr.reduce_step(x), k_pyr.reduce_step_plain(x)):
                    assert _same_bits(got, want), (h, case)
            if h > k_pyr.TAIL_MAX:
                continue
            levels = len(sizes) - i
            bands, downs = k_pyr.reduce_tail(x, levels)
            p_bands, p_downs = k_pyr.reduce_tail_plain(x, levels)
            for got, want in zip(bands + downs, p_bands + p_downs):
                assert _same_bits(got, want), (h, case, "ladder tail")
            top = _pyramid_data(rng, tuple(downs[-1].shape), case, dev)
            for b in (p_bands, [t.to(torch.bfloat16) for t in p_bands]):
                assert _same_bits(k_pyr.expand_tail(top, b), k_pyr.expand_tail_plain(top, b)), \
                    (h, case, "expand tail")


# sizes whose last strip (120 band columns, 60 down columns) ends 2 to 0
# columns short of, on or past a strip's edge, in both parities, and levels
# of 3072 and 600 whose runs end short of their last row
STRIP_EDGE_SIZES = [6, 7, 118, 119, 120, 121, 122, 123, 124, 125, 238, 239, 240, 241, 242, 243,
                    361, 362, 363]


def _reduce_step_rows(x, rows):
    """The fused step of x [n, n] with runs of ``rows`` down rows (the C
    entry called directly, past the wrapper's rule)."""
    n = x.shape[0]
    d = -(-n // 2)
    band = torch.empty((n, n), dtype=torch.float32, device=x.device)
    dn = torch.empty((d, d), dtype=torch.float32, device=x.device)
    rc = launch.lib().musica_reduce_step(x.data_ptr(), 0, n, n, n, dn.data_ptr(), 0, d,
                                         band.data_ptr(), rows, launch.stream(x.device))
    assert rc == 0, rc
    return band, dn


@pytest.mark.parametrize("n", STRIP_EDGE_SIZES)
def test_fused_step_equals_plain_at_strip_edges(dev, n):
    """The fused step's warp strips at sizes on and around a strip's edge
    (odd and even, their last down column a lane's first or second), from
    an aligned image and from one 4 bytes off 16-byte alignment (the scalar
    loads), and with runs of 1, 2, 3, 5 and 19 down rows (the last run
    short), equal the plain down and band bit for bit."""
    rng = np.random.default_rng(n)
    for case in ("mixed", "-0.0"):
        x = _pyramid_data(rng, (n, n), case, dev)
        want = k_pyr.reduce_step_plain(x)
        buf = torch.empty(n * n + 1, dtype=torch.float32, device=dev)
        off = buf[1:].view(n, n)
        off.copy_(x)
        assert off.data_ptr() % 16
        for got in (k_pyr.reduce_step(x), k_pyr.reduce_step(off),
                    *[_reduce_step_rows(x, r) for r in (1, 2, 3, 5, 19)]):
            for g, w in zip(got, want):
                assert _same_bits(g, w), (n, case)


@pytest.mark.parametrize("n,rows", [(3072, 19), (3072, 7), (1536, 5), (600, 4), (600, 2)])
def test_fused_step_runs_equal_plain(dev, n, rows):
    """The fused step at real level sizes with runs other than the rule's
    (the last run short of ``rows``) equals the plain step bit for bit."""
    x = _pyramid_data(np.random.default_rng(n + rows), (n, n), "mixed", dev)
    for g, w in zip(_reduce_step_rows(x, rows), k_pyr.reduce_step_plain(x)):
        assert _same_bits(g, w), (n, rows)


def test_fused_step_tally_by_strip_height(dev):
    """Each fused step counts one launch under the strip height the rule
    gives its level, eagerly and in each replay of a captured forward."""
    x = torch.rand(3072, 3072, device=dev)
    launch.reset_launch_counts()
    pyramid.reduce_ladder(x, 12)
    want = {}
    for h in pyramid_cases.level_sizes(3072)[:6]:
        key = ("reduce_step", k_pyr.strip_rows(h))
        want[key] = want.get(key, 0) + 1
    assert launch.GEOMETRY == want
    cfg = MusicaConfig(image_size=512)
    img = torch.from_numpy(synthetic_radiograph(512, "thorax")).to(dev)
    musica.process_jit(img, cfg)
    launch.reset_launch_counts()
    musica.process_jit(img, cfg)
    torch.cuda.synchronize()
    want = {}
    for h in (512, 256, 128, 64):
        key = ("reduce_step", k_pyr.strip_rows(h))
        want[key] = want.get(key, 0) + 1
    assert launch.GEOMETRY == want


def test_pyramid_kernels_on_every_card(dev):
    """On each visible card, the down step, the fused step, the expand step
    (each mode, a bf16 band too) and both tails launch on their tensors'
    card, count one launch each, and equal their plain versions on the CPU
    bit for bit, on a whole level and on a row window that starts on an odd
    row."""
    rng = np.random.default_rng(11)
    n, src, (a, b) = 600, 300, (151, 450)
    x_np = pyramid_cases.adversarial(rng, (n, n))
    s_np = pyramid_cases.adversarial(rng, (src, src))
    lo, hi = pyramid.needed_rows("upsample_smooth", n, a, b)
    dlo, dhi = pyramid.needed_rows("smooth_downsample", n, 76, 225)

    def steps(x, small):
        band = x.to(torch.bfloat16)
        tb, td = k_pyr.reduce_tail(small[:75, :75].contiguous(), 8)
        return (k_pyr.smooth_downsample(x), k_pyr.smooth_downsample_rows(x[dlo:dhi].contiguous(),
                                                                          dlo, n, 76, 225),
                k_pyr.upsample_smooth(small, n), k_pyr.upsample_subtract(x, small),
                k_pyr.upsample_add(small, band),
                k_pyr.upsample_add(small[lo:hi].contiguous(), band[a:b].contiguous(), lo, a),
                *k_pyr.reduce_step(x), *tb, *td, k_pyr.expand_tail(td[-1], tb))
    want = steps(torch.from_numpy(x_np), torch.from_numpy(s_np))
    for k in range(torch.cuda.device_count()):
        card = torch.device("cuda", k)
        launch.reset_launch_counts()
        got = steps(torch.from_numpy(x_np).to(card), torch.from_numpy(s_np).to(card))
        torch.cuda.synchronize(card)
        assert _pyramid_counts() == (3, 4, 2), k
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.device == card and _same_bits(g.cpu(), w), (k, i)


def test_pyramid_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.rand(40, 40, device=dev)
    dn = torch.rand(20, 20, device=dev)
    with pytest.raises(TypeError):
        k_pyr.smooth_downsample(x.double())
    with pytest.raises(ValueError):
        k_pyr.smooth_downsample(x.T)
    with pytest.raises(ValueError):
        k_pyr.smooth_downsample_rows(x[6:30], 6, 40, 3, 12)  # misses row 4
    with pytest.raises(TypeError):
        k_pyr.upsample_subtract(x.to(torch.bfloat16), dn)
    with pytest.raises(ValueError):
        k_pyr.upsample_smooth_rows(dn[5:15], 5, 40, 9, 26)  # misses row 4
    with pytest.raises(ValueError):
        k_pyr.reduce_step(x[:5, :5].contiguous())  # below the polyphase size
    with pytest.raises(ValueError):
        k_pyr.reduce_tail(torch.rand(161, 161, device=dev), 2)  # past 227 KB
    with pytest.raises(ValueError):
        k_pyr.expand_tail(dn, [x, x])  # a 40-px band under a 40-px one


# ----------------------------------------------------------------------
# KT, the tone map (csrc/tonemap.cu), and KS, the default path's sdev
# (sdev_kernel in csrc/sdev_noise.cu)
# ----------------------------------------------------------------------

def _tone_inputs(n, anatomy, dev, **variant):
    """(grad_input, gpx, gpy) of a phantom's forward on the card."""
    cfg = MusicaConfig(image_size=n, **variant)
    res = musica.musica_forward(torch.from_numpy(synthetic_radiograph(n, anatomy)).to(dev), cfg,
                                want_intermediates=True)
    gpx, gpy, _ = res["intermediates"]["grad_curve"]
    return res["intermediates"].get("linear", res["recon"]), gpx, gpy


def _tone_cases(rng, n, dev):
    """(name, x, gpx, gpy): the main path's and the linear gradation's real
    curves on their images, and the adversarial curves on images that hit
    every knot, its neighbours and the special values."""
    out = [("main",) + _tone_inputs(n, "thorax", dev),
           ("linear",) + _tone_inputs(n, "pelvis", dev, grad_with_linear_image=True)]
    for name, (px, py) in tone_cases.adversarial_curves(rng).items():
        x = torch.from_numpy(tone_cases.image(rng, (n, n), px)).to(dev)
        out.append((name, x, torch.from_numpy(px).to(dev), torch.from_numpy(py).to(dev)))
    return out


def _same_tone(got, want, what, nan_bits=True):
    """graded bit for bit (NaN where it has NaN; with ``nan_bits`` the NaN's
    bits too: the CPU makes 0xffc00000 where the card makes 0x7fffffff) and
    out_u8 equal."""
    g, w = got[0], want[0]
    if nan_bits:
        assert _same_bits(g, w), f"{what}: graded"
    else:
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(g), nan), f"{what}: graded NaN"
        assert _same_bits(g[~nan], w[~nan]), f"{what}: graded"
    assert got[1].dtype == torch.uint8 and torch.equal(got[1], want[1]), f"{what}: out_u8"


@pytest.mark.parametrize("n", [3072, 600, 144])
def test_tone_map_kernel_equals_plain(dev, n):
    """KT against the plain chain on the card and on the CPU, bit for bit
    (graded with its NaN, out_u8), on the real gradation curves and the
    adversarial ones; the tables its first block builds equal
    curves.general_tables bit for bit; one launch a call."""
    rng = np.random.default_rng(n)
    for name, x, gpx, gpy in _tone_cases(rng, n, dev):
        launch.reset_launch_counts()
        got = k_tone.tone_map(x, gpx, gpy, 10)
        assert launch.LAUNCHES["tone_map"] == 1
        _same_tone(got, k_tone.tone_map_plain(x, gpx, gpy, 10), f"{n} {name}")
        cpu = k_tone.tone_map_plain(x.cpu(), gpx.cpu(), gpy.cpu(), 10)
        _same_tone([t.cpu() for t in got], cpu, f"{n} {name} vs the CPU", nan_bits=False)
        g, o, tab = k_tone.tone_tables(x, gpx, gpy, 10)
        _same_tone((g, o), got, f"{n} {name}, with its tables")
        want = curves.general_tables(gpx, gpy)
        k = gpx.shape[0]
        for j, w in enumerate(want):
            assert _same_bits(tab[j, :w.shape[0]].contiguous(), w), (n, name, j)
        assert got[1].shape == (n - 20, n - 20)


@pytest.mark.parametrize("n,space", [(3072, 4), (600, 4), (600, 2), (144, 2), (144, 3)])
def test_tone_map_kernel_on_windows(dev, n, space):
    """KT on every shard's rows of a plan over ``space`` shards and on
    windows that start on odd rows and inside the margins: each equals the
    plain version's window, and the windows put together equal the whole
    image's graded and out_u8."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    rng = np.random.default_rng(n + space)
    cfg = MusicaConfig(image_size=n)
    plan = spatial.row_plan(n, space, cfg)
    cuts = {"plan": list(plan.bounds[0]), "odd": [0, 5, 11, n // 2 + 1, n - 9, n]}
    for name, x, gpx, gpy in _tone_cases(rng, n, dev)[:4]:
        whole = k_tone.tone_map(x, gpx, gpy, 10)
        for kind, bounds in cuts.items():
            parts = [k_tone.tone_map(x[a:b], gpx, gpy, 10, a) for a, b in zip(bounds, bounds[1:])]
            for (a, b), got in zip(zip(bounds, bounds[1:]), parts):
                _same_tone(got, k_tone.tone_map_plain(x[a:b], gpx, gpy, 10, a),
                           f"{n} {name} {kind} rows [{a}, {b})")
            _same_tone((torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])),
                       whole, f"{n} {name} {kind} windows together")


def _sdev_windows(plan, bands, levels, i):
    rows = [plan.rows(k, i) if k < plan.replicated else (0, plan.sizes[k]) for k in levels]
    need = [pyramid.needed_rows("img_sdev", b.shape[-1], *r) for b, r in zip(bands, rows)]
    return [b[lo:hi] for b, (lo, hi) in zip(bands, need)], [lo for lo, _ in need], rows


@pytest.mark.parametrize("size,source", [(3072, "thorax"), (600, "pelvis"), (144, "hand"),
                                         (600, "random"), (144, "random")])
def test_sdev_kernel_equals_img_sdev(dev, size, source):
    """KS over every analysis level in one launch equals img_sdev a level on
    the card and on the CPU bit for bit, and K7's sdev; also with a few
    blocks whose task ranges cross levels, and on every shard's windows of
    a 4-shard plan, 3 at 144 (img_sdev_rows, the whole image's rows)."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    cfg = MusicaConfig(image_size=size, quirks=size != 144)
    lv = list(cfg.analysis_levels)
    if source == "random":
        bands = _random_bands(size, [-(-size // 2 ** i) for i in lv], dev)
    else:
        bands = _bands(synthetic_radiograph(size, source), cfg, dev)
    want = [stats.img_sdev(b) for b in bands]
    k7 = fh.sdev_noise_hists(bands, cfg)[0]
    for grid in (0, 3):
        launch.reset_launch_counts()
        got = fh.sdevs(bands, grid=grid)
        assert launch.LAUNCHES["sdev"] == 1 and launch.LAUNCHES["sdev_noise_hist"] == 0
        for g, w, s7, b in zip(got, want, k7, bands):
            assert _same_bits(g, w) and _same_bits(g, s7), (size, source, grid)
            assert _same_bits(g.cpu(), stats.img_sdev(b.cpu()))
    space = 4 if size > 144 else 3  # 144 holds no 4 shards of whole 16-px tiles
    plan = spatial.row_plan(size, space, cfg)
    for i in range(space):
        wins, los, rows = _sdev_windows(plan, bands, lv, i)
        got = fh.sdevs_rows(wins, los, rows)
        for g, w, p, (r0, r1) in zip(got, want, fh.sdevs_rows_plain(wins, los, rows), rows):
            assert _same_bits(g, p) and _same_bits(g, w[r0:r1].contiguous()), (size, i)


def _same_nan_bits(g, w):
    """float32 bit for bit where w is a number, NaN where w is NaN."""
    nan = torch.isnan(w)
    return bool(torch.equal(torch.isnan(g), nan)
                and torch.equal(g[~nan].view(torch.int32), w[~nan].view(torch.int32)))


def test_sdev_tail_equals_the_plain_chain(dev):
    """KS's and K7's per-output tail (sdev_tail_kernel: div25 and
    sqrt_to_f32) equals torch.sqrt(s / 25).to(float32) on the card bit for
    bit, NaN where it has NaN, on the adversarial sums of
    testing/sdev_cases.py and on a million random doubles; one launch a
    call."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import sdev_cases
    rng = np.random.default_rng(15)
    for what, s in (("adversarial", sdev_cases.adversarial_sums(rng)),
                    ("random", sdev_cases.random_doubles(rng, 1 << 20))):
        t = torch.from_numpy(s).to(dev)
        launch.reset_launch_counts()
        got = fh.sdev_tail(t)
        assert launch.LAUNCHES["sdev_tail"] == 1
        assert _same_nan_bits(got, fh.sdev_tail_plain(t)), what


def test_sdev_tail_rsqrt_start_is_within_the_proofs_bound(dev):
    """rsqrt.approx.ftz.f64, where sqrt_to_f32 starts, has a relative error
    below 2^-16 (the proof's requirement) on every significand its high
    word holds (both exponent parities, low word 0 and all ones) and on
    random q over the tail's range."""
    hi = np.arange(1 << 20, dtype=np.int64)
    q = np.concatenate([((e << 52) | (hi << 32) | low).view(np.float64)
                        for e in (1022, 1023) for low in (0, 0xffffffff)])
    rng = np.random.default_rng(16)
    q = np.concatenate([q, np.exp2(rng.uniform(-245.0, 236.0, 1 << 20))])
    t = torch.from_numpy(q).to(dev)
    err = (fh.sdev_tail_rsqrt(t) * torch.sqrt(t) - 1.0).abs().max().item()
    assert err < 2.0 ** -16, err


@pytest.mark.parametrize("n,space", [(600, 4), (600, 2), (144, 2)])
def test_tone_map_kernel_search_and_chain_on_windows(dev, n, space):
    """KT on a strictly increasing curve (the binary search) and on a folded
    one (the chain), whole and on every shard's rows of a plan over
    ``space`` shards: each window equals the plain version's, and the
    windows put together equal the whole image's."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    rng = np.random.default_rng(n * space)
    curves_ = tone_cases.adversarial_curves(np.random.default_rng(0))
    bounds = list(spatial.row_plan(n, space, MusicaConfig(image_size=n)).bounds[0])
    for name in ("increasing 22", "fold-back"):
        px, py = (torch.from_numpy(a).to(dev) for a in curves_[name])
        x = torch.from_numpy(tone_cases.image(rng, (n, n), curves_[name][0])).to(dev)
        whole = k_tone.tone_map(x, px, py, 10)
        _same_tone(whole, k_tone.tone_map_plain(x, px, py, 10), f"{n} {name}")
        parts = [k_tone.tone_map(x[a:b], px, py, 10, a) for a, b in zip(bounds, bounds[1:])]
        for (a, b), got in zip(zip(bounds, bounds[1:]), parts):
            _same_tone(got, k_tone.tone_map_plain(x[a:b], px, py, 10, a), f"{n} {name} [{a}, {b})")
        _same_tone((torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])), whole,
                   f"{n} {name} windows together")


def test_tone_map_and_sdev_on_every_card(dev):
    """On each visible card KT (whole and a window) and KS (whole and a
    window) launch on their tensors' card, count one launch each and equal
    their plain versions on the CPU bit for bit."""
    rng = np.random.default_rng(5)
    px, py = tone_cases.adversarial_curves(rng)["fold-back"]
    x = tone_cases.image(rng, (600, 600), px)
    band = rng.normal(0.0, 0.03, (600, 600)).astype(np.float32)

    def run(t, cpx, cpy, b, small):
        return (*k_tone.tone_map(t, cpx, cpy, 10), *k_tone.tone_map(t[151:450], cpx, cpy, 10, 151),
                *fh.sdevs([b, small]), *fh.sdevs_rows([b[149:452]], [149], [(151, 450)]))
    cpu = [torch.from_numpy(a) for a in (x, px, py, band, band[:75, :75].copy())]
    want = run(*cpu)
    for k in range(torch.cuda.device_count()):
        card = torch.device("cuda", k)
        launch.reset_launch_counts()
        got = run(*[t.to(card) for t in cpu])
        torch.cuda.synchronize(card)
        assert (launch.LAUNCHES["tone_map"], launch.LAUNCHES["sdev"]) == (2, 2), k
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.device == card, (k, i)
            assert (torch.equal(g.cpu(), w) if w.dtype == torch.uint8
                    else _same_bits(g.cpu(), w)), (k, i)


def test_tone_map_and_sdev_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.rand(40, 40, device=dev)
    px = torch.linspace(0, 1, 22, device=dev)
    with pytest.raises(TypeError):
        k_tone.tone_map(x.double(), px, px, 10)
    with pytest.raises(ValueError):
        k_tone.tone_map(x.T, px, px, 10)
    with pytest.raises(ValueError):
        k_tone.tone_map(x, px.double(), px, 10)
    with pytest.raises(ValueError):
        k_tone.tone_map(x, torch.rand(64, device=dev), torch.rand(64, device=dev), 10)
    with pytest.raises(ValueError):
        k_tone.tone_map(x, px, px, 20)  # no column left after the crop
    with pytest.raises(ValueError):
        k_tone.tone_map(x[30:], px, px, 10, 35)  # rows past the image
    with pytest.raises(ValueError, match="window holds"):
        fh.sdevs_rows([x[4:20]], [4], [(4, 20)])  # misses rows 2 and 3
    with pytest.raises(TypeError):
        fh.sdevs([x.double()])


# ----------------------------------------------------------------------
# KA, the contrast stage (csrc/contrast_apply.cu)
# ----------------------------------------------------------------------

def _contrast_inputs(n, anatomy, dev, storage="float32"):
    """(cfg, bands, sdevs, max bins, cnr) of the port's forward at n px."""
    tile = 16 if n > 144 else 12
    cfg = MusicaConfig(image_size=n, quirks=n > 144, histogram_area_size=tile, storage=storage)
    res = musica.musica_forward(torch.from_numpy(synthetic_radiograph(n, anatomy)).to(dev), cfg,
                                want_intermediates=True)
    it = res["intermediates"]
    return (cfg, [it[f"red_bandpass_{k}"] for k in range(cfg.pyramid_levels)],
            {k: it[f"sdev_{k}"] for k in cfg.analysis_levels},
            {k: it[f"noise_max_bin_{k}"] for k in cfg.analysis_levels}, res["cnr"])


def _odd(t, seed, values=(np.nan, np.inf, -np.inf, 1e-40, 1e-45, 3e38, 0.0, -0.0)):
    """``t`` with a few pixels set to each of ``values``."""
    rng = np.random.default_rng(seed)
    t = t.clone().reshape(-1)
    at = torch.from_numpy(rng.choice(t.numel(), min(t.numel(), 3 * len(values)),
                                     replace=False)).to(t.device)
    t[at] = torch.tensor(np.resize(np.array(values, np.float32), at.numel()),
                         device=t.device).to(t.dtype)
    return t


def _same_band(got, want, what):
    """float32 or bf16 bands equal bit for bit, NaN where the other has NaN."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    g, w = got.float(), want.float()
    nan = torch.isnan(w)
    assert torch.equal(torch.isnan(g), nan), what
    assert torch.equal(g[~nan].view(torch.int32), w[~nan].view(torch.int32)), what


def _same_stage(got, want, what):
    for k, (g, w) in enumerate(zip(got[0], want[0])):
        _same_band(g, w, f"{what}: the expand's band {k}")
    assert set(got[1]) == set(want[1]), what
    for key, w in want[1].items():
        if key.startswith("contrast_curve"):
            for g_, w_ in zip(got[1][key], w):
                assert torch.equal(g_.view(torch.int32), w_.view(torch.int32)), (what, key)
        else:
            _same_band(got[1][key], w, f"{what}: {key}")


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,anatomy", [(3072, "thorax"), (600, "pelvis"), (144, "hand")])
def test_contrast_kernel_equals_plain(dev, n, anatomy, storage):
    """KA equals contrast_apply_plain on the card bit for bit (NaN masks
    equal), with and without intermediates, on the forward's inputs and
    with NaN, +-inf, denormal and huge bands, sdevs and CNR cells; one
    launch a call."""
    cfg, bands, sdevs, mbs, cnr = _contrast_inputs(n, anatomy, dev, storage)
    odd = ([_odd(b, k).reshape(b.shape) for k, b in enumerate(bands)],
           {k: _odd(s, 20 + k).reshape(s.shape) for k, s in sdevs.items()},
           _odd(cnr, 40).reshape(cnr.shape))
    for what, (b, sd, cn) in (("forward", (bands, sdevs, cnr)), ("odd values", odd)):
        for inter in (False, True):
            cnrs = {k: (cn, 0) for k in k_ka.nr_levels(cfg, inter)}
            launch.reset_launch_counts()
            got = k_ka.contrast_apply(b, sd, mbs, cnrs, cfg, intermediates=inter)
            assert launch.LAUNCHES["contrast_apply"] == 1
            _same_stage(got, k_ka.contrast_apply_plain(b, sd, mbs, cnrs, cfg, intermediates=inter),
                        f"{n} {storage} {what}, intermediates {inter}")
            cpu = k_ka.contrast_apply_plain([t.cpu() for t in b], {k: t.cpu() for k, t in sd.items()},
                                            {k: t.cpu() for k, t in mbs.items()},
                                            {k: (c.cpu(), r) for k, (c, r) in cnrs.items()}, cfg,
                                            intermediates=inter)
            for k, (g, w) in enumerate(zip(got[0], cpu[0])):
                nan = torch.isnan(w.float())
                assert torch.equal(torch.isnan(g.cpu().float()), nan), (n, storage, what, k)
                assert torch.equal(g.cpu().float()[~nan], w.float()[~nan]), (n, storage, what, k)


def test_contrast_tables_at_every_max_bin(dev):
    """The curves KA's blocks build equal curves.contrast_curve and its
    slopes at all 2,048 max bins."""
    cfg = MusicaConfig(image_size=3072)
    L = cfg.pyramid_levels
    one = [torch.zeros((1, 8), device=dev) for _ in range(L)]
    sd = {k: one[k] for k in cfg.analysis_levels}
    cnrs = {k: (torch.zeros((1, 1), device=dev), 0) for k in k_ka.nr_levels(cfg, False)}
    for mb in range(cfg.noise_histogram_bins):
        t = torch.tensor(mb, dtype=torch.int32, device=dev)
        _, _, tab = k_ka.contrast_tables(one, sd, {k: t for k in cfg.analysis_levels}, cnrs, cfg)
        for k, (lcf, hcf) in enumerate(cfg.contrast_factors):
            if mb and lcf == 1.0:
                continue
            px, py = curves.contrast_curve(t, lcf, hcf, cfg)
            for j, w in enumerate((px, py, (py[1:] - py[:-1]) / (px[1:] - px[:-1]))):
                got = tab[k, j, :w.shape[0]].contiguous()
                assert torch.equal(got.view(torch.int32), w.view(torch.int32)), (mb, k, j)


@pytest.mark.parametrize("n,space", [(3072, 4), (600, 4), (600, 2), (144, 2), (144, 4)])
def test_contrast_kernel_on_windows(dev, n, space):
    """Every shard's rows of the spatial plan: KA equals its plain version
    and the whole stage's rows, in float32 and bf16."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    for storage in ("float32", "bfloat16"):
        cfg, bands, sdevs, mbs, cnr = _contrast_inputs(n, "knee", dev, storage)
        nrl = k_ka.nr_levels(cfg, False)
        whole = k_ka.contrast_apply(bands, sdevs, mbs, {k: (cnr, 0) for k in nrl}, cfg)[0]
        plan = spatial.row_plan(n, space, cfg)
        for i in range(space):
            rows = [plan.rows(k, i) if k < plan.replicated else (0, plan.sizes[k])
                    for k in range(cfg.pyramid_levels)]
            cnrs = {}
            for k in nrl:
                lo, hi = noise.cnr_rows(cnr.shape[-1], plan.sizes[k], *rows[k])
                cnrs[k] = (cnr[lo:hi], lo)
            wb = [b[r0:r1] for b, (r0, r1) in zip(bands, rows)]
            ws = {k: sdevs[k][r0:r1] for k, (r0, r1) in enumerate(rows) if k in sdevs}
            r0s = [r0 for r0, _ in rows]
            got = k_ka.contrast_apply(wb, ws, mbs, cnrs, cfg, r0s)[0]
            want = k_ka.contrast_apply_plain(wb, ws, mbs, cnrs, cfg, r0s)[0]
            for k, (r0, r1) in enumerate(rows):
                _same_band(got[k], want[k], f"{n} {storage} shard {i}, level {k}")
                _same_band(got[k], whole[k][r0:r1], f"{n} {storage} shard {i}, level {k} whole")


def test_contrast_wrapper_rejects_what_the_kernel_does_not_take(dev):
    cfg, bands, sdevs, mbs, cnr = _contrast_inputs(144, "hand", dev)
    cnrs = {k: (cnr, 0) for k in k_ka.nr_levels(cfg, False)}
    with pytest.raises(ValueError):
        k_ka.contrast_apply([bands[0].cpu(), *bands[1:]], sdevs, mbs, cnrs, cfg)  # two devices
    with pytest.raises(TypeError):
        k_ka.contrast_apply([b.double() for b in bands], sdevs, mbs, cnrs, cfg)
    with pytest.raises(ValueError):
        k_ka.contrast_apply([bands[0].T, *bands[1:]], sdevs, mbs, cnrs, cfg)
    with pytest.raises(ValueError):
        k_ka.contrast_apply(bands, sdevs, mbs, {0: (cnr[:1], 0), 1: cnrs[1]}, cfg)
    with pytest.raises(ValueError):
        k_ka.contrast_apply(bands * 2, sdevs, mbs, cnrs, cfg)


def test_contrast_kernel_on_every_card(dev):
    """KA on each visible card's tensors equals its plain version there."""
    for i in range(torch.cuda.device_count()):
        d = torch.device(f"cuda:{i}")
        cfg, bands, sdevs, mbs, cnr = _contrast_inputs(600, "pelvis", d)
        cnrs = {k: (cnr, 0) for k in k_ka.nr_levels(cfg, True)}
        _same_stage(k_ka.contrast_apply(bands, sdevs, mbs, cnrs, cfg, intermediates=True),
                    k_ka.contrast_apply_plain(bands, sdevs, mbs, cnrs, cfg, intermediates=True),
                    f"cuda:{i}")


# ----------------------------------------------------------------------
# KN (normalize) and KG (the gradation curve)
# ----------------------------------------------------------------------

def _norm_images():
    """[3i]'s cases at small sizes: name -> integer image."""
    rng = np.random.default_rng(31)
    v = np.arange(65536, dtype=np.uint16)
    return {"600 pelvis": synthetic_radiograph(600, "pelvis"),
            "144 hand": synthetic_radiograph(144, "hand"),
            "512 thorax (aligned chain)": synthetic_radiograph(512, "thorax"),
            "256 all values": rng.permutation(v).reshape(256, 256),
            "512 constant": np.full((512, 512), 5000, np.uint16),
            "600 constant": np.full((600, 600), 5000, np.uint16),
            "512 zero": np.zeros((512, 512), np.uint16),
            "75 random": rng.integers(0, 65536, (75, 75)).astype(np.uint16),
            "144 int32": rng.integers(0, 2 ** 31, (144, 144)).astype(np.int32),
            "144 int32 negative": rng.integers(-2 ** 31, 2 ** 31, (144, 144)).astype(np.int32)}


def _same_norm(got, want, what):
    for part, g, w in zip(("image", "vmax", "vmin"), got, want):
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(g), nan), (what, part)
        assert torch.equal(g[~nan].view(torch.int32), w[~nan].view(torch.int32)), (what, part)


@pytest.mark.parametrize("quirks", [True, False])
@pytest.mark.parametrize("name", sorted(_norm_images()))
def test_normalize_kernel_matches_plain(dev, name, quirks):
    x = torch.from_numpy(_norm_images()[name]).to(dev)
    launch.reset_launch_counts()
    got = normalize.normalize_from_u16(x, quirks)
    assert launch.LAUNCHES["normalize"] == 2
    _same_norm(got, normalize.normalize_from_u16_plain(x, quirks), name)


def test_normalize_kernel_at_an_odd_address_and_its_root(dev):
    """An input 2 bytes past a 16-byte boundary (the pixel-a-thread path);
    the root alone over all 65,536 values (extrema 1 and 0 on a 512-wide
    window) equals NumPy's float32 sqrt."""
    flat = torch.from_numpy(synthetic_radiograph(600, "pelvis")).reshape(-1).to(dev)
    buf = torch.empty(flat.numel() + 1, dtype=torch.uint16, device=dev)
    buf[1:] = flat
    x = buf[1:].view(600, 600)
    assert x.data_ptr() % 16 == 2
    for quirks in (True, False):
        _same_norm(normalize.normalize_from_u16(x, quirks),
                   normalize.normalize_from_u16_plain(x, quirks), f"odd address {quirks}")
    v = torch.from_numpy(np.arange(65536, dtype=np.uint16).reshape(128, 512)).to(dev)
    one, zero = torch.ones((), device=dev), torch.zeros((), device=dev)
    got = normalize.normalize_from_u16(v, True, extrema=(one, zero))[0].cpu().numpy()
    want = np.sqrt(np.arange(65536, dtype=np.float32)).reshape(128, 512)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n,space", [(600, 4), (600, 2), (144, 4)])
def test_normalize_windows_match_plain_and_the_whole(dev, n, space):
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
    cfg = MusicaConfig(image_size=n, histogram_area_size=16 if n > 144 else 12)
    x = torch.from_numpy(synthetic_radiograph(n, "pelvis")).to(dev)
    bounds = spatial.row_plan(n, space, cfg).bounds[0]
    q = torch.cat([normalize.extrema_partials(x[a:b]) for a, b in zip(bounds, bounds[1:])])
    ext = (q[:, 0].amax(), q[:, 1].amin())
    xf = x.to(torch.float32)
    assert float(ext[0]) == float(xf.amax()) and float(ext[1]) == float(xf.amin())
    for quirks in (True, False):
        whole = normalize.normalize_from_u16(x, quirks)[0]
        for a, b in zip(bounds, bounds[1:]):
            got = normalize.normalize_from_u16(x[a:b], quirks, extrema=ext)
            _same_norm(got, normalize.normalize_from_u16_plain(x[a:b], quirks, extrema=ext),
                       (a, b, quirks))
            _same_norm(got[:1], (whole[a:b],), (a, b, quirks, "whole"))


def _curve_bits(curve):
    px, py, t = curve
    return torch.cat([px, py, torch.stack(list(t))]).cpu().view(torch.int32)


def test_gradation_curve_kernel_matches_plain(dev):
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import gradation
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import grad_cases
    cfg = MusicaConfig(image_size=512)
    hists = {k: torch.from_numpy(h).to(dev) for k, (h, _) in grad_cases.cases().items()}
    for n, anatomy in ((512, "thorax"), (256, "hand")):
        c = MusicaConfig(image_size=n)
        x = torch.from_numpy(synthetic_radiograph(n, anatomy)).to(dev)
        for name, cc in (("main", c), ("CLAHE + linear",
                                       c.with_(enable_clahe=True, grad_with_linear_image=True))):
            res = musica.musica_forward(x, cc, want_intermediates=True)
            hists[f"{n} {anatomy} {name}"] = res["intermediates"]["grad_hist"]
    for name, h in hists.items():
        launch.reset_launch_counts()
        got = gradation.gradation_curve(h, cfg)
        assert launch.LAUNCHES["gradation_curve"] == 1
        want = _curve_bits(gradation.gradation_curve_plain(h, cfg))
        assert torch.equal(_curve_bits(got), want), name
        assert torch.equal(_curve_bits(gradation.gradation_curve_plain(h.cpu(), cfg)), want), name


def test_forward_launches_normalize_twice_and_the_curve_once(dev):
    cfg = MusicaConfig(image_size=256)
    x = torch.from_numpy(synthetic_radiograph(256, "hand")).to(dev)
    musica.musica_forward(x, cfg)  # build the kernels first
    launch.reset_launch_counts()
    out = musica.musica_forward(x, cfg)["out_u8"]
    torch.cuda.synchronize()
    assert launch.LAUNCHES["normalize"] == 2 and launch.LAUNCHES["gradation_curve"] == 1
    assert torch.equal(out.cpu(), musica.musica_forward(x.cpu(), cfg)["out_u8"])


# ----------------------------------------------------------------------
# the relevance mask inside the kernels: K3's block weights, KH, KC
# ----------------------------------------------------------------------

def _dense_inputs(n, k=5.0, border=20, tiles=4, seed=0):
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import relevance_cases
    cfg = MusicaConfig(image_size=n, relevant_k=k, relevant_border=border, enable_clahe=True,
                       clahe_tiles=tiles)
    rng = np.random.default_rng(seed + n)
    return (cfg, relevance_cases.clahe_recon(rng, n, cfg.clahe_bins),
            hist_cases.gradation_image(rng, n), relevance_cases.pixel_tests(rng, n, cfg),
            relevance_cases.dense_cnr(rng, cfg, -(-n // 8)))


@pytest.mark.parametrize("n,k", [(512, 5.0), (144, 5.0), (512, 4.5), (256, 1.0)])
def test_k3_block_weights_in_the_kernel_match_the_plane_and_plain(dev, n, k):
    """K3 computes each CNR block's weight from the CNR map (integer k) or
    reads the weight plane (4.5); either equals the other route and the
    plain version, whole and on every window, on dense CNR values."""
    cfg, _, recon, nrm, cnr = _dense_inputs(n, k)
    recon, nrm, cnr = (torch.from_numpy(a).to(dev) for a in (recon, nrm, cnr))
    launch.reset_launch_counts()
    whole = fh.grad_hist_relevant(recon, nrm, cnr, cfg)
    assert launch.LAUNCHES["grad_hist_relevant"] == 1
    assert torch.equal(whole, fh.grad_hist_relevant_plain(recon, nrm, cnr, cfg))
    assert torch.equal(whole, fh._launch_grad_hist_relevant(recon, nrm, cnr, cfg, 0, 0, 0))
    assert torch.equal(whole.cpu(), fh.grad_hist_relevant_plain(recon.cpu(), nrm.cpu(),
                                                                cnr.cpu(), cfg))
    total = torch.zeros_like(whole)
    bounds = list(range(0, n, 48)) + [n]
    for a, b in zip(bounds, bounds[1:]):
        c0, c1 = noise.cnr_rows(cnr.shape[-1], n, a, b)
        got = fh.grad_hist_relevant(recon[a:b], nrm[a:b], cnr[c0:c1], cfg, a, c0)
        assert torch.equal(got, fh.grad_hist_relevant_plain(recon[a:b], nrm[a:b], cnr[c0:c1],
                                                            cfg, a, c0)), (a, b)
        total += got
    assert torch.equal(total, whole)


@pytest.mark.parametrize("n,tiles,k", [(512, 4, 5.0), (600, 8, 5.0), (144, 4, 5.0),
                                       (256, 8, 4.5)])
def test_clahe_hist_kernel_matches_plain(dev, n, tiles, k):
    """KH equals its plain version (the relevance image, then the joint
    histogram) on adversarial recon (bin edges +-1 ulp, NaN, +-inf,
    negatives), normalized at max_pixel +-1 ulp and dense CNR values, whole
    (at 4.5 through the weight plane), on windows starting on odd rows
    (summing to the whole), and on the CPU."""
    cfg, recon, _, nrm, cnr = _dense_inputs(n, k, tiles=tiles)
    recon, nrm, cnr = (torch.from_numpy(a).to(dev) for a in (recon, nrm, cnr))
    launch.reset_launch_counts()
    whole = kh_mod().clahe_hist(recon, nrm, cnr, cfg)
    assert launch.LAUNCHES["clahe_hist"] == 1 and launch.LAUNCHES["histogram"] == 0
    assert torch.equal(whole, kh_mod().clahe_hist_plain(recon, nrm, cnr, cfg))
    assert torch.equal(whole.cpu(), kh_mod().clahe_hist_plain(recon.cpu(), nrm.cpu(), cnr.cpu(),
                                                              cfg))
    assert int(whole.sum()) > 0
    total = torch.zeros_like(whole)
    b = _odd_bounds(n, 4)
    for r0, r1 in zip(b, b[1:]):
        c0, c1 = noise.cnr_rows(cnr.shape[-1], n, r0, r1)
        got = kh_mod().clahe_hist(recon[r0:r1], nrm[r0:r1], cnr[c0:c1], cfg, r0, c0)
        assert torch.equal(got, kh_mod().clahe_hist_plain(recon[r0:r1], nrm[r0:r1],
                                                          cnr[c0:c1], cfg, r0, c0)), (r0, r1)
        total += got
    assert torch.equal(total, whole)


def kh_mod():
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import clahe_hist
    return clahe_hist


@pytest.mark.parametrize("tiles,bins", [(4, 256), (8, 256), (4, 64), (2, 1000)])
def test_clahe_curves_kernel_matches_plain(dev, tiles, bins):
    """KC equals ``clahe_curves_plain`` bit for bit with equal NaN masks (empty
    tiles), on random histograms, on the card and against the CPU."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import relevance_cases
    cfg = MusicaConfig(image_size=512, enable_clahe=True, clahe_tiles=tiles, clahe_bins=bins)
    rng = np.random.default_rng(tiles * bins)
    nan_tiles = 0
    for _ in range(16):
        h = torch.from_numpy(relevance_cases.random_clahe_hists(rng, cfg)).to(dev)
        launch.reset_launch_counts()
        px, py = clahe.clahe_curves(h, cfg)
        assert launch.LAUNCHES["clahe_curves"] == 1
        for want in (clahe.clahe_curves_plain(h, cfg), clahe.clahe_curves_plain(h.cpu(), cfg)):
            assert torch.equal(px.cpu().view(torch.int32), want[0].cpu().view(torch.int32))
            torch.testing.assert_close(py.cpu(), want[1].cpu(), rtol=0, atol=0, equal_nan=True)
        nan_tiles += int(torch.isnan(py).all(dim=-1).sum())
    assert nan_tiles > 0


def _kernel_names(fn, pad=64):
    """The CUDA kernels one call of ``fn`` launches (the profiler's events,
    fills included).  The profiler may drop the first events of a record,
    so each record begins with ``pad`` spin kernels and counts only if it
    kept one of them; the names are those two counted records agree on."""
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                torch.cuda._sleep(20_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith(("Memcpy", "Memset"))]
        if not any("spin_kernel" in nm for nm in names):
            continue
        names = sorted(nm for nm in names if "spin_kernel" not in nm)
        if names in seen:
            return names
        seen.append(names)
    raise AssertionError(f"no two counted records agree: {seen}")


def test_relevance_wrappers_launch_no_plain_ops(dev):
    """Without a relevance image, K3 (integer k), KH and KC each launch
    their kernel and at most the zeroing of their output: none of the weight
    plane's or the relevance image's ops."""
    cfg, recon, _, nrm, cnr = _dense_inputs(512)
    recon, nrm, cnr = (torch.from_numpy(a).to(dev) for a in (recon, nrm, cnr))
    h = kh_mod().clahe_hist(recon, nrm, cnr, cfg)
    for fn, kernel in ((lambda: fh.grad_hist_relevant(recon, nrm, cnr, cfg), "grad_hist_kernel"),
                       (lambda: kh_mod().clahe_hist(recon, nrm, cnr, cfg), "clahe_hist_kernel"),
                       (lambda: clahe.clahe_curves(h, cfg), "clahe_curves_kernel")):
        names = _kernel_names(fn)
        mine = [nm for nm in names if kernel in nm]
        assert len(mine) == 1 and len(names) - 1 <= 1, names  # the kernel, a fill at most


@pytest.mark.parametrize("variant", ["main", "clahe_linear", "fused_sdev", "bf16"])
def test_forward_launch_counts_of_every_path(dev, variant):
    """One eager forward at 512 launches K3 once (no K4, no K6), and with
    CLAHE KH, KC and K5 once each."""
    kw, fused = {"main": ({}, False), "clahe_linear": (dict(enable_clahe=True,
                                                           grad_with_linear_image=True), False),
                 "fused_sdev": ({}, True), "bf16": (dict(storage="bfloat16"), False)}[variant]
    cfg = MusicaConfig(image_size=512, relevant_border=20, **kw)
    x = torch.from_numpy(synthetic_radiograph(512, "thorax")).to(dev)
    musica.musica_forward(x, cfg, fused_sdev=fused)
    launch.reset_launch_counts()
    res = musica.musica_forward(x, cfg, fused_sdev=fused)
    torch.cuda.synchronize()
    c = dict(launch.LAUNCHES)
    assert c["grad_hist_relevant"] == 1 and c["grad_hist"] == c["histogram"] == 0, c
    n_clahe = 1 if cfg.enable_clahe else 0
    assert c["clahe_hist"] == c["clahe_curves"] == c["clahe_apply"] == n_clahe, c
    ref = musica.musica_forward(x.cpu(), cfg, fused_sdev=fused)
    assert torch.equal(res["out_u8"].cpu(), ref["out_u8"])
