"""The PyTorch port's spatial path (``parallel/spatial.py``: one image's rows
split over the ``space`` entries of a mesh row, halo exchanges and
histogram all-reduces written out) on the CPU, with mesh entries that are
all the CPU device (what is held is the split, the halos, the all-reduces
and the gather).

Each case of the JAX package's spatial tests (``tests/test_sharding.py``)
equals the port's unsharded ``forward_batch`` bit for bit and meets the
parity bar against the JAX package's unsharded ``process_batch_jit(...,
"fact")``; the 256 case is also held against the JAX package's own spatial
``process_sharded`` on its 2 x 4 virtual CPU mesh.  The row-window ops
equal slices of the whole-image ops bit for bit, and the plain versions of
the windowed kernels (K1, K3, K4) summed over a plan's windows equal the
whole-image histograms, K2's plain argmax on the sum the whole image's
first-max bins."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig as JConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica as j_musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.parallel import sharding as j_sharding
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import (
    noise, normalize, pyramid, stats)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import (
    sharding, spatial)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import hist_cases
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
    synthetic_radiograph)

from test_torch_pipeline import assert_u8_parity

torch.set_num_threads(2)

CPU = torch.device("cpu")


def cpu_mesh(n_data, n_space):
    return sharding.make_mesh(n_data=n_data, n_space=n_space, devices=[CPU] * (n_data * n_space))


def phantoms(size, anatomies):
    return np.stack([synthetic_radiograph(size, a) for a in anatomies])


@functools.lru_cache(maxsize=None)
def jax_unsharded(size, anatomies, **kw):
    """The JAX package's unsharded ``process_batch_jit(..., "fact")``."""
    imgs = jnp.asarray(phantoms(size, anatomies))
    return np.asarray(j_musica.process_batch_jit(imgs, JConfig(image_size=size, **kw), "fact"))


# the JAX package's six spatial tests (tests/test_sharding.py), at their
# sizes, meshes, configurations and phantoms
CASES = {
    "256-2x4": (256, (2, 4), ("knee", "head"), {}),
    "300-1x4": (300, (1, 4), ("thorax", "pelvis"), {}),
    "300-2x4": (300, (2, 4), ("thorax", "pelvis"), {}),
    "bf16-256-2x4": (256, (2, 4), ("knee", "head"), {"storage": "bfloat16"}),
    "linear-576-2x2": (576, (2, 2), ("thorax", "head"), {"grad_with_linear_image": True}),
    "structural-576-2x2": (576, (2, 2), ("foot", "pelvis"),
                           {"coarser_levels_start": 2, "cnr_level": 2,
                            "noise_histogram_bins": 2000}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spatial_equals_unsharded_and_meets_parity_with_jax(case):
    size, (d, s), anatomies, kw = CASES[case]
    cfg = MusicaConfig(image_size=size, **kw)
    imgs = phantoms(size, anatomies)
    plan = spatial.row_plan(size, s, cfg)
    assert plan.replicated >= 4 and plan.bounds[0][1] % cfg.histogram_area_size == 0
    out = sharding.process_sharded(imgs, cfg, cpu_mesh(d, s))
    assert out.device == CPU and out.dtype == torch.uint8
    assert torch.equal(out, musica.forward_batch(torch.from_numpy(imgs), cfg))
    assert_u8_parity(out.numpy(), jax_unsharded(size, anatomies, **kw),
                     f"{case} vs the JAX package's unsharded fact path")


@pytest.fixture(scope="module")
def jax_spatial_256():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    imgs = phantoms(256, ("knee", "head"))
    mesh = j_sharding.make_mesh(n_data=2, n_space=4)
    return np.asarray(j_sharding.process_sharded(jnp.asarray(imgs), JConfig(image_size=256), mesh))


def test_spatial_256_against_jax_spatial(jax_spatial_256):
    """The tolerance of the JAX package's spatial tests: |du8| <= 1 on
    fewer than 1e-4 of the pixels."""
    imgs = phantoms(256, ("knee", "head"))
    out = sharding.process_sharded(imgs, MusicaConfig(image_size=256), cpu_mesh(2, 4)).numpy()
    diff = np.abs(out.astype(np.int32) - jax_spatial_256.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-4, (diff.max(), (diff > 0).mean())


def test_spatial_outputs_gathered_whole():
    cfg = MusicaConfig(image_size=256)
    imgs = phantoms(256, ("foot", "thorax"))
    out, cnr, recon = sharding.process_sharded(imgs, cfg, cpu_mesh(1, 2),
                                               outputs=("out_u8", "cnr", "recon"))
    assert out.shape == (2, 236, 236) and cnr.shape == (2, 32, 32) and recon.shape == (2, 256, 256)
    for i, im in enumerate(imgs):
        r = musica.musica_forward(torch.from_numpy(im), cfg)
        assert torch.equal(out[i], r["out_u8"])
        assert torch.equal(cnr[i], r["cnr"])
        assert torch.equal(recon[i], r["recon"])
    graded = spatial.forward(torch.from_numpy(imgs[0]), cfg, [spatial.Entry(CPU)] * 4,
                             ("graded",))["graded"]
    assert torch.equal(graded, musica.musica_forward(torch.from_numpy(imgs[0]), cfg)["graded"])


def test_spatial_throughput_step_checksum():
    cfg = MusicaConfig(image_size=128)
    mesh = cpu_mesh(4, 2)
    step, example = sharding.throughput_step(cfg, mesh, batch_per_device=1)
    assert len(example) == 4 and all(e.shape == (1, 128, 128) for e in example)
    batch = np.random.default_rng(0).integers(0, 65535, (4, 128, 128), dtype=np.uint16)
    np.testing.assert_array_equal(torch.cat(example).numpy(), batch)
    total = step(example)
    assert total.shape == () and total.dtype == torch.int64 and total.device == CPU
    assert int(total) == int(musica.forward_batch(torch.from_numpy(batch), cfg)
                             .sum(dtype=torch.int64))


def test_row_plan():
    cfg = MusicaConfig(image_size=3072)
    plan = spatial.row_plan(3072, 4, cfg)
    assert plan.replicated == 9 and plan.bounds[8] == (0, 3, 6, 9, 12)
    assert plan.bounds[0] == (0, 768, 1536, 2304, 3072)
    assert spatial.row_plan(300, 4, MusicaConfig(image_size=300)).bounds[0] == (0, 80, 160, 240, 300)
    with pytest.raises(ValueError, match="do not split"):
        spatial.row_plan(40, 4, MusicaConfig(image_size=40))
    with pytest.raises(ValueError, match="at least 2"):
        spatial.row_plan(256, 1, MusicaConfig(image_size=256))


# ----------------------------------------------------------------------
# row-window ops against slices of the whole-image ops, bit for bit
# ----------------------------------------------------------------------

def windows(m):
    """Row windows [r0, r1) of an m-row output: starting and ending at
    every parity, at the true first and last rows, and the whole."""
    starts = sorted({0, 1, 2, 3, m // 2 - 1, m // 2, m - 4, m - 3, m - 2, m - 1})
    out = {(0, m)}
    for r0 in starts:
        if 0 <= r0 < m:
            for r1 in (r0 + 1, r0 + 2, r0 + 3, r0 + 4, m // 2 + 1, m):
                if r0 < r1 <= m:
                    out.add((r0, r1))
    return sorted(out)


def level_images(n, seed):
    """Random float32 images at the sizes of n's pyramid down to 7 px (the
    least a sharded level can hold: 2 rows on each of >= 2 shards at the
    next level), and at 7 px (the small form of ``smooth_downsample``)."""
    rng = np.random.default_rng(seed)
    sizes = [n]
    while -(-sizes[-1] // 2) >= 7:
        sizes.append(-(-sizes[-1] // 2))
    sizes.append(7)
    return [torch.from_numpy(rng.normal(0.5, 0.2, (m, m)).astype(np.float32)) for m in sizes]


def ext_rows(x, lo, hi):
    """The rows [lo, hi) of an image as a shard receives them (a copy)."""
    return x[lo:hi].clone()


@pytest.mark.parametrize("n", [144, 300, 600])
def test_smooth_downsample_rows(n):
    for x in level_images(n, 1):
        h = x.shape[-1]
        whole = pyramid.smooth_downsample(x)
        for j0, j1 in windows(whole.shape[-2]):
            lo, hi = pyramid.needed_rows("smooth_downsample", h, j0, j1)
            got = pyramid.smooth_downsample_rows(ext_rows(x, lo, hi), lo, h, j0, j1)
            assert torch.equal(got, whole[j0:j1]), (h, j0, j1)


@pytest.mark.parametrize("n", [144, 300, 600])
def test_upsample_smooth_rows(n):
    for x in level_images(n, 2):
        out = x.shape[-1]
        small = pyramid.smooth_downsample(x)
        whole = pyramid.upsample_smooth(small, out)
        for r0, r1 in windows(out):
            lo, hi = pyramid.needed_rows("upsample_smooth", out, r0, r1)
            got = pyramid.upsample_smooth_rows(ext_rows(small, lo, hi), lo, out, r0, r1)
            assert torch.equal(got, whole[r0:r1]), (out, r0, r1)


@pytest.mark.parametrize("n", [144, 300, 600])
def test_img_sdev_rows(n):
    for x in level_images(n, 3):
        h = x.shape[-1]
        x = x - 0.5
        whole = stats.img_sdev(x)
        for r0, r1 in windows(h):
            lo, hi = pyramid.needed_rows("img_sdev", h, r0, r1)
            got = stats.img_sdev_rows(ext_rows(x, lo, hi), lo, h, r0, r1)
            assert torch.equal(got, whole[r0:r1]), (h, r0, r1)


@pytest.mark.parametrize("n", [144, 300, 600])
def test_normalize_rows(n):
    """Each window normalized with the extrema reduced over all windows
    (the spatial path's all-reduce) equals the whole image's rows."""
    img = torch.from_numpy(synthetic_radiograph(n, "hand"))
    for quirks in (True, False):
        whole = normalize.normalize_from_u16(img, quirks)[0]
        bounds = (0, n // 3, 2 * n // 3, n)
        parts = [img[a:b].to(torch.float32) for a, b in zip(bounds, bounds[1:])]
        ext = (torch.stack([p.amax() for p in parts]).amax(),
               torch.stack([p.amin() for p in parts]).amin())
        for r0, r1 in windows(n):
            got = normalize.normalize_from_u16(img[r0:r1], quirks, extrema=ext)[0]
            assert torch.equal(got, whole[r0:r1]), (quirks, r0, r1)


# ----------------------------------------------------------------------
# plain versions of the windowed kernels, summed over a plan's windows
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tile", [8, 12, 16, 32])
@pytest.mark.parametrize("n,quirks", [(600, True), (256, False)])
def test_noise_hist_windows_sum_to_whole(tile, n, quirks):
    """K1's plain windowed histograms over a 4-shard plan's rows of every
    analysis level sum to the whole levels' (coverage cropped at 600, padded
    in clean-math mode), and K2's plain argmax on the sum equals
    ``stats.histogram_max``; also on levels whose bins tie."""
    cfg = MusicaConfig(image_size=n, quirks=quirks, histogram_area_size=tile)
    plan = spatial.row_plan(n, 4, cfg)
    rng = np.random.default_rng(tile)
    lv = list(cfg.analysis_levels)
    sizes = [plan.sizes[k] for k in lv]
    for levels in (hist_cases.noise_levels(rng, sizes), hist_cases.tie_levels(sizes)):
        levels = [torch.from_numpy(a) for a in levels]
        whole = fh.noise_hists_plain(levels, cfg)
        total = torch.zeros_like(whole)
        for i in range(4):
            # a level past the plan's sharded ones is scanned whole by the
            # first shard, as spatial.forward does
            rows = [plan.rows(k, i) if k < plan.replicated else (0, plan.sizes[k] if i == 0 else 0)
                    for k in lv]
            part = fh.noise_hists_rows([sd[a:b] for sd, (a, b) in zip(levels, rows)],
                                       [a for a, _ in rows], cfg)
            if part is not None:
                total += part
        assert torch.equal(total, whole)
        assert torch.equal(fh.hist_argmax(total), stats.histogram_max(whole)[1])
        assert torch.equal(fh.hist_argmax(total), fh.noise_hists(levels, cfg)[1])


def test_noise_hist_window_without_covered_rows():
    """A shard whose rows lie past every level's coverage (512 rows of a
    600 level in quirks mode) gives None: its kernel launches nothing."""
    cfg = MusicaConfig(image_size=600)
    assert stats.coverage(600, cfg) == 512
    sd = torch.full((100, 600), 0.05)
    assert fh.noise_hists_rows([sd], [500], cfg) is not None
    assert fh.noise_hists_rows([sd[:80]], [520], cfg) is None
    assert fh.noise_hists_rows([sd[:0]], [0], cfg) is None


@pytest.mark.parametrize("tile", [8, 12, 16, 32])
@pytest.mark.parametrize("n,quirks", [(600, True), (256, False)])
def test_grad_hist_windows_sum_to_whole(tile, n, quirks):
    """K4's and K3's plain windowed histograms over a 4-shard plan's level-0
    rows (tiles whole in each window, the relevance border and the CNR rows
    global) sum to the whole image's."""
    cfg = MusicaConfig(image_size=n, quirks=quirks, histogram_area_size=tile)
    plan = spatial.row_plan(n, 4, cfg)
    rng = np.random.default_rng(100 + tile)
    recon = torch.from_numpy(hist_cases.gradation_image(rng, n))
    rel = torch.from_numpy(rng.uniform(0.0, 1.0, (n, n)).astype(np.float32))
    nrm = torch.from_numpy(rng.uniform(0.0, 1.01, (n, n)).astype(np.float32))
    cs = -(-n // 8)
    cnr = torch.from_numpy(rng.uniform(0.0, 0.1, (cs, cs)).astype(np.float32))
    k4 = torch.zeros(cfg.grad_histogram_bins, dtype=torch.int32)
    k3 = torch.zeros_like(k4)
    for i in range(4):
        a, b = plan.rows(0, i)
        k4 += fh.grad_hist(recon[a:b], rel[a:b], cfg, a)
        c0, c1 = noise.cnr_rows(cs, n, a, b)
        k3 += fh.grad_hist_relevant(recon[a:b], nrm[a:b], cnr[c0:c1], cfg, a, c0)
    assert torch.equal(k4, fh.grad_hist(recon, rel, cfg))
    assert torch.equal(k3, fh.grad_hist_relevant(recon, nrm, cnr, cfg))
    with pytest.raises(ValueError, match="whole"):
        fh.grad_hist(recon[1:tile + 1], rel[1:tile + 1], cfg, 1)


def test_spatial_refuses_what_it_does_not_run():
    """``clahe_graded`` without ``enable_clahe`` and an unknown output
    raise (the CLAHE and fused-sdev variants run: test_torch_spatial_variants.py)."""
    mesh = cpu_mesh(1, 2)
    imgs = phantoms(128, ("hand",))
    with pytest.raises(ValueError, match="spatial path gives"):
        sharding.process_sharded(imgs, MusicaConfig(image_size=128), mesh,
                                 outputs=("clahe_graded",))
    with pytest.raises(ValueError, match="spatial path gives"):
        sharding.process_sharded(imgs, MusicaConfig(image_size=128), mesh,
                                 outputs=("out_u8", "sdev"))


@pytest.mark.parametrize("tile", [8, 12, 32])
def test_spatial_at_other_tiles(tile):
    """Histogram tiles other than 16 move the shard boundaries: at 600 over
    4 with 12-px tiles (156-row shards) only levels 0-2 are sharded, so the
    analysis level 3 and the CNR map are computed whole on every entry and
    K1 scans level 3 on the first shard alone."""
    cfg = MusicaConfig(image_size=600, histogram_area_size=tile)
    plan = spatial.row_plan(600, 4, cfg)
    if tile == 12:
        assert plan.replicated == 3 == cfg.cnr_level
    img = torch.from_numpy(synthetic_radiograph(600, "pelvis"))
    names = [k for k in spatial.OUTPUTS if k != "clahe_graded"]
    got = spatial.forward(img, cfg, [spatial.Entry(CPU)] * 4, names)
    want = musica.musica_forward(img, cfg)
    for k in names:
        assert torch.equal(got[k], want[k]), k
