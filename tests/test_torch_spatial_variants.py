"""The PyTorch port's spatial path (``parallel/spatial.py``) in the CLAHE
variant (K6 per shard on global-row tiles, K5 on each shard's rows) and the
fused-sdev analysis (K7 on each shard's rows with the 2-row halos), on the
CPU, with mesh entries that are all the CPU device.

Each case equals the port's unsharded ``musica_forward`` bit for bit; the
CLAHE case of the JAX package's spatial tests (``tests/test_sharding.py::
test_variant_sharding_576[clahe]``) meets that test's bar against the JAX
package's ``musica_forward(..., "fact")``, and every fused-sdev case the
parity bar against its unsharded ``"fact"`` path (its golden model at 600
with 12-px tiles, a configuration that path does not run).  The plain window
versions of K5, K6 and K7 equal the whole-image functions' rows, and their
histograms summed over a partition of the rows the whole image's; K7's
task partition over windows covers each output pixel and each scanned group
once."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig as JConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica as j_musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import (
    clahe, pyramid, stats)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import clahe_apply as k_clahe
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import (
    sharding, spatial)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import hist_cases

from test_torch_kernel_formulations import sdev_partition
from test_torch_pipeline import assert_u8_parity
from test_torch_spatial import cpu_mesh, jax_unsharded, phantoms

torch.set_num_threads(2)

CPU = torch.device("cpu")


def equal_nan(a, b) -> bool:
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


@functools.lru_cache(maxsize=None)
def jax_clahe_576():
    """The JAX package's ``musica_forward(im, cfg, "fact")`` of the 576
    thorax and head with ``enable_clahe``: (out_u8, clahe_graded), as
    ``tests/test_sharding.py::test_variant_sharding_576`` computes them."""
    cfg = JConfig(image_size=576, enable_clahe=True)

    @jax.jit
    def one(im):
        r = j_musica.musica_forward(im, cfg, "fact")
        return r["out_u8"], r["clahe_graded"]

    outs = [one(im) for im in jnp.asarray(phantoms(576, ("thorax", "head")))]
    return tuple(np.stack([np.asarray(o[j]) for o in outs]) for j in range(2))


# ----------------------------------------------------------------------
# CLAHE under n_space > 1
# ----------------------------------------------------------------------

def test_clahe_576_2x2_equals_unsharded_and_meets_the_jax_spatial_bar():
    """``clahe-576-2x2``: bit-equal to the port's unsharded forward per
    image; against the JAX package, |du8| <= 1 on fewer than 1e-4 of the
    pixels and ``clahe_graded`` within 1e-5 (NaN tiles equal), the bar of
    its own spatial test."""
    cfg = MusicaConfig(image_size=576, enable_clahe=True)
    imgs = phantoms(576, ("thorax", "head"))
    out, graded = sharding.process_sharded(imgs, cfg, cpu_mesh(2, 2),
                                           outputs=("out_u8", "clahe_graded"))
    assert graded.shape == (2, 576, 576) and graded.dtype == torch.float32
    for i, im in enumerate(imgs):
        r = musica.musica_forward(torch.from_numpy(im), cfg)
        assert torch.equal(out[i], r["out_u8"])
        assert equal_nan(graded[i], r["clahe_graded"])
    ref_u8, ref_graded = jax_clahe_576()
    diff = np.abs(out.numpy().astype(np.int32) - ref_u8.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-4, (diff.max(), (diff > 0).mean())
    np.testing.assert_allclose(graded.numpy(), ref_graded, rtol=0, atol=1e-5)


CLAHE_CASES = {
    "clahe-linear-300-1x4": (300, (1, 4), ("thorax", "pelvis"),
                             {"enable_clahe": True, "grad_with_linear_image": True}),
    "clahe-8x8-576-2x2": (576, (2, 2), ("foot", "hand"),
                          {"enable_clahe": True, "clahe_tiles": 8}),
}


@pytest.mark.parametrize("case", list(CLAHE_CASES))
def test_clahe_variants_equal_unsharded(case):
    """CLAHE + linear gradation (300 over 1x4: 80/80/80/60 rows, no shard a
    multiple of the 75-px CLAHE tile) and 8x8 CLAHE tiles (576 over 2x2),
    every output bit-equal to the unsharded forward's."""
    size, (d, s), anatomies, kw = CLAHE_CASES[case]
    cfg = MusicaConfig(image_size=size, **kw)
    imgs = phantoms(size, anatomies)
    names = spatial.OUTPUTS
    got = sharding.process_sharded(imgs, cfg, cpu_mesh(d, s), outputs=names)
    for i, im in enumerate(imgs):
        want = musica.musica_forward(torch.from_numpy(im), cfg)
        for name, g in zip(names, got):
            assert equal_nan(g[i].float(), want[name].float()), (case, name)


def test_clahe_throughput_step_checksum():
    """``throughput_step`` with ``enable_clahe`` on a 2 x 2 mesh of CPU
    entries sums the unsharded outputs."""
    cfg = MusicaConfig(image_size=128, enable_clahe=True)
    step, example = sharding.throughput_step(cfg, cpu_mesh(2, 2), batch_per_device=1)
    total = step(example)
    assert int(total) == int(musica.forward_batch(torch.cat(example), cfg).sum(dtype=torch.int64))


# ----------------------------------------------------------------------
# fused-sdev under n_space > 1
# ----------------------------------------------------------------------

# the reference of each case: the JAX package's unsharded "fact" path, or
# its golden model where that path does not run (600 at 12-px tiles in
# quirks mode: its noise histogram splits the 512-px coverage into 12-px
# groups and fails)
FUSED_CASES = {
    "fused-256-2x4": (256, (2, 4), ("knee", "head"), {}, "fact"),
    "fused-300-1x4": (300, (1, 4), ("thorax", "pelvis"), {}, "fact"),
    # 156-row shards: levels 0-2 sharded, the analysis level 3 replicated
    "fused-600-1x4-tile12": (600, (1, 4), ("pelvis",), {"histogram_area_size": 12}, "golden"),
    "fused-bf16-256-2x4": (256, (2, 4), ("knee", "head"), {"storage": "bfloat16"}, "fact"),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_sdev_equals_unsharded_and_meets_parity_with_jax(case):
    size, (d, s), anatomies, kw, ref = FUSED_CASES[case]
    cfg = MusicaConfig(image_size=size, **kw)
    imgs = phantoms(size, anatomies)
    plan = spatial.row_plan(size, s, cfg)
    if "tile12" in case:
        assert plan.replicated == 3 and 3 in cfg.analysis_levels
    out, recon = sharding.process_sharded(imgs, cfg, cpu_mesh(d, s), outputs=("out_u8", "recon"),
                                          fused_sdev=True)
    want = musica.forward_batch(torch.from_numpy(imgs), cfg, fused_sdev=True)
    assert torch.equal(out, want)
    assert torch.equal(recon[0], musica.musica_forward(torch.from_numpy(imgs[0]), cfg,
                                                       fused_sdev=True)["recon"])
    if ref == "golden":
        want_ref = np.stack([golden.process(im, JConfig(image_size=size, **kw)) for im in imgs])
    else:
        want_ref = jax_unsharded(size, anatomies, **kw)
    assert_u8_parity(out.numpy(), want_ref, f"{case} vs the JAX package's unsharded {ref}")


# ----------------------------------------------------------------------
# the plain window versions of K5, K6 and K7
# ----------------------------------------------------------------------

def odd_bounds(n, space):
    """A partition of n rows into ``space`` windows, the inner ones
    starting on odd rows."""
    return [0] + [i * n // space + (1 - i * n // space % 2) for i in range(1, space)] + [n]


def clahe_inputs(n, cfg, seed):
    rng = np.random.default_rng(seed)
    recon = torch.from_numpy(rng.uniform(-0.05, 1.05, (n, n)).astype(np.float32))
    recon[0, :7] = torch.tensor([0.0, 1.0, 0.5, 1.0 / 256, 255.0 / 256, -0.0, 2.0])
    relevant = torch.from_numpy((rng.uniform(size=(n, n)) < 0.7).astype(np.float32))
    relevant[: n // 3, : n // 3] = 0.0  # a tile without relevant pixels: NaN LUT
    return recon, relevant


@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("n", [144, 300, 600])
def test_clahe_apply_rows_equal_the_whole_rows(n, space):
    cfg = MusicaConfig(image_size=n, enable_clahe=True)
    recon, relevant = clahe_inputs(n, cfg, n + space)
    px, py = clahe.clahe_curves(clahe.clahe_histograms(recon, relevant, cfg), cfg)
    assert bool(torch.isnan(py).any())
    whole = clahe.clahe_apply(recon, px, py, cfg)
    b = odd_bounds(n, space)
    for r0, r1 in zip(b, b[1:]):
        got = k_clahe.clahe_apply(recon[r0:r1].clone(), px, py, cfg, r0)
        assert equal_nan(got, whole[r0:r1]), (n, r0, r1)
        assert equal_nan(clahe.clahe_apply_rows(recon[r0:r1], px, py, r0, n, cfg), got)


@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("n", [144, 300, 600])
def test_clahe_joint_histograms_of_windows_sum_to_whole(n, space):
    for tiles in (4, 8):
        cfg = MusicaConfig(image_size=n, enable_clahe=True, clahe_tiles=tiles)
        recon, relevant = clahe_inputs(n, cfg, 7 * n + space)
        b = odd_bounds(n, space)
        total = sum(clahe.clahe_histograms_rows(recon[r0:r1], relevant[r0:r1], r0, n, cfg)
                    for r0, r1 in zip(b, b[1:]))
        assert torch.equal(total, clahe.clahe_histograms(recon, relevant, cfg)), (n, tiles)
        joint, w = clahe.clahe_joint_bins(recon, relevant, cfg)
        for r0, r1 in zip(b, b[1:]):
            jr, wr = clahe.clahe_joint_bins_rows(recon[r0:r1], relevant[r0:r1], r0, n, cfg)
            assert torch.equal(jr, joint[r0:r1]) and torch.equal(wr, w[r0:r1])


def plan_rows(plan, k, i):
    """Shard i's rows of level k; a replicated level whole on every shard."""
    return plan.rows(k, i) if k < plan.replicated else (0, plan.sizes[k])


@pytest.mark.parametrize("tile", [8, 12, 16, 32])
@pytest.mark.parametrize("n,quirks", [(144, False), (300, True), (600, True)])
def test_sdev_noise_windows_equal_the_whole(n, quirks, tile):
    """K7's plain window version over the plans of 2 and 4 shards (where
    the tiles split): each shard's sdev rows equal ``img_sdev``'s rows (the
    band rows from ``needed_rows``, the halos included), and its
    histograms, a replicated level counted by the first shard alone, sum to
    the whole levels'; also where the bands' sdev tie."""
    cfg = MusicaConfig(image_size=n, quirks=quirks, histogram_area_size=tile)
    lv = list(cfg.analysis_levels)
    rng = np.random.default_rng(n + tile)
    plans = []
    for space in (2, 4):
        try:
            plans.append(spatial.row_plan(n, space, cfg))
        except ValueError:
            pass
    assert plans
    sizes = [plans[0].sizes[k] for k in lv]
    for bands in (hist_cases.noise_levels(rng, sizes), hist_cases.tie_levels(sizes)):
        bands = [torch.from_numpy(a) - 0.05 for a in bands]
        whole_sd = [stats.img_sdev(b) for b in bands]
        whole_h = fh.noise_hists_plain(whole_sd, cfg)
        for plan in plans:
            total = torch.zeros_like(whole_h)
            for i in range(plan.space):
                rows = [plan_rows(plan, k, i) for k in lv]
                wins = [pyramid.needed_rows("img_sdev", b.shape[-1], *r) for b, r in zip(bands, rows)]
                sds, h = fh.sdev_noise_hists_rows(
                    [b[lo:hi].clone() for b, (lo, hi) in zip(bands, wins)], [lo for lo, _ in wins],
                    rows, cfg, [k < plan.replicated or i == 0 for k in lv])
                for sd, want, (r0, r1) in zip(sds, whole_sd, rows):
                    assert torch.equal(sd, want[r0:r1]), (plan.space, i, r0, r1)
                total += h
            assert torch.equal(total, whole_h), (plan.space, tile)


SDEV_PLANS = {"3072 over 4": (3072, True, 16, 4), "600 over 4, tile 12": (600, True, 12, 4),
              "144 clean math over 2": (144, False, 16, 2)}


@pytest.mark.parametrize("wave", [528, 7])
@pytest.mark.parametrize("case", list(SDEV_PLANS))
def test_sdev_task_partition_over_windows(case, wave):
    """K7's tasks numbered over each shard's output rows (a band starts at
    the window's first row, not on a 32-row band of the level): over the
    shards of a plan every output pixel lies in one task, every group of
    the coverage is scanned once, a replicated level's by the first shard."""
    n, quirks, tile, space = SDEV_PLANS[case]
    cfg = MusicaConfig(image_size=n, quirks=quirks, histogram_area_size=tile)
    plan = spatial.row_plan(n, space, cfg)
    lv = list(cfg.analysis_levels)
    ns = [plan.sizes[k] for k in lv]
    covered = [np.zeros((m, m), np.int32) for m in ns]
    scanned = [np.zeros((min(c, m), c // tile), np.int32)
               for m, c in zip(ns, (stats.coverage(m, cfg) for m in ns))]
    for i in range(space):
        counted = [k < plan.replicated or i == 0 for k in lv]
        covs = [stats.coverage(m, cfg) if c else 0 for m, c in zip(ns, counted)]
        c, s, _, _ = sdev_partition(ns, covs, tile, wave, [plan_rows(plan, k, i) for k in lv])
        for j, k in enumerate(lv):
            if counted[j]:
                covered[j] += c[j]
                scanned[j] += s[j]
            else:  # a replicated level: computed whole on every shard
                assert (c[j] == 1).all() and s[j].size == 0, (case, i, k)
    assert all((a == 1).all() for a in covered), case
    assert all((a == 1).all() for a in scanned), case
