"""The tone map of the PyTorch port (``ops/cuda/tonemap.py``: KT's wrapper and
its plain version, ``curves.curve_get_y_general`` then ``curve_apply_u8`` on
the margin crop) and the default analysis path's sdev (``fused_hist.sdevs``,
``sdevs_rows``: KS's wrappers and their plain versions) on the CPU.

The plain tone map is held bit for bit to the JAX package's
``curve_get_y_adaptive`` (graded) and ``curve_apply_u8_adaptive`` on the
cropped input (out_u8), the pair its ``models/musica.py`` calls: on the
adversarial curves of ``testing/tone_cases.py`` (fold-backs, duplicate
points, 1-ulp neighbours of every knot, NaN and +-inf x, a positive interval
of denormal width) and on the gradation curves of phantoms through the
whole port path.  XLA on the CPU flushes float32 denormals to 0, so x that
a flush would move (``tone_cases.flushed``) is left out of that comparison;
the port's own kernel formulation is held to the plain chain on them in
tests/test_torch_kernel_formulations.py.  The windows of the spatial
plans, put together, equal the whole image and its crop.  On a CUDA tensor
each wrapper launches its kernel (here through a recording ``launch``), and
the pipeline takes each wrapper once (the spatial path once a shard)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import curves as j_curves
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import (
    curves, normalize, pyramid, stats)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import tonemap
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding, spatial
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import tone_cases
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
    synthetic_radiograph)

torch.set_num_threads(2)

M = 10  # the default margin
CURVES = sorted(tone_cases.adversarial_curves(np.random.default_rng(0)))


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_tone(px_b: bytes, py_b: bytes, x_b: bytes, shape) -> tuple:
    """The JAX package's graded image and cropped u8 of one input."""
    px, py = np.frombuffer(px_b, np.float32), np.frombuffer(py_b, np.float32)
    x = np.frombuffer(x_b, np.float32).reshape(shape)
    graded = np.asarray(j_curves.curve_get_y_adaptive(jnp.asarray(px), jnp.asarray(py),
                                                      jnp.asarray(x)))
    u8 = np.asarray(j_curves.curve_apply_u8_adaptive(jnp.asarray(px), jnp.asarray(py),
                                                     jnp.asarray(x[M:-M, M:-M])))
    return graded, u8


def _hold_to_jax(px, py, x, graded, out_u8, what):
    """graded and out_u8 (the port's) against the JAX package's on x,
    bit for bit, where no denormal flush moves the JAX result."""
    j_graded, j_u8 = _jax_tone(px.tobytes(), py.tobytes(), x.tobytes(), x.shape)
    keep = ~tone_cases.flushed(x, px)
    assert keep.mean() > 0.5, what
    np.testing.assert_array_equal(_bits(graded)[keep], _bits(j_graded)[keep], err_msg=what)
    crop = keep[M:-M, M:-M]
    np.testing.assert_array_equal(np.asarray(out_u8)[crop], j_u8[crop], err_msg=what)


@pytest.mark.parametrize("curve", CURVES)
def test_plain_tone_map_equals_jax_on_adversarial_curves(curve):
    rng = np.random.default_rng(CURVES.index(curve))
    px, py = tone_cases.adversarial_curves(np.random.default_rng(0))[curve]
    x = tone_cases.image(rng, (96, 96), px, denormals=False)
    graded, out_u8 = tonemap.tone_map(torch.from_numpy(x), torch.from_numpy(px),
                                      torch.from_numpy(py), M)
    assert graded.dtype == torch.float32 and out_u8.dtype == torch.uint8
    assert out_u8.shape == (96 - 2 * M, 96 - 2 * M)
    _hold_to_jax(px, py, x, graded.numpy(), out_u8.numpy(), curve)
    # every special value and every knot's neighbours are in the image
    assert np.isnan(x).any() and np.isinf(x).any()
    assert np.isin(tone_cases.knot_values(px), x).mean() > 0.9


def test_adversarial_curves_reach_every_kind_of_result():
    """Between them the curves give NaN and +-inf graded values (the
    infinite slope), zero-width intervals met exactly (duplicates,
    descending points) and a first match below a later one (the fold-back),
    and the most points the kernel takes."""
    curves_ = tone_cases.adversarial_curves(np.random.default_rng(0))
    rng = np.random.default_rng(1)
    got = {}
    for name, (px, py) in curves_.items():
        x = torch.from_numpy(tone_cases.image(rng, (64, 64), px))
        got[name] = tonemap.tone_map_plain(x, torch.from_numpy(px), torch.from_numpy(py), M)[0]
    assert torch.isnan(got["infinite slope"]).any() and torch.isinf(got["infinite slope"]).any()
    assert all(torch.isfinite(g).all() for k, g in got.items() if k != "infinite slope")
    assert max(c[0].shape[0] for c in curves_.values()) == tonemap.MAX_POINTS
    px = curves_["fold-back"][0]
    assert (np.diff(px) < 0).any() and (np.diff(px) > 0).any()
    assert (np.diff(curves_["duplicates"][0]) == 0).any()


@functools.lru_cache(maxsize=None)
def _port_forward(size: int, anatomy: str, linear: bool):
    cfg = MusicaConfig(image_size=size, grad_with_linear_image=linear)
    return cfg, musica.musica_forward(torch.from_numpy(synthetic_radiograph(size, anatomy)), cfg,
                                      want_intermediates=True)


@pytest.mark.parametrize("size,anatomy,linear", [(256, "thorax", False), (600, "pelvis", False),
                                                 (256, "knee", True)])
def test_port_path_tone_map_on_phantom_curves(size, anatomy, linear):
    """The port's forward on a phantom: its graded image and out_u8 equal
    the JAX package's curve functions on the forward's own gradation input
    and curve bit for bit, and the wrapper's plain version on them."""
    cfg, res = _port_forward(size, anatomy, linear)
    inter = res["intermediates"]
    x = inter["linear"] if linear else res["recon"]
    gpx, gpy, _ = inter["grad_curve"]
    assert gpx.shape == (22,)
    px, py, xn = gpx.numpy(), gpy.numpy(), x.numpy()
    assert not tone_cases.flushed(xn, px).any()
    _hold_to_jax(px, py, xn, res["graded"].numpy(), res["out_u8"].numpy(), f"{size} {anatomy}")
    graded, out_u8 = tonemap.tone_map_plain(x, gpx, gpy, cfg.out_margin)
    assert torch.equal(graded.view(torch.int32), res["graded"].view(torch.int32))
    assert torch.equal(out_u8, res["out_u8"])


def _odd_cuts(n):
    """Windows that start on odd rows, inside the top margin and past the
    bottom one."""
    return [0, 5, 11, n // 2 + 1, n - 9, n]


@pytest.mark.parametrize("n,space", [(256, 4), (256, 2), (600, 4), (600, 2), (144, 3)])
def test_windows_put_together_equal_the_whole(n, space):
    """The row windows of a plan over ``space`` shards (1x4: 4, 2x2: 2) and
    odd windows: each window's out_u8 holds exactly its rows of the crop,
    and the windows' graded and out_u8 put together equal the whole
    image's."""
    cfg = MusicaConfig(image_size=n)
    rng = np.random.default_rng(n + space)
    px, py = (torch.from_numpy(a) for a in
              tone_cases.adversarial_curves(np.random.default_rng(0))["fold-back"])
    x = torch.from_numpy(tone_cases.image(rng, (n, n), px.numpy()))
    whole = tonemap.tone_map(x, px, py, M)
    for bounds in (spatial.row_plan(n, space, cfg).bounds[0], _odd_cuts(n)):
        parts = []
        for a, b in zip(bounds, bounds[1:]):
            g, o = tonemap.tone_map(x[a:b], px, py, M, a)
            lo, hi = tonemap.crop_rows(n, a, b - a, M)
            assert o.shape == (hi - lo, n - 2 * M)
            parts.append((g, o))
        graded = torch.cat([g for g, _ in parts])
        assert torch.equal(graded.view(torch.int32), whole[0].view(torch.int32))
        assert torch.equal(torch.cat([o for _, o in parts]), whole[1])


def test_cpu_calls_run_the_plain_versions_and_count_no_launch():
    x = torch.rand(40, 40)
    px = torch.linspace(0, 1, 22)
    launch.reset_launch_counts()
    assert "tone_map" in launch.LAUNCHES and "sdev" in launch.LAUNCHES
    tonemap.tone_map(x, px, px.sqrt(), M)
    fh.sdevs([x, x[:20, :20].contiguous()])
    fh.sdevs_rows([x[2:30]], [2], [(4, 28)])
    assert launch.LAUNCHES == {k: 0 for k in launch.LAUNCHES}
    with pytest.raises(ValueError):
        tonemap.tone_map(x, px.to("meta"), px, M)  # mixed devices


# ----------------------------------------------------------------------
# KS's plain entries
# ----------------------------------------------------------------------

def _bands(size, anatomy):
    cfg = MusicaConfig(image_size=size)
    nrm, _, _ = normalize.normalize_from_u16(
        torch.from_numpy(synthetic_radiograph(size, anatomy)), cfg.quirks)
    bands, _ = pyramid.reduce_ladder(nrm, cfg.pyramid_levels)
    return cfg, {i: bands[i] for i in cfg.analysis_levels}


@pytest.mark.parametrize("size,anatomy", [(256, "thorax"), (600, "pelvis")])
def test_sdevs_equal_img_sdev_and_golden(size, anatomy):
    """All analysis levels in one call (``stats.analysis_sdevs``, keyed by
    level) equal ``img_sdev`` a level and the golden model's sdev bit for
    bit."""
    cfg, bands = _bands(size, anatomy)
    got = stats.analysis_sdevs(bands)
    assert list(got) == list(cfg.analysis_levels)
    for i, b in bands.items():
        assert torch.equal(got[i], stats.img_sdev(b)), i
        np.testing.assert_array_equal(got[i].numpy(), golden.img_sdev(b.numpy()))


@pytest.mark.parametrize("size,space", [(256, 4), (600, 4), (600, 2)])
def test_sdevs_rows_equal_img_sdev_rows_and_the_whole(size, space):
    """On every shard's windows of a plan (band rows with the 2-row halos, a
    replicated level whole on every shard): ``sdevs_rows`` equals
    ``img_sdev_rows`` a level and the whole levels' rows."""
    cfg, bands = _bands(size, "thorax")
    plan = spatial.row_plan(size, space, cfg)
    lv = list(cfg.analysis_levels)
    whole = fh.sdevs([bands[k] for k in lv])
    for i in range(space):
        rows = [plan.rows(k, i) if k < plan.replicated else (0, plan.sizes[k]) for k in lv]
        need = [pyramid.needed_rows("img_sdev", plan.sizes[k], *r) for k, r in zip(lv, rows)]
        wins = [bands[k][lo:hi] for k, (lo, hi) in zip(lv, need)]
        got = fh.sdevs_rows(wins, [lo for lo, _ in need], rows)
        for k, g, w, (lo, _), (r0, r1) in zip(lv, got, wins, need, rows):
            assert torch.equal(g, stats.img_sdev_rows(w, lo, plan.sizes[k], r0, r1)), (i, k)
            assert torch.equal(g, whole[lv.index(k)][r0:r1]), (i, k)


# ----------------------------------------------------------------------
# the wrappers' CUDA path, and the pipeline's calls of each wrapper
# ----------------------------------------------------------------------

@pytest.fixture
def card(monkeypatch):
    """The wrappers' CUDA path on CPU inputs: tensors report a device that
    is not the CPU (outputs are allocated on ``meta``), and ``launch``
    records each call instead of calling the library."""
    calls = []
    monkeypatch.setattr(launch, "device_of", lambda ts: torch.device("meta"))
    monkeypatch.setattr(launch, "lib", lambda: None)
    monkeypatch.setattr(launch, "launch",
                        lambda lib, fn, counter, dev, *args: calls.append((fn, counter, args)))
    return calls


def test_cuda_tensors_launch_the_kernels(card):
    x = torch.rand(40, 40)
    px = torch.linspace(0, 1, 22)
    g, o = tonemap.tone_map(x, px, px, M)
    assert g.shape == (40, 40) and g.dtype == torch.float32
    assert o.shape == (20, 20) and o.dtype == torch.uint8
    g, o = tonemap.tone_map(x[3:17], px, px, M, 3)  # rows 10 .. 16 inside the crop
    assert g.shape == (14, 40) and o.shape == (7, 20)
    g, o = tonemap.tone_map(x[:8], px, px, M)  # inside the top margin
    assert o.shape == (0, 20)
    _, _, tab = tonemap.tone_tables(x, px, px, M)
    assert tab.shape == (4, 23)
    sds = fh.sdevs([x, x[:20, :20].contiguous()])
    assert [tuple(s.shape) for s in sds] == [(40, 40), (20, 20)]
    (sd,) = fh.sdevs_rows([x[2:30]], [2], [(4, 28)])
    assert sd.shape == (24, 40)
    names = [(fn, counter) for fn, counter, _ in card]
    assert names == [("musica_tone_map", "tone_map")] * 4 + [("musica_sdev", "sdev")] * 2
    args = [a for _, _, a in card]
    # x, graded, out, gpx, gpy, k, rows, n, row0, m, tables
    assert args[0][0] == x.data_ptr() and args[0][5:11] == (22, 40, 40, 0, M, None)
    assert args[1][5:10] == (22, 14, 40, 3, M)
    assert args[2][6:10] == (8, 40, 0, M)
    assert args[3][10] is not None
    # bands, sdevs, ns, los, his, r0s, r1s, levels, grid
    assert list(args[4][2]) == [40, 20] and list(args[4][3]) == [0, 0]
    assert list(args[4][4]) == [40, 20] and list(args[4][6]) == [40, 20] and args[4][7:] == (2, 0)
    assert list(args[5][3]) == [2] and list(args[5][4]) == [30]
    assert (list(args[5][5]), list(args[5][6])) == ([4], [28])


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    x = torch.rand(40, 40)
    px = torch.linspace(0, 1, 22)
    with pytest.raises(TypeError):
        tonemap.tone_map(x.double(), px, px, M)
    with pytest.raises(ValueError):
        tonemap.tone_map(x.T, px, px, M)
    with pytest.raises(ValueError):
        tonemap.tone_map(x, torch.rand(64), torch.rand(64), M)  # past 63 points
    with pytest.raises(ValueError):
        tonemap.tone_map(x, px, px[:21], M)
    with pytest.raises(ValueError):
        tonemap.tone_map(x, px, px, 20)
    with pytest.raises(ValueError):
        tonemap.tone_map(x[30:], px, px, M, 35)
    with pytest.raises(ValueError, match="window holds"):
        fh.sdevs_rows([x[4:20]], [4], [(4, 20)])
    with pytest.raises(ValueError):
        fh.sdevs([x[:, :30]])  # not contiguous
    assert card == []


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("fused_sdev", [False, True])
def test_the_pipeline_takes_each_wrapper_once(monkeypatch, fused_sdev):
    """musica_forward: the analysis levels' sdev in one ``fh.sdevs`` call
    (none with fused_sdev: K7 gives it) and the tone map in one
    ``tonemap.tone_map`` call; the spatial path both once per shard."""
    calls = []
    for module, name in ((fh, "sdevs"), (fh, "sdevs_rows"), (tonemap, "tone_map")):
        _spy(monkeypatch, module, name, calls)
    cfg = MusicaConfig(image_size=128)
    imgs = np.stack([synthetic_radiograph(128, "hand")])
    want = musica.musica_forward(torch.from_numpy(imgs[0]), cfg, fused_sdev=fused_sdev)
    assert calls == ([] if fused_sdev else ["sdevs"]) + ["tone_map"]
    calls.clear()
    mesh = sharding.make_mesh(n_data=1, n_space=2, devices=[torch.device("cpu")] * 2)
    got = sharding.process_sharded_eager(imgs, cfg, mesh, fused_sdev=fused_sdev)
    assert calls == ([] if fused_sdev else ["sdevs_rows"] * 2) + ["tone_map"] * 2
    assert torch.equal(got[0], want["out_u8"])
