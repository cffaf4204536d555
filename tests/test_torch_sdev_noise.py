"""The fused sdev + noise-histogram step of the PyTorch port
(``ops/cuda/fused_hist.py::sdev_noise_hists``, kernel 7's wrapper, and
``ops/stats.py::sdev_and_noise_histograms``) and the fused-sdev analysis
path (``musica_forward(fused_sdev=True)``) on the CPU.

The port's sdev accumulates in float64, as golden does; the JAX package's
``sdev_noise_hist_fused`` accumulates in float32.  So the port is held to
the JAX kernel as tests/test_fused_hist.py holds that kernel to golden: the
sdev equals golden bit for bit and lies within 2e-6 of the JAX kernel's
(Pallas interpret mode), and the histogram equals golden's and the JAX
package's exact two-step histogram ("fact") on the port's own sdev.  (The
JAX kernels in interpret mode on the CPU divide by 0.1 through a reciprocal:
on the 512 random band they move 3 of 262,144 bin decisions that sit within
an ulp of a bin edge, so their histogram logic is held against the port's
on nudged inputs, in tests/test_torch_fused_hist.py.)  Where the JAX
package falls back to two steps (coverage != level size), the port's one
step equals its own two steps exactly.  End to end, the fused-sdev path
equals the default path bit for bit and meets docs/PARITY.md's bar against
the JAX package's ``hist_method="fused_sdev_interpret"``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica as j_musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import stats as j_stats
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import synthetic_radiograph
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import normalize, pyramid, stats
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch

from test_torch_pipeline import assert_u8_parity

torch.set_num_threads(2)

F32 = np.float32


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_band(seed, n):
    """As tests/test_fused_hist.py's K7 input: N(0, 0.02) with 1 % zeros."""
    rng = np.random.default_rng(seed)
    band = rng.normal(0, 0.02, (n, n)).astype(F32)
    band[rng.uniform(size=(n, n)) < 0.01] = 0.0
    return band


def _bands(size, anatomy):
    """The analysis levels' bandpass images of a phantom, as the main path
    makes them (dict keyed by level)."""
    cfg = MusicaConfig(image_size=size)
    nrm, _, _ = normalize.normalize_from_u16(T(synthetic_radiograph(size, anatomy)), cfg.quirks)
    bands, _ = pyramid.reduce_ladder(nrm, cfg.pyramid_levels)
    return {i: bands[i] for i in cfg.analysis_levels}


@pytest.mark.parametrize("source,level", [("random", 0), ("thorax", 0), ("thorax", 1),
                                          ("thorax", 2), ("thorax", 3)])
def test_plain_version_matches_jax_kernel_and_golden(source, level):
    """A 512 random band and the 512 thorax levels (512, 256, 128, 64):
    every one is fully covered, so the JAX package runs its kernel on each."""
    cfg = MusicaConfig(image_size=512)
    band = _random_band(75, 512) if source == "random" else _bands(512, "thorax")[level].numpy()
    assert stats.coverage(band.shape[-1], cfg) == band.shape[-1]
    sds, hs, mbs = fh.sdev_noise_hists([T(band)], cfg)
    assert len(sds) == 1 and sds[0].dtype == torch.float32 and sds[0].shape == band.shape
    assert hs.dtype == torch.int32 and hs.shape == (1, cfg.noise_histogram_bins)
    assert mbs.dtype == torch.int32 and mbs.tolist() == [int(np.argmax(hs[0].numpy()))]
    sd, h = sds[0].numpy(), hs[0].numpy()
    np.testing.assert_array_equal(sd, golden.img_sdev(band))
    j_sd, _ = j_stats.sdev_and_noise_histogram(jnp.asarray(band), cfg, "fused_sdev_interpret")
    np.testing.assert_allclose(sd, np.asarray(j_sd), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(h.astype(np.int64), golden.noise_histogram(sd, cfg))
    np.testing.assert_array_equal(
        h, np.asarray(j_stats.noise_histogram(jnp.asarray(sd), cfg, "fact")))
    assert h.sum() > 0


@pytest.mark.parametrize("n,image_size", [(40, 512), (600, 600), (75, 600)])
def test_partial_coverage_equals_two_step(n, image_size):
    """Coverage padded (40 -> 48, 75 -> 80) or cropped (600 -> 512): the
    JAX package falls back to img_sdev + noise_histogram there; the port's
    one step equals its own two steps exactly, and those the JAX package's."""
    cfg = MusicaConfig(image_size=image_size)
    assert stats.coverage(n, cfg) != n
    band = _random_band(76 + n, n)
    sds, hs, mbs = fh.sdev_noise_hists([T(band)], cfg)
    sd_ref = stats.img_sdev(T(band))
    assert int(mbs[0]) == int(np.argmax(hs[0].numpy()))
    assert torch.equal(sds[0], sd_ref)
    assert torch.equal(hs[0], stats.noise_histogram(sd_ref, cfg))
    assert int(hs.sum()) > 0
    j_sd, _ = j_stats.sdev_and_noise_histogram(jnp.asarray(band), cfg, "fused_sdev_interpret")
    np.testing.assert_allclose(sd_ref.numpy(), np.asarray(j_sd), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(hs[0].numpy().astype(np.int64),
                                  golden.noise_histogram(sd_ref.numpy(), cfg))
    np.testing.assert_array_equal(
        hs[0].numpy(), np.asarray(j_stats.noise_histogram(jnp.asarray(sd_ref.numpy()), cfg, "fact")))


@pytest.mark.parametrize("size,anatomy", [(512, "thorax"), (600, "pelvis"),
                                          (144, "hand"), (256, "knee")])
def test_levels_equal_two_step(size, anatomy):
    """All analysis levels in one call, keyed by level: equal to img_sdev +
    analysis_noise_hists, with int32 0-d argmaxes.  600 crops and pads,
    144 goes down to an 18-px level; below 512 the quirks coverage is 0
    (empty histograms, argmax 0)."""
    cfg = MusicaConfig(image_size=size)
    bands = _bands(size, anatomy)
    sdevs, hists, max_bins = stats.sdev_and_noise_histograms(bands, cfg)
    assert set(sdevs) == set(hists) == set(max_bins) == set(cfg.analysis_levels)
    ref_sd = {i: stats.img_sdev(b) for i, b in bands.items()}
    ref_h, ref_mb = stats.analysis_noise_hists(ref_sd, cfg)
    for i in cfg.analysis_levels:
        assert torch.equal(sdevs[i], ref_sd[i]), f"level {i}"
        assert torch.equal(hists[i], ref_h[i]), f"level {i}"
        assert max_bins[i].dtype == torch.int32 and max_bins[i].shape == ()
        assert int(max_bins[i]) == int(ref_mb[i]) == int(np.argmax(hists[i].numpy()))
    if size < 512:  # quirks coverage: whole 512-px workgroups only
        assert all(int(h.sum()) == 0 for h in hists.values())
    else:
        assert int(hists[0].sum()) > 0


def test_cpu_call_runs_plain_version_and_counts_no_launch():
    cfg = MusicaConfig(image_size=512)
    x = torch.rand((512, 512)) * 0.05
    launch.reset_launch_counts()
    sds, hs, mbs = fh.sdev_noise_hists([x, x[:64, :64].contiguous()], cfg)
    assert "sdev_noise_hist" in launch.LAUNCHES
    assert launch.LAUNCHES == {k: 0 for k in launch.LAUNCHES}
    plain_sd, plain_h = fh.sdev_noise_hists_plain([x, x[:64, :64].contiguous()], cfg)
    assert all(torch.equal(a, b) for a, b in zip(sds, plain_sd))
    assert torch.equal(hs, plain_h)
    assert torch.equal(mbs, fh.hist_argmax_plain(plain_h))
    with pytest.raises(ValueError):
        fh.sdev_noise_hists([x, x.to("meta")], cfg)  # mixed devices


def _tensors_equal(a, b):
    if isinstance(a, tuple):
        return all(_tensors_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("size,anatomy,storage", [(256, "thorax", "float32"),
                                                  (512, "thorax", "float32"),
                                                  (600, "pelvis", "float32"),
                                                  (512, "hand", "bfloat16")])
def test_fused_sdev_path_equals_default(size, anatomy, storage):
    """musica_forward(fused_sdev=True) gives every output and intermediate
    of the default path bit for bit (600: ragged levels and cropped
    coverage; bf16 band storage)."""
    cfg = MusicaConfig(image_size=size, storage=storage)
    x = T(synthetic_radiograph(size, anatomy))
    ref = musica.musica_forward(x, cfg, want_intermediates=True)
    got = musica.musica_forward(x, cfg, want_intermediates=True, fused_sdev=True)
    for k in ("out_u8", "graded", "recon", "cnr"):
        assert _tensors_equal(got[k], ref[k]), k
    gi, ri = got["intermediates"], ref["intermediates"]
    assert set(gi) == set(ri)
    for k in ri:
        assert _tensors_equal(gi[k], ri[k]), k
    fast = musica.musica_forward(x, cfg, fused_sdev=True)
    assert torch.equal(fast["out_u8"], ref["out_u8"])


@pytest.mark.parametrize("size", [256, 512])
def test_fused_sdev_path_matches_jax(size):
    """Against the JAX package's fused-sdev path (its kernel in interpret
    mode at 512, where every level is fully covered; its two-step fallback
    at 256, where the quirks coverage is 0): equal argmax bins and
    t0/ta/t1, sdev within 2e-6, u8 output at the parity bar."""
    cfg = MusicaConfig(image_size=size)
    img = synthetic_radiograph(size, "thorax")
    res = musica.musica_forward(T(img), cfg, want_intermediates=True, fused_sdev=True)
    jres = jax.jit(lambda im: j_musica.musica_forward(
        im, cfg, "fused_sdev_interpret", want_intermediates=True))(jnp.asarray(img))
    ti, ji = res["intermediates"], jres["intermediates"]
    assert set(ti) == set(ji)
    for i in cfg.analysis_levels:
        assert int(ti[f"noise_max_bin_{i}"]) == int(ji[f"noise_max_bin_{i}"]), f"level {i}"
        np.testing.assert_allclose(ti[f"sdev_{i}"].numpy(), np.asarray(ji[f"sdev_{i}"]),
                                   rtol=0, atol=2e-6, err_msg=f"level {i}")
    assert (tuple(float(t) for t in ti["grad_curve"][2])
            == tuple(float(t) for t in ji["grad_curve"][2]))
    assert_u8_parity(res["out_u8"].numpy(), np.asarray(jres["out_u8"]), "vs JAX fused_sdev")


def test_fused_sdev_host_entry_points():
    """process, process_batch and timed_process take fused_sdev and give
    the default path's output."""
    cfg = MusicaConfig(image_size=128)
    imgs = np.stack([synthetic_radiograph(128, a) for a in ("hand", "knee")])
    want = musica.process_batch(imgs, cfg, "cpu")
    np.testing.assert_array_equal(musica.process_batch(imgs, cfg, "cpu", fused_sdev=True), want)
    np.testing.assert_array_equal(musica.process(imgs[0], cfg, "cpu", fused_sdev=True), want[0])
    out, times = musica.timed_process(imgs[1], cfg, "cpu", fused_sdev=True)
    np.testing.assert_array_equal(out, want[1])
    assert list(times) == ["norm", "red", "anly", "aply", "exp", "grad", "tot"]
