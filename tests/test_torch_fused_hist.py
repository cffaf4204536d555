"""The histogram module of the PyTorch port (``ops/cuda/fused_hist.py``) on
the CPU: its plain versions against the JAX package's Pallas kernels in
interpret mode and against the golden model, plus the wrapper's dispatch,
launch counters and build errors.

Counts and argmaxes must be exactly equal.  Pixels whose bin decision lies
within 1e-3 of a boundary are nudged first (helpers copied from
tests/test_fused_hist.py): differently compiled programs may round such a
decision value differently (QUIRKS #29), and these tests target the kernel
logic -- break/return semantics, coverage, weights -- not that rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import (
    gradation as j_gradation, noise as j_noise, stats as j_stats)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import gradation, noise, stats
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import build
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh

torch.set_num_threads(2)

F32 = np.float32


def _snap_noise_bins(sd: np.ndarray, cfg, eps: float = 1e-3) -> np.ndarray:
    """Nudge pixels whose noise-hist decision value ``v/0.1*2048 + 0.5``
    (shaders/noise_hist.comp:31-35) lies within ``eps`` of an integer."""
    sd = sd.copy()
    for _ in range(8):
        t = (sd.astype(F32) / F32(cfg.max_noise_value)) \
            * F32(cfg.noise_histogram_bins) + F32(0.5)
        near = (np.abs(t - np.round(t)) < eps) & (sd > 0)
        if not near.any():
            return sd
        sd[near] *= F32(1.0007)
    raise AssertionError("could not move pixels off bin boundaries")


def _snap_grad_bins(recon: np.ndarray, cfg, eps: float = 1e-3) -> np.ndarray:
    """Nudge pixels whose gradation-hist decision value ``v * 1024``
    (shaders/gradation_histogram.comp:27) lies within ``eps`` of an
    integer truncation boundary."""
    recon = recon.copy()
    for _ in range(8):
        t = recon.astype(F32) * F32(cfg.grad_histogram_bins)
        near = (np.abs(t - np.round(t)) < eps) & (recon != 0)
        if not near.any():
            return recon
        recon[near] += F32(eps / cfg.grad_histogram_bins * 4)
    raise AssertionError("could not move pixels off bin boundaries")


def _snap_weights(relevant: np.ndarray, eps: float = 1e-3) -> np.ndarray:
    """Nudge relevance weights whose ``uint(rel * 100)``
    (shaders/gradation_histogram.comp:30) sits within ``eps`` of a step."""
    relevant = relevant.copy()
    t = relevant.astype(F32) * F32(100.0)
    near = np.abs(t - np.round(t)) < eps
    relevant[near] += F32(0.003)
    return relevant


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _noise_levels(seed, cfg, zero_frac=0.08, empty_level=None):
    rng = np.random.default_rng(seed)
    out = {}
    for i in cfg.analysis_levels:
        n = -(-cfg.image_size // 2 ** i)
        sd = rng.uniform(0, 0.12, (n, n)).astype(F32)
        sd[rng.uniform(size=(n, n)) < zero_frac] = 0.0
        if i == empty_level:
            sd[:] = 0.0
        out[i] = _snap_noise_bins(sd, cfg)
    return out


# ----------------------------------------------------------------------
# noise histogram + argmax
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,image_size,seed", [(256, 512, 71), (128, 1024, 72),
                                               (600, 600, 73), (75, 600, 74)])
def test_noise_hist_matches_pallas_interpret_and_golden(n, image_size, seed):
    """One level, every break kind, the coverage crop (600 -> 512) and pad
    (75 -> 80): plain version == Pallas ``noise_hist_fused`` (interpret) ==
    golden."""
    rng = np.random.default_rng(seed)
    cfg = MusicaConfig(image_size=image_size)
    sd = rng.uniform(0, 0.15, (n, n)).astype(F32)
    sd[rng.uniform(size=(n, n)) < 0.1] = 0.0
    sd = _snap_noise_bins(sd, cfg)
    got = stats.noise_histogram(T(sd), cfg)
    assert got.dtype == torch.int32 and got.shape == (2048,)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), golden.noise_histogram(sd, cfg))
    ref = np.asarray(j_stats.noise_histogram(jnp.asarray(sd), cfg, "fused_interpret"))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_multi_level_matches_pallas_multi_interpret():
    """All levels in one call: hists and FIRST-max argmaxes equal what the
    JAX package's "multi_interpret" dispatch gives (at 1024 its level-0
    coverage exceeds 512, so it runs the Pallas per-level kernels in
    interpret mode), including an all-zero level (argmax 0)."""
    cfg = MusicaConfig(image_size=1024)
    sdevs = _noise_levels(77, cfg, empty_level=3)
    hists, maxb = stats.analysis_noise_hists({i: T(v) for i, v in sdevs.items()}, cfg)
    jh, jm = j_stats.analysis_noise_hists({i: jnp.asarray(v) for i, v in sdevs.items()},
                                          cfg, "multi_interpret")
    for i in cfg.analysis_levels:
        np.testing.assert_array_equal(hists[i].numpy(), np.asarray(jh[i]), err_msg=f"level {i}")
        assert int(maxb[i]) == int(jm[i]), f"level {i}"
        assert maxb[i].dtype == torch.int32 and maxb[i].shape == ()
    assert int(maxb[3]) == 0


@pytest.mark.parametrize("image_size", [512, 600, 256])
def test_levels_match_per_level_fact(image_size):
    """The level-list call equals the JAX package's per-level path ('fact')
    at the slice's sizes: 512 (full coverage), 600 (crop + pads) and 256
    (quirks coverage 0: every histogram empty, every argmax 0)."""
    cfg = MusicaConfig(image_size=image_size)
    sdevs = _noise_levels(image_size, cfg)
    hs, mbs = fh.noise_hist_levels([T(sdevs[i]) for i in cfg.analysis_levels], cfg)
    for j, i in enumerate(cfg.analysis_levels):
        ref = np.asarray(j_stats.noise_histogram(jnp.asarray(sdevs[i]), cfg, "fact"))
        np.testing.assert_array_equal(hs[j].numpy(), ref, err_msg=f"level {i}")
        assert int(mbs[j]) == int(np.argmax(ref))
    if image_size < 512:
        assert int(hs.sum()) == 0 and int(mbs.abs().sum()) == 0


def test_argmax_first_max_tie():
    """Equal counts in two bins: the first bin wins, as the Pallas kernel's
    in-kernel argmax (strict >)."""
    cfg = MusicaConfig(image_size=512)
    v1, v2 = F32(0.0301), F32(0.0703)
    sdevs = {i: np.zeros((512 >> i, 512 >> i), F32) for i in cfg.analysis_levels}
    sdevs[0][0, :16] = v1   # one full tile-column group each, no breaks
    sdevs[0][0, 16:32] = v2
    hists, maxb = stats.analysis_noise_hists({i: T(v) for i, v in sdevs.items()}, cfg)
    h0 = hists[0].numpy()
    assert len(np.flatnonzero(h0 == h0.max())) == 2
    assert int(maxb[0]) == int(np.argmax(h0)) == golden.histogram_max(h0)[1]
    # the JAX multi-level kernel does not lower in interpret mode on the CPU
    # at this size (every cov <= 512); its per-level kernels do
    jh, jm = j_stats.analysis_noise_hists({i: jnp.asarray(v) for i, v in sdevs.items()},
                                          cfg, "fused_interpret")
    np.testing.assert_array_equal(np.asarray(jh[0]), h0)
    assert int(jm[0]) == int(maxb[0])


# ----------------------------------------------------------------------
# gradation histograms
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(256, 73), (600, 75), (75, 76)])
def test_grad_hist_matches_pallas_interpret_and_golden(n, seed):
    """Relevance-image histogram with the whole-tile return: plain version
    == Pallas ``grad_hist_fused`` (interpret) == golden; 600 and 75 are
    ragged (pixels past n read as 0.0 and end their tile)."""
    rng = np.random.default_rng(seed)
    cfg = MusicaConfig(image_size=n)
    recon = rng.uniform(-0.1, 1.2, (n, n)).astype(F32)
    recon[rng.uniform(size=(n, n)) < 0.02] = 0.0
    recon = _snap_grad_bins(recon, cfg)
    relevant = _snap_weights((rng.uniform(0, 1, (n, n)) ** 2).astype(F32))
    got = gradation.gradation_histogram(T(recon), T(relevant), cfg)
    assert got.dtype == torch.int32 and got.shape == (1024,)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  golden.gradation_histogram(recon, relevant, cfg))
    ref = np.asarray(j_gradation.gradation_histogram(
        jnp.asarray(recon), jnp.asarray(relevant), cfg, "fused_interpret"))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n,cnr_n,border", [(512, 64, 100), (256, 32, 20)])
def test_grad_hist_relevant_matches_pallas_interpret(n, cnr_n, border):
    """In-kernel relevance histogram: plain version == Pallas
    ``grad_hist_relevant_fused`` (interpret) == golden's two steps."""
    rng = np.random.default_rng(n + border)
    cfg = MusicaConfig(image_size=n, relevant_border=border)
    recon = rng.uniform(-0.1, 1.2, (n, n)).astype(F32)
    recon[rng.uniform(size=(n, n)) < 0.02] = 0.0
    recon = _snap_grad_bins(recon, cfg)
    normalized = rng.uniform(0, 1.01, (n, n)).astype(F32)
    cnr = rng.uniform(0, 0.1, (cnr_n, cnr_n)).astype(F32)
    got = gradation.gradation_histogram_fused_relevance(T(recon), T(normalized), T(cnr), cfg)
    ref = np.asarray(j_gradation.gradation_histogram_fused_relevance(
        jnp.asarray(recon), jnp.asarray(normalized), jnp.asarray(cnr), cfg,
        "fused_interpret"))
    np.testing.assert_array_equal(got.numpy(), ref)
    rel = golden.img_relevant(normalized, cnr, cfg)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  golden.gradation_histogram(recon, rel, cfg))


def test_relevance_weight_plane_equals_relevance_image():
    """The CUDA wrapper's block weight plane, expanded and completed with the
    per-pixel border and intensity tests, is trunc(img_relevant * 100)."""
    cfg = MusicaConfig(image_size=512)
    rng = np.random.default_rng(5)
    cnr = T(rng.uniform(0, 0.1, (64, 64)).astype(F32))
    cnr[0, :4] = torch.tensor([1.0, 6.0, 256.0, 300.0]) / 256.0  # range edges
    nrm = T(rng.uniform(0, 1.01, (512, 512)).astype(F32))
    plane = fh.relevance_weight_plane(cnr, cfg)
    assert plane.dtype == torch.int32
    up = noise.nearest_upsample(plane, 512)
    xs = torch.arange(512)
    inb = (xs > cfg.relevant_border) & (xs < 512 - cfg.relevant_border)
    w = torch.where(up >= 0, up, torch.where(nrm <= cfg.relevant_max_pixel, 100, 0))
    w = torch.where(inb[:, None] & inb[None, :], w, 0)
    ref = (noise.img_relevant(nrm, cnr, cfg) * 100.0).to(torch.int32)
    assert torch.equal(w.to(torch.int32), ref)
    np.testing.assert_array_equal(
        ref.numpy(), (np.asarray(j_noise.img_relevant(jnp.asarray(nrm.numpy()),
                                                      jnp.asarray(cnr.numpy()), cfg))
                      * F32(100)).astype(np.int32))


# ----------------------------------------------------------------------
# dispatch, counters, errors
# ----------------------------------------------------------------------

def test_cpu_calls_run_plain_versions_and_count_no_launch():
    cfg = MusicaConfig(image_size=512)
    fh.reset_launch_counts()
    x = torch.rand((512, 512))
    fh.noise_hist_levels([x, x[:256, :256].contiguous()], cfg)
    fh.grad_hist(x, x, cfg)
    fh.grad_hist_relevant(x, x, torch.rand((64, 64)), cfg)
    assert fh.LAUNCHES == {k: 0 for k in fh.LAUNCHES}
    with pytest.raises(ValueError):
        fh.grad_hist(x, x.to("meta"), cfg)  # mixed devices


def test_failed_launch_raises_and_is_not_counted():
    class FakeLib:
        @staticmethod
        def musica_grad_hist(*args):
            return 700

        @staticmethod
        def musica_error_string(code):
            return b"an illegal memory access was encountered"

    fh.reset_launch_counts()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fh._launch(FakeLib, "musica_grad_hist", "grad_hist")
    assert fh.LAUNCHES["grad_hist"] == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: building raises (no plain-version fallback for CUDA inputs)."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    if (build.Path("/usr/local/cuda") / "bin" / "nvcc").exists():
        pytest.skip("this machine has nvcc under /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "kernels").exists() or not list((tmp_path / "kernels").iterdir())


def test_library_name_follows_source_hash(monkeypatch, tmp_path):
    """An edited source gets a new library name, so it is rebuilt."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    monkeypatch.setattr(build, "SRC_DIR", src)
    first = build.library_path()
    (src / "a.cu").write_text("// two\n")
    assert build.library_path() != first
    assert build.library_path().parent == build.BUILD_DIR
