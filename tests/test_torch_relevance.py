"""The relevance mask inside the kernels that read it, on the CPU: K3's
block weights (``ops/cuda/fused_hist.py::grad_hist_relevant``), the CLAHE
joint histogram KH (``ops/cuda/clahe_hist.py``) and the LUTs KC
(``ops/cuda/clahe_curves.py``).

* A float32 NumPy model of the kernels' per-block weight
  (``csrc/relevance.cuh::block_weight``) on dense CNR values (every float32
  within 64 ulps of the rule's edges, 0, NaN, +-inf) equals
  ``relevance_weight_plane`` bit for bit, and, expanded with the border and
  the pixel test, the relevance image of the port and of the JAX package;
  KH's reading of a weight (``relevance_of_weight``: 100 is a ramp value of
  1.0) gives the pixels where that image is 1.0.  For a non-integer
  exponent the kernels read the plane, which expands to the image alike.
* A NumPy model of KH's per-pixel bin (NaN to bin 0, saturating, as XLA
  and the card convert) and of KC's lane-partitioned float64 scan equals
  the plain versions.
* KH's plain version equals the JAX package's ``clahe_histograms`` of its
  relevance image exactly (NaN recon pixels included), and its row
  partitions sum to the whole.
* The CLAHE + linear path through the new dispatch meets the parity bar
  against the JAX package's ``musica_forward`` at 256 and 600, its
  ``clahe_graded`` within 1e-4 of golden and the JAX package (NaN masks
  equal), and bit-equal to the port's old route (the relevance image
  through ``clahe_grade``).
* The wrappers' CUDA paths through a recording ``launch`` (``card``
  fixture): their arguments, the explicit plane route of a non-integer
  exponent, their refusals, and the pipeline taking KH and KC once (the
  spatial path once a shard).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica as j_musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import clahe as j_clahe
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import noise as j_noise
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import synthetic_radiograph
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import clahe, noise
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import clahe_curves as kc
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import clahe_hist as kh
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import relevance_cases

torch.set_num_threads(2)

F32 = np.float32
EXPONENTS = [5.0, 1.0, 8.0, 4.5]  # the chain at 5 (the default), 1 and 8; pow at 4.5


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------------------------
# a float32 NumPy model of the kernels' per-block decision
# ----------------------------------------------------------------------

def _ramp(c, cfg):
    """(c / top)^k as csrc/relevance.cuh::ramp_value: a true float32
    division, then the multiply chain."""
    with np.errstate(all="ignore"):
        x = c / F32(cfg.relevant_cnr_low + cfg.relevant_cnr_ramp)
        acc = x
        for _ in range(int(cfg.relevant_k) - 1):
            acc = acc * x
    return acc


def _regions(cnr, cfg):
    with np.errstate(all="ignore"):
        c = cnr * F32(cfg.max_cnr_value)
        top = F32(cfg.relevant_cnr_low + cfg.relevant_cnr_ramp)
        ramp = (c >= F32(cfg.relevant_cnr_low)) & (c <= top)
        solid = (c >= top) & (c <= F32(cfg.max_cnr_value))
    return c, ramp, solid


def block_weight_model(cnr, cfg):
    """K3's weight of each CNR block (int32): trunc((c / top)^k * 100) on
    the ramp, -1 for a solid block off it, else 0."""
    c, ramp, solid = _regions(cnr, cfg)
    with np.errstate(all="ignore"):
        w = np.where(ramp, _ramp(c, cfg) * F32(100), 0).astype(np.int64)
    return np.where(ramp, w, np.where(solid, -1, 0)).astype(np.int32)


def relevance_of_weight(w):
    """KH's decision from a block weight (``relevance.cuh``): 1 where it is
    100 (a ramp value of 1.0), -1 for a solid block, else 0."""
    return np.where(w == 100, 1, np.where(w == -1, -1, 0)).astype(np.int32)


def _expand(plane, nrm, cfg, solid_value):
    """A block plane expanded to pixels (nearest upsampling), the border and
    the pixel test of a solid block applied: the relevance as the kernels
    see it."""
    n = nrm.shape[-1]
    up = noise.nearest_upsample(T(plane), n).numpy()
    xs = np.arange(n)
    inner = (xs > cfg.relevant_border) & (xs < n - cfg.relevant_border)
    w = np.where(up >= 0, up, np.where(nrm <= F32(cfg.relevant_max_pixel), solid_value, 0))
    return np.where(inner[:, None] & inner[None, :], w, 0)


@functools.lru_cache(maxsize=None)
def _dense(n, k, border=40):
    """Dense CNR values (``relevance_cases.dense_cnr``) on an n-px image's
    CNR map, pixels around max_pixel, and the port's relevance image."""
    cfg = MusicaConfig(image_size=n, relevant_k=k, relevant_border=border)
    rng = np.random.default_rng(int(10 * k) + n)
    cnr = relevance_cases.dense_cnr(rng, cfg, -(-n // 8))
    nrm = relevance_cases.pixel_tests(rng, n, cfg)
    return cfg, cnr, nrm, noise.img_relevant(T(nrm), T(cnr), cfg).numpy()


def test_dense_cnr_holds_every_edge_value():
    cfg = MusicaConfig(image_size=512)
    cnr = relevance_cases.dense_cnr(np.random.default_rng(0), cfg, 64)
    c = cnr * F32(256)
    for edge in (1.0, 6.0, 256.0):
        near = c[np.isfinite(c) & (np.abs(c - F32(edge)) < 1e-3 * edge)]
        assert len(np.unique(near)) == 129, edge
    assert np.isnan(c).any() and np.isposinf(c).any() and np.isneginf(c).any() and (c == 0).any()


@pytest.mark.parametrize("k", EXPONENTS)
def test_block_weight_model_equals_the_weight_plane(k):
    """K3's decision: the model equals ``relevance_weight_plane`` where the
    kernel computes it (integer k); for 4.5 the kernel reads that plane."""
    cfg, cnr, nrm, rel = _dense(512, k)
    plane = fh.relevance_weight_plane(T(cnr), cfg).numpy()
    if noise.chain_exponent(k):
        np.testing.assert_array_equal(block_weight_model(cnr, cfg), plane)
    # expanded with the border and the pixel test it is trunc(relevance * 100)
    want = (T(rel) * 100.0).to(torch.int32).numpy()
    np.testing.assert_array_equal(_expand(plane, nrm, cfg, 100), want)


@pytest.mark.parametrize("k", EXPONENTS)
def test_kh_decision_from_the_weight_plane(k):
    """KH's decision: the weights (the model's for an integer k, the plane
    it reads for 4.5) read as KH reads them, expanded, are 1 exactly where
    the relevance image is 1.0."""
    cfg, cnr, nrm, rel = _dense(512, k)
    plane = fh.relevance_weight_plane(T(cnr), cfg).numpy()
    weights = block_weight_model(cnr, cfg) if noise.chain_exponent(k) else plane
    np.testing.assert_array_equal(_expand(relevance_of_weight(weights), nrm, cfg, 1),
                                  (rel == 1.0).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 2.0 ** -10), (0.99, 1.0), (1 - 2.0 ** -12, 1.0)])
def test_a_weight_of_100_is_a_ramp_value_of_one(lo, hi):
    """Every float32 v in [lo, hi] (the ramp's values lie in [0, 1]):
    trunc(v * 100) is 100 exactly where v is 1.0, so KH's reading of K3's
    weight is its own test \"the relevance equals 1.0\"."""
    a, b = np.array([lo, hi], F32).view(np.int32)
    v = np.arange(a, b + 1, max(1, (b - a) // (1 << 20)), dtype=np.int32).view(F32)
    v = np.concatenate([v, np.array([hi], F32)])
    w = (T(v) * 100.0).to(torch.int32).numpy()
    np.testing.assert_array_equal(w == 100, v == F32(1))
    assert (w <= 100).all()


@pytest.mark.parametrize("k", [5.0, 1.0])
def test_the_models_against_the_jax_relevance_image(k):
    cfg, cnr, nrm, rel = _dense(256, k)
    jrel = np.asarray(j_noise.img_relevant(jnp.asarray(nrm), jnp.asarray(cnr), cfg))
    np.testing.assert_array_equal(rel.view(np.int32), jrel.view(np.int32))
    np.testing.assert_array_equal(
        _expand(relevance_of_weight(block_weight_model(cnr, cfg)), nrm, cfg, 1),
        (jrel == 1.0).astype(np.int64))
    np.testing.assert_array_equal(_expand(block_weight_model(cnr, cfg), nrm, cfg, 100),
                                  (jrel * F32(100)).astype(np.int32))


def test_chain_exponent():
    assert [noise.chain_exponent(k) for k in (1, 5.0, 8, 0, 9, 4.5, -2)] == [1, 5, 8, 0, 0, 0, 0]


# ----------------------------------------------------------------------
# KH: the per-pixel bin, the plain version against the JAX package
# ----------------------------------------------------------------------

def bin_model(recon, bins):
    """KH's bin: the float32 product and sum, converted as the card's and
    XLA's conversion to int32 (truncation, NaN to 0, saturating)."""
    with np.errstate(all="ignore"):
        bf = recon * F32(bins - 1) + F32(0.5)
        b = np.trunc(np.nan_to_num(bf, nan=0.0, posinf=2.0 ** 31, neginf=-2.0 ** 31))
    return np.clip(b, -2.0 ** 31, 2.0 ** 31 - 1).astype(np.int64)


def test_bin_model_equals_the_plain_joint_bins():
    cfg = MusicaConfig(image_size=144, enable_clahe=True)
    recon = relevance_cases.clahe_recon(np.random.default_rng(3), 144, cfg.clahe_bins)
    rel = np.ones((144, 144), F32)
    joint, w = clahe.clahe_joint_bins(T(recon), T(rel), cfg)
    b = bin_model(recon, cfg.clahe_bins)
    keep = (b >= 0) & (b < cfg.clahe_bins)
    np.testing.assert_array_equal(w.numpy(), keep.astype(np.int32))
    np.testing.assert_array_equal(joint.numpy() % cfg.clahe_bins, np.where(keep, b, 0))
    assert keep[np.isnan(recon)].all() and (b[np.isnan(recon)] == 0).all()


@functools.lru_cache(maxsize=None)
def _kh_inputs(n, tiles, k=5.0):
    cfg = MusicaConfig(image_size=n, enable_clahe=True, clahe_tiles=tiles, relevant_k=k,
                       relevant_border=20)
    rng = np.random.default_rng(n + tiles)
    recon = relevance_cases.clahe_recon(rng, n, cfg.clahe_bins)
    nrm = relevance_cases.pixel_tests(rng, n, cfg)
    cnr = relevance_cases.dense_cnr(rng, cfg, -(-n // 8))
    return cfg, recon, nrm, cnr


@pytest.mark.parametrize("n,tiles", [(144, 4), (256, 4), (256, 8)])
def test_kh_plain_matches_jax_clahe_histograms(n, tiles):
    """The relevance image and the joint histogram of the JAX package
    (``"fact"``: its factorised histogram), NaN recon pixels counted in bin
    0 as XLA converts them."""
    cfg, recon, nrm, cnr = _kh_inputs(n, tiles)
    got = kh.clahe_hist(T(recon), T(nrm), T(cnr), cfg)
    jrel = j_noise.img_relevant(jnp.asarray(nrm), jnp.asarray(cnr), cfg)
    want = np.asarray(j_clahe.clahe_histograms(jnp.asarray(recon), jrel, cfg, "fact"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) > 0


@pytest.mark.parametrize("n,tiles", [(144, 4), (256, 8)])
def test_kh_windows_sum_to_the_whole(n, tiles):
    cfg, recon, nrm, cnr = _kh_inputs(n, tiles)
    whole = kh.clahe_hist(T(recon), T(nrm), T(cnr), cfg)
    for bounds in ([0, 48, 96, n], [0, 31, 77, 101, n]):
        total = torch.zeros_like(whole)
        for a, b in zip(bounds, bounds[1:]):
            c0, c1 = noise.cnr_rows(cnr.shape[-1], n, a, b)
            total += kh.clahe_hist(T(recon[a:b]), T(nrm[a:b]), T(cnr[c0:c1]), cfg, a, c0)
        assert torch.equal(total, whole), bounds


# ----------------------------------------------------------------------
# KC: the lane-partitioned scan
# ----------------------------------------------------------------------

def kc_model(h, cfg):
    """KC's arithmetic on int32 histograms [t, t, bins]: per tile 32 lanes of
    ceil(bins / 32) bins, each lane's float64 sums, the lanes' sums
    combined, then the lane's running sum."""
    bins = cfg.clahe_bins
    per = -(-bins // 32)
    with np.errstate(all="ignore"):
        total = h.astype(np.int64).sum(-1, keepdims=True).astype(F32)
        norm = h.astype(F32) / total
        clipped = np.where(np.isnan(norm), norm, np.minimum(norm, F32(cfg.clahe_clip_limit)))
        d = (norm - clipped).astype(np.float64)
        excess = sum(d[..., i * per:(i + 1) * per].sum(-1) for i in range(32))
        redist = clipped + (excess.astype(F32) / F32(bins))[..., None]
        lanes = [redist[..., i * per:(i + 1) * per].astype(np.float64) for i in range(32)]
        before = np.zeros(h.shape[:-1])
        out = []
        for lane in lanes:
            out.append((before[..., None] + np.cumsum(lane, -1)).astype(F32))
            before = before + lane.sum(-1)
    return np.concatenate(out, -1)


@pytest.mark.parametrize("tiles,bins", [(4, 256), (8, 256), (4, 64)])
def test_kc_model_equals_the_plain_curves(tiles, bins):
    cfg = MusicaConfig(image_size=512, enable_clahe=True, clahe_tiles=tiles, clahe_bins=bins)
    rng = np.random.default_rng(tiles * bins)
    for _ in range(8):
        h = relevance_cases.random_clahe_hists(rng, cfg)
        px, py = clahe.clahe_curves(T(h), cfg)
        want = py.numpy()
        got = kc_model(h, cfg)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.nan_to_num(got).view(np.int32),
                                      np.nan_to_num(want).view(np.int32))
        assert np.isnan(want).any() and px[-1] == 1.0


# ----------------------------------------------------------------------
# the CLAHE + linear path through KH and KC
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_forward(n, anatomy):
    cfg = MusicaConfig(image_size=n, enable_clahe=True, grad_with_linear_image=True)
    img = synthetic_radiograph(n, anatomy)
    jres = jax.jit(lambda im: j_musica.musica_forward(im, cfg, "fact"))(jnp.asarray(img))
    return cfg, img, {k: np.asarray(jres[k]) for k in ("out_u8", "clahe_graded")}


def _u8_parity(a, b, what):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    mse = np.mean(d.astype(np.float64) ** 2)
    psnr = np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    assert psnr >= 90.0 and np.mean(d == 0) > 0.9999 and d.max() <= 1, (what, psnr)


def _close(got, want, atol, what):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("n,anatomy", [(256, "thorax"), (600, "pelvis")])
def test_clahe_linear_path_matches_jax_golden_and_the_old_route(n, anatomy):
    cfg, img, jres = _jax_forward(n, anatomy)
    res = musica.musica_forward(T(img), cfg)
    _u8_parity(res["out_u8"].numpy(), jres["out_u8"], "out_u8 vs JAX")
    cg = res["clahe_graded"].numpy()
    _close(cg, jres["clahe_graded"], 1e-4, "clahe_graded vs JAX")
    _, gi = golden.process(img, cfg, return_intermediates=True)
    _close(cg, gi["clahe_graded"], 1e-4, "clahe_graded vs golden")
    # the old route: the relevance image through clahe_grade
    inter = musica.musica_forward(T(img), cfg, want_intermediates=True)["intermediates"]
    old = clahe.clahe_grade(res["recon"], inter["relevant"], cfg)
    assert torch.equal(res["clahe_graded"].view(torch.int32), old.view(torch.int32))


# ----------------------------------------------------------------------
# dispatch: the plain versions on the CPU, the kernels on a CUDA tensor
# ----------------------------------------------------------------------

@pytest.fixture
def card(monkeypatch):
    """The wrappers' CUDA paths on CPU inputs: tensors report a device that
    is not the CPU (outputs are allocated on ``meta``), and ``launch``
    records each call instead of calling the library."""
    calls = []
    monkeypatch.setattr(launch, "device_of", lambda ts: torch.device("meta"))
    monkeypatch.setattr(launch, "lib", lambda: None)
    monkeypatch.setattr(launch, "launch",
                        lambda lib, fn, counter, dev, *args: calls.append((fn, counter, args)))
    return calls


def _small(k=5.0, n=64):
    cfg = MusicaConfig(image_size=n, enable_clahe=True, relevant_k=k)
    rng = np.random.default_rng(1)
    x = T(rng.uniform(0, 1, (n, n)).astype(F32))
    cnr = T(rng.uniform(0, 0.1, (n // 8, n // 8)).astype(F32))
    return cfg, x, cnr


def test_cpu_tensors_take_the_plain_versions():
    cfg, x, cnr = _small()
    launch.reset_launch_counts()
    h = kh.clahe_hist(x, x, cnr, cfg)
    assert torch.equal(h, kh.clahe_hist_plain(x, x, cnr, cfg))
    px, py = clahe.clahe_curves(h, cfg)
    assert torch.equal(py.nan_to_num(), clahe.clahe_curves_plain(h, cfg)[1].nan_to_num())
    assert launch.LAUNCHES == {k: 0 for k in launch.LAUNCHES}


@pytest.mark.parametrize("k", [5.0, 4.5])
def test_kh_launch_takes_the_cnr_map_or_the_weight_plane(card, k):
    cfg, x, cnr = _small(k)
    h = kh.clahe_hist(x[8:40], x[8:40], cnr[1:5], cfg, 8, 1)
    assert h.shape == (4, 4, 256) and h.dtype == torch.int32
    (fn, counter, args), = card
    assert (fn, counter) == ("musica_clahe_hist", "clahe_hist")
    assert args[2:5] == (64, 8, 32)
    if k == 5.0:  # the chain: the CNR map and the exponent
        assert args[5] == cnr[1:5].data_ptr() and args[6] is None and args[15] == 5
    else:  # pow: the weight plane, no exponent
        assert args[5] is None and args[6] is not None and args[15] == 0
    assert args[7:11] == (8, 1, 4, cfg.relevant_border)
    assert args[11:15] == (F32(0.9), F32(256), F32(1), F32(6))
    assert args[16:18] == (4, 256)


@pytest.mark.parametrize("k", [5.0, 4.5])
def test_k3_launch_takes_the_cnr_map_or_the_weight_plane(card, k):
    cfg, x, cnr = _small(k)
    fh.grad_hist_relevant(x, x, cnr, cfg)
    (fn, counter, args), = card
    assert (fn, counter) == ("musica_grad_hist_relevant", "grad_hist_relevant")
    if k == 5.0:
        assert args[6] == cnr.data_ptr() and args[7] is None and args[17] == 5
    else:
        assert args[6] is None and args[7] is not None and args[17] == 0
    assert args[8:13] == (8, 0, 8, 8, cfg.relevant_border)
    assert args[13:17] == (F32(0.9), F32(256), F32(1), F32(6))


@pytest.mark.parametrize("rule", [{"relevant_cnr_low": -1.0}, {"relevant_k": -0.5}])
def test_kh_refuses_a_ramp_value_above_one(card, rule):
    """A negative ramp start or exponent can make the ramp's value exceed 1,
    where a weight of 100 is no longer a value of 1.0: KH refuses it."""
    cfg, x, cnr = _small()
    with pytest.raises(ValueError, match="at most 1"):
        kh.clahe_hist(x, x, cnr, cfg.with_(**rule))
    assert card == []


def test_kc_launch(card):
    cfg, _, _ = _small()
    h = torch.zeros((4, 4, 256), dtype=torch.int32)
    px, py = clahe.clahe_curves(h, cfg)
    assert px.shape == (256,) and py.shape == (4, 4, 256) and py.is_contiguous()
    (fn, counter, args), = card
    assert (fn, counter, args[:4]) == ("musica_clahe_curves", "clahe_curves",
                                       (h.data_ptr(), 16, 256, F32(1 / 32)))


def test_the_wrappers_reject_what_the_kernels_do_not_take(card):
    cfg, x, cnr = _small()
    with pytest.raises(ValueError, match="CNR rows"):
        kh.clahe_hist(x[8:40], x[8:40], cnr[2:5], cfg, 8, 2)  # row 8 reads CNR row 1
    with pytest.raises(ValueError):
        kh.clahe_hist(x, x[:32], cnr, cfg)
    with pytest.raises(ValueError, match="shared memory"):
        kh.clahe_hist(x, x, cnr, cfg.with_(clahe_tiles=32))  # 1 MB of bins
    with pytest.raises(TypeError):
        kh.clahe_hist(x.double(), x, cnr, cfg)
    for bad in (torch.zeros((4, 4, 256), dtype=torch.int64), torch.zeros((4, 4, 128),
                                                                          dtype=torch.int32)):
        with pytest.raises(ValueError):
            kc.clahe_curves(bad, cfg)
    assert card == []


def test_the_pipeline_takes_kh_and_kc_once(monkeypatch):
    """musica_forward takes KH, KC and K3 once and no K4 (no relevance
    image) where K3's condition holds; the spatial path KH and K3 once a
    shard and KC once an entry."""
    calls = {"clahe_hist": 0, "clahe_curves": 0, "grad_hist_relevant": 0, "grad_hist": 0}

    def spy(mod, name):
        real = getattr(mod, name)

        def f(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(mod, name, f)
    spy(kh, "clahe_hist")
    spy(clahe, "clahe_curves")
    spy(fh, "grad_hist_relevant")
    spy(fh, "grad_hist")
    cfg = MusicaConfig(image_size=128, enable_clahe=True, grad_with_linear_image=True,
                       relevant_border=10)
    imgs = np.stack([synthetic_radiograph(128, "hand")])
    want = musica.musica_forward(T(imgs[0]), cfg)
    assert calls == {"clahe_hist": 1, "clahe_curves": 1, "grad_hist_relevant": 1, "grad_hist": 0}
    calls.update({k: 0 for k in calls})
    mesh = sharding.make_mesh(n_data=1, n_space=2, devices=[torch.device("cpu")] * 2)
    got = sharding.process_sharded_eager(imgs, cfg, mesh, outputs=("out_u8", "clahe_graded"))
    assert calls == {"clahe_hist": 2, "clahe_curves": 2, "grad_hist_relevant": 2, "grad_hist": 0}
    assert torch.equal(got[0][0], want["out_u8"])
    torch.testing.assert_close(got[1][0], want["clahe_graded"], rtol=0, atol=0, equal_nan=True)
