"""The gradation curve of the PyTorch port (``ops/gradation.py``:
``gradation_curve`` and its plain version, ``gradation_curve_plain``) on the
CPU.

The plain version is held bit for bit (px, py, t0, ta, t1) to the JAX
package's ``gradation_curve`` on every histogram of
``testing/grad_cases.py`` and on the port's own gradation histograms of
phantoms.  The cases include histograms that int32 atomics have wrapped
(negative bins): the JAX package reads the bins as the reference shader's
uint32, so must the port.  On the cases without a negative bin the curve
is also held to golden (``models/golden.py::gradation_curve_generate``) to
``tests/test_ops_golden.py``'s bar; golden floors a negative bin before its
uint64 cast, so it is no oracle on the others.

A NumPy transcription of the kernel KG's algorithm (``csrc/gradation_curve.cu``:
a thread's bins, the block reductions, the scalar tail) equals the plain
version on the same set, which checks KG's design on the CPU where the
kernel cannot run.  On a CUDA tensor ``gradation_curve`` launches KG (here
through a recording ``launch``), and the pipeline takes it once (the spatial
path once a shard)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import (
    MusicaConfig as JaxConfig)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import golden
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import (
    gradation as j_gradation)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import gradation
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import (
    gradation as kg)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import grad_cases
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
    synthetic_radiograph)

torch.set_num_threads(2)

F32 = np.float32
CFG = MusicaConfig(image_size=512)
CASES = grad_cases.cases()


def _bits(a) -> np.ndarray:
    return np.asarray(a, F32).reshape(-1).view(np.int32)


def _flat(curve) -> np.ndarray:
    """px, py, t0, ta, t1 as one float32 vector."""
    px, py, t = curve
    return np.concatenate([np.asarray(px, F32), np.asarray(py, F32),
                           np.array([float(v) for v in t], F32)])


def _plain(hist: np.ndarray, cfg=CFG) -> np.ndarray:
    return _flat(gradation.gradation_curve_plain(torch.from_numpy(hist), cfg))


@functools.lru_cache(maxsize=None)
def _jax(hist_b: bytes) -> np.ndarray:
    h = np.frombuffer(hist_b, np.int32)
    return _flat(j_gradation.gradation_curve(jnp.asarray(h), JaxConfig(image_size=512)))


@functools.lru_cache(maxsize=None)
def _phantom_hist(n: int, anatomy: str) -> np.ndarray:
    img = synthetic_radiograph(n, anatomy)
    res = musica.musica_forward(torch.from_numpy(img), MusicaConfig(image_size=n),
                                want_intermediates=True)
    return res["intermediates"]["grad_hist"].numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_jax(name):
    hist, _ = CASES[name]
    np.testing.assert_array_equal(_bits(_plain(hist)), _bits(_jax(hist.tobytes())))


@pytest.mark.parametrize("n,anatomy", [(512, "thorax"), (256, "hand")])
def test_plain_equals_jax_on_phantom_histograms(n, anatomy):
    hist = _phantom_hist(n, anatomy)
    assert hist.dtype == np.int32 and hist.sum() > 0
    np.testing.assert_array_equal(_bits(_plain(hist)), _bits(_jax(hist.tobytes())))


@pytest.mark.parametrize("name", sorted(k for k, (_, neg) in CASES.items() if not neg))
def test_plain_equals_golden_without_negative_bins(name):
    hist, _ = CASES[name]
    gpx, gpy, gt = golden.gradation_curve_generate(hist.astype(np.int64), CFG)
    got = _plain(hist)
    np.testing.assert_allclose(got[:22], gpx, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got[22:44], gpy, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got[44:], np.array(gt, F32), rtol=0, atol=1e-7)


def test_negative_bins_read_as_uint32():
    """ta at the peak that the uint32 counts give (NumPy's uint32 sums):
    the case where the port read negative bins as negative counts before."""
    hist, neg = CASES["negative bins"]
    assert neg
    counts = hist.view(np.uint32) // 100
    idx = np.arange(1024)
    rel = idx >= 10
    with np.errstate(over="ignore"):
        mean = int((counts * idx.astype(np.uint32))[rel].sum(dtype=np.uint32)
                   // counts[rel].sum(dtype=np.uint32))
    peak = int(np.argmax(np.where(rel & (idx < mean), counts, 0)))
    assert peak > 0
    assert _plain(hist)[45] == F32(peak) * F32(1 / 1024)


# ----------------------------------------------------------------------
# KG's algorithm in NumPy: the kernel's thread layout and reductions
# ----------------------------------------------------------------------

THREADS, PER_THREAD = 1024, 4  # csrc/gradation_curve.cu: kThreads, kPerThread


def _block(values: np.ndarray, op) -> np.ndarray:
    """A block reduction as the kernel takes it: each thread's value (over
    its bins, [PER_THREAD, THREADS]), a warp's lanes, then the 32 warps."""
    d = values.dtype  # no widening: uint32 sums wrap as the kernel's do
    per_thread = op.reduce(values, axis=0, dtype=d)
    return op.reduce(op.reduce(per_thread.reshape(32, 32), axis=1, dtype=d), dtype=d)


def _max_nan(a, b):
    return F32(np.nan) if np.isnan(a) or np.isnan(b) else F32(max(a, b))


def _min_nan(a, b):
    return F32(np.nan) if np.isnan(a) or np.isnan(b) else F32(min(a, b))


def _bezier(s, m, e, t):
    a = F32(s + F32(F32(m - s) * t))
    b = F32(m + F32(F32(e - m) * t))
    return F32(a + F32(F32(b - a) * t))


def kg_model(hist: np.ndarray, cfg) -> np.ndarray:
    """KG's arithmetic: px, py, t0, ta, t1 as one float32 vector."""
    bins, lowest = cfg.grad_histogram_bins, cfg.grad_lowest_relevant_bin
    slots = THREADS * PER_THREAD
    i = np.arange(slots)
    valid = i < bins
    c = np.zeros(slots, np.uint32)
    c[:bins] = hist.view(np.uint32) // np.uint32(100)
    rel = valid & (i >= lowest)
    with np.errstate(over="ignore"):
        ci = np.where(rel, c * i.astype(np.uint32), np.uint32(0)).astype(np.uint32)
    grid = (PER_THREAD, THREADS)  # thread t holds bins t + 1024 k
    mean_count = int(_block(ci.reshape(grid), np.add))
    mean_sum = int(_block(np.where(rel, c, np.uint32(0)).reshape(grid), np.add))
    mean_bin = 0 if mean_sum == 0 else mean_count // mean_sum
    bins_f = F32(bins)
    mean_hist_pos = F32(F32(mean_bin) / bins_f)
    mean_limit = int(np.trunc(F32(mean_hist_pos * bins_f)))
    v = np.where(rel & (i < mean_limit), c, np.uint32(0)).astype(np.uint64)
    key = (v << np.uint64(32)) | (~i.astype(np.uint64) & np.uint64(0xFFFFFFFF))
    key = int(_block(key.reshape(grid), np.maximum))
    max_count = key >> 32
    peak = (~key & 0xFFFFFFFF) if max_count > 0 else 0
    low_threshold = int(np.trunc(F32(F32(max_count) * F32(cfg.grad_low_threshold_frac))))
    below = int(_block(np.where(valid & (i <= peak) & (c.astype(np.int64) < low_threshold),
                                i, -1).reshape(grid), np.maximum))
    empty = int(_block(np.where(valid & (i >= peak) & (c == 0), i, bins).reshape(grid),
                       np.minimum))
    inv = F32(1.0 / bins)
    start = max(below + 1, 1)
    t0 = F32(F32(start) * inv) if start <= peak else F32(0)
    t1 = F32(F32(empty - 1) * inv) if empty > peak else F32(0)
    ta = F32(F32(peak) * inv)
    t0 = _max_nan(F32(t0 - F32(cfg.grad_t0_backoff)), F32(0))
    t1 = _min_nan(t1, F32(1))
    m, y_m = F32(cfg.grad_slope), F32(cfg.grad_y_mid)
    tf = _max_nan(F32(-F32(F32(0.5) / m) + ta), t0)
    with np.errstate(divide="ignore"):
        m2 = F32(y_m / F32(ta - tf)) if tf == t0 else m
        ts = F32(F32(y_m / m2) + ta)
    px, py = [F32(0)], [F32(0)]
    for j in range(10):
        t = F32(F32(j) / F32(10))
        px.append(_bezier(t0, tf, ta, t))
        py.append(_bezier(F32(0), F32(0), y_m, t))
    for j in range(10):
        t = F32(F32(j) / F32(10))
        px.append(_bezier(ta, ts, t1, t))
        py.append(_bezier(y_m, F32(1), F32(1), t))
    px.append(F32(1))
    py.append(F32(1))
    return np.array(px + py + [t0, ta, t1], F32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_equals_plain(name):
    hist, _ = CASES[name]
    np.testing.assert_array_equal(_bits(kg_model(hist, CFG)), _bits(_plain(hist)))


def test_kernel_model_equals_plain_on_phantoms_and_other_bins():
    """The port's own histograms, and a configuration of 4,096 bins (every
    slot a thread holds) and of 1,000 (a ragged last slot)."""
    for n, anatomy in ((512, "thorax"), (256, "hand")):
        hist = _phantom_hist(n, anatomy)
        np.testing.assert_array_equal(_bits(kg_model(hist, CFG)), _bits(_plain(hist)))
    rng = np.random.default_rng(5)
    for bins in (4096, 1000):
        cfg = CFG.with_(grad_histogram_bins=bins)
        i = np.arange(bins)
        hist = (rng.gamma(2.0, 200.0, bins) * np.exp(-((i - bins // 3) / (bins / 7)) ** 2)
                ).astype(np.int32) * 100
        np.testing.assert_array_equal(_bits(kg_model(hist, cfg)), _bits(_plain(hist, cfg)))


# ----------------------------------------------------------------------
# dispatch: the plain version on the CPU, KG on a CUDA tensor
# ----------------------------------------------------------------------

@pytest.fixture
def card(monkeypatch):
    """The wrapper's CUDA path on CPU inputs: tensors report a device that
    is not the CPU (outputs are allocated on ``meta``), and ``launch``
    records each call instead of calling the library."""
    calls = []
    monkeypatch.setattr(launch, "device_of", lambda ts: torch.device("meta"))
    monkeypatch.setattr(launch, "lib", lambda: None)
    monkeypatch.setattr(launch, "launch",
                        lambda lib, fn, counter, dev, *args: calls.append((fn, counter, args)))
    return calls


def test_cpu_histograms_take_the_plain_version():
    hist, _ = CASES["random 0"]
    launch.reset_launch_counts()
    got = gradation.gradation_curve(torch.from_numpy(hist), CFG)
    np.testing.assert_array_equal(_bits(_flat(got)), _bits(_plain(hist)))
    assert launch.LAUNCHES == {k: 0 for k in launch.LAUNCHES}


def test_cuda_histograms_launch_the_kernel(card):
    hist = torch.from_numpy(CASES["random 0"][0])
    px, py, (t0, ta, t1) = gradation.gradation_curve(hist, CFG)
    assert px.shape == py.shape == (22,) and px.dtype == torch.float32
    assert px.is_contiguous() and py.is_contiguous()
    assert t0.shape == ta.shape == t1.shape == ()
    (fn, counter, args), = card
    assert (fn, counter) == ("musica_gradation_curve", "gradation_curve")
    # hist, bins, lowest, frac, 1 / bins, backoff, slope, y_mid, out
    assert args[0] == hist.data_ptr() and args[1:3] == (1024, 10)
    assert [type(a) for a in args[3:8]] == [np.float32] * 5
    assert args[3:8] == (F32(0.05), F32(1 / 1024), F32(0.01), F32(3.0), F32(0.5))


def test_the_wrapper_rejects_what_the_kernel_does_not_take(card):
    h = torch.zeros(1024, dtype=torch.int32)
    for bad in (h.to(torch.int64), h[:1000], torch.zeros(2048, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError):
            kg.gradation_curve(bad, CFG)
    with pytest.raises(ValueError):
        kg.gradation_curve(torch.zeros(8192, dtype=torch.int32),
                           CFG.with_(grad_histogram_bins=8192))
    assert card == []


def test_the_pipeline_takes_the_curve_once(monkeypatch):
    """musica_forward takes ``gradation_curve`` once; the spatial path once
    a shard."""
    calls = []
    real = gradation.gradation_curve

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(gradation, "gradation_curve", spy)
    cfg = MusicaConfig(image_size=128)
    imgs = np.stack([synthetic_radiograph(128, "hand")])
    want = musica.musica_forward(torch.from_numpy(imgs[0]), cfg)
    assert len(calls) == 1
    calls.clear()
    mesh = sharding.make_mesh(n_data=1, n_space=2, devices=[torch.device("cpu")] * 2)
    got = sharding.process_sharded_eager(imgs, cfg, mesh)
    assert len(calls) == 2
    assert torch.equal(got[0], want["out_u8"])
