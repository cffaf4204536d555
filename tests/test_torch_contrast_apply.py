"""The contrast stage of the PyTorch port (``ops/cuda/contrast_apply.py``: KA's
wrapper and its plain version, the contrast curves, each level's gain and the
noise reduction) on the CPU.

The plain version is held bit for bit to the JAX package's
``contrast_curve``, ``contrast_curve_apply`` and ``noise_reduction``, run op by
op (XLA's jit contracts to FMA), on inputs made from a seed with NumPy at 144
and 256 px in float32 and bf16 storage: the curves at max bins 0, 1, 2047
and 61 seeded others; sdevs at every control point, px[0], just above the
last point, +-0 and above 1 on the flat level; CNR values at the ramp's ends
and their float32 neighbours.  A NumPy model of the kernel's own arithmetic
(its curve built point by point; the count from the bucket table and a
search over the points in x's bucket, ``test_torch_kernel_formulations.
ka_count``; the noise-reduction factor once a CNR cell along each group of 4
pixels, the cell at its pixel's global row) equals the plain version
on the same inputs and on NaN, +-inf and denormal sdevs, whole and on the
row windows of the spatial plans.  On a CUDA tensor the wrapper launches
the kernel (here through a recording ``launch``), and the pipeline takes it
once (the spatial path once a shard)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import (
    MusicaConfig as JaxConfig)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import curves as j_curves
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import noise as j_noise
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import curves, noise
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import (
    contrast_apply as ka)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding, spatial
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
    synthetic_radiograph)
from test_torch_kernel_formulations import KA_GROUP, ka_count

torch.set_num_threads(2)

F32 = np.float32
CASES = [(size, storage) for size in (144, 256) for storage in ("float32", "bfloat16")]
_SD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, F32)).view(np.int32)


def _same(got, want, what, nan_bits=True):
    """float32 arrays equal bit for bit; NaN where the other has NaN (its
    bits too unless ``nan_bits`` is False)."""
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    keep = ~nan if not nan_bits else np.ones_like(nan)
    np.testing.assert_array_equal(_bits(got)[keep], _bits(want)[keep], err_msg=what)


def _f(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _flat_curves(cfg):
    return [k for k, (lcf, _) in enumerate(cfg.contrast_factors) if lcf == 1.0]


def _max_bins(seed: int = 16) -> list:
    """0, 1, 2047 and 61 seeded others."""
    rng = np.random.default_rng(seed)
    return [0, 1, 2047] + sorted(rng.choice(np.arange(2, 2047), 61, replace=False).tolist())


# ----------------------------------------------------------------------
# inputs from a seed
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inputs(size: int, storage: str, seed: int = 0):
    """(cfg, bands [L] in the storage dtype, sdevs, max_bins, cnr) of one
    image size: random bands and sdevs, every analysis level's sdev holding
    its curve's control points, px[0], the float32 above the last point,
    +-0 and px[1]'s neighbours where normal (the flat level also 1, its
    successor, 1.5 and 2), and a CNR map
    whose cells (times max_cnr) hit each ramp end and its float32
    neighbours."""
    cfg = MusicaConfig(image_size=size, storage=storage)
    rng = np.random.default_rng(seed)
    sd = _SD[storage]
    bands = [torch.from_numpy(rng.normal(0.0, 0.03, (h, h)).astype(F32)).to(sd)
             for h in cfg.level_sizes[:cfg.pyramid_levels]]
    bins = {k: int(b) for k, b in zip(cfg.analysis_levels, (1, 2047, 0, 700, 5))}
    max_bins = {k: torch.tensor(b, dtype=torch.int32) for k, b in bins.items()}
    sdevs = {}
    for k in cfg.analysis_levels:
        h = cfg.level_sizes[k]
        x = rng.uniform(0.0, 0.12, (h, h)).astype(F32)
        px, _ = curves.contrast_curve(max_bins[k], *cfg.contrast_factors[k], cfg)
        px = px.numpy()
        special = [*px, np.nextafter(px[-1], F32(np.inf)), F32(0.0), F32(-0.0),
                   np.nextafter(px[1], F32(0)), np.nextafter(px[1], F32(1))]
        if k in _flat_curves(cfg):
            special += [F32(1.0), np.nextafter(F32(1.0), F32(2)), F32(1.5), F32(2.0)]
        # no denormal: XLA on the CPU flushes them to 0
        special = [v for v in special if v == 0 or abs(v) >= np.finfo(F32).tiny]
        flat = x.reshape(-1)
        at = rng.choice(flat.size, min(flat.size, 4 * len(special)), replace=False)
        flat[at] = np.resize(np.array(special, F32), at.size)
        sdevs[k] = torch.from_numpy(x)
    c = cfg.cnr_level
    cnr = rng.uniform(0.0, 12.0 / cfg.max_cnr_value, (cfg.level_sizes[c],) * 2).astype(F32)
    lo_c, _, hi_c, _ = cfg.noise_reduction_params[0]
    ends = [F32(v) for v in (lo_c, hi_c)]
    special = [w / F32(cfg.max_cnr_value) for e in ends
               for w in (e, np.nextafter(e, F32(0)), np.nextafter(e, F32(np.inf)))]
    flat = cnr.reshape(-1)
    at = rng.choice(flat.size, min(flat.size, 3 * len(special)), replace=False)
    flat[at] = np.resize(np.array(special, F32), at.size)
    return cfg, bands, sdevs, max_bins, torch.from_numpy(cnr)


def _with(sdevs, values, seed=1):
    """sdevs with a few of each level's pixels set to ``values``."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in sdevs.items():
        x = s.numpy().copy().reshape(-1)
        at = rng.choice(x.size, min(x.size, 2 * len(values)), replace=False)
        x[at] = np.resize(np.array(values, F32), at.size)
        out[k] = torch.from_numpy(x.reshape(s.shape))
    return out


def _plain(size, storage, intermediates=True, sdevs=None):
    cfg, bands, sdevs0, max_bins, cnr = _inputs(size, storage)
    cnrs = {k: (cnr, 0) for k in ka.nr_levels(cfg, intermediates)}
    return ka.contrast_apply(bands, sdevs0 if sdevs is None else sdevs, max_bins, cnrs, cfg,
                             intermediates=intermediates)


# ----------------------------------------------------------------------
# the JAX package, op by op
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_curve(mb: int, lcf: float, hcf: float, size: int):
    px, py = j_curves.contrast_curve(jnp.asarray(mb, jnp.int32), lcf, hcf,
                                     JaxConfig(image_size=size))
    return np.asarray(px), np.asarray(py)


@functools.lru_cache(maxsize=None)
def _jax_stage(size: int, storage: str):
    """The JAX package's contrast bands (each level) and noise-reduced bands
    (levels below cnr_level) of ``_inputs``, as its ``models/musica.py``
    computes them, op by op; float32 numpy arrays."""
    cfg, bands, sdevs, max_bins, cnr = _inputs(size, storage)
    jcfg = JaxConfig(image_size=size, storage=storage)
    sd = jnp.bfloat16 if storage == "bfloat16" else jnp.float32
    exp, nr = [], []
    for k, b in enumerate(bands):
        jb = jnp.asarray(_f(b)).astype(sd)
        lcf, hcf = cfg.contrast_factors[k]
        if k in sdevs:
            px, py = _jax_curve(int(max_bins[k]), lcf, hcf, size)
            e = j_curves.contrast_curve_apply(jb.astype(jnp.float32), jnp.asarray(sdevs[k].numpy()),
                                              jnp.asarray(px), jnp.asarray(py))
        else:
            e = jb.astype(jnp.float32) * jnp.float32(hcf)
        exp.append(e.astype(sd))
    for k in range(cfg.cnr_level):
        nr.append(j_noise.noise_reduction(exp[k], jnp.asarray(cnr.numpy()),
                                          *cfg.noise_reduction_params[k], jcfg).astype(sd))
    return ([np.asarray(e.astype(jnp.float32)) for e in exp],
            [np.asarray(v.astype(jnp.float32)) for v in nr])


@pytest.mark.parametrize("level", [0, 1, 2])
def test_curves_equal_jax_at_every_kind_of_max_bin(level):
    """The bezier levels' curves at max bins 0, 1, 2047 and 61 seeded
    others equal the JAX package's bit for bit; so does every flat level's;
    and the kernel model's points and slopes equal the plain ones."""
    cfg = MusicaConfig(image_size=3072)
    lcf, hcf = cfg.contrast_factors[level]
    assert lcf != 1.0
    for mb in _max_bins():
        px, py = curves.contrast_curve(torch.tensor(mb, dtype=torch.int32), lcf, hcf, cfg)
        assert px.shape == (33,)
        jpx, jpy = _jax_curve(mb, lcf, hcf, 3072)
        _same(px.numpy(), jpx, f"level {level}, max bin {mb}, px")
        _same(py.numpy(), jpy, f"level {level}, max bin {mb}, py")
        mpx, mpy, mm = _model_curve(mb, lcf, hcf, cfg)
        _same(mpx, px.numpy(), f"model px, max bin {mb}")
        _same(mpy, py.numpy(), f"model py, max bin {mb}")
        with np.errstate(invalid="ignore", divide="ignore"):
            want_m = ((py[1:] - py[:-1]) / (px[1:] - px[:-1])).numpy()
        _same(mm, want_m, f"model slopes, max bin {mb}")
    for k in _flat_curves(cfg):
        px, py = curves.contrast_curve(torch.tensor(7, dtype=torch.int32),
                                       *cfg.contrast_factors[k], cfg)
        jpx, jpy = _jax_curve(7, *cfg.contrast_factors[k], 3072)
        _same(px.numpy(), jpx, f"flat level {k}")
        _same(py.numpy(), jpy, f"flat level {k}")


@pytest.mark.parametrize("size,storage", CASES)
def test_plain_stage_equals_jax(size, storage):
    """Every level's contrast band, the noise-reduced bands of levels 0 to
    cnr_level - 1 and the bands the expand reads equal the JAX package's
    bit for bit (bf16: the same bf16 values)."""
    cfg = _inputs(size, storage)[0]
    bands_in, inter = _plain(size, storage)
    exp, nr = _jax_stage(size, storage)
    for k, e in enumerate(exp):
        assert inter[f"contrast_bandpass_{k}"].dtype == _SD[storage]
        _same(_f(inter[f"contrast_bandpass_{k}"]), e, f"{size} {storage}: contrast band {k}")
    for k, v in enumerate(nr):
        _same(_f(inter[f"nr_bandpass_{k}"]), v, f"{size} {storage}: NR band {k}")
    assert len(bands_in) == cfg.pyramid_levels
    for k, b in enumerate(bands_in):
        want = nr[k] if k < cfg.cnr_level - 1 else exp[k]
        _same(_f(b), want, f"{size} {storage}: the expand's band {k}")
    # what the adversarial inputs reach: the gain 0 past the flat curve, the
    # three factors of the noise reduction
    flat = _flat_curves(cfg)[0]
    sdev = _inputs(size, storage)[2][flat].numpy()
    assert (exp[flat][sdev > 1.0] == 0).all() and (sdev > 1.0).any()
    f0 = nr[0] / np.where(exp[0] == 0, 1.0, exp[0])
    lo_f, hi_f = (F32(v) for v in cfg.noise_reduction_params[0][1::2])
    assert storage == "bfloat16" or ((f0 == lo_f).any() and (f0 == hi_f).any())


def test_the_main_path_computes_only_the_bands_the_expand_reads(monkeypatch):
    """Without intermediates the noise reduction runs on the levels below
    cnr_level - 1 alone (the expand reads no other); with them also on level
    cnr_level - 1; the bands the expand reads are the same either way."""
    calls = []
    real = noise.noise_reduction

    def spy(*args, **kwargs):
        calls.append(args[0].shape[-1])
        return real(*args, **kwargs)
    monkeypatch.setattr(noise, "noise_reduction", spy)
    cfg = _inputs(144, "float32")[0]
    got, inter = _plain(144, "float32", intermediates=False)
    assert inter == {} and calls == [144, 72]
    calls.clear()
    want, inter = _plain(144, "float32", intermediates=True)
    assert calls == [144, 72, 36]
    assert sorted(inter) == sorted(
        [f"contrast_bandpass_{k}" for k in range(cfg.pyramid_levels)]
        + [f"nr_bandpass_{k}" for k in range(cfg.cnr_level)]
        + [f"contrast_curve_{k}" for k in range(cfg.pyramid_levels)])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    calls.clear()
    res = musica.musica_forward(torch.from_numpy(synthetic_radiograph(128, "hand")),
                                MusicaConfig(image_size=128))
    assert calls == [128, 64] and res["out_u8"].shape == (108, 108)


# ----------------------------------------------------------------------
# the kernel's arithmetic, modelled in NumPy float32
# ----------------------------------------------------------------------

def _model_curve(mb, lcf, hcf, cfg):
    """KA's curve (csrc/contrast_apply.cu::curve_point): points and slopes,
    each float32 operation in the kernel's order."""
    if lcf == 1.0:
        px, py = np.array([0.0, 1.0], F32), np.array([hcf, hcf], F32)
    else:
        f = F32
        p = f(f(f(mb) * f(1.0 / cfg.noise_histogram_bins)) * f(cfg.max_noise_value))
        lcf = f(lcf)
        p45, p65, p75 = (f(f(p * f(c)) / f(5.0)) for c in (4.0, 6.0, 7.0))
        l45 = f(f(lcf * f(4.0)) / f(5.0))

        def lerp(a, b, t):
            return f(a + f(f(b - a) * t))
        pts = []
        for (sx, sy), (mx, my), (ex, ey) in (((f(0), f(1)), (p45, lcf), (p, lcf)),
                                             ((p, lcf), (p65, lcf), (p75, l45)),
                                             ((p75, l45), (f(p * f(2.0)), f(1)), (f(1), f(1)))):
            for j in range(11):
                t = f(f(j) / f(10.0))
                xa, ya, xb, yb = lerp(sx, mx, t), lerp(sy, my, t), lerp(mx, ex, t), lerp(my, ey, t)
                pts.append((lerp(xa, xb, t), lerp(ya, yb, t)))
        px, py = (np.array(v, F32) for v in zip(*pts))
    with np.errstate(invalid="ignore", divide="ignore"):
        m = (py[1:] - py[:-1]) / (px[1:] - px[:-1])
    return px, py, m


def _model_get_y(px, py, m, x):
    """KA's getY: the count of points that are not >= x (``ka_count``: the
    bucket table's start and a search over x's bucket), then the clamped
    lerp and its two edge cases."""
    n = px.size
    cnt = ka_count(px, x)[0]
    sel = np.clip(cnt - 1, 0, n - 2)
    with np.errstate(invalid="ignore", over="ignore"):
        y = m[sel] * (x - px[sel]) + py[sel]
    low = np.where(x == px[0], py[0], F32(0))
    return np.where(cnt == n, F32(0), np.where(cnt > 0, y, low)).astype(F32)


def _round_bf16(v):
    """float32 -> bf16 (round to nearest even) -> float32, NaN kept."""
    u = np.asarray(v, F32).view(np.uint32).astype(np.uint64)
    r = (((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16).astype(np.uint32).view(F32)
    return np.where(np.isnan(v), v, r).astype(F32)


def _model_stage(cfg, bands, sdevs, max_bins, cnrs, row0s, storage):
    """KA on each level (float32 numpy): the bands the expand reads and,
    per level, the contrast band and (where computed) the noise-reduced
    band."""
    rnd = _round_bf16 if storage == "bfloat16" else (lambda v: v)
    out_c, out_nr = {}, {}
    for k, b in enumerate(bands):
        b = _f(b)
        lcf, hcf = cfg.contrast_factors[k]
        mb = int(max_bins[k]) if k in max_bins else 0
        if k in sdevs:
            g = _model_get_y(*_model_curve(mb, lcf, hcf, cfg), sdevs[k].numpy())
        else:
            g = F32(hcf)
        with np.errstate(invalid="ignore", over="ignore"):
            e = rnd((b * g).astype(F32))
        out_c[k] = e
        if k in cnrs:
            cnr, c0 = cnrs[k]
            cnr = cnr.numpy()
            rows, n = b.shape
            s = -(-n // cnr.shape[-1])
            # a thread's groups of KA_GROUP pixels along the level, wrapping
            # rows: a cell is read where a pixel starts a group, a cell or a
            # row, and each pixel takes the factor of the last pixel that
            # read one
            i = np.arange(rows * n)
            col = i % n
            fresh = (i % KA_GROUP == 0) | (col % s == 0)
            src = np.maximum.accumulate(np.where(fresh, i, 0))
            with np.errstate(over="ignore"):
                cell = cnr[(row0s[k] + src // n) // s - c0, src % n // s]
                cu = (cell * F32(cfg.max_cnr_value)).reshape(rows, n)
            lo_c, lo_f, hi_c, hi_f = (F32(v) for v in cfg.noise_reduction_params[k])
            ramp = F32((cfg.noise_reduction_params[k][3] - cfg.noise_reduction_params[k][1])
                       / (cfg.noise_reduction_params[k][2] - cfg.noise_reduction_params[k][0]))
            with np.errstate(invalid="ignore"):
                fac = np.where(cu < lo_c, lo_f, np.where(cu > hi_c, hi_f, ramp * cu + lo_f))
            with np.errstate(invalid="ignore", over="ignore"):
                out_nr[k] = rnd((e * fac).astype(F32))
    bands_in = [out_nr[k] if k < cfg.cnr_level - 1 else out_c[k] for k in range(len(bands))]
    return bands_in, out_c, out_nr


ODD = [np.nan, -np.nan, np.inf, -np.inf, 1e-40, -1e-40, 1e-45, F32(np.finfo(F32).max)]


@pytest.mark.parametrize("size,storage", CASES)
def test_kernel_model_equals_plain(size, storage):
    """The kernel's arithmetic modelled in NumPy equals the plain version on
    the adversarial inputs, and with NaN, +-inf, denormal and huge sdevs,
    bands and CNR cells (NaN where the plain version has NaN, float32 NaN
    bits too)."""
    cfg, bands, sdevs, max_bins, cnr = _inputs(size, storage)
    odd = _with({k: b.float() for k, b in enumerate(bands)}, ODD, seed=2)
    odd_bands = [odd[k].to(b.dtype) for k, b in enumerate(bands)]
    odd_cnr = _with({0: cnr}, ODD, seed=3)[0]
    nans = 0
    for what, b, sd, c in (("adversarial", bands, sdevs, cnr),
                           ("odd values", odd_bands, _with(sdevs, ODD), odd_cnr)):
        nrl = ka.nr_levels(cfg, True)
        cnrs = {k: (c, 0) for k in nrl}
        bands_in, inter = ka.contrast_apply(b, sd, max_bins, cnrs, cfg, intermediates=True)
        m_in, m_c, m_nr = _model_stage(cfg, b, sd, max_bins, cnrs, [0] * len(b), storage)
        for k in range(len(b)):
            _same(_f(inter[f"contrast_bandpass_{k}"]), m_c[k], f"{what}: contrast band {k}",
                  nan_bits=storage == "float32")
            _same(_f(bands_in[k]), m_in[k], f"{what}: the expand's band {k}",
                  nan_bits=storage == "float32")
        for k in nrl:
            _same(_f(inter[f"nr_bandpass_{k}"]), m_nr[k], f"{what}: NR band {k}",
                  nan_bits=storage == "float32")
            nans += int(np.isnan(m_nr[k]).sum())
    assert nans > 0


@pytest.mark.parametrize("size,space", [(144, 4), (256, 4), (256, 2)])
def test_windows_equal_the_whole(size, space):
    """On every shard's rows of a plan (the replicated levels whole on every
    shard, each noise-reduced level's CNR rows from ``noise.cnr_rows``): the
    plain version and the kernel model equal the whole stage's rows."""
    for storage in ("float32", "bfloat16"):
        cfg, bands, sdevs, max_bins, cnr = _inputs(size, storage)
        L, c = cfg.pyramid_levels, cfg.cnr_level
        cfg_t = cfg.with_(histogram_area_size=16 if size > 144 else 12)
        plan = spatial.row_plan(size, space, cfg_t)
        nrl = ka.nr_levels(cfg, False)
        whole, _ = ka.contrast_apply(bands, sdevs, max_bins, {k: (cnr, 0) for k in nrl}, cfg)
        for i in range(space):
            rows = [plan.rows(k, i) if k < plan.replicated else (0, plan.sizes[k])
                    for k in range(L)]
            cnrs = {}
            for k in nrl:
                lo, hi = noise.cnr_rows(cnr.shape[-1], plan.sizes[k], *rows[k])
                cnrs[k] = (cnr[lo:hi].contiguous(), lo)
            win = [bands[k][a:b].contiguous() for k, (a, b) in enumerate(rows)]
            sd = {k: sdevs[k][a:b].contiguous() for k, (a, b) in enumerate(rows) if k in sdevs}
            row0s = [a for a, _ in rows]
            got, _ = ka.contrast_apply(win, sd, max_bins, cnrs, cfg, row0s)
            model, _, _ = _model_stage(cfg, win, sd, max_bins, cnrs, row0s, storage)
            for k, (a, b) in enumerate(rows):
                what = f"{size} {storage}, shard {i} of {space}, level {k}, rows [{a}, {b})"
                _same(_f(got[k]), _f(whole[k][a:b]), what)
                _same(_f(got[k]), model[k], what + ", model")
        assert c - 1 >= 1 and plan.replicated > 1


# ----------------------------------------------------------------------
# the wrapper's CUDA path, and the pipeline's calls of it
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


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_cuda_tensors_launch_the_kernel(card, storage):
    cfg, bands, sdevs, max_bins, cnr = _inputs(144, storage)
    L, c = cfg.pyramid_levels, cfg.cnr_level
    bands_in, inter = ka.contrast_apply(bands, sdevs, max_bins,
                                        {k: (cnr, 0) for k in range(c - 1)}, cfg)
    assert inter == {} and len(bands_in) == L
    assert all(b.shape == a.shape and b.dtype == a.dtype for a, b in zip(bands, bands_in))
    _, inter, tab = ka.contrast_tables(bands, sdevs, max_bins, {k: (cnr, 0) for k in range(c)},
                                       cfg, intermediates=True)
    assert tab.shape == (L, 3, 33)
    assert sorted(inter) == sorted([f"contrast_bandpass_{k}" for k in range(L)]
                                   + [f"nr_bandpass_{k}" for k in range(c)]
                                   + [f"contrast_curve_{k}" for k in range(L)])
    assert [inter[f"contrast_curve_{k}"][0].shape[0] for k in range(L)] == \
        [33 if lcf != 1.0 else 2 for lcf, _ in cfg.contrast_factors]
    assert [(fn, counter) for fn, counter, _ in card] == [("musica_contrast_apply",
                                                          "contrast_apply")] * 2
    (arr, n, bf16, inv_bins, max_noise, max_cnr), (arr2, *_) = (a for _, _, a in card)
    assert (n, bf16) == (L, int(storage == "bfloat16"))
    assert (inv_bins, max_noise, max_cnr) == (F32(1 / 2048), F32(0.1), F32(256.0))
    for k, lv in enumerate(arr):
        lcf, hcf = cfg.contrast_factors[k]
        assert (lv.band, lv.rows, lv.n, lv.row0) == (bands[k].data_ptr(), *bands[k].shape, 0)
        assert bool(lv.sdev) == (k in sdevs) and bool(lv.max_bin) == (k in max_bins)
        assert lv.bezier == (lcf != 1.0) and lv.hcf == F32(hcf) and lv.tables is None
        # the main path: the noise-reduced band alone below cnr_level - 1
        assert (lv.out_c is None) == (k < c - 1) and (lv.out_nr is not None) == (k < c - 1)
        if k < c - 1:
            lo_c, lo_f, hi_c, hi_f = cfg.noise_reduction_params[k]
            assert (lv.cnr, lv.cnr_n, lv.cnr_row0) == (cnr.data_ptr(), cnr.shape[-1], 0)
            assert lv.scale == -(-bands[k].shape[-1] // cnr.shape[-1])
            assert (lv.lo_c, lv.lo_f, lv.hi_c, lv.hi_f) == tuple(F32(v) for v in (lo_c, lo_f,
                                                                                  hi_c, hi_f))
            assert lv.ramp == F32((hi_f - lo_f) / (hi_c - lo_c))
    # with intermediates: every contrast band, NR below cnr_level, the tables
    assert all(lv.out_c and lv.tables for lv in arr2)
    assert [bool(lv.out_nr) for lv in arr2] == [k < c for k in range(L)]


def test_windows_launch_with_their_rows(card):
    cfg, bands, sdevs, max_bins, cnr = _inputs(256, "float32")
    plan = spatial.row_plan(256, 4, cfg)
    rows = [plan.rows(k, 2) if k < plan.replicated else (0, plan.sizes[k])
            for k in range(cfg.pyramid_levels)]
    cnrs = {}
    for k in range(cfg.cnr_level - 1):
        lo, hi = noise.cnr_rows(cnr.shape[-1], plan.sizes[k], *rows[k])
        cnrs[k] = (cnr[lo:hi].contiguous(), lo)
    win = [bands[k][a:b].contiguous() for k, (a, b) in enumerate(rows)]
    sd = {k: sdevs[k][a:b].contiguous() for k, (a, b) in enumerate(rows) if k in sdevs}
    ka.contrast_apply(win, sd, max_bins, cnrs, cfg, [a for a, _ in rows])
    (arr, *_), = (a for _, _, a in card)
    assert [(lv.row0, lv.rows) for lv in arr] == [(a, b - a) for a, b in rows]
    assert [lv.cnr_row0 for lv in arr[:cfg.cnr_level - 1]] == [cnrs[k][1] for k in cnrs]
    # a window whose CNR rows miss the ones it reads
    with pytest.raises(ValueError, match="CNR rows"):
        ka.contrast_apply(win, sd, max_bins, {0: (cnr[:2].contiguous(), 0), 1: cnrs[1]}, cfg,
                          [a for a, _ in rows])


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    cfg, bands, sdevs, max_bins, cnr = _inputs(144, "float32")
    cnrs = {k: (cnr, 0) for k in range(cfg.cnr_level - 1)}

    def call(bands=bands, sdevs=sdevs, max_bins=max_bins, cnrs=cnrs, cfg=cfg, row0s=None):
        ka.contrast_apply(bands, sdevs, max_bins, cnrs, cfg, row0s)
    with pytest.raises(TypeError):
        call(bands=[b.double() for b in bands])
    with pytest.raises(TypeError):
        call(bands=[bands[0].to(torch.bfloat16), *bands[1:]])  # mixed storage
    with pytest.raises(ValueError):
        call(bands=[bands[0].T, *bands[1:]])  # strided
    with pytest.raises(ValueError):
        call(sdevs={**sdevs, 1: sdevs[1][:10]})
    with pytest.raises(TypeError):
        call(max_bins={**max_bins, 0: max_bins[0].long()})
    with pytest.raises(ValueError):
        call(bands=bands[:-1])  # fewer levels than the config
    with pytest.raises(ValueError):
        call(row0s=[1] + [0] * (len(bands) - 1))  # rows past the level
    with pytest.raises(TypeError):
        call(cnrs={k: (c.double(), r) for k, (c, r) in cnrs.items()})
    assert card == []


def test_the_pipeline_takes_the_wrapper_once(monkeypatch):
    """musica_forward calls ``contrast_apply`` once; the spatial path once a
    shard, each with its rows."""
    calls = []
    real = ka.contrast_apply

    def spy(bands, *args, **kwargs):
        calls.append([tuple(b.shape) for b in bands])
        return real(bands, *args, **kwargs)
    monkeypatch.setattr(ka, "contrast_apply", spy)
    cfg = MusicaConfig(image_size=128)
    imgs = np.stack([synthetic_radiograph(128, "knee")])
    want = musica.musica_forward(torch.from_numpy(imgs[0]), cfg)
    assert len(calls) == 1 and calls[0][0] == (128, 128)
    calls.clear()
    mesh = sharding.make_mesh(n_data=1, n_space=2, devices=[torch.device("cpu")] * 2)
    got = sharding.process_sharded_eager(imgs, cfg, mesh)
    assert len(calls) == 2 and calls[0][0] == calls[1][0] == (64, 128)
    assert torch.equal(got[0], want["out_u8"])
