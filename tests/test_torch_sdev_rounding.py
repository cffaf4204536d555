"""The per-output tail of the sdev kernels KS and K7 (``csrc/sdev_noise.cu``:
``div25``, ``sqrt_to_f32``, ``sdev_tail``), modelled on the CPU before the
card runs it, against the plain chain ``stats.sdev_of_sums`` (``sqrt(s /
25)`` in float64, rounded to float32), which equals NumPy's IEEE chain on
every sum: its float64 square root (``stats.sqrt64``) is correctly rounded
on the CPU too.

The kernel divides by 25 with a product, one exact FMA residual and
Markstein's correction, and rounds the square root to float32 from an approximate reciprocal square root,
one Newton step and one exact square of a float32 midpoint.  ``model_tail``
repeats that operation by operation in float64 (Python has no ``math.fma``
before 3.13: ``fractions.Fraction`` gives the FMA's exact result, rounded
once) and must equal the plain chain bit for bit on sums of seeded phantom
bands in ``img_sdev_rows``' order and on the adversarial sums of
``testing/sdev_cases.py``, for starting approximations as good as the
card's and as bad as the proof allows (relative error just under 2^-16).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import normalize, pyramid, stats
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import sdev_cases
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import synthetic_radiograph

F64 = np.float64
I64 = np.int64


def fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once (float() of a Fraction is correctly rounded)."""
    return np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                     for x, y, z in np.broadcast(a, b, c)], F64)


def hi_lo(x):
    """The high and low 32-bit words of float64 ``x`` (int64, unsigned)."""
    b = np.asarray(x, F64).view(I64)
    return b >> 32, b & 0xffffffff


def from_words(hi, lo):
    return ((np.asarray(hi, I64) << 32) | np.asarray(lo, I64)).view(F64)


def div25(s):
    """csrc/sdev_noise.cu::div25 for positive s: Markstein's correction."""
    q0 = s * F64(0.04)
    r = fma(-25.0, q0, s)
    return fma(r, 0.04, q0)


def rsqrt_start(q, kind):
    """Stand-ins for rsqrt.approx.ftz.f64: ``exact`` RN(1 / sqrt q);
    ``high`` from q's high word alone, rounded to float32 (~2^-20);
    ``+bound`` / ``-bound`` the exact value off by a relative 0.99 * 2^-16,
    the most the proof allows."""
    exact = np.array([1.0 / np.sqrt(float(v)) for v in q], F64)
    if kind == "exact":
        return exact
    if kind == "high":
        hi, _ = hi_lo(q)
        return (1.0 / np.sqrt(from_words(hi, 0))).astype(np.float32).astype(F64)
    return exact * (1.0 + (0.99 if kind == "+bound" else -0.99) * 2.0 ** -16)


def sqrt_to_f32(q, y):
    """csrc/sdev_noise.cu::sqrt_to_f32 for q in [2^-245, 2^236], from the
    start y."""
    r = q * y
    e = fma(-r, 0.5 * y, 0.5)
    a = fma(r, e, r)
    a_hi, a_lo = hi_lo(a)
    m_lo = (a_lo & ~0x1fffffff) | 0x10000000
    m = from_words(a_hi, m_lo)
    d = q - m * m
    t = from_words(((2 * (a_hi >> 20) - 1075) << 20) | (a_hi & 0xfffff), m_lo)
    # RZ32(a): a's significand cut to 24 bits (a is a normal float32 here)
    f_lo = (((a_hi >> 20) - 896) << 23) | ((a_hi & 0xfffff) << 3) | (a_lo >> 29)
    up, down = d > t, d <= -t
    bits = f_lo + (up | (~down & ((f_lo & 1) == 1)))
    return bits.astype(np.int32).view(np.float32)


def model_tail(s, kind="high"):
    """csrc/sdev_noise.cu::sdev_tail with its slow path: (float32 sdev,
    which sums took the slow path)."""
    s = np.asarray(s, F64)
    hi, _ = hi_lo(s)
    fast = ((hi - (783 << 20)) & 0xffffffff) < (480 << 20)
    zero = s == 0.0
    slow = ~fast & ~zero
    sf = np.where(fast, s, 1.0)
    q = div25(sf)
    f = sqrt_to_f32(q, rsqrt_start(q, kind))
    out = np.where(fast, f, np.where(np.signbit(s), np.float32(-0.0), np.float32(0.0)))
    out[slow] = ieee(s[slow])
    return out, slow


def ieee(s):
    """The chain with IEEE operations (NumPy's division and square root are
    correctly rounded, as the card's are)."""
    with np.errstate(invalid="ignore", over="ignore"):
        return np.sqrt(np.asarray(s, F64) / 25.0).astype(np.float32)


def plain(s):
    """``sdev_tail_plain`` on the CPU."""
    return fh.sdev_tail_plain(torch.from_numpy(np.asarray(s, F64))).numpy()


def assert_same(got, want, what):
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    bad = np.flatnonzero(got[~nan].view(np.int32) != want[~nan].view(np.int32))
    assert bad.size == 0, (what, bad[:5])


def assert_plain(got, s, what):
    """got equals the IEEE chain and the port's plain version everywhere."""
    assert_same(got, ieee(s), what + " vs IEEE")
    assert_same(got, plain(s), what + " vs sdev_tail_plain")


def single_rounding(q: float) -> np.float32:
    """RN32(sqrt(q)), exact: the float32 c nearest sqrt(q), found by
    comparing q with the squares of the float32 midpoints (ties to even)."""
    c = np.float32(np.sqrt(q))
    inf = np.float32(np.inf)

    def above(a, b):  # sqrt(q) against the midpoint of float32 a < b
        mid = (Fraction(float(a)) + Fraction(float(b))) / 2
        d = Fraction(q) - mid * mid
        return d > 0 or (d == 0 and b.view(np.int32) % 2 == 0)

    while above(c, np.nextafter(c, inf)):
        c = np.nextafter(c, inf)
    while not above(np.nextafter(c, -inf), c):
        c = np.nextafter(c, -inf)
    return c


def band_sums(size, anatomy, level):
    """Every sum of 25 squares of an analysis level's band, in
    ``stats.img_sdev_rows``' order (float64 [n, n])."""
    cfg = MusicaConfig(image_size=size)
    nrm, _, _ = normalize.normalize_from_u16(
        torch.from_numpy(synthetic_radiograph(size, anatomy)), cfg.quirks)
    x = pyramid.reduce_ladder(nrm, cfg.pyramid_levels)[0][level]
    sq = torch.nn.functional.pad((x * x).double(), (2, 2, 2, 2))
    h, w = x.shape
    tmp = sq[0:h]
    for m in range(1, 5):
        tmp = tmp + sq[m:m + h]
    s = tmp[:, 0:w]
    for n in range(1, 5):
        s = s + tmp[:, n:n + w]
    return s.numpy()


@pytest.mark.parametrize("kind", ["exact", "high", "+bound", "-bound"])
def test_tail_model_equals_plain_on_band_sums(kind):
    """~21k sums of a thorax's and a hand's bands (levels 0 and 1) through
    the model equal the plain chain, and agree with img_sdev's own float32
    (the same chain); none takes the slow path."""
    sums = np.concatenate([band_sums(128, "thorax", 0).ravel(),
                           band_sums(128, "hand", 1).ravel()])
    assert sums.size > 20000 and (sums > 0).mean() > 0.9
    got, slow = model_tail(sums, kind)
    assert not slow.any()
    assert_plain(got, sums, kind)


@pytest.mark.parametrize("kind", ["exact", "high", "+bound", "-bound"])
def test_tail_model_equals_plain_on_adversarial_sums(kind):
    """The adversarial sums of testing/sdev_cases.py (division edges,
    squared float32 midpoints and their neighbours, the special values):
    bit for bit, NaN where the plain chain has NaN; the slow path only for
    sums no band gives."""
    rng = np.random.default_rng(15)
    s = sdev_cases.adversarial_sums(rng, 400)
    got, slow = model_tail(s, kind)
    assert_plain(got, s, kind)
    # a sum of 25 float32 squares: 0, or in [2^-149, 25 * float32 max]
    reachable = (s == 0) | ((s >= 2.0 ** -149) & (s <= 25.0 * sdev_cases.FLT_MAX))
    assert not (slow & reachable).any()
    assert slow.any() and (~slow).sum() > 0.9 * s.size


def test_double_rounding_of_the_square_root_is_the_plain_chains():
    """On q next to a squared float32 midpoint the float64 square root lands
    on the midpoint and rounds to even, where the exact root would round
    the other way: the model takes both roundings, as the plain chain does
    (so Figueroa's condition does not apply to a float64 q); and the
    division edges move RN(s / 25) by one step across them."""
    rng = np.random.default_rng(3)
    s, q = sdev_cases.midpoint_squares(rng, 300)
    want = np.sqrt(q).astype(np.float32)  # numpy: both roundings
    got = sqrt_to_f32(q, rsqrt_start(q, "high"))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the exact root rounded once differs on some of them
    once = np.array([single_rounding(float(v)) for v in q], np.float32)
    differ = once.view(np.int32) != want.view(np.int32)
    assert 0 < differ.sum() < differ.size // 2
    edges = sdev_cases.division_edges(rng, 200)
    q25 = div25(edges)
    np.testing.assert_array_equal(q25.view(I64), (edges / 25.0).view(I64))
    assert len(set((edges / 25.0).tolist())) > edges.size // 3


def test_tail_probe_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(7)
    s = torch.from_numpy(sdev_cases.random_doubles(rng, 4000))
    got = fh.sdev_tail(s)
    assert got.dtype == torch.float32 and got.shape == s.shape
    assert_same(got.numpy(), plain(s.numpy()), "cpu")
    model, _ = model_tail(s.numpy(), "high")
    assert_plain(model, s.numpy(), "model")
    with pytest.raises(ValueError):
        fh._launch_sdev_tail(s.float(), 0)


@pytest.mark.parametrize("case", ["adversarial", "midpoint squares", "random"])
def test_the_plain_chain_equals_the_ieee_chain_on_every_sum(case):
    """``sdev_tail_plain`` (``stats.sdev_of_sums``) on the CPU equals NumPy's
    IEEE chain on every sum of ``testing/sdev_cases.py``, NaN where it has
    NaN."""
    rng = np.random.default_rng(16)
    s = {"adversarial": lambda: sdev_cases.adversarial_sums(rng),
         "midpoint squares": lambda: sdev_cases.midpoint_squares(rng)[0],
         "random": lambda: sdev_cases.random_doubles(rng, 1 << 20)}[case]()
    assert_same(plain(s), ieee(s), case)
    assert_same(stats.sdev_of_sums(torch.from_numpy(s)).numpy(), ieee(s), case)


def test_sqrt64_is_correctly_rounded():
    """``stats.sqrt64`` equals NumPy's square root bit for bit on every high
    word of three binades (both ends of each low word), on subnormal,
    huge and random doubles, and keeps sqrt's special values."""
    hi = np.arange(1 << 20, dtype=I64)
    q = np.concatenate([((e << 52) | (hi << 32) | low).view(F64)
                        for e in (1, 1022, 1023) for low in (0, 0xffffffff)])
    rng = np.random.default_rng(5)
    q = np.concatenate([q, rng.integers(1, 1 << 52, 4096).view(F64),
                        ((2046 << 52) | rng.integers(0, 1 << 52, 4096)).view(F64),
                        sdev_cases.random_doubles(rng, 1 << 18), sdev_cases.SPECIAL])
    with np.errstate(invalid="ignore"):
        want = np.sqrt(q)
    got = stats.sqrt64(torch.from_numpy(q)).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(I64), want[~nan].view(I64))


@pytest.mark.parametrize("size,anatomy", [(128, "thorax"), (144, "hand")])
def test_img_sdev_equals_the_ieee_chain(size, anatomy):
    """``img_sdev`` (and so ``img_sdev_rows``) of every analysis level's band
    equals NumPy's IEEE chain on the same float64 sums, and a window of
    rows the whole level's rows."""
    cfg = MusicaConfig(image_size=size)
    nrm, _, _ = normalize.normalize_from_u16(
        torch.from_numpy(synthetic_radiograph(size, anatomy)), cfg.quirks)
    bands = pyramid.reduce_ladder(nrm, cfg.pyramid_levels)[0]
    for level in cfg.analysis_levels:
        got = stats.img_sdev(bands[level]).numpy()
        assert_same(got, ieee(band_sums(size, anatomy, level)), f"level {level}")
        h = bands[level].shape[-1]
        r0, r1 = h // 3, h // 3 + max(1, h // 4)
        win = stats.img_sdev_rows(bands[level], 0, h, r0, r1).numpy()
        assert_same(win, got[r0:r1], f"level {level}, rows [{r0}, {r1})")
