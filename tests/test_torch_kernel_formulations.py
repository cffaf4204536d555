"""The formulations of the CUDA kernels K5 (CLAHE apply), K7 (sdev + noise
histogram), KS (K7's sdev alone) and KT (the tone map), emulated on the CPU
before the card runs them.

K5 (``csrc/clahe_apply.cu``) takes the divisions out of the per-pixel work:
each block builds per tile and segment the float2 {y1, slope} with the
plain version's own divisions, per segment its start x1, and computes the
blend attributes itself.  ``kernel_clahe_apply`` below repeats that
formulation in float32 torch operations (each correctly rounded, none
contracted, as in the kernel) and must equal ``ops.clahe.clahe_apply`` bit
for bit, NaN masks included.

K7 (``csrc/sdev_noise.cu``) runs a one-wave grid over a prefix table of
tasks (a task: 32 output rows by a column tile of one level), each block a
contiguous range of tasks, flushing its shared histogram where the range
crosses into the next level.  ``sdev_partition`` below repeats the host's
and the kernel's index arithmetic: every output pixel must lie in exactly
one task and every group of the scanned coverage be scanned exactly once.
KS walks strips of 120 columns down runs of 32 rows, a warp each;
``ks_partition`` repeats its index arithmetic.

KT (``csrc/tonemap.cu``) builds the curve's tables in each block with the
plain version's own float32 operations, selects per pixel the smallest
matching interval (by a binary search on a strictly increasing curve, by
the descending chain otherwise) and writes ``out_u8`` through its own row
and column arithmetic, in aligned words completed from the next lane where
the widths allow.  ``kernel_tone_map`` below repeats that in NumPy float32
and must equal ``ops/cuda/tonemap.py::tone_map_plain`` bit for bit, NaN and
denormals included, every crop byte written once.
"""

import numpy as np
import pytest
import torch

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import clahe, curves, stats
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import tonemap
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import spatial
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import tone_cases

torch.set_num_threads(2)

F32 = torch.float32
I32 = torch.int32


# ----------------------------------------------------------------------
# K5: segment tables and in-kernel blend attributes
# ----------------------------------------------------------------------

def kernel_axis(n, t):
    """csrc/clahe_apply.cu::axis_attr for every index: (base tile, neighbour
    tile, base weight, neighbour weight, centre flag), each [n]."""
    coord = torch.arange(n, dtype=F32) / torch.tensor(float(n // t))
    fl = torch.floor(coord).to(I32)
    base = fl.to(F32) + 0.5
    diff = coord - base
    sgn = (diff > 0.0).to(I32) - (diff < 0.0).to(I32)
    wb = 1.0 - torch.abs(base - coord)
    base_t = fl.clamp(0, t - 1)
    wn = 1.0 - torch.abs((base_t + sgn).to(F32) + 0.5 - coord)  # from the clamped base
    return base_t, (fl + sgn).clamp(0, t - 1), wb, wn, diff == 0.0


def kernel_tables(luts, bins):
    """The block's tables: segment starts x1 [bins - 1] and, per tile and
    segment, y1 and the slope (y2 - y1) / (x2 - x1); entry bins - 1 holds
    the LUT's last value and slope 0."""
    i = torch.arange(bins - 1)
    fb = torch.tensor(float(bins))
    x1 = i.to(F32) / fb
    x2 = torch.where(i == bins - 2, torch.tensor(1.0), (i + 1).to(F32) / fb)
    slope = torch.zeros_like(luts)
    slope[:, :-1] = (luts[:, 1:] - luts[:, :-1]) / (x2 - x1)
    return x1, luts, slope


def kernel_clahe_apply(recon, py, t, bins):
    """The kernel's per-pixel work: +0.0 outside [0, 1]; else the segment
    from one product and one conversion, x - x1 shared by the tiles (x1 a
    product where bins is a power of two), per tile y1 + slope * (x - x1)
    (the last entry at exactly 1.0), and the blend chosen by the centre
    flags, summed left to right."""
    n = recon.shape[-1]
    x1, y1, slope = kernel_tables(py.reshape(t * t, bins), bins)
    x = recon
    inside = (x >= 0.0) & (x <= 1.0)
    i = torch.clamp((x * float(bins)).to(I32), 0, bins - 2)
    seg = torch.where(x == 1.0, bins - 1, i).to(torch.int64)
    if bins & (bins - 1) == 0:  # the kernel's exact product i * (1 / bins)
        xm = x - i.to(F32) * (1.0 / bins)
    else:
        xm = x - x1[i.to(torch.int64)]
    rb, rn, rwb, rwn, rc = (a[:, None] for a in kernel_axis(n, t))
    cb, cn, cwb, cwn, cc = (a[None, :] for a in kernel_axis(n, t))

    def g(tx, ty):
        k = (tx * t + ty).to(torch.int64) * bins + seg
        e_y, e_m = y1.reshape(-1)[k], slope.reshape(-1)[k]
        return torch.where(seg == bins - 1, e_y, e_m * xm + e_y)

    g_bb = g(rb, cb)
    v_r = cwb * g_bb + cwn * g(rb, cn)
    v_c = rwb * g_bb + rwn * g(rn, cb)
    v_4 = (rwb * cwb * g_bb + rwn * cwb * g(rn, cb)) + rwb * cwn * g(rb, cn) + rwn * cwn * g(rn, cn)
    v = torch.where(rc & cc, g_bb, torch.where(rc, v_r, torch.where(cc, v_c, v_4)))
    # outside [0, 1] the kernel returns +0.0 at once (the blend of zeros)
    return torch.where(inside, v, torch.tensor(0.0))


def edge_recon(rng, n, bins):
    """x at segment edges i / bins (true float32 divisions) and the next
    float up, 1.0, +-0.0, below 0, above 1, denormals and their negatives,
    among uniform values in [-0.05, 1.05]."""
    edges = np.arange(bins + 1, dtype=np.float32) / np.float32(bins)
    special = np.float32([1.0, -0.0, 0.0, -1e-3, 1.001, 1e-40, -1e-40, 1e-45, 2.0])
    pool = np.concatenate([edges, np.nextafter(edges, np.float32(2)), special])
    x = rng.uniform(-0.05, 1.05, (n, n)).astype(np.float32)
    pick = rng.uniform(size=(n, n)) < 0.5
    x[pick] = rng.choice(pool, int(pick.sum()))
    return torch.from_numpy(x)


@pytest.mark.parametrize("bins", [64, 256])
@pytest.mark.parametrize("t", [2, 4, 8])
@pytest.mark.parametrize("n", [600, 144, 17])
def test_clahe_kernel_tables_equal_plain_apply(n, t, bins):
    """The table formulation equals the plain apply bit for bit (NaN masks
    and signed zeros included) on random LUTs with a NaN tile and a tile of
    denormals, and on the real clipped-CDF LUTs."""
    rng = np.random.default_rng(n * t + bins)
    cfg = MusicaConfig(image_size=n, enable_clahe=True, clahe_tiles=t, clahe_bins=bins)
    recon = edge_recon(rng, n, bins)
    py = np.sort(rng.uniform(0, 1, (t, t, bins)).astype(np.float32), axis=-1)
    py[t - 1, 0] = np.nan
    py[0, t - 1] = np.float32(1e-40) * np.arange(bins, dtype=np.float32)
    relevant = torch.from_numpy((rng.uniform(size=(n, n)) < 0.7).astype(np.float32))
    px_real, py_real = clahe.clahe_curves(clahe.clahe_histograms(recon, relevant, cfg), cfg)
    for py_t in (torch.from_numpy(py), py_real):
        want = clahe.clahe_apply(recon, px_real, py_t, cfg)
        got = kernel_clahe_apply(recon, py_t, t, bins)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        fin = ~torch.isnan(want)
        assert torch.equal(got[fin].view(torch.int32), want[fin].view(torch.int32))


@pytest.mark.parametrize("n,t", [(3072, 4), (600, 8), (17, 4), (144, 2)])
def test_clahe_kernel_axis_attributes_equal_plain(n, t):
    """The kernel's blend attributes equal ``ops.clahe.axis_attrs``."""
    cfg = MusicaConfig(image_size=n, enable_clahe=True, clahe_tiles=t)
    for got, want in zip(kernel_axis(n, t), clahe.axis_attrs(n, cfg, torch.zeros(1))):
        assert got.dtype == want.dtype or want.dtype == torch.bool
        assert torch.equal(got.view(torch.int32) if got.is_floating_point() else got,
                           want.view(torch.int32) if want.is_floating_point() else want)


# ----------------------------------------------------------------------
# K7: the task partition of the one-wave grid
# ----------------------------------------------------------------------

def sdev_partition(ns, covs, tile, wave, rows=None):
    """Repeat csrc/sdev_noise.cu's launch_sdev and kernel over levels of
    sizes ``ns`` with scanned coverages ``covs``, each computing its output
    rows ``rows[l]`` = (r0, r1) (default: every row): returns per level the
    number of tasks holding each output pixel [n, n] and the number of
    scans of each (row, group) of the coverage [min(cov, n), cov // tile],
    and per block its flushes (the levels, in order)."""
    band, width = fh.SDEV_BAND, fh.sdev_task_width(tile)
    rows = [(0, n) for n in ns] if rows is None else rows
    col_tasks = [-(-n // width) for n in ns]
    first = [0]
    for (r0, r1), ct in zip(rows, col_tasks):
        first.append(first[-1] + ct * -(-(r1 - r0) // band))
    total = first[-1]
    per_block = -(-total // wave)
    blocks = -(-total // per_block)
    assert blocks <= wave
    covered = [np.zeros((n, n), np.int32) for n in ns]
    scanned = [np.zeros((min(c, n), c // tile), np.int32) for n, c in zip(ns, covs)]

    def task_of(t):
        level = 0
        while level + 1 < len(ns) and t >= first[level + 1]:
            level += 1
        local = t - first[level]
        return (level, rows[level][0] + local // col_tasks[level] * band,
                local % col_tasks[level] * width)

    flushes = []
    for b in range(blocks):
        begin, end = b * per_block, min(b * per_block + per_block, total)
        out = []
        for t in range(begin, end):
            level, r0, c0 = task_of(t)
            r1 = rows[level][1]
            covered[level][r0:min(r0 + band, r1), c0:c0 + width] += 1
            groups = covs[level] // tile
            g0, g1 = c0 // tile, min(c0 // tile + width // tile, groups)
            scanned[level][r0:min(r0 + band, r1, covs[level]), g0:max(g0, g1)] += 1
            nxt = task_of(t + 1)[0] if t + 1 < end else level
            if t + 1 == end or nxt != level:
                out.append(level)
        flushes.append(out)
    return covered, scanned, flushes, first


LADDERS = {"3072": (3072, True), "600 ragged, cov < n": (600, True),
           "144 clean math, cov > n": (144, False), "75 below one band": (75, False)}


@pytest.mark.parametrize("wave", [528, 132, 7, 1])
@pytest.mark.parametrize("tile", [16, 12, 5, 32])
@pytest.mark.parametrize("ladder", list(LADDERS))
def test_sdev_task_partition_covers_each_pixel_and_group_once(ladder, tile, wave):
    size, quirks = LADDERS[ladder]
    cfg = MusicaConfig(image_size=size, quirks=quirks, histogram_area_size=tile)
    ns = [-(-size // 2 ** i) for i in cfg.analysis_levels]
    covs = [stats.coverage(n, cfg) for n in ns]
    covered, scanned, flushes, first = sdev_partition(ns, covs, tile, wave)
    for level in range(len(ns)):
        assert (covered[level] == 1).all(), (ladder, level)
        assert (scanned[level] == 1).all(), (ladder, level)
    # a block flushes once per level its range touches, in order, and every
    # level is flushed by as many blocks as its tasks span
    per_block = -(-first[-1] // wave)
    for b, out in enumerate(flushes):
        begin, end = b * per_block, min(b * per_block + per_block, first[-1])
        touched = [lv for lv in range(len(ns)) if first[lv] < end and first[lv + 1] > begin]
        assert out == touched, (b, out, touched)
    if wave < len(ns):
        assert any(len(out) > 1 for out in flushes)  # some range crosses a level


def test_sdev_partition_at_3072_is_one_wave_of_equal_tasks():
    """At the main path's 3072 ladder the tasks are 6,120 tiles of 32 x 64
    px (4,608 + 1,152 + 288 + 72), none ragged."""
    cfg = MusicaConfig(image_size=3072)
    ns = [3072 >> i for i in cfg.analysis_levels]
    _, _, flushes, first = sdev_partition(ns, [stats.coverage(n, cfg) for n in ns], 16, 528)
    assert first == [0, 4608, 5760, 6048, 6120]
    assert len(flushes) == 510  # 12 tasks a block


def ks_partition(ns, warps, rows=None):
    """Repeat csrc/sdev_noise.cu's musica_sdev and sdev_kernel over levels of
    sizes ``ns``, each computing its output rows ``rows[l]`` = (r0, r1)
    (default: every row), with ``warps`` warps looping over the tasks (a
    strip of KS_STRIP output columns by a run of KS_RUN output rows; lane l
    holds columns c0 - 4 + 4 l, lanes 1..30 store): per level the number of
    stores of each output pixel [n, n], and the band rows each level's runs
    read, which must lie in [r0 - 2, r1 + 2) inside the level."""
    strip, run = fh.KS_STRIP, fh.KS_RUN
    rows = [(0, n) for n in ns] if rows is None else rows
    strips = [-(-n // strip) for n in ns]
    first = [0]
    for (r0, r1), st in zip(rows, strips):
        first.append(first[-1] + st * -(-(r1 - r0) // run))
    stored = [np.zeros((n, n), np.int32) for n in ns]
    read = [set() for _ in ns]
    for w in range(warps):
        for t in range(w, first[-1], warps):
            level = max(lv for lv in range(len(ns)) if first[lv] <= t)
            local = t - first[level]
            n, (r0, r1) = ns[level], rows[level]
            ra = r0 + local // strips[level] * run
            rb = min(ra + run, r1)
            read[level].update(r for r in range(ra - 2, rb + 2) if 0 <= r < n)
            for lane in range(1, 31):
                c = local % strips[level] * strip - 4 + 4 * lane
                if c < n:
                    stored[level][ra:rb, c:min(c + 4, n)] += 1
    return stored, read


@pytest.mark.parametrize("wave", [1056, 132, 7, 1])
@pytest.mark.parametrize("ladder", list(LADDERS))
def test_ks_task_partition_covers_each_pixel_once(ladder, wave):
    """KS (``sdev_kernel``): strips of 120 columns by runs of 32 rows, a
    warp a task or ``wave`` warps looping over them, over every level whole
    and over the windows of a 2-shard plan: every output pixel is stored
    exactly once, and a window's runs read only the rows it holds."""
    size, quirks = LADDERS[ladder]
    cfg = MusicaConfig(image_size=size, quirks=quirks)
    ns = [-(-size // 2 ** i) for i in cfg.analysis_levels]
    stored, _ = ks_partition(ns, wave)
    assert all((c == 1).all() for c in stored)
    if size < 96:
        return
    plan = spatial.row_plan(size, 2, cfg)
    lv = list(cfg.analysis_levels)
    for i in range(2):
        rows = [plan.rows(k, i) if k < plan.replicated else (0, ns[j]) for j, k in enumerate(lv)]
        stored, read = ks_partition(ns, wave, rows)
        for c, got, n, (r0, r1) in zip(stored, read, ns, rows):
            assert (c[r0:r1] == 1).all() and c[:r0].sum() == c[r1:].sum() == 0
            assert got <= set(range(max(r0 - 2, 0), min(r1 + 2, n)))


# ----------------------------------------------------------------------
# KA: getY's bucketed count and the one-wave walk over every level's chunks
# ----------------------------------------------------------------------

KA_THREADS, KA_GROUPS, KA_GROUP = 512, 2, 4  # csrc/contrast_apply.cu: kThreads, kGroups
KA_CHUNK = KA_THREADS * KA_GROUPS * KA_GROUP  # kChunk
KA_BUCKET_SHIFT, KA_BUCKETS = 18, 512
KA_BUCKET_OFF = (0x3F800000 >> KA_BUCKET_SHIFT) - (KA_BUCKETS - 1)


def ka_bucket_of(x):
    """csrc/contrast_apply.cu::bucket_of: the float32 bits shifted right,
    offset and clamped (monotone in x over every float32 but NaN)."""
    b = (np.asarray(x, np.float32).view(np.int32) >> KA_BUCKET_SHIFT) - KA_BUCKET_OFF
    return np.clip(b, 0, KA_BUCKETS - 1)


def ka_count(px, x):
    """KA's getY count (csrc/contrast_apply.cu::get_y) at each of x: on a
    non-decreasing curve whose buckets hold at most 2 points each, the
    points below x's bucket (``points_below``) plus how many of the next
    two keys are not >= x (x's bucket's points, or points of higher buckets
    or the +inf past n, which add nothing), NaN x counting every point;
    otherwise the full
    branch-free search over the points padded with +inf to 64.  Returns
    (counts, whether the curve took the bucket table)."""
    px, x = np.asarray(px, np.float32), np.asarray(x, np.float32)
    n = px.size
    with np.errstate(invalid="ignore"):
        ordered = bool(np.all(px[1:] >= px[:-1]))
        fb = ka_bucket_of(px)
        if not ordered or np.bincount(fb, minlength=KA_BUCKETS).max() > 2:
            keys = np.full(64, np.inf, np.float32)
            keys[:n] = px
            pos = np.zeros(x.shape, np.int64)
            s = 32
            while s:
                pos += np.where(~(keys[pos + s - 1] >= x), s, 0)
                s >>= 1
            return np.minimum(pos, n), False
        lo = (fb[None, :] < np.arange(KA_BUCKETS)[:, None]).sum(1)[ka_bucket_of(x)]
        keys = np.concatenate([px, np.full(2, np.inf, np.float32)])
        c = lo + ~(keys[lo] >= x) + ~(keys[lo + 1] >= x)
    return np.where(np.isnan(x), n, c), True


def ka_probe_points(px):
    """x at every point of a curve, its float32 neighbours, +-0, +-inf and
    NaN."""
    px = np.asarray(px, np.float32)
    inf = np.float32(np.inf)
    return np.concatenate([px, np.nextafter(px, inf), np.nextafter(px, -inf),
                           np.float32([0.0, -0.0, np.inf, -np.inf, np.nan])])


def test_ka_bucketed_count_equals_searchsorted_at_every_max_bin():
    """At every max bin of the default config (the bezier levels' px; the
    flat curve's), on each point, its neighbours, +-0, +-inf and NaN, the
    kernel's count equals ``torch.searchsorted``'s left count, which the
    plain ``curves.curve_get_y_sorted`` takes.  Every curve is in order;
    all but 9 (those whose buckets hold 3 points or more) take the bucket
    table, the others the full search."""
    cfg = MusicaConfig()
    lcf = next(l for l, _ in cfg.contrast_factors if l != 1.0)
    flat = curves.contrast_curve(torch.zeros((), dtype=I32), 1.0, 2.0, cfg)[0]
    full = []
    for mb in [None, *range(cfg.noise_histogram_bins)]:
        px = flat if mb is None else \
            curves.contrast_curve(torch.tensor(mb, dtype=I32), lcf, 1.5, cfg)[0]
        assert np.all(px.numpy()[1:] >= px.numpy()[:-1])
        x = ka_probe_points(px.numpy())
        got, bucketed = ka_count(px.numpy(), x)
        want = torch.searchsorted(px, torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"max bin {mb}")
        if not bucketed:
            full.append(mb)
    # max bin 0 (22 points at 0) and 1, and 7 max bins whose segment 2
    # crowds 3 points into a bucket
    assert len(full) == 9 and full[:2] == [0, 1]


def test_ka_full_search_takes_a_curve_out_of_order():
    """A curve whose last segment folds back (max_noise 1.0, so p > 0.5)
    takes the full search; its count is the +inf-padded binary search's."""
    cfg = MusicaConfig(max_noise_value=1.0)
    px = curves.contrast_curve(torch.tensor(1900, dtype=I32), 0.5, 1.5, cfg)[0].numpy()
    assert not np.all(px[1:] >= px[:-1])
    got, bucketed = ka_count(px, ka_probe_points(px))
    assert not bucketed and got.max() <= px.size


def ka_div(x, d):
    """csrc/contrast_apply.cu::div_u with make_div's multiplier for d:
    Granlund and Montgomery's multiply and shift, in uint64 arithmetic."""
    x = np.asarray(x, np.uint64)
    if d == 1:
        return x
    lg = int(np.ceil(np.log2(d)))
    while (1 << lg) < d:
        lg += 1
    m = np.uint64((((1 << lg) - d) << 32) // d + 1)
    t = (x * m) >> np.uint64(32)
    return (t + ((x - t) >> np.uint64(1))) >> np.uint64(lg - 1)


def test_ka_division_by_multiply_and_shift_is_exact():
    """KA's row, column and CNR cell divisions: exact for every divisor up
    to 4,096 and the level widths and CNR scales of 3072, 600 and 144, at
    numerators around each multiple of d and up to 2^31 - 1."""
    divisors = list(range(1, 4097)) + [3072, 1536, 768, 600, 300, 150, 75, 38, 19, 10, 5,
                                       46340, 65535, 2 ** 20 + 7]
    rng = np.random.default_rng(0)
    for d in divisors:
        x = np.concatenate([np.arange(0, 3 * d + 3), (np.arange(1, 40) * d)[:, None]
                            + np.arange(-2, 3)[None, :],
                            rng.integers(0, 2 ** 31, 200), [2 ** 31 - 1, 2 ** 31 - 2]],
                           axis=None).astype(np.int64)
        x = x[(x >= 0) & (x < 2 ** 31)]
        np.testing.assert_array_equal(ka_div(x, d), x // d, err_msg=f"d = {d}")


def ka_walk(levels, wave):
    """Repeat csrc/contrast_apply.cu's launch and its kernel's walk over
    levels of (rows, n): block b takes chunks b, b + blocks, ..., each
    chunk's level from the prefix table, thread t the KA_GROUP pixels from
    g * KA_THREADS * KA_GROUP + KA_GROUP * t of it for g < KA_GROUPS (fewer
    at the level's end).  Returns per level the number of visits of each
    pixel [rows * n], and the blocks."""
    chunk = KA_CHUNK
    chunk0 = [0]
    for rows, n in levels:
        chunk0.append(chunk0[-1] + -(-rows * n // chunk))
    total = chunk0[-1]
    blocks = max(1, min(total, wave))
    q = np.concatenate([np.arange(b, total, blocks) for b in range(blocks)])
    level = np.searchsorted(np.array(chunk0), q, side="right") - 1
    first = (q - np.array(chunk0)[level]) * chunk  # each chunk's first pixel
    lanes = (np.arange(KA_GROUPS)[:, None] * KA_THREADS * KA_GROUP
             + np.arange(KA_THREADS)[None, :] * KA_GROUP).reshape(-1)
    visits = []
    for k, (rows, n) in enumerate(levels):
        groups = -(-rows * n // KA_GROUP)
        g = (first[level == k][:, None] + lanes[None, :]) // KA_GROUP
        per_group = np.bincount(g[g < groups], minlength=groups)
        visits.append(np.repeat(per_group, KA_GROUP)[:rows * n])
    return visits, blocks


@pytest.mark.parametrize("size", [3072, 600, 144])
@pytest.mark.parametrize("wave", [396, 7, 1])
def test_ka_walk_visits_every_pixel_once(size, wave):
    """The one-wave walk over every level's chunks (a block chunks b, b +
    grid, ...): every pixel of every level visited once, whole and on each
    shard's rows of the 1x4 plan (the replicated levels whole)."""
    cfg = MusicaConfig(image_size=size, quirks=size > 144,
                       histogram_area_size=16 if size > 144 else 12)
    ns = [-(-size // 2 ** k) for k in range(cfg.pyramid_levels)]
    plan = spatial.row_plan(size, 4, cfg)
    windows = [[(0, n) for n in ns]]
    windows += [[plan.rows(k, i) if k < plan.replicated else (0, n) for k, n in enumerate(ns)]
                for i in range(4)]
    for rows in windows:
        visits, blocks = ka_walk([(b - a, n) for (a, b), n in zip(rows, ns)], wave)
        assert all((v == 1).all() for v in visits), rows
        assert blocks <= wave


# ----------------------------------------------------------------------
# KH: the strips, the tiles each block zeroes and flushes
# ----------------------------------------------------------------------

KH_BLOCK_COLS, KH_MAX_SEGMENTS = 1024, 32  # csrc/clahe_hist.cu


def kh_tile_of(x, n, tiles):
    """csrc/clahe_hist.cu::tile_of: uint(x / n * tiles) in float32."""
    f = np.float32
    return ((np.asarray(x, f) / f(n)) * f(tiles)).astype(np.int64)


def kh_partition(n, row0, rows, tiles, blocks_per_sm, sms=132):
    """Repeat csrc/clahe_hist.cu's musica_clahe_hist and its kernel's
    block geometry on the rows [row0, row0 + rows) of an [n, n] image:
    returns the visits of each pixel of the window [rows, n], each block's
    (rows, columns, tile rows, tile columns) and the shared memory's tiles
    (span_x, span_y)."""
    t_first, t_last = (int(kh_tile_of(r, n, tiles)) for r in (row0, row0 + rows - 1))
    n_seg = t_last - t_first + 1 if t_last - t_first + 1 <= KH_MAX_SEGMENTS else 1
    xs = kh_tile_of(np.arange(row0, row0 + rows), n, tiles)
    seg_row = [0] + [int(np.searchsorted(xs, t_first + j)) for j in range(1, n_seg)] + [rows]
    gx = -(-n // KH_BLOCK_COLS)
    strips = max(1, sms * blocks_per_sm // gx)
    strip_rows = -(-rows // strips)
    blocks, span_x = [], 0
    for j in range(n_seg):
        for r in range(seg_row[j], seg_row[j + 1], strip_rows):
            r1 = min(r + strip_rows, seg_row[j + 1])
            span_x = max(span_x, int(kh_tile_of(row0 + r1 - 1, n, tiles)
                                     - kh_tile_of(row0 + r, n, tiles)) + 1)
            blocks.append((r, r1))
    span_y = max(int(kh_tile_of(min(n, (b + 1) * KH_BLOCK_COLS) - 1, n, tiles)
                     - kh_tile_of(b * KH_BLOCK_COLS, n, tiles)) + 1 for b in range(gx))
    visits = np.zeros((rows, n), np.int32)
    geometry = []
    for bx in range(gx):
        c0, c1 = bx * KH_BLOCK_COLS, min(n, (bx + 1) * KH_BLOCK_COLS)
        for r, r1 in blocks:
            visits[r:r1, c0:c1] += 1
            geometry.append(((r, r1), (c0, c1),
                             (int(kh_tile_of(row0 + r, n, tiles)),
                              int(kh_tile_of(row0 + r1 - 1, n, tiles))),
                             (int(kh_tile_of(c0, n, tiles)), int(kh_tile_of(c1 - 1, n, tiles)))))
    return visits, geometry, (min(span_x + 1, tiles), min(span_y + 1, tiles))


def kh_rows(row0, r_begin, r_end, n, border, scale):
    """The window rows a thread of csrc/clahe_hist.cu's kernel visits in a
    strip [r_begin, r_end): those inside the border, a CNR row at a time
    (every row of a CNR row with a relevant or solid block)."""
    rows = []
    r, r_hi = max(r_begin, border + 1 - row0), min(r_end, n - border - row0)
    while r < r_hi:
        cr = (row0 + r) // scale
        r_next = min(r_hi, (cr + 1) * scale - row0)
        while r < r_next:
            rows.append(r)
            r += 1
    return rows


@pytest.mark.parametrize("size", [3072, 600, 144])
@pytest.mark.parametrize("tiles", [4, 8])
def test_kh_partition_visits_each_pixel_once_in_the_tiles_it_flushes(size, tiles):
    """KH's blocks over the whole image and the 1x4 plan's shard windows, at
    2, 4 and 8 blocks an SM: every pixel visited once; every pixel's tile
    (global row and column) among the tiles its block zeroes and flushes;
    each block's tiles fit the shared memory the launch gives; a strip lies
    in one tile row where the window holds few; a thread's walk a CNR row
    at a time (scale 8, border 100 or 10) visits every row of its strip
    inside the border once and no other."""
    cfg = MusicaConfig(image_size=size, quirks=size > 144,
                       histogram_area_size=16 if size > 144 else 12)
    bounds = spatial.row_plan(size, 4, cfg).bounds[0]
    for a, b in [(0, size), *zip(bounds, bounds[1:])]:
        for per_sm in (2, 4, 8):
            visits, geometry, (sx, sy) = kh_partition(size, a, b - a, tiles, per_sm)
            assert (visits == 1).all(), (a, b, per_sm)
            for (r0, r1), (c0, c1), (tx0, tx1), (ty0, ty1) in geometry:
                rt = kh_tile_of(np.arange(a + r0, a + r1), size, tiles)
                ct = kh_tile_of(np.arange(c0, c1), size, tiles)
                assert tx0 <= rt.min() and rt.max() <= tx1 and ty0 <= ct.min() and ct.max() <= ty1
                assert tx1 - tx0 + 1 <= sx and ty1 - ty0 + 1 <= sy
                assert tx0 == tx1  # cut at the tile rows' edges
                if c0 == 0:
                    border = 100 if size > 144 else 10
                    want = [r for r in range(r0, r1) if border < a + r < size - border]
                    assert kh_rows(a, r0, r1, size, border, 8) == want
            assert sx * sy <= tiles * tiles


# ----------------------------------------------------------------------
# KT: the tone map's tables, selection and crop addressing
# ----------------------------------------------------------------------

def kernel_tone_map(x, gpx, gpy, m, row0=0):
    """csrc/tonemap.cu in NumPy float32: (graded [rows, n], out_u8, the
    number of writes of each out_u8 byte, the block's tables px_e, py_e,
    m_tab [k + 1] and px_hi [k], whether the curve took the binary
    search, and whether out_u8 went out in words)."""
    f = np.float32
    k = gpx.shape[0]
    rows, n = x.shape
    px_e, py_e, m_tab, hi = (np.zeros(k + 1, f) for _ in range(4))
    search = True
    with np.errstate(all="ignore"):
        for i in range(k + 1):  # build_curve: thread i
            px_e[i] = gpx[i] if i < k else f(0)
            py_e[i] = gpy[i] if i < k else f(0)
            if i < k:
                px1 = gpx[i + 1] if i + 1 < k else f(0)
                py1 = gpy[i + 1] if i + 1 < k else f(0)
                ms = f(f(py1 - py_e[i]) / f(px1 - px_e[i]))
                nonmono = px1 <= px_e[i]
                m_tab[i] = f(0) if nonmono else ms
                hi[i] = px_e[i] if nonmono else px1
                search &= bool(px1 > px_e[i]) if i + 1 < k else bool(nonmono)
        keys = np.full(64, np.inf, f)
        keys[:k - 1] = gpx[1:]
        v = np.where(np.isfinite(x), x, f(3.0e38)).astype(f).reshape(-1)
        if search:  # count(px[i] < x, 1 <= i <= k - 1) by the branch-free search
            step0 = 0
            while 2 * step0 < k:
                step0 = 2 * step0 if step0 else 1
            step0 = step0 if k > 1 else 0
            pos = np.zeros(v.shape, np.int64)
            s = step0
            while s > 0:
                pos += np.where(keys[pos + s - 1] < v, s, 0)
                s >>= 1
            sel = np.where((px_e[0] <= v) & (v <= px_e[k - 1]), pos, k)
        else:  # the descending chain
            sel = np.full(v.shape, k)
            for i in range(k - 1, -1, -1):
                sel = np.where((px_e[i] <= v) & (v <= hi[i]), i, sel)
        g = (m_tab[sel] * (v - px_e[sel])).astype(f) + py_e[sel]
        t = np.trunc(g * f(255)).astype(f)
        t = np.where(np.isnan(t), t, np.clip(t, f(0), f(255)))
        u8 = np.where(np.isnan(t), 0, t).astype(np.int64).astype(np.uint8)  # NaN -> 0
    u8 = u8.reshape(rows, n)
    # chunks of 8 pixels of a row, chunk e in lane e % 32 of its warp (the
    # grid's stride is whole blocks); out_u8 byte by byte, or in words
    out_w = n - 2 * m
    o0, o1 = max(row0, m), max(max(row0, m), min(row0 + rows, n - m))
    out = np.zeros((o1 - o0) * out_w, np.uint8)
    writes = np.zeros_like(out, np.int32)
    words = n % 8 == 0 and out_w % 4 == 0
    lead = m & 3
    chunks = -(-n // 8)

    def put(r, col, val):
        if m <= col < n - m:
            i = (row0 + r - o0) * out_w + col - m
            out[i] = val
            writes[i] += 1

    for e in range(rows * chunks):
        r, c = divmod(e, chunks)
        c *= 8
        lane = e % 32
        if not m <= row0 + r < n - m:
            continue
        b = [u8[r, c + j] if c + j < n else 0 for j in range(8)]
        if not words:
            for j in range(8):
                if c + j < n:
                    put(r, c + j, b[j])
            continue
        has_prev, has_next = lane > 0 and c > 0, lane < 31 and c + 8 < n
        nxt = divmod(e + 1, chunks)  # the next lane's chunk: its first bytes
        nb = [u8[nxt[0], nxt[1] * 8 + j] for j in range(4)] if has_next else [None] * 4
        if not has_prev:
            for j in range(lead):
                put(r, c + j, b[j])
        c0, c1 = c + lead, c + lead + 4
        if m <= c0 < n - m:
            assert (c0 - m) % 4 == 0 and c0 + 4 <= n - m  # an aligned word inside
            for j in range(4):
                put(r, c0 + j, b[lead + j])
        if m <= c1 < n - m:
            assert (c1 - m) % 4 == 0 and c1 + 4 <= n - m
            if has_next or lead == 0:
                for j in range(4):
                    put(r, c1 + j, (b + nb)[lead + 4 + j])
            else:
                for col in range(c1, c + 8):
                    put(r, col, b[col - c])
    return (g.reshape(rows, n), out.reshape(o1 - o0, out_w), writes,
            (px_e, py_e, m_tab, hi[:k]), search, words)


def check_tone_formulation(curve, n, cuts, m):
    px, py = tone_cases.adversarial_curves(np.random.default_rng(0))[curve]
    rng = np.random.default_rng(n)
    x = tone_cases.image(rng, (n, n), px)
    want = curves.general_tables(torch.from_numpy(px), torch.from_numpy(py))
    for a, b in zip(cuts, cuts[1:]):
        g, o, writes, tables, search, words = kernel_tone_map(x[a:b], px, py, m, a)
        pg, po = tonemap.tone_map_plain(torch.from_numpy(x[a:b]), torch.from_numpy(px),
                                        torch.from_numpy(py), m, a)
        np.testing.assert_array_equal(g.view(np.int32), pg.numpy().view(np.int32))
        np.testing.assert_array_equal(o, po.numpy())
        assert (writes == 1).all()
        assert search == bool((np.diff(px) > 0).all() and px[-1] >= 0)
        assert words == (n % 8 == 0 and (n - 2 * m) % 4 == 0)
    for got, w in zip(tables, want):
        np.testing.assert_array_equal(got.view(np.int32), w.numpy().view(np.int32))


@pytest.mark.parametrize("curve", sorted(tone_cases.adversarial_curves(np.random.default_rng(0))))
@pytest.mark.parametrize("n,cuts", [(64, (0, 64)), (75, (0, 3, 11, 40, 66, 75)),
                                    (96, (0, 48, 96))])
def test_tone_map_kernel_formulation_equals_plain(curve, n, cuts):
    """KT's in-block tables, selection (the binary search on a strictly
    increasing curve, else the first hit of the descending chain), float32
    lerp, u8 cast and out_u8 addressing (at 64 and 96 aligned words
    completed from the next lane, 2 lead bytes; at 75 bytes) on whole images
    and on row windows (inside the margins, odd rows) equal the plain chain
    bit for bit, NaN and denormal x included, each out_u8 byte written once
    (curves.general_tables equal the block's tables too)."""
    check_tone_formulation(curve, n, cuts, 10)


@pytest.mark.parametrize("curve", sorted(tone_cases.adversarial_curves(np.random.default_rng(0))))
@pytest.mark.parametrize("n,cuts,m", [(96, (0, 5, 11, 49, 87, 96), 8),
                                      (104, (0, 51, 104), 9)])
def test_tone_map_kernel_formulation_other_margins(curve, n, cuts, m):
    """As above at margins 8 (words with no lead byte) and 9 (an odd crop
    width: bytes)."""
    check_tone_formulation(curve, n, cuts, m)


def test_tone_map_kernel_formulation_takes_both_selections():
    """The adversarial curves take the binary search (the increasing,
    denormal-width, infinite-slope and one-point curves) and the chain (the
    fold-back, duplicates, descending and 63 random points) between them."""
    x = np.linspace(-0.5, 1.5, 64 * 64, dtype=np.float32).reshape(64, 64)
    took = {name: kernel_tone_map(x, px, py, 10)[4]
            for name, (px, py) in tone_cases.adversarial_curves(np.random.default_rng(0)).items()}
    assert {k for k, v in took.items() if v} == {"increasing 22", "denormal width",
                                                "infinite slope", "one point"}
    assert {k for k, v in took.items() if not v} == {"fold-back", "duplicates", "descending",
                                                    "63 random"}


@pytest.mark.parametrize("n,anatomy,linear", [(600, "pelvis", False), (256, "knee", True)])
def test_tone_map_kernel_formulation_on_phantom_curves(n, anatomy, linear):
    """The port forward's own gradation input and curve: the pelvis's at
    600 is strictly increasing and takes the search, the knee's linear
    gradation at 256 folds back and takes the chain; both equal the plain
    chain bit for bit, every out_u8 byte written once in words."""
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        synthetic_radiograph)
    cfg = MusicaConfig(image_size=n, grad_with_linear_image=linear)
    res = musica.musica_forward(torch.from_numpy(synthetic_radiograph(n, anatomy)), cfg,
                                want_intermediates=True)
    x = (res["intermediates"]["linear"] if linear else res["recon"]).numpy()
    gpx, gpy, _ = res["intermediates"]["grad_curve"]
    g, o, writes, _, search, words = kernel_tone_map(x, gpx.numpy(), gpy.numpy(), 10)
    pg, po = tonemap.tone_map_plain(torch.from_numpy(x), gpx, gpy, 10)
    np.testing.assert_array_equal(g.view(np.int32), pg.numpy().view(np.int32))
    np.testing.assert_array_equal(o, po.numpy())
    assert (writes == 1).all() and words
    assert search == (not linear)
