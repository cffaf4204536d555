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
