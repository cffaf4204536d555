"""The pyramid kernels of ``csrc/pyramid.cu`` emulated on the CPU before the
card runs them, their fused modes and schedules, and their wrappers'
dispatch.

The kernels repeat the plain path's float64 sums (``ops/pyramid.py``)
operation by operation.  The functions below compute what the kernels
compute, block by block: ``step`` is ``reduce_step_kernel<false>`` (a
block's staged input tile with the rows and columns it loads, its down
tile), ``strip_step`` is ``reduce_step_kernel<true>`` warp by warp (each
lane's columns through the mirror, the sums its neighbours lend it, each
run's walk with the rows its window holds, the edge maps of the expand's
positions), ``up`` is
``upsample_smooth_kernel<mode>`` (the staged small tile, the vertical phase
on slots, the horizontal phase), ``tail_ladder`` and ``tail_expand`` are
``pyramid_tail_kernel`` (its shared buffers as flat arrays, the levels
alternating between them).  Each asserts that every tap reads a staged (or
written) value inside its tile or buffer, and that every output is written
exactly once; each product and sum is a correctly rounded torch operation
as each intrinsic is on the card.  They must equal the plain functions bit
for bit (tolerance: none; bit patterns compared, so -0.0 differs from +0.0)
at every level of 600, 144, 75, 17, 5, 3, 2 and 1 px, at sizes whose tiles
or strips end on, short of or past a boundary, on every shard window of the
spatial plans at 600 and 144 over 4 shards, and, index maps only, at every
level of 3072.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig as JConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica as j_musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import pyramid
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import pyramid as kp
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import pyramid_cases as pc
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import synthetic_radiograph

from test_torch_pipeline import assert_u8_parity

torch.set_num_threads(2)

# csrc/pyramid.cu: reduce_step_kernel<false>'s down tile and staged input;
# upsample_smooth_kernel's output tile, staged small tile, slots; the
# tail's level limit
DH, DW = 16, 32
CUR_ROWS, CUR_COLS = 2 * DH + 8, 2 * DW + 8
UP_H, UP_W = 32, 64
SMALL_ROWS, SMALL_COLS, UP_SLOTS = UP_H // 2 + 3, UP_W // 2 + 8, UP_W // 2 + 2
MAX_TAIL = 16
TABLE_BYTES = 2 * (256 + 4) + 2 * (128 + 2)  # TailTables: mirror and extension maps
# kW0, kW1, kW2 as the kernel derives them: float32 roundings of doubles
KW = (float(np.float32(0.25 - 0.3 / 2)), float(np.float32(0.25)), float(np.float32(0.3)))
W5 = (KW[0], KW[1], KW[2], KW[1], KW[0])
NAN = float("nan")


def ceil2(n):
    return -(-n // 2)


def mirror(p, n):
    """The kernel's mirror(): one reflection, -1 where out of [0, n)."""
    p = np.asarray(p)
    v = np.where(p > n - 1, 2 * (n - 1) - p, np.where(p < 0, -p, p))
    return np.where((v >= 0) & (v <= n - 1), v, -1)


def extend(p, src, n):
    """The kernel's extend(): the polyphase form's small-grid positions
    -1 .. src -> row/column."""
    p = np.asarray(p)
    return np.where(p < 0, 1, np.where(p >= src, n - 1 - src, p))


def polyphase(n):
    """The kernels' branch: n >= 6 and src >= 3."""
    return n >= 6 and ceil2(n) >= 3


def taps5(vals):
    """W0*v0 + W1*v1 + ... + W4*v4 in float64, from the first product on."""
    acc = W5[0] * vals[0]
    for w, v in zip(W5[1:], vals[1:]):
        acc = acc + w * v
    return acc


def phase_even(e0, e1, e2):
    return (KW[0] * e0 + KW[2] * e1) + KW[0] * e2


def phase_odd(e1, e2):
    return KW[1] * e1 + KW[1] * e2


def gain4(s):
    return s.float() * 4.0


def round16(n):
    return -(-n // 16) * 16


def tail_maps(n):
    """A tail level's tables: mirror(p, n) for p in [-2, n + 1] and the
    extension for p in [-1, ceil(n/2)], as pyramid_tail_kernel builds them;
    every tap must fall inside them."""
    return mirror(np.arange(-2, n + 2), n), extend(np.arange(-1, ceil2(n) + 1), ceil2(n), n)


def bits(t):
    return t.contiguous().view(torch.int32)


def assert_bits(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert torch.equal(bits(got), bits(want)), what


def t_(a):
    return torch.from_numpy(np.array(a))


def scatter_once(shape, rows, cols, mask, vals, what):
    """out[rows, cols] = vals where mask (block-shaped arrays broadcast
    together), each output pixel written exactly once."""
    rows, cols, mask = np.broadcast_arrays(rows, cols, mask)
    count = np.zeros(shape, np.int64)
    np.add.at(count, (rows[mask], cols[mask]), 1)
    assert (count == 1).all(), f"{what}: outputs written {count.min()} to {count.max()} times"
    out = torch.empty(shape, dtype=vals.dtype)
    out[t_(rows[mask]), t_(cols[mask])] = vals[t_(mask)]
    return out


# ----------------------------------------------------------------------
# reduce_step_kernel<false>: the down step alone, block by block
# ----------------------------------------------------------------------

def step_axis(n, j0, j1, x0, xrows, tile):
    """One axis of reduce_step_kernel<false>'s blocks (rows: tile DH,
    columns: DW): per block, the down position of its first slot (D0), the
    staged input's first position (2 D0 - 4), which staged entries it
    loads, each slot's validity and down position, and each slot's 5 taps
    as staged indices (-1: the tap reads 0.0).  Asserts that every tap of a
    valid slot reads a loaded entry."""
    staged = 2 * tile + 8
    d0 = j0 + tile * np.arange(-(-(j1 - j0) // tile))
    base = 2 * d0 - 4
    pos = base[:, None] + np.arange(staged)
    loaded = (pos >= np.maximum(base, x0)[:, None]) & (pos < np.minimum(base + staged,
                                                                       x0 + xrows)[:, None])
    p = d0[:, None] + np.arange(tile)
    valid = p <= j1 - 1
    rows = mirror(2 * p[..., None] + np.arange(5) - 2, n)
    idx = np.where(rows >= 0, rows - base[:, None, None], -1)
    inside = (idx >= 0) & (idx < staged)
    hit = np.take_along_axis(loaded, np.clip(idx, 0, staged - 1).reshape(len(d0), -1),
                             1).reshape(idx.shape)
    assert ((rows < 0) | (inside & hit))[valid].all(), "a tap reads an entry not staged"
    # an interior block reads slot s's taps at staged 2 s + m + 2 without
    # its tables: they must say the same
    last = p[:, -1]
    inner = (p[:, 0] >= 1) & (last <= j1 - 1) & (2 * last + 2 <= n - 1)
    linear = 2 * np.arange(tile)[:, None] + np.arange(5) + 2
    assert (idx[inner] == linear).all(), "an interior block's taps are not the linear map"
    return d0, base, loaded, valid, p, idx


def step(x, x0, h, j0, j1):
    """reduce_step_kernel<false> block by block: rows [j0, j1) of the down
    image of an [h, w] image from x, its rows [x0, ...)."""
    w = x.shape[-1]
    dw = ceil2(w)
    D0, rbase, rload, rvalid, rpos, ridx = step_axis(h, j0, j1, x0, x.shape[0], DH)
    E0, cbase, cload, cvalid, cpos, cidx = step_axis(w, 0, dw, 0, w, DW)
    By, Bx = len(D0), len(E0)
    # the staged tiles [By, Bx, 40, 72], NaN where nothing was staged
    gr = np.clip(rbase[:, None] + np.arange(CUR_ROWS) - x0, 0, x.shape[0] - 1)
    gc = np.clip(cbase[:, None] + np.arange(CUR_COLS), 0, w - 1)
    tiles = x.double()[t_(gr)[:, None, :, None], t_(gc)[None, :, None, :]]
    tiles = torch.where(t_(rload[:, None, :, None] & cload[None, :, None, :]), tiles, NAN)
    by, bx = torch.arange(By)[:, None, None], torch.arange(Bx)[None, :, None]
    # vertical sums at each slot's down row and staged column
    q = []
    for m in range(5):
        im = t_(ridx[..., m])
        q.append(torch.where((im >= 0)[:, None, :, None], tiles[by, bx, im.clamp(min=0)[:, None]],
                             0.0))
    vs = torch.where(t_(rvalid[:, None, :, None] & cload[None, :, None, :]), taps5(q), 0.0)
    # the down tile: horizontal sums of the staged columns
    hq = []
    for k in range(5):
        ik = t_(cidx[..., k])
        g = torch.gather(vs, 3, ik.clamp(min=0)[None, :, None, :].expand(By, Bx, vs.shape[2], -1))
        hq.append(torch.where((ik >= 0)[None, :, None, :], g, 0.0))
    ok = rvalid[:, None, :, None] & cvalid[None, :, None, :]
    dt = torch.where(t_(ok), taps5(hq).float(), 0.0)
    assert not dt.isnan().any(), "a down pixel read an entry not staged"
    return scatter_once((j1 - j0, dw), (rpos - j0)[:, None, :, None], cpos[None, :, None, :],
                        ok, dt, "down")


# ----------------------------------------------------------------------
# reduce_step_kernel<true>: the fused step, warp strips
# ----------------------------------------------------------------------

STRIP = 120  # band columns of a warp's strip (kStripCols): 30 writing lanes x 4
# the positions dq - 1, dq, dq + 1, dq + 2 of the expand's horizontal
# phase as (lane offset, which of the lane's two down columns), and each
# band column's taps among them (even columns 3, odd 2)
U_SOURCES = ((-1, 1), (0, 0), (0, 1), (1, 0))
BAND_TAPS = ((0, 1, 2), (1, 2), (1, 2, 3), (2, 3))


def mirror_clamp(p, n):
    """The kernel's mirror_clamp(): mirror(), clamped into [0, n) where a
    position lies past the mirror's reach."""
    p = np.asarray(p)
    return np.clip(np.where(p < 0, -p, np.where(p > n - 1, 2 * (n - 1) - p, p)), 0, n - 1)


def strip_lanes(n):
    """The fused step's lanes at an n-px level, per strip and lane: its
    down columns dq (and dq + 1), the level columns it loads (its band
    columns 2 dq .. 2 dq + 3 through the mirror), whether it writes, and
    the source (lane offset, down column) of each position dq - 1 .. dq + 2
    that its band reads, after the extension (position -1 reads 1, dh reads
    n - 1 - dh)."""
    dh = ceil2(n)
    lane = np.arange(32)
    dq = (STRIP // 2) * np.arange(-(-n // STRIP))[:, None] - 2 + 2 * lane
    cols = mirror_clamp(2 * dq[..., None] + np.arange(4), n)
    out = (lane >= 1) & (lane <= 30) & (2 * dq < n)
    src = np.broadcast_to(np.array(U_SOURCES), dq.shape + (4, 2)).copy()
    src[dq == 0, 0] = (0, 1)
    src[dq + 1 == dh, 2] = (-1, 1) if n % 2 else (0, 0)
    src[dq + 2 == dh, 3] = (0, 0) if n % 2 else (0, 1)
    return dq, cols, out, src


def strip_walk(n, rows):
    """The fused step's runs of ``rows`` down rows at an n-px level, each
    walked down as the kernel walks it: per run, the down rows it computes
    (ja - 1 .. ja + rows) with the level rows of each one's 5 vertical taps
    (through the mirror) as the walk's window holds them, and per step its
    down row j, whether the run has it, and the computed rows it reads as
    down rows j - 1, j, j + 1 after the extension.  Asserts that the window
    holds each down row's taps in order, each row loaded once."""
    dh = ceil2(n)
    runs = -(-dh // rows)
    ja = rows * np.arange(runs)
    jb = np.minimum(ja + rows, dh)
    taps = np.zeros((runs, rows + 2, 5), np.int64)
    for r in range(runs):
        window = list(range(2 * ja[r] - 4, 2 * ja[r] + 3))   # the first 7 rows
        got = [window[:5], window[2:]]                       # down rows ja - 1, ja
        loaded = list(window)
        window = window[4:]
        for j in range(ja[r], jb[r]):
            new = [2 * j + 3, 2 * j + 4]
            loaded += new
            window = window + new
            got.append(window)                               # down row j + 1
            window = window[2:]
        assert len(set(loaded)) == len(loaded), "a level row loaded twice"
        for i, rows_of in enumerate(got):
            d = ja[r] - 1 + i
            assert rows_of == list(range(2 * d - 2, 2 * d + 3)), "a down row's taps"
            taps[r, i] = rows_of
    k = np.arange(rows)
    j = ja[:, None] + k
    live = j < jb[:, None]
    # computed row i of a run is down row ja - 1 + i: row j is slot k + 1
    prev, cur, nxt = (np.broadcast_to(k + i, j.shape) for i in range(3))
    nxt = np.where(j + 1 == dh, prev if n % 2 else cur, nxt)
    prev = np.where(j == 0, nxt, prev)
    return ja, j, live, mirror_clamp(taps, n), np.stack([prev, cur, nxt], -1)


def shfl(a, off):
    """__shfl_up_sync (off -1) or __shfl_down_sync (off 1) by one lane along
    the lane axis (-2): a lane past the warp's edge reads its own value."""
    return torch.cat([a[..., :1, :], a[..., :-1, :]] if off < 0 else [a[..., 1:, :], a[..., -1:, :]],
                     dim=-2)


def strip_step(x, rows=None):
    """reduce_step_kernel<true> warp by warp: (band, down) of the square
    level x, each run ``rows`` down rows long (the wrapper's
    ``strip_rows``)."""
    n = x.shape[0]
    dh = ceil2(n)
    rows = rows or kp.strip_rows(n)
    dq, cols, out, src = strip_lanes(n)
    ja, j, live, taps, slots = strip_walk(n, rows)
    X = x.double()
    # the vertical sums of each computed down row at each lane's 4 columns:
    # [runs, rows + 2, strips, 32, 4]
    v = taps5([X[t_(taps[..., m])][..., t_(cols)] for m in range(5)])
    left, right = shfl(v, -1), shfl(v, 1)
    d = torch.stack([taps5([left[..., 2], left[..., 3], v[..., 0], v[..., 1], v[..., 2]]),
                     taps5([v[..., 0], v[..., 1], v[..., 2], v[..., 3], right[..., 0]])],
                    -1).float()
    # each step's down rows j - 1, j, j + 1: [runs, rows, strips, 32, 2]
    run = torch.arange(len(ja))[:, None]
    lo, mid, hi = (d[run, t_(slots[..., i])].double() for i in range(3))
    # each lane's source of positions dq - 1 .. dq + 2: one of its own two
    # down columns or of either neighbour's, code (offset + 1) * 2 + column
    code = t_((src[..., 0] + 1) * 2 + src[..., 1])
    band = {}
    for r, u in ((0, phase_even(lo, mid, hi)), (1, phase_odd(mid, hi))):
        cand = torch.stack([(shfl(u, o) if o else u)[..., i] for o in (-1, 0, 1) for i in (0, 1)],
                           -1)
        pos = torch.gather(cand, -1, code.expand(*cand.shape[:-1], 4))
        up = [gain4(phase_even(*[pos[..., t] for t in tp]) if len(tp) == 3
                    else phase_odd(*[pos[..., t] for t in tp])) for tp in BAND_TAPS]
        row = 2 * j + r
        cur = X[t_(np.minimum(row, n - 1))][..., t_(cols)].float()
        band[r] = (row, cur - torch.stack(up, -1))
    bcol = 2 * dq[..., None] + np.arange(4)
    rows_all = np.stack([band[0][0], band[1][0]])[:, :, :, None, None, None]
    ok = (live[None, :, :, None, None, None] & out[None, None, None, :, :, None]
          & (bcol < n)[None, None, None] & (rows_all < n))
    got_band = scatter_once((n, n), rows_all, bcol[None, None, None], ok,
                            torch.stack([band[0][1], band[1][1]]), "band")
    dcol = dq[..., None] + np.arange(2)
    ok = live[:, :, None, None, None] & out[None, None, :, :, None] & (dcol < dh)[None, None]
    got_dn = scatter_once((dh, dh), j[:, :, None, None, None], dcol[None, None], ok,
                          d[:, 1:rows + 1], "down")
    return got_band, got_dn


def strip_check(n, rows=None):
    """The fused step's maps at an n-px level (no data): every down pixel
    and band pixel written once, by a writing lane; each down pixel's
    taps, and each band pixel's down rows and columns, the plain path's
    (its mirror table, the polyphase extension), each of those down columns
    computed by a lane whose neighbours lend it its sums."""
    rows = rows or kp.strip_rows(n)
    dh = ceil2(n)
    idx, valid = pyramid._mirror_idx(n)
    dq, cols, out, src = strip_lanes(n)
    ja, j, live, taps, slots = strip_walk(n, rows)
    drow = ja[:, None] - 1 + np.arange(rows + 2)
    # down rows a step reads: the extension of j - 1, j, j + 1, computed from
    # the plain path's rows
    read = np.take_along_axis(drow, slots.reshape(len(ja), -1), 1).reshape(slots.shape)
    want = extend(j[..., None] + np.arange(-1, 2), dh, n)
    assert (read == want)[live].all(), "a band row reads the wrong down rows"
    inside = (drow >= 0) & (drow < dh)
    pos = np.clip(2 * drow[..., None] + np.arange(5) - 2, -2, n + 1) + 2
    assert (valid[pos] > 0)[inside].all() and (taps == idx[pos])[inside].all(), \
        "a down row's taps are not the plain path's"
    assert np.array_equal(np.sort(j[live]), np.arange(dh)), "each down row once"
    # columns: the lanes' level columns are the plain mirror of their band
    # columns wherever a down column < dh reads them
    vcol = 2 * dq[..., None] + np.arange(4)
    near = (vcol >= -2) & (vcol <= n + 1)
    assert (cols == idx[np.clip(vcol, -2, n + 1) + 2])[near].all()
    for s, l in zip(*np.nonzero(out)):
        for e, tp in enumerate(BAND_TAPS):
            if 2 * dq[s, l] + e >= n:
                continue
            for t in tp:
                o, i = src[s, l, t]
                ln = l + o
                assert dq[s, ln] + i == extend(dq[s, l] - 1 + t, dh, n), \
                    "a band column reads the wrong down column"
                assert (1 <= ln + i <= 31) and 0 <= dq[s, ln] + i < dh, \
                    "a down column read from a lane without its neighbours' sums"
    cover = np.zeros(n, np.int64)
    np.add.at(cover, (2 * dq[..., None] + np.arange(4))[out[..., None] & (vcol < n)], 1)
    assert (cover == 1).all(), "each band column once"
    dcover = np.zeros(dh, np.int64)
    dcol = dq[..., None] + np.arange(2)
    np.add.at(dcover, dcol[out[..., None] & (dcol < dh)], 1)
    assert (dcover == 1).all(), "each down column once"


# ----------------------------------------------------------------------
# upsample_smooth_kernel<mode>
# ----------------------------------------------------------------------

def up_small_form(S, n, r0, r1):
    """smooth(upsample(img, n), 4.0) at each output pixel of rows [r0, r1)
    from the whole small image S (float64): the zero-stuffed grid read
    through the mirror (upsample_pixel_small)."""
    u = mirror(np.arange(r0, r1)[:, None] + np.arange(5)[None, :] - 2, n)   # [rows, 5]
    vc = mirror(np.arange(n)[:, None] + np.arange(5)[None, :] - 2, n)       # [n, 5]
    acc = None
    for k in range(5):
        tk = None
        for m in range(5):
            um, vk = u[:, m][:, None], vc[:, k][None, :]
            ok = (um >= 0) & (um % 2 == 0) & (vk >= 0) & (vk % 2 == 0)
            val = S[np.where(ok, um // 2, 0), np.where(ok, vk // 2, 0)]
            prod = W5[m] * torch.where(t_(ok), val, 0.0)
            tk = prod if m == 0 else tk + prod
        tk = torch.where(t_(vc[:, k] >= 0)[None, :], tk, 0.0)
        prod = W5[k] * tk
        acc = prod if k == 0 else acc + prod
    return (acc * 4.0).float()


def combine(up, mode, other):
    if mode == 1:
        return other - up
    if mode == 2:
        return up + other.float()
    return up


def up(small, s0, n, r0, r1, mode=0, other=None, srows=None):
    """upsample_smooth_kernel<mode> block by block: rows [r0, r1) of
    upsample_smooth(img, n) (mode 0), of other - that (1) or that + other
    (2), from small, the rows [s0, ...) of the ceil(n/2)-px img.  With
    small None, only the index maps of a small image of ``srows`` rows."""
    src = ceil2(n)
    srows = small.shape[0] if small is not None else srows
    if not polyphase(n):
        assert s0 == 0 and small.shape[0] == src, "the small form reads the whole small image"
        return combine(up_small_form(small.double(), n, r0, r1), mode, other)
    By, Bx = -(-(r1 - r0) // UP_H), -(-n // UP_W)
    rb = r0 + UP_H * np.arange(By)
    rend = np.minimum(rb + UP_H, r1)
    P0, P1 = (rb >> 1) - 1, ((rend - 1) >> 1) + 1
    rbase = np.maximum(P0, 0)
    r_lo = np.maximum(rbase, s0)
    r_hi = np.minimum(np.minimum(P1 + 1, src), s0 + srows)
    cb = UP_W * np.arange(Bx)
    Q0 = cb // 2 - 1
    cbase = np.maximum(Q0, 0) & ~3
    c_lo, c_hi = np.maximum(Q0, 0), np.minimum(np.minimum(Q0 + UP_SLOTS, src), cbase + SMALL_COLS)
    # the staged tiles [By, Bx, 19, 40], NaN where nothing was staged
    sr = rbase[:, None] + np.arange(SMALL_ROWS)
    sc = cbase[:, None] + np.arange(SMALL_COLS)
    rl = (sr >= r_lo[:, None]) & (sr < r_hi[:, None])
    cl = (sc >= c_lo[:, None]) & (sc < c_hi[:, None])
    # row taps of output row rb + rr: positions j - 1, j, j + 1
    row = rb[:, None] + np.arange(UP_H)
    rvalid = row < rend[:, None]
    ridx = extend((row >> 1)[..., None] + np.arange(-1, 2), src, n) - rbase[:, None, None]
    # slot column b: position Q0 + b
    q = Q0[:, None] + np.arange(UP_SLOTS)
    cvalid = q <= src
    cidx = extend(q, src, n) - cbase[:, None]
    for idx, lim, load, ok in ((ridx, SMALL_ROWS, rl, rvalid[..., None]),
                               (cidx, SMALL_COLS, cl, cvalid)):
        inside = (idx >= 0) & (idx < lim)
        hit = np.take_along_axis(load, np.clip(idx, 0, lim - 1).reshape(len(load), -1),
                                 1).reshape(idx.shape)
        assert (inside & hit)[np.broadcast_to(ok, idx.shape)].all(), "a tap reads past the tile"
    if small is None:
        return None
    tiles = small.double()[t_(np.clip(sr - s0, 0, srows - 1))[:, None, :, None],
                           t_(np.clip(sc, 0, src - 1))[None, :, None, :]]
    tiles = torch.where(t_(rl[:, None, :, None] & cl[None, :, None, :]), tiles, NAN)
    by, bx = torch.arange(By)[:, None, None, None], torch.arange(Bx)[None, :, None, None]
    ci = t_(np.clip(cidx, 0, SMALL_COLS - 1))[None, :, None, :]
    e = [tiles[by, bx, t_(np.clip(ridx[..., i], 0, SMALL_ROWS - 1))[:, None, :, None], ci]
         for i in range(3)]
    uv = torch.where(t_(row % 2 == 1)[:, None, :, None], phase_odd(e[1], e[2]), phase_even(*e))
    uv = torch.where(t_(rvalid[:, None, :, None] & cvalid[None, :, None, :]), uv, 0.0)
    cc = np.arange(UP_W)
    f = [uv[..., t_(cc // 2 + i)] for i in range(3)]
    vals = gain4(torch.where(t_(cc % 2 == 1), phase_odd(f[1], f[2]), phase_even(*f)))
    col = cb[:, None] + cc
    inb = rvalid[:, None, :, None] & (col < n)[None, :, None, :]
    assert not vals[t_(np.broadcast_to(inb, vals.shape))].isnan().any(), "read a tap not staged"
    out = scatter_once((r1 - r0, n), (row - r0)[:, None, :, None], col[None, :, None, :], inb,
                       vals, "up")
    return combine(out, mode, other)


# ----------------------------------------------------------------------
# pyramid_tail_kernel<kExpand>
# ----------------------------------------------------------------------

class Buffer:
    """A region of the tail's shared memory: reads must fall inside the
    image it holds now (``size`` entries) and on entries written."""

    def __init__(self, length, dtype):
        self.data = torch.full((length,), NAN, dtype=dtype)
        self.size = 0

    def write(self, idx, vals, size):
        assert idx.max() < len(self.data), "a write past the buffer"
        self.size = size
        self.data[t_(idx)] = vals.to(self.data.dtype)

    def read(self, idx):
        assert idx.max() < self.size, "a read past the image the buffer holds"
        v = self.data[t_(idx)]
        assert not v.isnan().any(), "a read of an entry not written"
        return v.double()


def tail_up(sm, n, work, finish):
    """tail_up: the expand of the ceil(n/2)-px image in buffer ``sm`` to n
    px, ``finish(t, up)`` combining each output pixel t with cur or the
    band."""
    src = ceil2(n)
    mt, et = tail_maps(n)
    assert len(mt) <= 256 + 4 and len(et) <= 128 + 2
    t = np.arange(n * n)
    row, col = t // n, t % n
    if polyphase(n):
        tt = np.arange(n * src)
        r, qq = tt // src, tt % src
        j = r >> 1
        e = [sm.read(extend(j + i, src, n) * src + qq) for i in (-1, 0, 1)]
        work.write(tt, torch.where(t_(r % 2 == 1), phase_odd(e[1], e[2]), phase_even(*e)),
                   n * src)
        k = col >> 1
        f = [work.read(row * src + extend(k + i, src, n)) for i in (-1, 0, 1)]
        vals = gain4(torch.where(t_(col % 2 == 1), phase_odd(f[1], f[2]), phase_even(*f)))
    else:
        S = sm.read(np.arange(src * src)).reshape(src, src)
        vals = up_small_form(S, n, 0, n).reshape(-1)
    return finish(t, vals)


def tail_ladder(cur, levels):
    """pyramid_tail_kernel<false>: (bands, downs) of ``levels`` levels from
    cur [s, s], the levels alternating between buffers A (s^2) and B
    (ceil(s/2)^2), the float64 sums in one ceil(s/2) x s work buffer."""
    size = cur.shape[0]
    ds0 = ceil2(size)
    assert kp.tail_shared_bytes(size, False) == round16(8 * (ds0 * size + size * size + ds0 * ds0)
                                                        + 2 * TABLE_BYTES)
    work = Buffer(ds0 * size, torch.float64)
    c, d = Buffer(size * size, torch.float64), Buffer(ds0 * ds0, torch.float64)
    c.write(np.arange(size * size), cur.reshape(-1), size * size)
    bands, downs, s = [], [], size
    for _ in range(levels):
        ds = ceil2(s)
        assert 2 * ds <= s + 1  # the last tap position lies in the mirror table
        t = np.arange(ds * s)
        j, col = t // s, t % s
        rows = [mirror(2 * j + m - 2, s) for m in range(5)]
        work.write(t, taps5([torch.where(t_(r >= 0), c.read(np.where(r >= 0, r, 0) * s + col), 0.0)
                             for r in rows]), ds * s)
        t = np.arange(ds * ds)
        j, k = t // ds, t % ds
        cols = [mirror(2 * k + m - 2, s) for m in range(5)]
        v = taps5([torch.where(t_(cc >= 0), work.read(j * s + np.where(cc >= 0, cc, 0)), 0.0)
                   for cc in cols]).float()
        d.write(t, v, ds * ds)
        downs.append(v.reshape(ds, ds))
        bands.append(tail_up(d, s, work, lambda tt, u: (c.read(tt).float() - u)).reshape(s, s))
        c, d, s = d, c, ds
    return bands, downs


def tail_expand(top, bands):
    """pyramid_tail_kernel<true>: top expanded through bands (the largest
    first), the intermediate levels alternating between two ceil(s/2)^2
    buffers, only the result leaving the block."""
    size = bands[0].shape[0]
    ds0 = ceil2(size)
    staged = sum(round16(b.numel() * b.element_size()) for b in bands)
    assert kp.tail_shared_bytes(size, True, staged) == round16(
        8 * (ds0 * size + 2 * ds0 * ds0) + 2 * TABLE_BYTES) + staged
    work = Buffer(ds0 * size, torch.float64)
    sm, o = Buffer(ds0 * ds0, torch.float64), Buffer(ds0 * ds0, torch.float64)
    sm.write(np.arange(top.numel()), top.reshape(-1), top.numel())
    for lvl in range(len(bands) - 1, -1, -1):
        b = bands[lvl].reshape(-1)
        n = bands[lvl].shape[0]
        vals = tail_up(sm, n, work, lambda tt, u: u + b[t_(tt)].float())
        if lvl == 0:
            return vals.reshape(n, n)
        o.write(np.arange(n * n), vals, n * n)
        sm, o = o, sm


# ----------------------------------------------------------------------
# (a) the formulations
# ----------------------------------------------------------------------

def test_kernel_taps_are_the_plain_weights():
    assert list(W5) == list(pyramid._W)


@pytest.mark.parametrize("level", range(12))
def test_index_maps_at_every_level_of_3072(level):
    """At each level of the 3072 ladder (no data): every tap of the down
    step and the expand step reads a row and column that its block staged,
    the plain path's mirror table and polyphase extension name the same
    rows, the expand takes the plain path's form, the fused step's lanes,
    halo lanes and runs (the rule's strip height and others) read the
    plain path's taps and write each pixel once, and a
    level goes to the fused step or the tail as the schedule says."""
    h = pc.level_sizes(3072)[level]
    dh = ceil2(h)
    idx, valid = pyramid._mirror_idx(h)
    D0, rbase, _, rvalid, rpos, ridx = step_axis(h, 0, dh, 0, h, DH)
    rows = np.where(ridx >= 0, ridx + rbase[:, None, None], -1)[rvalid]
    pos = 2 * rpos[rvalid][:, None] + np.arange(5) - 2
    assert np.array_equal(rows >= 0, valid[pos + 2] > 0)
    assert np.array_equal(np.where(rows >= 0, rows, 0), np.where(valid[pos + 2] > 0, idx[pos + 2], 0))
    assert np.array_equal(np.sort(rpos[rvalid]), np.arange(dh))   # each down row once
    step_axis(h, 0, dh, 0, h, DW)
    src = ceil2(h)
    assert polyphase(h) == pyramid.polyphase(h) == (h >= 6)
    if polyphase(h):
        for rows in (None, 1, 2, 5, 19):
            strip_check(h, rows)
        edge = h - 1 - src
        tap = pyramid._up_map(h)
        k = np.arange(h) >> 1
        want = np.array([[tap(p)[0] for p in range(kk - 1, kk + 2)] for kk in k])
        assert np.array_equal(extend(k[:, None] + np.arange(-1, 2), src, h), want)
        assert extend(-1, src, h) == 1 and extend(src, src, h) == edge
        up(None, 0, h, 0, h, srows=src)
    assert (h > kp.TAIL_CUT) == (level < 6)


@pytest.mark.parametrize("n", [600, 144, 75, 17, 5, 3, 2, 1])
def test_formulation_equals_plain_at_every_level(n):
    """The down step on every level of the n-px ladder and the expand step
    (each mode) back to it, on data with +-0, denormals and 1e30, and on
    constant planes (a denormal one among them: the small expand's gain
    before its rounding shows there), against the plain functions bit for
    bit."""
    rng = np.random.default_rng(n)
    for h in pc.level_sizes(n):
        src = ceil2(h)
        for case in pc.CASES:
            x = torch.from_numpy(pc.adversarial(rng, (h, h), case))
            assert_bits(step(x, 0, h, 0, src), pyramid.smooth_downsample_plain(x), f"down {h} {case}")
            small = torch.from_numpy(pc.adversarial(rng, (src, src), case))
            want = pyramid.upsample_smooth_plain(small, h)
            assert_bits(up(small, 0, h, 0, h), want, f"up {h} {case}")
            assert_bits(up(small, 0, h, 0, h, 1, x), x - want, f"up-subtract {h} {case}")
            assert_bits(up(small, 0, h, 0, h, 2, x), want + x, f"up-add {h} {case}")
            band16 = x.to(torch.bfloat16)
            assert_bits(up(small, 0, h, 0, h, 2, band16), want + band16.float(), f"bf16 {h}")
    # the down step also on non-square images (the plain path's small form
    # on one axis)
    for shape in ((17, 5), (5, 17), (9, 2)):
        x = torch.from_numpy(pc.adversarial(rng, shape))
        assert_bits(step(x, 0, shape[0], 0, ceil2(shape[0])),
                    pyramid.smooth_downsample_plain(x), f"down {shape}")


@pytest.mark.parametrize("n", [600, 144, 75, 17])
def test_fused_step_equals_plain_at_every_level(n):
    """The fused step (warp strips: the down and its neighbouring rows
    and columns in registers, the band) on every level of the n-px ladder
    at the expand's polyphase size, on the adversarial data and constant
    planes, equals the plain path's down and band bit for bit."""
    rng = np.random.default_rng(n + 1)
    for h in [s for s in pc.level_sizes(n) if polyphase(s)]:
        for case in pc.CASES:
            x = torch.from_numpy(pc.adversarial(rng, (h, h), case))
            band, dn = strip_step(x)
            want_band, want_dn = kp.reduce_step_plain(x)
            assert_bits(dn, want_dn, f"fused down {h} {case}")
            assert_bits(band, want_band, f"fused band {h} {case}")


@pytest.mark.parametrize("h", [6, 7, 8, 62, 63, 64, 65, 66, 67, 126, 127, 128, 129, 130, 131,
                               118, 119, 120, 121, 122, 123, 124, 125, 238, 239, 240, 241, 242,
                               243])
def test_fused_step_at_tile_edges(h):
    """Sizes whose last strip (120 band, 60 down columns) ends 2 to 0
    columns short of, on or past a strip's edge, with the last down column
    a lane's first or second and the band's last row odd or even, walked in
    runs of the rule's rows and of 2, 3 and 5 (the last run short): the
    edge maps (position -1 -> 1, ceil(h/2) -> h - 1 -
    ceil(h/2), down row and column alike), not a neighbour's rows or
    columns, reach the plain path's band bit for bit."""
    rng = np.random.default_rng(h)
    x = torch.from_numpy(pc.adversarial(rng, (h, h)))
    want_band, want_dn = kp.reduce_step_plain(x)
    for rows in (None, 2, 3, 5):
        strip_check(h, rows)
        band, dn = strip_step(x, rows)
        assert_bits(dn, want_dn, f"fused down {h} {rows}")
        assert_bits(band, want_band, f"fused band {h} {rows}")


@pytest.mark.parametrize("n", [3072, 600, 144])
def test_strip_rows_rule_at_every_level(n):
    """The fused step's strip height is a function of the level size alone:
    at every level of an n-px ladder that the fused step takes, the fewest
    down rows that keep the level's warps (strips x runs) within
    STRIP_WARPS, one warp's strip a run; long runs at 3072 and 1536, a row
    or two from 768 down (a small level spread over hundreds of warps)."""
    got = {}
    for h in [s for s in pc.level_sizes(n) if polyphase(s)]:
        rows = kp.strip_rows(h)
        strips, dh = -(-h // STRIP), ceil2(h)
        assert rows >= 1 and (strips * -(-dh // rows) <= kp.STRIP_WARPS or rows == dh)
        assert rows == 1 or strips * -(-dh // (rows - 1)) > kp.STRIP_WARPS
        assert kp.strip_rows(h) == rows   # no state
        got[h] = rows
    if n == 3072:
        assert got == {3072: 19, 1536: 5, 768: 2, 384: 1, 192: 1, 96: 1, 48: 1, 24: 1, 12: 1,
                       6: 1}
    else:
        assert set(got.values()) == {1}


@pytest.mark.parametrize("n", [600, 144, 75, 17, 5, 3, 2, 1])
def test_tail_equals_plain_from_every_level(n):
    """The ladder's tail from each level of the n-px ladder that the tail
    holds, down through the 1-px level, and the expand's tail back up (f32
    bands; bf16 ones; both mixed), equal reduce_ladder_plain and
    expand_ladder_plain bit for bit."""
    rng = np.random.default_rng(n + 2)
    sizes = pc.level_sizes(n)
    for i, s in enumerate(sizes):
        if s > kp.TAIL_MAX:
            continue
        levels = min(len(sizes) - i, MAX_TAIL)
        x = torch.from_numpy(pc.adversarial(rng, (s, s)))
        bands, downs = tail_ladder(x, levels)
        pb, pd = pyramid.reduce_ladder_plain(x, levels)
        for lvl, (g, w) in enumerate(zip(bands + downs, pb + pd)):
            assert_bits(g, w, f"ladder tail from {s}, output {lvl}")
        top = torch.from_numpy(pc.adversarial(rng, tuple(downs[-1].shape)))
        for dtypes in ((torch.float32,), (torch.bfloat16,), (torch.bfloat16, torch.float32)):
            adds = [b.to(dtypes[j % len(dtypes)]) for j, b in enumerate(pb)]
            assert_bits(tail_expand(top, adds), pyramid.expand_ladder_plain(top, adds),
                        f"expand tail to {s}, {dtypes}")


def test_tail_cut():
    """A tail holds a level of up to 128 px: its image, its down and a
    step's sums, all float64, and the tap tables fit in one block's 227 KB,
    and the expand's tail to 128 px with its bands staged, float32 ones too.
    The schedules cut at 48 px: a 3072 ladder takes 6 fused steps (3072 ..
    96) and its tail from 48 px, a 600 one from 38."""
    assert kp.TAIL_MAX == 128
    assert kp.tail_shared_bytes(128, False) <= launch.MAX_SHARED_BYTES
    assert kp.tail_shared_bytes(129, False) > launch.MAX_SHARED_BYTES
    assert kp.tail_shared_bytes(96, False) == 73728 + 18432 + 36864 + 1568
    f32 = sum(round16(4 * s * s) for s in pc.level_sizes(128))
    assert kp.tail_shared_bytes(128, True, f32) <= launch.MAX_SHARED_BYTES
    assert kp.TAIL_CUT <= kp.TAIL_MAX
    for n, cut in ((3072, 48), (600, 38), (512, 32), (144, 36)):
        assert max(s for s in pc.level_sizes(n) if s <= kp.TAIL_CUT) == cut


@pytest.mark.parametrize("n,tile", [(600, 16), (144, 12), (144, 8)])
def test_formulation_equals_plain_on_shard_windows(n, tile):
    """The down step and the expand step (each mode) on every shard window
    of the spatial plan, from the rows the window reads, against the plain
    row-window functions bit for bit; some windows start on odd rows."""
    rng = np.random.default_rng(n + tile)
    wins = pc.shard_windows(n, tile)
    assert any(r[0] % 2 for _, _, _, r in wins), "no window starts on an odd row"
    for op, h, (lo, hi), (a, b) in wins:
        if op == "down":
            x = torch.from_numpy(pc.adversarial(rng, (h, h)))
            assert_bits(step(x[lo:hi], lo, h, a, b),
                        pyramid.smooth_downsample_rows_plain(x[lo:hi], lo, h, a, b),
                        f"down {h} rows {a}-{b}")
            assert_bits(step(x[lo:hi], lo, h, a, b), pyramid.smooth_downsample_plain(x)[a:b],
                        f"down {h} rows {a}-{b} vs whole")
        else:
            src = ceil2(h)
            small = torch.from_numpy(pc.adversarial(rng, (src, src)))
            cur = torch.from_numpy(pc.adversarial(rng, (b - a, h)))
            want = kp.upsample_rows_plain(small[lo:hi], lo, h, a, b)
            assert_bits(up(small[lo:hi], lo, h, a, b), want, f"up {h} rows {a}-{b}")
            assert_bits(want, pyramid.upsample_smooth_plain(small, h)[a:b], f"up {h} vs whole")
            assert_bits(up(small[lo:hi], lo, h, a, b, 1, cur), cur - want, f"subtract {h}")
            assert_bits(up(small[lo:hi], lo, h, a, b, 2, cur), want + cur, f"add {h}")


# ----------------------------------------------------------------------
# (b) the fused modes and the schedules
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [600, 19, 5])
def test_fused_modes_equal_the_unfused_sequence(n):
    """upsample_subtract and upsample_add, one call each, equal the expand
    followed by the float32 subtraction or addition, on whole levels and
    on windows, with a float32 and a bf16 band."""
    rng = np.random.default_rng(7)
    src = ceil2(n)
    cur = torch.from_numpy(pc.adversarial(rng, (n, n)))
    small = torch.from_numpy(pc.adversarial(rng, (src, src)))
    want = pyramid.upsample_smooth(small, n)
    assert_bits(pyramid.upsample_subtract(cur, small), cur - want, "subtract")
    assert_bits(pyramid.upsample_add(small, cur), want + cur, "add")
    b16 = cur.to(torch.bfloat16)
    assert_bits(pyramid.upsample_add(small, b16), want + b16.float(), "add bf16")
    a, b = n // 3 | 1, n - n // 4  # a window starting on an odd row
    lo, hi = pyramid.needed_rows("upsample_smooth", n, a, b) if pyramid.polyphase(n) else (0, src)
    assert_bits(pyramid.upsample_subtract(cur[a:b], small[lo:hi], lo, a), cur[a:b] - want[a:b],
                "subtract window")
    assert_bits(pyramid.upsample_add(small[lo:hi], b16[a:b], lo, a), want[a:b] + b16[a:b].float(),
                "add window")


def test_reduce_ladder_equals_its_plain_version():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, (144, 144)).astype(np.float32))
    bands, downs = pyramid.reduce_ladder(x, 8)
    pb, pd = pyramid.reduce_ladder_plain(x, 8)
    for got, want in zip(bands + downs, pb + pd):
        assert_bits(got, want, "ladder")
    band, dn = kp.reduce_step(x)
    assert_bits(band, pb[0], "reduce_step band")
    assert_bits(dn, pd[0], "reduce_step down")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expand_ladder_equals_the_upsample_add_loop(dtype):
    """expand_ladder (and expand_tail) on the CPU equal an upsample_add a
    level, the coarsest first, bit for bit; no bands: the top itself."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 1, (300, 300)).astype(np.float32))
    pb, pd = pyramid.reduce_ladder_plain(x, 9)
    bands = [torch.from_numpy(pc.adversarial(rng, tuple(b.shape))).to(dtype) for b in pb]
    recon = pd[-1]
    for b in reversed(bands):
        recon = pyramid.upsample_add(recon, b)
    assert_bits(pyramid.expand_ladder(pd[-1], bands), recon, "expand_ladder")
    assert_bits(kp.expand_tail(pd[-1], bands), recon, "expand_tail")
    assert pyramid.expand_ladder(pd[-1], []) is pd[-1]


def test_forward_with_the_expand_ladder_meets_the_jax_parity_bar():
    """musica_forward's main path (the expand through ``expand_ladder``)
    equals the intermediates path (an expand step a level) bit for bit and
    meets the parity bar against the JAX package's musica_forward (>= 90
    dB, > 99.99 % bit-exact, max |du8| <= 1) at 256 px."""
    img = synthetic_radiograph(256, "thorax")
    cfg = MusicaConfig(image_size=256)
    res = musica.musica_forward(torch.from_numpy(img), cfg)
    dbg = musica.musica_forward(torch.from_numpy(img), cfg, want_intermediates=True)
    assert torch.equal(res["recon"], dbg["recon"]) and torch.equal(res["out_u8"], dbg["out_u8"])
    jcfg = JConfig(image_size=256)
    jres = jax.jit(lambda im: j_musica.musica_forward(im, jcfg, "fact"))(jnp.asarray(img))
    assert_u8_parity(res["out_u8"].numpy(), np.asarray(jres["out_u8"]), "vs JAX")


# ----------------------------------------------------------------------
# (c) dispatch
# ----------------------------------------------------------------------

def test_cpu_tensors_run_plain_and_count_no_launch():
    launch.reset_launch_counts()
    x = torch.rand(40, 40)
    dn = pyramid.smooth_downsample(x)
    pyramid.smooth_downsample_rows(x[4:30], 4, 40, 3, 12)
    pyramid.upsample_smooth(dn, 40)
    pyramid.upsample_smooth_rows(dn[3:15], 3, 40, 9, 26)
    pyramid.upsample_subtract(x, dn)
    pyramid.upsample_add(dn, x.to(torch.bfloat16))
    bands, downs = pyramid.reduce_ladder(x, 4)
    pyramid.expand_ladder(downs[-1], bands)
    kp.reduce_step(x)
    kp.reduce_tail(x, 3)
    kp.expand_tail(downs[-1], bands)
    assert launch.LAUNCHES == {k: 0 for k in launch.LAUNCHES}
    # leading batch dimensions stay with the plain versions
    xb = torch.rand(2, 24, 24)
    assert_bits(pyramid.smooth_downsample(xb)[1], pyramid.smooth_downsample(xb[1]), "batch down")


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
    dn = torch.rand(20, 20)
    assert tuple(pyramid.smooth_downsample(x).shape) == (20, 20)
    assert tuple(pyramid.smooth_downsample_rows(x[4:30], 4, 40, 3, 12).shape) == (9, 20)
    assert tuple(pyramid.upsample_smooth(dn, 40).shape) == (40, 40)
    assert tuple(pyramid.upsample_smooth_rows(dn[3:15], 3, 40, 9, 26).shape) == (17, 40)
    pyramid.upsample_subtract(x, dn)
    pyramid.upsample_add(dn[3:15], x[9:26].to(torch.bfloat16), 3, 9)
    pyramid.upsample_add(torch.rand(2, 2), torch.rand(1, 4), 0, 3)  # the small form's window
    band, down = kp.reduce_step(x)
    assert tuple(band.shape) == (40, 40) and tuple(down.shape) == (20, 20)
    names = [(fn, counter) for fn, counter, _ in card]
    assert names == [("musica_reduce_step", "pyramid_down")] * 2 + [
        ("musica_upsample_smooth", "pyramid_up")] * 5 + [("musica_reduce_step", "pyramid_down")]
    args = [a for _, _, a in card]
    # x0, rows, h, w; j0, j1, band (none: the down step alone), strip rows
    assert args[0][1:5] == (0, 40, 40, 40) and args[0][6:] == (0, 20, None, 0)
    assert args[1][1:5] == (4, 26, 40, 40) and args[1][6:] == (3, 12, None, 0)
    assert args[2][1:4] == (0, 20, 40) and args[2][5:] == (0, 40, 0, None, 0)
    assert args[3][1:4] == (3, 12, 40) and args[3][5:] == (9, 26, 0, None, 0)
    assert args[4][5:8] == (0, 40, 1) and args[4][8] == x.data_ptr() and args[4][9] == 0
    assert args[5][5:8] == (9, 26, 2) and args[5][9] == 1                # a bf16 band
    assert args[6][1:4] == (0, 2, 4) and args[6][5:8] == (3, 4, 2)
    assert args[7][1:5] == (0, 40, 40, 40) and args[7][6:8] == (0, 20)
    assert args[7][8] == band.data_ptr()                                  # the fused step
    assert args[7][9] == kp.strip_rows(40)


def test_cuda_ladder_and_expand_schedules_at_3072(card):
    """On a 3072 ladder of 12 levels, reduce_ladder launches the fused step
    at 3072 .. 96 px and one tail for the 6 levels from 48 px; expand_ladder
    one tail up to 48 px (bf16 bands flagged) and an expand step at 96 ..
    3072: 14 pyramid launches where a step a level took 36."""
    x = torch.empty(3072, 3072)
    bands, downs = pyramid.reduce_ladder(x, 12)
    assert [b.shape[0] for b in bands] == pc.level_sizes(3072)[:12]
    assert [d.shape[0] for d in downs] == pc.level_sizes(3072)[1:13]
    bands = [b.to(torch.bfloat16) if i % 2 else b for i, b in enumerate(bands)]
    recon = pyramid.expand_ladder(downs[-1], bands)
    assert tuple(recon.shape) == (3072, 3072)
    names = [(fn, counter) for fn, counter, _ in card]
    assert names == ([("musica_reduce_step", "pyramid_down")] * 6
                     + [("musica_reduce_tail", "pyramid_tail"), ("musica_expand_tail", "pyramid_tail")]
                     + [("musica_upsample_smooth", "pyramid_up")] * 6)
    args = [a for _, _, a in card]
    assert [a[1] for a in args[:6]] == [0] * 6 and [a[3] for a in args[:6]] == [3072, 1536, 768,
                                                                                 384, 192, 96]
    assert args[6][1:3] == (48, 6) and len(args[6][3]) == len(args[6][4]) == 6  # size, levels
    assert args[7][1:3] == (48, 6) and args[7][4] == sum(1 << j for j in range(6) if (6 + j) % 2)
    assert [a[3] for a in args[8:]] == [96, 192, 384, 768, 1536, 3072]
    assert [a[7] for a in args[8:]] == [2] * 6                 # mode 2: up + band
    counts = {}
    for _, counter, _ in card:
        counts[counter] = counts.get(counter, 0) + 1
    assert counts == {"pyramid_down": 6, "pyramid_tail": 2, "pyramid_up": 6}


def test_fused_step_tally_by_strip_height(card):
    """Each fused step counts its launch under the strip height it took,
    beside LAUNCHES (whose keys stay as they were); the down step alone
    counts none; reset_launch_counts clears the tally."""
    launch.reset_launch_counts()
    pyramid.reduce_ladder(torch.empty(3072, 3072), 12)
    kp.smooth_downsample(torch.empty(40, 40))
    assert launch.GEOMETRY == {("reduce_step", 19): 1, ("reduce_step", 5): 1,
                               ("reduce_step", 2): 1, ("reduce_step", 1): 3}
    assert [a[9] for fn, _, a in card if fn == "musica_reduce_step"] == [19, 5, 2, 1, 1, 1, 0]
    assert "reduce_step" not in launch.LAUNCHES
    launch.reset_launch_counts()
    assert launch.GEOMETRY == {}


def test_cuda_tail_splits_past_its_level_limit(card):
    """A tail of more than 16 levels (a ladder run on past 1 px) takes two
    launches; the expand takes the coarsest 16 first."""
    x = torch.empty(40, 40)
    bands, downs = pyramid.reduce_ladder(x, 20)
    assert len(bands) == len(downs) == 20
    pyramid.expand_ladder(downs[-1], bands)
    tails = [a[1:3] for fn, _, a in card if fn.endswith("_tail")]
    assert tails == [(40, 16), (1, 4), (3, 16), (40, 4)]


@pytest.mark.parametrize("call,error", [
    (lambda x, dn: pyramid.smooth_downsample(x.double()), TypeError),
    (lambda x, dn: pyramid.smooth_downsample(x.T), ValueError),                # not contiguous
    (lambda x, dn: pyramid.smooth_downsample(x[None]), ValueError),            # not 2-D
    (lambda x, dn: pyramid.smooth_downsample_rows(x[4:30], 4, 40, 3, 21), ValueError),  # j1 > dh
    (lambda x, dn: pyramid.smooth_downsample_rows(x[6:30], 6, 40, 3, 12), ValueError),  # misses row 4
    (lambda x, dn: pyramid.smooth_downsample_rows(x[20:40], 30, 40, 16, 20), ValueError),  # past h
    (lambda x, dn: pyramid.upsample_smooth(dn.half(), 40), TypeError),
    (lambda x, dn: pyramid.upsample_smooth(dn, 30), ValueError),               # 20 columns for 15
    (lambda x, dn: pyramid.upsample_smooth_rows(dn[5:15], 5, 40, 9, 26), ValueError),  # misses row 4
    (lambda x, dn: pyramid.upsample_smooth_rows(dn[3:15], 3, 40, 30, 41), ValueError),  # past n
    (lambda x, dn: pyramid.upsample_subtract(x.to(torch.bfloat16), dn), TypeError),
    (lambda x, dn: pyramid.upsample_subtract(x[:, :39].contiguous(), dn), ValueError),
    (lambda x, dn: pyramid.upsample_add(dn, x.double()), TypeError),
    (lambda x, dn: pyramid.upsample_add(dn, x[:, ::2]), ValueError),
    (lambda x, dn: pyramid.upsample_add(torch.rand(1, 2), torch.rand(1, 4), 1, 3), ValueError),
    (lambda x, dn: kp.reduce_step(x[:5, :5].contiguous()), ValueError),        # below 6 px
    (lambda x, dn: kp.reduce_step(x[:, :20].contiguous()), ValueError),        # not square
    (lambda x, dn: kp.reduce_tail(torch.rand(161, 161), 2), ValueError),       # past 227 KB
    (lambda x, dn: kp.reduce_tail(x, 17), ValueError),                         # past 16 levels
    (lambda x, dn: kp.reduce_tail(x.double(), 2), TypeError),
    (lambda x, dn: kp.expand_tail(torch.rand(10, 10), [x]), ValueError),       # top 10 for 40
    (lambda x, dn: kp.expand_tail(torch.rand(10, 10), [x, torch.rand(21, 21)]), ValueError),
    (lambda x, dn: kp.expand_tail(dn, [x.half()]), TypeError),
    (lambda x, dn: kp.expand_tail(torch.rand(100, 100), [torch.rand(200, 200)]), ValueError),
])
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(card, call, error):
    with pytest.raises(error):
        call(torch.rand(40, 40), torch.rand(20, 20))
    assert card == []
