"""The pyramid kernels of ``csrc/pyramid.cu`` emulated on the CPU before the
card runs them, their fused modes, and their wrappers' dispatch.

KP1 ``smooth_downsample_kernel`` and KP2 ``upsample_smooth_kernel<mode>``
repeat the plain path's float64 sums (``ops/pyramid.py``) operation by
operation.  ``kp1`` and ``kp2`` below compute what the kernels compute: the
same tap maps (the input row and column each tap of an output pixel reads,
its validity, the window offsets ``x0``/``s0``, the polyphase form's
extension of the small grid), the same branch between the expand's forms,
and the same float64 products and sums in the same order, each a correctly
rounded torch operation as each intrinsic is on the card.  They must equal
the plain functions bit for bit (tolerance: none; bit patterns compared, so
-0.0 differs from +0.0) at every level of 600, 144, 17, 5, 3, 2 and 1 px,
on every shard window of the spatial plans at 600 and 144 over 4 shards,
and, index maps only, at every level of 3072.
"""

import numpy as np
import pytest
import torch

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import pyramid
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import pyramid as kp
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing import pyramid_cases as pc

torch.set_num_threads(2)

OUT_H, OUT_W = 16, 64                      # kOutH, kOutW in csrc/pyramid.cu
DOWN_COLS, UP_COLS = 2 * OUT_W + 3, OUT_W // 2 + 2
# kW0, kW1, kW2 as the kernel derives them: float32 roundings of doubles
KW = (float(np.float32(0.25 - 0.3 / 2)), float(np.float32(0.25)), float(np.float32(0.3)))


def weight(m):
    return KW[0] if m in (0, 4) else KW[2] if m == 2 else KW[1]


def mirror(p, n):
    """The kernel's mirror(): one reflection, -1 where out of [0, n)."""
    p = np.asarray(p)
    v = np.where(p > n - 1, 2 * (n - 1) - p, np.where(p < 0, -p, p))
    return np.where((v >= 0) & (v <= n - 1), v, -1)


def bits(t):
    return t.contiguous().view(torch.int32)


def assert_bits(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert torch.equal(bits(got), bits(want)), what


# ----------------------------------------------------------------------
# the kernels' tap maps
# ----------------------------------------------------------------------

def down_row_taps(h, j0, j1):
    """KP1's vertical taps of output rows [j0, j1): input row or -1, [j, 5]."""
    j = np.arange(j0, j1)[:, None]
    return mirror(2 * j + np.arange(5)[None, :] - 2, h)


def down_col_taps(w):
    """KP1's horizontal taps: column c of block bx reads the block's
    vertical sum at tile index 2c + k, which is input column position
    2 * (64 bx + c) - 2 + k, mirrored (an invalid one holds +0.0)."""
    dw = -(-w // 2)
    col = np.arange(dw)
    bx, c = col // OUT_W, col % OUT_W
    i = 2 * c[:, None] + np.arange(5)[None, :]
    assert i.max() < DOWN_COLS
    return mirror(2 * bx[:, None] * OUT_W - 2 + i, w)


def extend(p, src, edge):
    """KP2's extension of the small grid (polyphase form)."""
    p = np.asarray(p)
    return np.where(p < 0, 1, np.where(p >= src, edge, p))


def up_phase_taps(positions, src, edge):
    """KP2's polyphase taps along one axis for output positions: (the
    small image's index of positions k - 1, k, k + 1 for k = position // 2,
    [P, 3]; whether the position is even).  An even position sums all
    three, an odd one the last two."""
    k = np.asarray(positions) >> 1
    idx = extend(k[:, None] + np.arange(-1, 2)[None, :], src, edge)
    even = (np.asarray(positions) & 1) == 0
    return idx, even


def polyphase(n):
    """The kernel's branch: n >= 6 and src >= 3."""
    return n >= 6 and -(-n // 2) >= 3


def gather_rows(x, rows, x0):
    """x's rows ``rows - x0`` (an int array), +0.0 where a tap is invalid."""
    ok = torch.from_numpy(rows >= 0)
    r = torch.from_numpy(np.where(rows >= 0, rows - x0, 0))
    assert int(r.min()) >= 0 and int(r.max()) < x.shape[0], "a tap reads outside the window"
    return torch.where(ok.reshape(ok.shape + (1,) * (x.ndim - 1)), x[r], 0.0)


# ----------------------------------------------------------------------
# the kernels' arithmetic
# ----------------------------------------------------------------------

def kp1(x, x0, h, j0, j1):
    """KP1: rows [j0, j1) of smooth_downsample of an [h, w] image from x,
    its rows [x0, ...): vertical sums at even rows, then horizontal sums at
    even columns, each from its first product, rounded once."""
    w = x.shape[-1]
    X = x.double()
    rt = down_row_taps(h, j0, j1)
    acc = None
    for m in range(5):
        prod = weight(m) * gather_rows(X, rt[:, m], x0)
        acc = prod if m == 0 else acc + prod
    ct = down_col_taps(w)
    out = None
    for k in range(5):
        prod = weight(k) * gather_rows(acc.T, ct[:, k], 0).T
        out = prod if k == 0 else out + prod
    return out.float()


def kp2(small, s0, n, r0, r1, mode=0, other=None):
    """KP2: rows [r0, r1) of upsample_smooth(img, n) (mode 0), of
    other - that (mode 1) or that + other (mode 2), from small, the rows
    [s0, ...) of the ceil(n/2)-px img."""
    src = -(-n // 2)
    S = small.double()
    if polyphase(n):
        edge = n - 1 - src
        # vertical phase of each output row, at every small column
        ridx, reven = up_phase_taps(np.arange(r0, r1), src, edge)
        e = [gather_rows(S, ridx[:, j], s0) for j in range(3)]
        ve = KW[0] * e[0]
        ve = ve + KW[2] * e[1]
        ve = ve + KW[0] * e[2]
        vo = KW[1] * e[1]
        vo = vo + KW[1] * e[2]
        v = torch.where(torch.from_numpy(reven)[:, None], ve, vo)
        # horizontal phase of each output column, from the block's tile
        cidx, ceven = up_phase_taps(np.arange(n), src, edge)
        c = np.arange(n) % OUT_W
        assert ((c >> 1) + 2).max() < UP_COLS
        q = [gather_rows(v.T, cidx[:, j], 0).T for j in range(3)]
        he = KW[0] * q[0]
        he = he + KW[2] * q[1]
        he = he + KW[0] * q[2]
        ho = KW[1] * q[1]
        ho = ho + KW[1] * q[2]
        up = torch.where(torch.from_numpy(ceven)[None, :], he, ho).float() * 4.0
    else:
        # smooth(upsample(img, n), 4.0) at each output pixel, the zero-stuffed
        # grid read through the mirror
        assert s0 == 0 and small.shape[0] == src, "the small form reads the whole small image"
        u = mirror(np.arange(r0, r1)[:, None] + np.arange(5)[None, :] - 2, n)   # [rows, 5]
        vc = mirror(np.arange(n)[:, None] + np.arange(5)[None, :] - 2, n)       # [n, 5]
        acc = None
        for k in range(5):
            tk = None
            for m in range(5):
                um, vk = u[:, m][:, None], vc[:, k][None, :]
                ok = (um >= 0) & (um % 2 == 0) & (vk >= 0) & (vk % 2 == 0)
                val = S[np.where(ok, um // 2, 0), np.where(ok, vk // 2, 0)]
                prod = weight(m) * torch.where(torch.from_numpy(ok), val, 0.0)
                tk = prod if m == 0 else tk + prod
            tk = torch.where(torch.from_numpy(vc[:, k] >= 0)[None, :], tk, 0.0)
            prod = weight(k) * tk
            acc = prod if k == 0 else acc + prod
        up = (acc * 4.0).float()
    if mode == 1:
        return other - up
    if mode == 2:
        return up + other.float()
    return up


# ----------------------------------------------------------------------
# (a) the formulation
# ----------------------------------------------------------------------

def test_kernel_taps_are_the_plain_weights():
    assert [weight(m) for m in range(5)] == list(pyramid._W)


@pytest.mark.parametrize("level", range(12))
def test_index_maps_at_every_level_of_3072(level):
    """At each level of the 3072 ladder (no data): every tap of KP1 and of
    KP2 reads the row and column the plain path's mirror table and
    polyphase extension name, inside the image; the grids cover every
    output once; KP2 takes the plain path's form."""
    h = pc.level_sizes(3072)[level]
    dh = -(-h // 2)
    idx, valid = pyramid._mirror_idx(h)
    rt = down_row_taps(h, 0, dh)
    pos = 2 * np.arange(dh)[:, None] + np.arange(5)[None, :] - 2
    assert np.array_equal(rt >= 0, valid[pos + 2] > 0)
    assert np.array_equal(np.where(rt >= 0, rt, 0), np.where(valid[pos + 2] > 0, idx[pos + 2], 0))
    assert np.array_equal(down_col_taps(h), rt)  # square: the column map is the row map
    gx, gy = -(-dh // OUT_W), -(-dh // OUT_H)
    assert gx * OUT_W >= dh > (gx - 1) * OUT_W and gy * OUT_H >= dh > (gy - 1) * OUT_H
    # KP2: the expand to h from the next level (src px)
    src = -(-h // 2)
    img = torch.zeros(src, src)
    plain_poly = not (h < 6 or img.shape[-1] < 3 or img.shape[-2] < 3)
    assert polyphase(h) == plain_poly == pyramid.polyphase(h)
    if plain_poly:
        edge = h - 1 - src
        ridx, even = up_phase_taps(np.arange(h), src, edge)
        tap = pyramid._up_map(h)
        want = np.array([[tap(p)[0] for p in range(k - 1, k + 2)] for k in np.arange(h) >> 1])
        assert np.array_equal(ridx, want)
        assert ridx.min() >= 0 and ridx.max() < src
        # the plain form's extension: e[0] = r[1], e[src + 1] = r[edge]
        assert extend(-1, src, edge) == 1 and extend(src, src, edge) == edge
        assert np.array_equal(even, np.arange(h) % 2 == 0)
        lo, hi = pyramid.needed_rows("upsample_smooth", h, 0, h)
        assert (lo, hi) == (int(ridx.min()), int(ridx.max()) + 1)


@pytest.mark.parametrize("n", [600, 144, 17, 5, 3, 2, 1])
def test_formulation_equals_plain_at_every_level(n):
    """KP1 on every level of the n-px ladder and KP2 (each mode) back to
    it, on data with +-0, denormals and 1e30, and on constant planes (a
    denormal one among them: the small form's gain before its rounding
    shows there), against the plain functions bit for bit."""
    rng = np.random.default_rng(n)
    for h in pc.level_sizes(n):
        src = -(-h // 2)
        for case in pc.CASES:
            x = torch.from_numpy(pc.adversarial(rng, (h, h), case))
            assert_bits(kp1(x, 0, h, 0, src), pyramid.smooth_downsample_plain(x), f"down {h} {case}")
            small = torch.from_numpy(pc.adversarial(rng, (src, src), case))
            up = pyramid.upsample_smooth_plain(small, h)
            assert_bits(kp2(small, 0, h, 0, h), up, f"up {h} {case}")
            assert_bits(kp2(small, 0, h, 0, h, 1, x), x - up, f"up-subtract {h} {case}")
            assert_bits(kp2(small, 0, h, 0, h, 2, x), up + x, f"up-add {h} {case}")
            band16 = x.to(torch.bfloat16)
            assert_bits(kp2(small, 0, h, 0, h, 2, band16), up + band16.float(), f"bf16 {h}")
    # KP1 also on non-square images (the plain path's small form on one axis)
    for shape in ((17, 5), (5, 17), (9, 2)):
        x = torch.from_numpy(pc.adversarial(rng, shape))
        assert_bits(kp1(x, 0, shape[0], 0, -(-shape[0] // 2)),
                    pyramid.smooth_downsample_plain(x), f"down {shape}")


@pytest.mark.parametrize("n,tile", [(600, 16), (144, 12), (144, 8)])
def test_formulation_equals_plain_on_shard_windows(n, tile):
    """KP1 and KP2 (each mode) on every shard window of the spatial plan,
    from the rows the window reads, against the plain row-window functions
    bit for bit; some windows start on odd rows."""
    rng = np.random.default_rng(n + tile)
    wins = pc.shard_windows(n, tile)
    assert any(r[0] % 2 for _, _, _, r in wins), "no window starts on an odd row"
    for op, h, (lo, hi), (a, b) in wins:
        if op == "down":
            x = torch.from_numpy(pc.adversarial(rng, (h, h)))
            assert_bits(kp1(x[lo:hi], lo, h, a, b),
                        pyramid.smooth_downsample_rows_plain(x[lo:hi], lo, h, a, b),
                        f"down {h} rows {a}-{b}")
            assert_bits(kp1(x[lo:hi], lo, h, a, b), pyramid.smooth_downsample_plain(x)[a:b],
                        f"down {h} rows {a}-{b} vs whole")
        else:
            src = -(-h // 2)
            small = torch.from_numpy(pc.adversarial(rng, (src, src)))
            cur = torch.from_numpy(pc.adversarial(rng, (b - a, h)))
            up = kp.upsample_rows_plain(small[lo:hi], lo, h, a, b)
            assert_bits(kp2(small[lo:hi], lo, h, a, b), up, f"up {h} rows {a}-{b}")
            assert_bits(up, pyramid.upsample_smooth_plain(small, h)[a:b], f"up {h} vs whole")
            assert_bits(kp2(small[lo:hi], lo, h, a, b, 1, cur), cur - up, f"subtract {h}")
            assert_bits(kp2(small[lo:hi], lo, h, a, b, 2, cur), up + cur, f"add {h}")


# ----------------------------------------------------------------------
# (b) the fused modes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [600, 19, 5])
def test_fused_modes_equal_the_unfused_sequence(n):
    """upsample_subtract and upsample_add, one call each, equal the expand
    followed by the float32 subtraction or addition, on whole levels and
    on windows, with a float32 and a bf16 band."""
    rng = np.random.default_rng(7)
    src = -(-n // 2)
    cur = torch.from_numpy(pc.adversarial(rng, (n, n)))
    small = torch.from_numpy(pc.adversarial(rng, (src, src)))
    up = pyramid.upsample_smooth(small, n)
    assert_bits(pyramid.upsample_subtract(cur, small), cur - up, "subtract")
    assert_bits(pyramid.upsample_add(small, cur), up + cur, "add")
    b16 = cur.to(torch.bfloat16)
    assert_bits(pyramid.upsample_add(small, b16), up + b16.float(), "add bf16")
    a, b = n // 3 | 1, n - n // 4  # a window starting on an odd row
    lo, hi = pyramid.needed_rows("upsample_smooth", n, a, b) if pyramid.polyphase(n) else (0, src)
    assert_bits(pyramid.upsample_subtract(cur[a:b], small[lo:hi], lo, a), cur[a:b] - up[a:b],
                "subtract window")
    assert_bits(pyramid.upsample_add(small[lo:hi], b16[a:b], lo, a), up[a:b] + b16[a:b].float(),
                "add window")


def test_reduce_ladder_equals_its_plain_version():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, (144, 144)).astype(np.float32))
    bands, downs = pyramid.reduce_ladder(x, 8)
    pb, pd = pyramid.reduce_ladder_plain(x, 8)
    for got, want in zip(bands + downs, pb + pd):
        assert_bits(got, want, "ladder")


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
    pyramid.reduce_ladder(x, 4)
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
    names = [(fn, counter) for fn, counter, _ in card]
    assert names == [("musica_smooth_downsample", "pyramid_down")] * 2 + [
        ("musica_upsample_smooth", "pyramid_up")] * 5
    args = [a for _, _, a in card]
    assert args[0][1:5] == (0, 40, 40, 40) and args[0][6:] == (0, 20)  # x0, rows, h, w; j0, j1
    assert args[1][1:5] == (4, 26, 40, 40) and args[1][6:] == (3, 12)
    assert args[2][1:4] == (0, 20, 40) and args[2][5:] == (0, 40, 0, None, 0)
    assert args[3][1:4] == (3, 12, 40) and args[3][5:] == (9, 26, 0, None, 0)
    assert args[4][5:8] == (0, 40, 1) and args[4][8] == x.data_ptr() and args[4][9] == 0
    assert args[5][5:8] == (9, 26, 2) and args[5][9] == 1                # a bf16 band
    assert args[6][1:4] == (0, 2, 4) and args[6][5:8] == (3, 4, 2)


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
])
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(card, call, error):
    with pytest.raises(error):
        call(torch.rand(40, 40), torch.rand(20, 20))
    assert card == []
