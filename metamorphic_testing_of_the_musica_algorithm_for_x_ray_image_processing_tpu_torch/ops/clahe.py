"""CLAHE gradation variant (reference: ``ENABLE_CLAHE``; shaders
clahe_histogram.comp, clahe_grad_curve.comp, clahe_grad_curve_apply.comp).
Port of the JAX package's ``ops/clahe.py``.

Per 4x4 image tile: a 256-bin histogram of relevance-masked pixels, clipped
at 1/32 with the clipped mass redistributed, cumulated into a CDF used as a
per-tile tone LUT; application blends the LUTs of up to 4 neighbouring
tiles bilinearly by distance to the tile centres.

The pipeline grades through ``clahe_grade_cnr``: the joint histogram with
the relevance test inside the kernel KH (``ops/cuda/clahe_hist.py``, no
full-size relevance image), the LUTs in one launch of KC
(``clahe_curves``, ``ops/cuda/clahe_curves.py``) and the blended apply
K5 (``ops/cuda/clahe_apply.py``; ``clahe_apply`` below is its plain
version).  ``clahe_grade`` grades from a relevance image: its joint
histogram goes through ``stats.fixed_histogram`` (K6 on the card).  The
``*_rows`` forms take a window of rows of an [n, n] image (the spatial
path's shards) with the tiles and blend attributes of its global rows; the
whole image is the window of all its rows.

Numerics:
  * every division by a constant divides by a 0-d device tensor (``f32``):
    PyTorch's CUDA ``tensor / python_float`` multiplies by the reciprocal,
    which moves 1,023 of the 3,072 values of ``i / 768`` by an ulp;
  * the clip excess and the CDF are summed in float64 and rounded to
    float32 once.  With power-of-two bins and fewer than 2^21 pixels per
    tile (tiles up to 1448 px; 768 at 3072) every term is a multiple of
    2^-51 and the sums stay below 2, so float64 holds every partial sum
    exactly and the CDF is the same in any summation order, on the CPU and
    the card alike.  Golden's sequential float32 loop and XLA's cumsum
    round at every step and differ from it by a few float32 ulps;
  * a tile without relevant pixels normalises by 0/0 and its LUT is NaN, as
    in the GLSL; NaN propagates through the apply;
  * an intensity bin converts to int32 as XLA and the card do: NaN to bin 0
    (counted), out-of-range values saturate (dropped).  PyTorch's CPU
    conversion gives INT_MIN for NaN, so the plain version maps NaN to 0
    first.

Undefined behaviour kept as the JAX package resolves it: at edge tiles the
GLSL converts a negative float tile coordinate to uint
(clahe_grad_curve_apply.comp:79); here, as there, it saturates to 0.
"""

from __future__ import annotations

import torch

from . import f32
from .stats import fixed_histogram

F32 = torch.float32
I32 = torch.int32


def tile_ids(n: int, t: int, like: torch.Tensor) -> torch.Tensor:
    """The histogram's tile index of each coordinate, uint(x / n * tiles),
    int32 [n]."""
    return (torch.arange(n, dtype=F32, device=like.device) / f32(n, like)
            * float(t)).to(I32)


def clahe_joint_bins(recon: torch.Tensor, relevant: torch.Tensor, cfg):
    """Per-pixel (joint bin, weight), both int32 [n, n]: joint bin = tile *
    bins + intensity bin, weight 1 where relevant == 1.0.

    bin = int(pixel * (bins-1) + 0.5) (clahe_histogram.comp:20); OOB bins
    (pixel outside [0, ~1]) are dropped atomics: weight 0, joint bin 0."""
    return clahe_joint_bins_rows(recon, relevant, 0, recon.shape[-1], cfg)


def clahe_joint_bins_rows(recon_rows: torch.Tensor, relevant_rows: torch.Tensor, row0: int,
                          n: int, cfg):
    """``clahe_joint_bins`` of the rows [row0, row0 + rows) of an [n, n]
    image, held in ``recon_rows`` and ``relevant_rows`` [rows, n]: each
    row's tile is that of its global row, so the histograms of a partition
    of the rows sum to the whole image's."""
    t, bins = cfg.clahe_tiles, cfg.clahe_bins
    rows = recon_rows.shape[-2]
    bf = recon_rows * float(bins - 1) + 0.5
    b = torch.where(torch.isnan(bf), 0.0, bf).to(I32)
    xs = tile_ids(n, t, recon_rows)
    tile_id = xs[row0:row0 + rows, None] * t + xs[None, :]
    in_range = (b >= 0) & (b < bins)
    joint = torch.where(in_range, b + tile_id * bins, 0)
    w = torch.where(in_range, (relevant_rows == 1.0).to(I32), 0)
    return joint, w


def clahe_histograms(recon: torch.Tensor, relevant: torch.Tensor,
                     cfg) -> torch.Tensor:
    """int32 [tiles, tiles, bins] histogram of the pixels with
    relevant == 1.0 (``clahe_joint_bins`` into ``stats.fixed_histogram``)."""
    return clahe_histograms_rows(recon, relevant, 0, recon.shape[-1], cfg)


def clahe_histograms_rows(recon_rows: torch.Tensor, relevant_rows: torch.Tensor, row0: int,
                          n: int, cfg) -> torch.Tensor:
    """The partial ``clahe_histograms`` of the rows [row0, row0 + rows) of
    an [n, n] image (``clahe_joint_bins_rows`` into one launch of
    ``stats.fixed_histogram``): the spatial path's per-shard histogram."""
    t, bins = cfg.clahe_tiles, cfg.clahe_bins
    joint, w = clahe_joint_bins_rows(recon_rows, relevant_rows, row0, n, cfg)
    return fixed_histogram(joint, w, t * t * bins).reshape(t, t, bins)


def clahe_curves(hists: torch.Tensor, cfg):
    """Per-tile clipped-CDF LUT (clahe_grad_curve.comp:22-97) of int32
    histograms [t, t, bins]: (px[bins], py[t, t, bins]) as float32, the x
    grid shared (i/bins, the last point 1.0), y the redistributed CDF.  A
    CUDA histogram launches KC (``ops/cuda/clahe_curves.py``) or raises; a
    CPU one runs ``clahe_curves_plain``."""
    from .cuda import launch

    if launch.device_of([hists]).type == "cpu":
        return clahe_curves_plain(hists, cfg)
    from .cuda import clahe_curves as kc
    return kc.clahe_curves(hists, cfg)


def clahe_curves_plain(hists: torch.Tensor, cfg):
    """Plain version of ``clahe_curves``."""
    bins = cfg.clahe_bins
    counts = hists.to(F32)
    # the tile's count as one integer, rounded to float32 once (golden's
    # F(count))
    total = hists.to(torch.int64).sum(dim=-1, keepdim=True).to(F32)
    norm = counts / total  # a tile without relevant pixels: 0/0 -> NaN
    clipped = torch.minimum(norm, f32(cfg.clahe_clip_limit, counts))
    excess = (norm - clipped).double().sum(dim=-1, keepdim=True).to(F32)
    redist = clipped + excess / f32(bins, counts)
    cdf = torch.cumsum(redist.double(), dim=-1).to(F32)
    px = torch.arange(bins - 1, dtype=F32, device=hists.device) / f32(bins, counts)
    # the last point is 1.0 (cat, not an indexed store: that copies the
    # scalar from the host and waits for it)
    return torch.cat([px, px.new_ones(1)]), cdf


def _lut_eval(px: torch.Tensor, py_flat: torch.Tensor, tile_idx: torch.Tensor,
              x: torch.Tensor, bins: int) -> torch.Tensor:
    """The per-tile LUT at x with the GLSL getY semantics on the uniform
    grid: exact match at 1.0, segment interpolation, 0 outside [0, 1].
    ``px`` is the grid ``clahe_curves`` returns; it is implied here
    (segment i spans [i/bins, (i+1)/bins], the last one ends at 1.0)."""
    del px
    bins_t = f32(bins, x)
    i = torch.clamp((x * float(bins)).to(I32), 0, bins - 2)
    x1 = i.to(F32) / bins_t
    x2 = torch.where(i == bins - 2, 1.0, (i + 1).to(F32) / bins_t)
    flat1 = (tile_idx * bins + i).to(torch.int64)
    y1 = torch.take(py_flat, flat1)
    y2 = torch.take(py_flat, flat1 + 1)
    m = (y2 - y1) / (x2 - x1)
    val = m * (x - x1) + y1
    last = torch.take(py_flat, (tile_idx * bins + bins - 1).to(torch.int64))
    val = torch.where(x == 1.0, last, val)
    return torch.where((x >= 0.0) & (x <= 1.0), val, 0.0)


def axis_attrs(n: int, cfg, like: torch.Tensor):
    """Per-index blend attributes along one axis, in the operation order of
    the JAX package's ``clahe_apply``: (base tile int32, neighbour tile
    int32, base weight f32, neighbour weight f32, centre flag bool), each
    [n].  The plain apply takes them from here; the CUDA kernel computes the
    same operations itself (``csrc/clahe_apply.cu::axis_attr``)."""
    t = cfg.clahe_tiles
    coord = (torch.arange(n, dtype=F32, device=like.device)
             / f32(n // t, like))  # GRID_TILE_SIZE: integer division
    base = torch.floor(coord).to(I32).to(F32) + 0.5
    diff = coord - base  # in (-0.5, 0.5]
    sgn = torch.sign(diff).to(I32)
    base_i = torch.floor(base).to(I32)
    nb_i = torch.clamp(base_i + sgn, 0, t - 1)  # saturating uint conversion
    base_i = torch.clamp(base_i, 0, t - 1)
    # per-axis weights: 1 - |tileCenter - coord|
    w_base = 1.0 - torch.abs(base - coord)
    nb_center = (base_i + sgn).to(F32) + 0.5
    w_nb = 1.0 - torch.abs(nb_center - coord)
    return base_i, nb_i, w_base, w_nb, diff == 0.0


def clahe_apply(recon: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                cfg) -> torch.Tensor:
    """Bilinear blend of neighbouring tile LUTs
    (clahe_grad_curve_apply.comp:38-160); the plain version of the kernel
    in ``ops/cuda/clahe_apply.py``."""
    return clahe_apply_rows(recon, px, py, 0, recon.shape[-1], cfg)


def clahe_apply_rows(recon_rows: torch.Tensor, px: torch.Tensor, py: torch.Tensor, row0: int,
                     n: int, cfg) -> torch.Tensor:
    """Rows [row0, row0 + rows) of ``clahe_apply`` of an [n, n] image, from
    those rows (``recon_rows`` [rows, n]): the row blend attributes are the
    global rows', the column attributes the whole image's."""
    t, bins = cfg.clahe_tiles, cfg.clahe_bins
    py_flat = py.reshape(-1)
    rows = recon_rows.shape[-2]
    base_i, nb_i, w_base, w_nb, zero = axis_attrs(n, cfg, recon_rows)
    win = slice(row0, row0 + rows)
    bx, nx = base_i[win, None], nb_i[win, None]
    by, ny = base_i[None, :], nb_i[None, :]
    wbx, wnx = w_base[win, None], w_nb[win, None]
    wby, wny = w_base[None, :], w_nb[None, :]
    zx, zy = zero[win, None], zero[None, :]

    def ev(tx, ty):
        return _lut_eval(px, py_flat, tx * t + ty, recon_rows, bins)

    g_bb, g_nb, g_bn, g_nn = ev(bx, by), ev(nx, by), ev(bx, ny), ev(nx, ny)
    v_x0 = wby * g_bb + wny * g_bn  # diff.x == 0: blend along y
    v_y0 = wbx * g_bb + wnx * g_nb  # diff.y == 0: blend along x
    v_4 = (wbx * wby * g_bb + wnx * wby * g_nb
           + wbx * wny * g_bn + wnx * wny * g_nn)
    return torch.where(zx & zy, g_bb,
                       torch.where(zx, v_x0, torch.where(zy, v_y0, v_4)))


def clahe_grade(recon: torch.Tensor, relevant: torch.Tensor,
                cfg) -> torch.Tensor:
    """Full CLAHE gradation: histograms -> clipped CDF LUTs -> blended
    apply.  On a CUDA device the apply is the kernel at every size."""
    from .cuda import clahe_apply as k_clahe

    px, py = clahe_curves(clahe_histograms(recon, relevant, cfg), cfg)
    return k_clahe.clahe_apply(recon, px, py, cfg)


def clahe_grade_cnr(recon: torch.Tensor, normalized: torch.Tensor, cnr: torch.Tensor,
                    cfg) -> torch.Tensor:
    """``clahe_grade(recon, noise.img_relevant(normalized, cnr, cfg), cfg)``
    without the relevance image: the joint histogram with the relevance test
    inside it (KH on a CUDA device), the LUTs (KC), the blended apply (K5).
    Equal to ``clahe_grade``'s bit for bit."""
    from .cuda import clahe_apply as k_clahe
    from .cuda import clahe_hist as kh

    px, py = clahe_curves(kh.clahe_hist(recon, normalized, cnr, cfg), cfg)
    return k_clahe.clahe_apply(recon, px, py, cfg)
