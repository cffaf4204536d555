"""Wrappers of the histogram kernels in ``csrc/fused_hist.cu`` and
``csrc/sdev_noise.cu``, each beside its plain PyTorch version (launch
counters: ``launch.LAUNCHES``).

=========================  ==================================================
wrapper                    replaces (JAX package, ops/pallas/fused_hist.py)
=========================  ==================================================
``noise_hists``            ``noise_hist_fused`` (``_noise_kernel``) and
                           ``noise_hist_argmax_multi``
                           (``_noise_multi_kernel``): every analysis level's
                           histogram and its first-max bin, one launch, at
                           every size
``sdev_noise_hists``       ``sdev_noise_hist_fused`` (``_sdev_noise_kernel``):
                           the sdev images, their noise histograms and the
                           first-max bins from the bandpass levels, one
                           launch over all levels, at every size (the JAX
                           package falls back to two steps where cov != n)
``grad_hist_relevant``     ``grad_hist_relevant_fused``
                           (``_grad_relevant_kernel``), with each CNR
                           block's weight computed in the kernel from the
                           CNR map (the JAX package computes that plane
                           with XLA ops before its kernel)
``grad_hist``              ``grad_hist_fused`` (``_grad_kernel``)
``noise_hists_rows``       ``noise_hist_fused`` on the spatial path: each
                           level's histogram of a shard's rows, no argmax
``sdev_noise_hists_rows``  ``sdev_noise_hist_fused`` on the spatial path:
                           each level's sdev rows of a shard (from its
                           rows and the 2-row halos) and their histograms,
                           no argmax
``sdevs``, ``sdevs_rows``  no Pallas kernel: ``ops/stats.py::img_sdev``
                           (XLA in the JAX package) on the default
                           analysis path, every level in one launch of
                           KS (``sdev_kernel``: K7's sums and tail
                           without the noise scan, a warp a strip of
                           columns down a run of rows), whole or on a
                           shard's rows
``hist_argmax``            ``noise_hist_argmax_multi``'s argmax, a launch of
                           its own on the spatial path's summed histograms
=========================  ==================================================

K1, K3, K4 and K7 take a window of rows of their images (the spatial
path's shards, ``parallel/spatial.py``): ``row0``, the window's first global
row, places the coverage, the tiles, the relevance border and the CNR rows
(K7: the sdev rows and the band rows that hold them, the halos included),
so the histograms of a partition of the rows sum to the whole image's; each
plain version is the whole-image plain function on the window's rows.  A
whole image is the window of all its rows.

Each histogram kernel is bound by one read of its images (4 bytes/px for
the noise histogram; 8 for the gradation histograms: recon + the relevance
image, or recon + normalized with the relevance computed in the kernel; 8
for the sdev kernel: the band in, the sdev out).  The histograms are
privatised per block in shared memory, with one global atomic per non-zero
bin at the end of the block (for the sdev kernel: where a block's range of
tasks crosses into the next level, and at its end).  The block that
finishes last takes every level's first-max bin (``csrc/hist_argmax.cuh``),
the argmax that ``noise_hist_argmax_multi`` takes on its last row block;
its ticket counter lies in the histograms' allocation, which one memset
zeroes per call.  The noise and
gradation kernels read neighbouring pixels across a warp's lanes and find
the reference's scan breaks with ballots and shuffles; each counted pixel
costs one shared atomic (``hist_add`` in ``csrc/fused_hist.cu``).  The
histogram tile (``histogram_area_size``, 16 px in the shaders) is a
template parameter of those warp layouts: 4, 8, 16 and 32 px for the noise
histogram, 8, 16 and 32 for the gradation histograms and the sdev kernel;
any other tile runs a kernel whose thread walks one group or tile in the
reference's order.  Every tile runs on the card.

Dispatch (``launch.py``): a CUDA tensor launches the kernel or raises; a
CPU tensor runs the plain version.  There is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import f32, gradation, noise, stats
from . import launch
from .histogram import histogram_plain

_MAX_LEVELS = 16  # MUSICA_MAX_LEVELS in fused_hist.cu
# csrc/sdev_noise.cu: K7's output rows of a task, its least width in
# columns; KS's output columns of a warp's strip and rows of its run
SDEV_BAND, SDEV_WIDTH = 32, 64
KS_STRIP, KS_RUN = 120, 32


def sdev_task_width(tile: int) -> int:
    """Output columns of a task of the sdev kernel: 64 for the tiles of its
    warp layout (8, 16, 32), else the least multiple of the tile that is
    >= 64."""
    if tile in (8, 16, 32):
        return SDEV_WIDTH
    return tile if tile >= SDEV_WIDTH else -(-SDEV_WIDTH // tile) * tile


def sdev_shared_bytes(tile: int, n_bins: int) -> int:
    """Shared memory of a block of the sdev kernel (``Layout`` in
    csrc/sdev_noise.cu): the float64 vertical sums, two staging buffers of
    the band and its halo, the sdev tile and the histogram."""
    w = sdev_task_width(tile)
    return (8 * SDEV_BAND * (w + 5) + 2 * 4 * (SDEV_BAND + 4) * (w + 8)
            + 4 * SDEV_BAND * (w + 1) + 4 * n_bins)


# ----------------------------------------------------------------------
# noise histogram + argmax (kernels 1 and 2 of the JAX package)
# ----------------------------------------------------------------------

def _hist_buffers(L: int, nb: int, dev):
    """(histograms int32 [L, nb], first-max bins int32 [L], the kernel's
    block ticket counter): views of one allocation, zeroed by one memset, so
    the counter starts at 0 in every call and no launch is added."""
    buf = torch.zeros(L * nb + L + 1, dtype=torch.int32, device=dev)
    return buf[:L * nb].view(L, nb), buf[L * nb:L * nb + L], buf[L * nb + L:]


def hist_argmax_plain(hists: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernels' argmax: ``torch.argmax`` (first
    maximum) per row."""
    return stats.histogram_max(hists)[1]


def noise_hists_plain(levels, cfg) -> torch.Tensor:
    """Plain version: per level, ``stats.noise_bins`` + an int64
    ``scatter_add_``."""
    nb = cfg.noise_histogram_bins
    hists = []
    for sd in levels:
        bins, w = stats.noise_bins(sd, cfg)
        hists.append(histogram_plain(bins, w, nb))
    return torch.stack(hists)


def noise_hists_rows_plain(windows, row0s, cfg) -> torch.Tensor:
    """Plain version of ``noise_hists_rows``: per level,
    ``stats.noise_bins_rows`` + an int64 ``scatter_add_``."""
    nb = cfg.noise_histogram_bins
    return torch.stack([histogram_plain(*stats.noise_bins_rows(sd, r0, cfg), nb)
                        for sd, r0 in zip(windows, row0s)])


def _scanned_rows(sd, row0: int, cfg) -> int:
    """Rows of the window [row0, row0 + rows) of an [n, n] level inside its
    coverage."""
    return max(0, min(sd.shape[-2], stats.coverage(sd.shape[-1], cfg) - row0))


def _launch_noise(levels, row0s, cfg, argmax: bool):
    """K1 on CUDA windows of rows: (histograms, first-max bins or None)."""
    dev = levels[0].device
    nb, tile = cfg.noise_histogram_bins, cfg.histogram_area_size
    launch.check_bins(nb)
    if not 1 <= len(levels) <= _MAX_LEVELS:
        raise ValueError(f"{len(levels)} levels, at most {_MAX_LEVELS}")
    for i, (sd, r0) in enumerate(zip(levels, row0s)):
        launch.check_rows(sd, f"level {i}")
        if not 0 <= r0 <= sd.shape[-1] - sd.shape[-2]:
            raise ValueError(f"level {i}: rows [{r0}, {r0 + sd.shape[-2]}) of a "
                             f"{sd.shape[-1]}-row level")
    L = len(levels)
    lib = launch.lib()
    hists, max_bins, ticket = _hist_buffers(L, nb, dev)
    ints = ctypes.c_int * L
    ptrs = (ctypes.c_void_p * L)(*[sd.data_ptr() for sd in levels])
    ns = ints(*[sd.shape[-1] for sd in levels])
    covs = ints(*[stats.coverage(sd.shape[-1], cfg) for sd in levels])
    strides = ints(*[max(sd.stride(0), sd.shape[-1]) for sd in levels])
    launch.launch(lib, "musica_noise_hist", "noise_hist", dev, ptrs, ns, covs, strides,
                  ints(*row0s), ints(*[sd.shape[-2] for sd in levels]), L, hists.data_ptr(),
                  max_bins.data_ptr() if argmax else None, ticket.data_ptr(), nb, tile,
                  float(cfg.max_noise_value))
    return hists, (max_bins if argmax else None)


def noise_hists(levels, cfg):
    """(noise histograms int32 [L, n_bins], their first-max bins int32 [L])
    of a list of [n_i, n_i] float32 level images, each scanned over its
    coverage (``stats.coverage``), in one launch."""
    dev = launch.device_of(levels)
    if dev.type == "cpu":
        hists = noise_hists_plain(levels, cfg)
        return hists, hist_argmax_plain(hists)
    for i, sd in enumerate(levels):
        launch.check_image(sd, f"level {i}")
    return _launch_noise(levels, [0] * len(levels), cfg, argmax=True)


def noise_hists_rows(windows, row0s, cfg):
    """Partial noise histograms (int32 [L, n_bins]) of windows of rows:
    ``windows[j]`` [rows_j, n_j] holds the rows [row0s[j], row0s[j] +
    rows_j) of an [n_j, n_j] level (0 rows: none of it), each scanned where
    it lies inside its level's coverage, in one launch without the argmax;
    ``None``, and no launch, where no window holds a covered row."""
    dev = launch.device_of(windows)
    if not any(_scanned_rows(sd, r0, cfg) for sd, r0 in zip(windows, row0s)):
        return None
    if dev.type == "cpu":
        return noise_hists_rows_plain(windows, row0s, cfg)
    return _launch_noise(windows, list(row0s), cfg, argmax=False)[0]


def hist_argmax(hists: torch.Tensor) -> torch.Tensor:
    """First-max bins (int32 [L]) of int32 histograms [L, n_bins], one
    launch (``hist_argmax_kernel``): the spatial path's argmax of its
    summed noise histograms."""
    dev = launch.device_of([hists])
    if dev.type == "cpu":
        return hist_argmax_plain(hists)
    if hists.dtype != torch.int32 or hists.ndim != 2 or not hists.is_contiguous():
        raise ValueError(f"hists: expected contiguous int32 [L, n_bins], got "
                         f"{hists.dtype} {tuple(hists.shape)}")
    L, nb = hists.shape
    if not 1 <= L <= _MAX_LEVELS:
        raise ValueError(f"{L} levels, at most {_MAX_LEVELS}")
    max_bins = torch.empty(L, dtype=torch.int32, device=dev)
    launch.launch(launch.lib(), "musica_hist_argmax", "hist_argmax", dev, hists.data_ptr(), L,
                  nb, max_bins.data_ptr())
    return max_bins


# ----------------------------------------------------------------------
# sdev + noise histogram in one pass (kernel 7 of the JAX package)
# ----------------------------------------------------------------------

def sdev_noise_hists_plain(bands, cfg):
    """Plain version: ``stats.img_sdev`` per level, then
    ``noise_hists_plain``."""
    sdevs = [stats.img_sdev(b) for b in bands]
    return sdevs, noise_hists_plain(sdevs, cfg)


def sdevs_plain(bands):
    """Plain version of ``sdevs``: ``stats.img_sdev`` per level."""
    return [stats.img_sdev(b) for b in bands]


def sdevs_rows_plain(bands, band_row0s, out_rows):
    """Plain version of ``sdevs_rows``: ``stats.img_sdev_rows`` per level."""
    return [stats.img_sdev_rows(b, lo, b.shape[-1], r0, r1)
            for b, lo, (r0, r1) in zip(bands, band_row0s, out_rows)]


def sdev_noise_hists_rows_plain(bands, band_row0s, out_rows, cfg, counted=None):
    """Plain version of ``sdev_noise_hists_rows``: ``stats.img_sdev_rows``
    per level, then ``noise_hists_rows_plain`` of the counted levels'
    windows."""
    counted = [True] * len(bands) if counted is None else counted
    sdevs = sdevs_rows_plain(bands, band_row0s, out_rows)
    return sdevs, noise_hists_rows_plain([sd if c else sd[:0] for sd, c in zip(sdevs, counted)],
                                         [r0 for r0, _ in out_rows], cfg)


def sdev_noise_hists(bands, cfg, grid: int = 0):
    """(sdev images, list of float32 [n_i, n_i]; noise histograms, int32
    [L, n_bins]; their first-max bins, int32 [L]) of a list of [n_i, n_i]
    float32 bandpass levels, each histogram scanned over its level's
    coverage (``stats.coverage``), in one launch.  ``grid`` > 0 launches at
    most that many blocks instead of one wave, so that a block's range of
    tasks spans levels (the tests use it)."""
    dev = launch.device_of(bands)
    if dev.type == "cpu":
        sdevs, hists = sdev_noise_hists_plain(bands, cfg)
        return sdevs, hists, hist_argmax_plain(hists)
    for i, b in enumerate(bands):
        launch.check_image(b, f"band {i}")
    L = len(bands)
    return _launch_sdev(bands, [0] * L, [(0, b.shape[-1]) for b in bands], [True] * L, cfg,
                        argmax=True, grid=grid)


def sdev_noise_hists_rows(bands, band_row0s, out_rows, cfg, counted=None, grid: int = 0):
    """(sdev windows, list of float32 [r1_j - r0_j, n_j]; partial noise
    histograms, int32 [L, n_bins]) of windows of rows of bandpass levels,
    in one launch without the argmax: ``bands[j]`` [rows_j, n_j] holds the
    rows [band_row0s[j], band_row0s[j] + rows_j) of an [n_j, n_j] level, at
    least ``pyramid.needed_rows("img_sdev", n_j, r0, r1)``; ``out_rows[j]``
    = (r0, r1), the sdev rows computed; level j's histogram counts its rows
    [r0, min(r1, coverage)) where ``counted[j]`` (default: every level), so
    the histograms of a partition of the rows sum to the whole levels'."""
    dev = launch.device_of(bands)
    counted = [True] * len(bands) if counted is None else list(counted)
    if dev.type == "cpu":
        return sdev_noise_hists_rows_plain(bands, band_row0s, out_rows, cfg, counted)
    return _launch_sdev(bands, list(band_row0s), list(out_rows), counted, cfg, argmax=False,
                        grid=grid)[:2]


def _sdev_windows(bands, los, out_rows):
    """Checks of K7's and KS's windows of rows; returns (the sdev windows,
    allocated, and the C arguments of the levels: the bands, the sdev
    windows, their sizes, and per level an int array each of the first
    band row, the end of the band rows, r0 and r1)."""
    dev = bands[0].device
    L = len(bands)
    if not 1 <= L <= _MAX_LEVELS:
        raise ValueError(f"{L} levels, at most {_MAX_LEVELS}")
    for i, (b, lo, (r0, r1)) in enumerate(zip(bands, los, out_rows)):
        launch.check_rows(b, f"band {i}")
        n = b.shape[-1]
        hi = lo + b.shape[-2]
        need = (max(r0 - 2, 0), min(r1 + 2, n))
        if not (0 <= r0 < r1 <= n and 0 <= lo <= need[0] and need[1] <= hi <= n):
            raise ValueError(f"band {i}: sdev rows [{r0}, {r1}) of a {n}-row level read its "
                             f"rows {list(need)}, the window holds [{lo}, {hi})")
    sdevs = [torch.empty((r1 - r0, b.shape[-1]), dtype=torch.float32, device=dev)
             for b, (r0, r1) in zip(bands, out_rows)]
    ints = ctypes.c_int * L
    src = (ctypes.c_void_p * L)(*[b.data_ptr() for b in bands])
    dst = (ctypes.c_void_p * L)(*[s.data_ptr() for s in sdevs])
    ns = ints(*[b.shape[-1] for b in bands])
    rows = (ints(*los), ints(*[lo + b.shape[-2] for b, lo in zip(bands, los)]),
            ints(*[r0 for r0, _ in out_rows]), ints(*[r1 for _, r1 in out_rows]))
    return sdevs, (src, dst, ns), rows


def _launch_sdev(bands, los, out_rows, counted, cfg, argmax: bool, grid: int = 0):
    """K7 on CUDA windows of rows: (sdev windows, histograms, first-max bins
    or None)."""
    dev = bands[0].device
    nb, tile = cfg.noise_histogram_bins, cfg.histogram_area_size
    launch.check_bins(nb)
    launch.check_shared(sdev_shared_bytes(tile, nb), f"noise_histogram_bins={nb}")
    sdevs, (src, dst, ns), rows = _sdev_windows(bands, los, out_rows)
    L = len(bands)
    lib = launch.lib()
    hists, max_bins, ticket = _hist_buffers(L, nb, dev)
    covs = (ctypes.c_int * L)(*[stats.coverage(b.shape[-1], cfg) if c else 0
                                for b, c in zip(bands, counted)])
    launch.launch(lib, "musica_sdev_noise_hist", "sdev_noise_hist", dev, src, dst, ns, covs,
                  *rows, L, hists.data_ptr(), max_bins.data_ptr() if argmax else None,
                  ticket.data_ptr(), nb, tile, float(cfg.max_noise_value), int(grid))
    return sdevs, hists, (max_bins if argmax else None)


# ----------------------------------------------------------------------
# KS: the default analysis path's sdev (no Pallas kernel in the JAX package)
# ----------------------------------------------------------------------

def sdevs(bands, grid: int = 0):
    """``stats.img_sdev`` of each of a list of [n_i, n_i] float32 bandpass
    levels (list of float32 [n_i, n_i]), in one launch: K7's sums and tail
    without its noise scan.  ``grid`` > 0 launches at most that many blocks
    (of 4 warps), whose warps then walk several strips and levels each (the
    tests use it)."""
    dev = launch.device_of(bands)
    if dev.type == "cpu":
        return sdevs_plain(bands)
    for i, b in enumerate(bands):
        launch.check_image(b, f"band {i}")
    return _launch_sdevs(bands, [0] * len(bands), [(0, b.shape[-1]) for b in bands], grid)


def sdevs_rows(bands, band_row0s, out_rows, grid: int = 0):
    """``stats.img_sdev_rows`` of windows of rows of bandpass levels (list of
    float32 [r1_j - r0_j, n_j]), in one launch: ``bands[j]``, its first row
    ``band_row0s[j]`` and the sdev rows ``out_rows[j]`` = (r0, r1) as in
    ``sdev_noise_hists_rows``."""
    dev = launch.device_of(bands)
    if dev.type == "cpu":
        return sdevs_rows_plain(bands, band_row0s, out_rows)
    return _launch_sdevs(bands, list(band_row0s), list(out_rows), grid)


def _launch_sdevs(bands, los, out_rows, grid: int = 0):
    """KS on CUDA windows of rows: the sdev windows."""
    dev = bands[0].device
    sdevs_out, (src, dst, ns), rows = _sdev_windows(bands, los, out_rows)
    launch.launch(launch.lib(), "musica_sdev", "sdev", dev, src, dst, ns, *rows, len(bands),
                  int(grid))
    return sdevs_out


def sdev_tail_plain(s: torch.Tensor) -> torch.Tensor:
    """Plain version of ``sdev_tail``: ``img_sdev``'s last step
    (``stats.sdev_of_sums``), the correctly rounded square root of a true
    float64 division by 25, rounded to float32."""
    return stats.sdev_of_sums(s)


def sdev_tail(s: torch.Tensor) -> torch.Tensor:
    """KS's (and K7's) per-output tail on any float64 values ``s`` (the sums
    of 25 squares in the kernels): float32 of the same shape, one launch of
    ``sdev_tail_kernel`` (``csrc/sdev_noise.cu``), which must equal
    ``sdev_tail_plain`` bit for bit (NaN where it has NaN)."""
    dev = launch.device_of([s])
    if dev.type == "cpu":
        return sdev_tail_plain(s)
    return _launch_sdev_tail(s, 0)


def sdev_tail_rsqrt(q: torch.Tensor) -> torch.Tensor:
    """The card's ``rsqrt.approx.ftz.f64`` of each float64 ``q`` (CUDA
    only, no plain version): the start of KS's square root, whose relative
    error ``chip_smoke.py`` [3g] bounds over every significand it reads."""
    return _launch_sdev_tail(q, 1)


def _launch_sdev_tail(s, mode: int):
    dev = launch.device_of([s])
    if s.dtype != torch.float64 or not s.is_contiguous():
        raise ValueError(f"s: expected contiguous float64, got {s.dtype}")
    out = torch.empty(s.shape, dtype=torch.float32 if mode == 0 else torch.float64, device=dev)
    launch.launch(launch.lib(), "musica_sdev_tail", "sdev_tail", dev, s.data_ptr(),
                  out.data_ptr(), s.numel(), mode)
    return out


# ----------------------------------------------------------------------
# gradation histograms (kernels 3 and 4 of the JAX package)
# ----------------------------------------------------------------------

def grad_hist_plain(recon, relevant, cfg, row0: int = 0):
    """Plain version: ``gradation.gradation_bins`` + an int64 scatter-add."""
    gradation.check_window(recon.shape[-1], row0, recon.shape[-2], cfg.histogram_area_size)
    bins, w = gradation.gradation_bins(recon, relevant, cfg)
    return histogram_plain(bins, w, cfg.grad_histogram_bins)


def grad_hist(recon: torch.Tensor, relevant: torch.Tensor, cfg, row0: int = 0) -> torch.Tensor:
    """Gradation histogram (int32 [n_bins]) of recon [n, n] weighted by
    trunc(relevant * 100), with the whole-tile return at the first 0.0; of
    the rows [row0, row0 + rows) of an [n, n] image where recon and
    relevant are [rows, n] (``gradation.check_window``)."""
    dev = launch.device_of([recon, relevant])
    if dev.type == "cpu":
        return grad_hist_plain(recon, relevant, cfg, row0)
    nb, tile = cfg.grad_histogram_bins, cfg.histogram_area_size
    launch.check_bins(nb)
    launch.check_rows(recon, "recon")
    launch.check_rows(relevant, "relevant")
    if relevant.shape != recon.shape:
        raise ValueError(f"relevant {tuple(relevant.shape)} != recon {tuple(recon.shape)}")
    rows, n = recon.shape
    gradation.check_window(n, row0, rows, tile)
    lib = launch.lib()
    hist = torch.zeros(nb, dtype=torch.int32, device=dev)
    launch.launch(lib, "musica_grad_hist", "grad_hist", dev, recon.data_ptr(),
                  relevant.data_ptr(), n, n, row0, rows, hist.data_ptr(), nb, tile)
    return hist


def relevance_weight_plane(cnr: torch.Tensor, cfg) -> torch.Tensor:
    """Block weights on the CNR grid (int32): the ramp's trunc((c/6)^5 * 100)
    where 1 <= c <= 6, -1 for a solid block (6 <= c <= 256: the weight is
    100 where the pixel's normalized value is <= 0.9), else 0; the ramp wins
    at c == 6 (img_relevant.comp:27-63).  Nearest upsampling copies, so this
    equals the per-pixel evaluation.  K3 computes these weights itself
    (``csrc/relevance.cuh::block_weight``, the same operations); it reads
    this plane only where ``noise.chain_exponent(cfg.relevant_k)`` is 0."""
    c = cnr * cfg.max_cnr_value
    top = cfg.relevant_cnr_low + cfg.relevant_cnr_ramp
    ramp = (c >= cfg.relevant_cnr_low) & (c <= top)
    solid = (c >= top) & (c <= cfg.max_cnr_value) & ~ramp
    w_ramp = (noise._pow_maybe_int(c / f32(top, c), cfg.relevant_k)
              * 100.0).to(torch.int32)
    return torch.where(solid, -1, torch.where(ramp, w_ramp, 0)).to(torch.int32)


def grad_hist_relevant_plain(recon, normalized, cnr, cfg, row0: int = 0, cnr_row0: int = 0):
    """Plain version: the relevance image (``noise.img_relevant``), then
    ``grad_hist_plain``."""
    return grad_hist_plain(recon, noise.img_relevant(normalized, cnr, cfg, row0, cnr_row0),
                           cfg, row0)


def grad_hist_relevant(recon: torch.Tensor, normalized: torch.Tensor,
                       cnr: torch.Tensor, cfg, row0: int = 0,
                       cnr_row0: int = 0) -> torch.Tensor:
    """Gradation histogram (int32 [n_bins]) with the relevance weight
    computed in the kernel from the small CNR map and the normalized image
    (no full-size relevance image; where the ramp's exponent is no integer in
    1..8, from ``relevance_weight_plane`` instead, one explicit branch of the
    launch).  On a CUDA device the CNR scale must
    divide the histogram tile, where ``gradation_histogram_fused_relevance``
    takes this path.  A window: recon and normalized [rows, n] hold the rows
    [row0, row0 + rows) as ``grad_hist``'s, cnr the CNR rows [cnr_row0,
    ...) that they read (``noise.cnr_rows``), all its columns."""
    dev = launch.device_of([recon, normalized, cnr])
    if dev.type == "cpu":
        return grad_hist_relevant_plain(recon, normalized, cnr, cfg, row0, cnr_row0)
    nb, tile = cfg.grad_histogram_bins, cfg.histogram_area_size
    launch.check_bins(nb)
    launch.check_rows(recon, "recon")
    launch.check_rows(normalized, "normalized")
    launch.check_rows(cnr, "cnr")
    if normalized.shape != recon.shape:
        raise ValueError(f"normalized {tuple(normalized.shape)} != recon {tuple(recon.shape)}")
    rows, n = recon.shape
    gradation.check_window(n, row0, rows, tile)
    scale = int(math.ceil(n / cnr.shape[-1]))
    if tile % scale:
        raise ValueError(f"CNR scale {scale} ({n} px over a {cnr.shape[-1]}-px CNR map) "
                         f"does not divide the {tile}-px tile")
    lo, hi = noise.cnr_rows(cnr.shape[-1], n, row0, row0 + rows)
    if not cnr_row0 <= lo < hi <= cnr_row0 + cnr.shape[-2]:
        raise ValueError(f"cnr holds CNR rows [{cnr_row0}, {cnr_row0 + cnr.shape[-2]}), "
                         f"the window reads [{lo}, {hi})")
    return _launch_grad_hist_relevant(recon, normalized, cnr, cfg, row0, cnr_row0,
                                      noise.chain_exponent(cfg.relevant_k))


def _launch_grad_hist_relevant(recon, normalized, cnr, cfg, row0: int, cnr_row0: int,
                               k: int) -> torch.Tensor:
    """The launch of ``grad_hist_relevant`` on CUDA tensors the wrapper has
    checked: for k in 1..8 (``noise.chain_exponent``) the kernel computes
    the block weights from the CNR rows [cnr_row0, ...), for k = 0 it reads
    them from ``relevance_weight_plane`` of those rows (``chip_smoke.py``
    holds the two routes against each other at an integer exponent)."""
    dev = recon.device
    nb, (rows, n), ws = cfg.grad_histogram_bins, recon.shape, cnr.shape[-1]
    wplane = None if k else relevance_weight_plane(cnr, cfg).contiguous()
    lib = launch.lib()
    hist = torch.zeros(nb, dtype=torch.int32, device=dev)
    launch.launch(lib, "musica_grad_hist_relevant", "grad_hist_relevant", dev,
                  recon.data_ptr(), normalized.data_ptr(), n, n, row0, rows,
                  cnr.data_ptr() if k else None, None if k else wplane.data_ptr(), ws,
                  cnr_row0, cnr.shape[-2], int(math.ceil(n / ws)), cfg.relevant_border,
                  *relevance_rule(cfg), k, hist.data_ptr(), nb, cfg.histogram_area_size)
    return hist


def relevance_rule(cfg):
    """The relevance mask's float32 constants as the kernels take them
    (``csrc/relevance.cuh``): max_pixel, max_cnr, lo and top = lo + ramp,
    each the value the plain version compares with (PyTorch rounds a Python
    float to the tensor's float32)."""
    f = np.float32
    return (f(cfg.relevant_max_pixel), f(cfg.max_cnr_value), f(cfg.relevant_cnr_low),
            f(cfg.relevant_cnr_low + cfg.relevant_cnr_ramp))
