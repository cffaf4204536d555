"""Wrapper of the contrast-stage kernel KA in ``csrc/contrast_apply.cu``, beside
its plain PyTorch version (launch counter: ``launch.LAUNCHES["contrast_apply"]``).

KA replaces no Pallas kernel: it is the counterpart of the JAX package's
``ops/curves.py::contrast_curve`` (:41), ``curve_get_y_sorted`` (:99) and
``contrast_curve_apply`` (:232), and ``ops/noise.py::nearest_upsample`` (:45)
with ``noise_reduction`` (:58), as its ``models/musica.py:112-140`` calls them
(XLA code).  The port's plain version, ``contrast_apply_plain``, is that chain
of ops (the twelve curves, each level's gain, the noise reduction), some 400
launches an image on the card; KA is one, with the same bits, NaN included.

The kernel builds every level's curve in each block of its one-wave grid
from the max bin on the device, so nothing waits for the host and a
captured graph replays it with each run's curves; the blocks then walk the
levels' chunks of ``CHUNK_PX`` pixels.  Bound: bytes, each band (and each
analysis level's sdev) read once, each output written once (151 MB at
3072^2 in float32).

Outputs: the bands the expand reads (the noise-reduced band of each level
below ``cfg.cnr_level - 1``, the contrast band of every other level) and, with
``intermediates``, also every level's contrast band and curve and the
noise-reduced band of every level below ``cfg.cnr_level``, from the same launch.

A window of rows (the spatial path's shards): level k's arrays hold the rows
[row0s[k], row0s[k] + rows) of its [n, n] image, and a noise-reduced level's
CNR map is given as the rows it reads (``noise.cnr_rows``) with the first.

Dispatch (``launch.py``): a CUDA tensor launches the kernel or raises; a CPU
tensor runs the plain version.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import curves, noise
from . import launch

MAX_LEVELS = 16  # csrc/contrast_apply.cu: kMaxLevels
MAX_POINTS = 33  # a bezier curve's points (kMaxPoints)
CHUNK_PX = 512 * 2 * 4  # a block's pixels a step of its walk (kThreads * kGroups * 4)
_STORAGE = (torch.float32, torch.bfloat16)


class _Level(ctypes.Structure):
    """csrc/contrast_apply.cu's ``LevelArgs``."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("band", "sdev", "out_c", "out_nr", "max_bin", "cnr", "tables")] + \
               [(name, ctypes.c_int) for name in
                ("rows", "n", "row0", "cnr_n", "cnr_row0", "scale", "bezier")] + \
               [(name, ctypes.c_float) for name in
                ("lcf", "hcf", "lo_c", "lo_f", "hi_c", "hi_f", "ramp")]


def nr_levels(cfg, intermediates: bool) -> range:
    """The levels whose noise-reduced band is computed: those the expand
    reads, and with ``intermediates`` also level ``cnr_level - 1``."""
    return range(cfg.cnr_level if intermediates else cfg.cnr_level - 1)


def _results(cfg, exp, nr, curve_list, intermediates):
    bands_in = [nr[k] if k < cfg.cnr_level - 1 else exp[k] for k in range(len(exp))]
    inter = {}
    if intermediates:
        inter.update({f"contrast_bandpass_{k}": e for k, e in enumerate(exp)})
        inter.update({f"nr_bandpass_{k}": b for k, b in nr.items()})
        inter.update({f"contrast_curve_{k}": c for k, c in enumerate(curve_list)})
    return bands_in, inter


def contrast_apply_plain(bands: Sequence[torch.Tensor], sdevs: Dict[int, torch.Tensor],
                         max_bins: Dict[int, torch.Tensor], cnrs, cfg,
                         row0s: Optional[Sequence[int]] = None, intermediates: bool = False):
    """Plain version of ``contrast_apply``: ``curves.contrast_curve`` a level,
    ``curves.contrast_curve_apply`` on the levels with an sdev and the
    constant gain hcf on the others, each stored in the bands' dtype, then
    ``noise.noise_reduction`` on the levels of ``nr_levels``."""
    L, sd = len(bands), bands[0].dtype
    row0s = [0] * L if row0s is None else list(row0s)
    no_bin = torch.zeros((), dtype=torch.int32, device=bands[0].device)
    curve_list = [curves.contrast_curve(max_bins.get(k, no_bin), lcf, hcf, cfg)
                  for k, (lcf, hcf) in enumerate(cfg.contrast_factors)]
    exp = []
    for k in range(L):
        if k in sdevs:
            e = curves.contrast_curve_apply(bands[k].float(), sdevs[k], *curve_list[k])
        else:
            # sdev is never computed for these levels in the reference; the
            # flat 2-point curve gives a constant hcf gain
            e = bands[k].float() * cfg.contrast_factors[k][1]
        exp.append(e.to(sd))
    nr = {}
    for k in nr_levels(cfg, intermediates):
        lo_c, lo_f, hi_c, hi_f = cfg.noise_reduction_params[k]
        cnr, cnr_row0 = cnrs[k]
        nr[k] = noise.noise_reduction(exp[k].float(), cnr, lo_c, lo_f, hi_c, hi_f, cfg,
                                      row0s[k], cnr_row0).to(sd)
    return _results(cfg, exp, nr, curve_list, intermediates)


def contrast_apply(bands: Sequence[torch.Tensor], sdevs: Dict[int, torch.Tensor],
                   max_bins: Dict[int, torch.Tensor], cnrs, cfg,
                   row0s: Optional[Sequence[int]] = None, intermediates: bool = False
                   ) -> Tuple[List[torch.Tensor], Dict[str, object]]:
    """The contrast stage of ``musica_forward`` on every pyramid level.

    ``bands``: level k's band [rows_k, n_k] (contiguous, float32 or bf16: the
    storage dtype, which the outputs keep), the rows [row0s[k], ...) of its
    [n_k, n_k] image (all 0 when None); ``sdevs``: {k: float32 [rows_k, n_k]}
    on the analysis levels; ``max_bins``: {k: int32 0-d} (0 where missing);
    ``cnrs``: {k: (float32 CNR rows [h, n_c], their first row)} for each
    level of ``nr_levels(cfg, intermediates)``.

    Returns ``(bands_in, inter)``: the bands the expand reads, and with
    ``intermediates`` ``contrast_bandpass_{k}``, ``nr_bandpass_{k}`` and
    ``contrast_curve_{k}`` (px, py), else {}.  One launch on a CUDA device."""
    tensors = [*bands, *sdevs.values(), *max_bins.values()]
    tensors += [cnrs[k][0] for k in nr_levels(cfg, intermediates)]
    if launch.device_of(tensors).type == "cpu":
        return contrast_apply_plain(bands, sdevs, max_bins, cnrs, cfg, row0s, intermediates)
    bands_in, inter, _ = _launch_contrast(bands, sdevs, max_bins, cnrs, cfg, row0s,
                                          intermediates)
    return bands_in, inter


def contrast_tables(bands, sdevs, max_bins, cnrs, cfg, row0s=None, intermediates=False):
    """``contrast_apply`` on CUDA tensors that also returns the curves each
    level's first block built, float32 [L, 3, 33]: px, py and the slopes
    (level k's first ``n_k``, ``n_k`` and ``n_k - 1`` entries, zeros after):
    the card's check that they equal ``curves.contrast_curve`` and its
    slopes."""
    return _launch_contrast(bands, sdevs, max_bins, cnrs, cfg, row0s, intermediates, True)


def _launch_contrast(bands, sdevs, max_bins, cnrs, cfg, row0s, intermediates: bool,
                     tables: bool = False):
    L = len(bands)
    nr_set = set(nr_levels(cfg, intermediates))
    dev = launch.device_of([*bands, *sdevs.values(), *max_bins.values(),
                            *[cnrs[k][0] for k in nr_set]])
    if not 1 <= L <= MAX_LEVELS or L != len(cfg.contrast_factors):
        raise ValueError(f"{L} levels; the config has {len(cfg.contrast_factors)}, the kernel "
                         f"takes 1 to {MAX_LEVELS}")
    sd = bands[0].dtype
    if sd not in _STORAGE:
        raise TypeError(f"bands: expected {' or '.join(map(str, _STORAGE))}, got {sd}")
    row0s = [0] * L if row0s is None else list(row0s)
    arr = (_Level * L)()
    exp: List[Optional[torch.Tensor]] = [None] * L
    nr: Dict[int, torch.Tensor] = {}
    tab = torch.zeros((L, 3, MAX_POINTS), dtype=torch.float32, device=bands[0].device) \
        if tables or intermediates else None
    for k, b in enumerate(bands):
        launch.check_rows(b, f"band {k}", sd)
        rows, n = b.shape
        if not 0 <= row0s[k] <= n - rows:
            raise ValueError(f"band {k}: rows [{row0s[k]}, {row0s[k] + rows}) of a {n}-row level")
        lv = arr[k]
        lv.band, lv.rows, lv.n, lv.row0 = b.data_ptr(), rows, n, row0s[k]
        if k in sdevs:
            launch.check_rows(sdevs[k], f"sdev {k}")
            if sdevs[k].shape != b.shape:
                raise ValueError(f"sdev {k}: {tuple(sdevs[k].shape)}, its band {tuple(b.shape)}")
            lv.sdev = sdevs[k].data_ptr()
        if k in max_bins:
            if max_bins[k].dtype != torch.int32 or max_bins[k].ndim != 0:
                raise TypeError(f"max bin {k}: expected a 0-d int32, got {max_bins[k].dtype} "
                                f"{tuple(max_bins[k].shape)}")
            lv.max_bin = max_bins[k].data_ptr()
        lcf, hcf = cfg.contrast_factors[k]
        lv.bezier, lv.lcf, lv.hcf = lcf != 1.0, np.float32(lcf), np.float32(hcf)
        if k >= cfg.cnr_level - 1 or intermediates:
            exp[k] = torch.empty_like(b)
            lv.out_c = exp[k].data_ptr()
        if k in nr_set:
            cnr, cnr_row0 = cnrs[k]
            launch.check_rows(cnr, f"CNR map of level {k}")
            lo, hi = noise.cnr_rows(cnr.shape[-1], n, row0s[k], row0s[k] + rows)
            if rows and not cnr_row0 <= lo <= hi <= cnr_row0 + cnr.shape[0]:
                raise ValueError(f"level {k}: rows [{row0s[k]}, {row0s[k] + rows}) read CNR rows "
                                 f"[{lo}, {hi}), the window holds [{cnr_row0}, "
                                 f"{cnr_row0 + cnr.shape[0]})")
            nr[k] = torch.empty_like(b)
            lo_c, lo_f, hi_c, hi_f = cfg.noise_reduction_params[k]
            lv.out_nr, lv.cnr, lv.cnr_n = nr[k].data_ptr(), cnr.data_ptr(), cnr.shape[-1]
            lv.cnr_row0, lv.scale = cnr_row0, int(math.ceil(n / cnr.shape[-1]))
            lv.lo_c, lv.lo_f, lv.hi_c, lv.hi_f = (np.float32(v) for v in (lo_c, lo_f, hi_c, hi_f))
            lv.ramp = np.float32((hi_f - lo_f) / (hi_c - lo_c))
        if tab is not None:
            lv.tables = tab[k].data_ptr()
    launch.launch(launch.lib(), "musica_contrast_apply", "contrast_apply", dev, arr, L,
                  int(sd == torch.bfloat16), np.float32(1.0 / cfg.noise_histogram_bins),
                  np.float32(cfg.max_noise_value), np.float32(cfg.max_cnr_value))
    curve_list = None
    if tab is not None:
        npts = [MAX_POINTS if lcf != 1.0 else 2 for lcf, _ in cfg.contrast_factors]
        curve_list = [(tab[k, 0, :m], tab[k, 1, :m]) for k, m in enumerate(npts)]
    bands_in, inter = _results(cfg, exp, nr, curve_list, intermediates)
    return bands_in, inter, tab
