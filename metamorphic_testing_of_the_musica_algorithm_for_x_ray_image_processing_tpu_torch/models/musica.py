"""The MUSICA pipeline on PyTorch.  Port of the JAX package's
``models/musica.py`` (``musica_forward``, ``process_jit``,
``process_batch_jit``, ``process``, a batch entry, ``timed_process``), with
the CLAHE and linear-gradation variants, bf16 band storage (``cfg.storage``)
and the opt-in fused-sdev analysis.

PyTorch runs eagerly, so the function below is the schedule: each stage is
a handful of device ops, and the pyramid's steps, the histograms, the
contrast stage and the CLAHE apply go through the CUDA kernels of
``ops/cuda`` when the image is on a CUDA device.  Histogram
argmaxes, curve points and t0/ta/t1 stay on the device as small tensors:
nothing in ``musica_forward`` waits for the host.  Each phase is a
``torch.profiler`` span named ``musica.<phase>`` (``utils/spans.py``: ~0.6
µs a phase without a profiler; scripts/profile_torch.py reads them).

Phase map (reference -> here):
  2. normalize        -> ops.normalize (sqrt + quirk-exact global max/min)
  3. pyramid reduce   -> ops.pyramid (fused smooth+decimate; polyphase expand
                         and band subtraction; on a CUDA device the kernels
                         of csrc/pyramid.cu)
  4. image analysis   -> ops.stats (sdev of every level in one kernel, noise
                         histograms + argmax; with fused_sdev one kernel for
                         sdev + histograms)
  5. apply            -> ops.noise (CNR), then the contrast curves, their gain
                         and the noise reduction (ops.curves, ops.noise; one
                         kernel on a CUDA device: ops.cuda.contrast_apply)
  6. pyramid expand   -> ops.pyramid (expand + band in one step)
  7. gradation        -> ops.gradation (relevance-weighted histogram, curve);
                         ENABLE_CLAHE: ops.clahe (joint histogram with the
                         relevance test inside it, per-tile LUTs, blended
                         apply)
  output              -> tone map, margin crop + x255 truncating u8 cast
                         (one kernel on a CUDA device: ops.cuda.tonemap)

The production entries ``process_jit`` and ``process_batch_jit`` (and
``process``, ``process_batch`` on top of them) replay ``musica_forward`` as a
captured CUDA graph on a CUDA device (``models/graphs.py``), as the JAX
package's run one compiled program; ``forward_batch``, ``timed_process``
and ``want_intermediates`` run eagerly.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import MusicaConfig
from ..ops import clahe, gradation, noise, normalize, pyramid, stats
from ..ops.cuda import contrast_apply, tonemap
from ..utils.spans import span
from . import graphs


# dtype of the band streams per cfg.storage: in "bfloat16" the bandpasses,
# the contrast-applied and the noise-reduced bandpasses are stored bf16 and
# every consumer upcasts them to float32 explicitly (PyTorch keeps a bf16
# tensor times a float32 scalar in bf16, where JAX computes in float32);
# normalized, downs, recon, sdev and cnr stay float32, as in the JAX package
# (its musica.py explains why only the bands)
_BAND_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _band_dtype(cfg: MusicaConfig) -> torch.dtype:
    if cfg.storage not in _BAND_DTYPES:
        raise NotImplementedError(
            f"storage={cfg.storage!r}: the port stores bands as one of "
            f"{sorted(_BAND_DTYPES)}")
    return _BAND_DTYPES[cfg.storage]


def _span(name: str):
    """musica_forward's phase marker: the span ``musica.<name>``."""
    return span("musica." + name)


# timed_process's phase keys (the JAX package's, after the reference's
# MEASURE_PROCESS summary); CLAHE and the tone map count as gradation
_TIMED_KEYS = {"normalize": "norm", "reduce": "red", "analysis": "anly",
               "apply": "aply", "expand": "exp", "gradation": "grad",
               "clahe": "grad", "tonemap": "grad"}


class _PhaseTimer:
    """timed_process's phase marker: the host clock around each phase,
    fenced at its end with ``torch.cuda.synchronize`` on a CUDA device (the
    JAX package fences with a host transfer)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.times = {k: 0.0 for k in dict.fromkeys(_TIMED_KEYS.values())}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        with _span(name):
            yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.times[_TIMED_KEYS[name]] += (time.perf_counter() - t0) * 1e3


def musica_forward(img_u16: torch.Tensor, cfg: MusicaConfig,
                   want_intermediates: bool = False,
                   fused_sdev: bool = False) -> Dict[str, object]:
    """Full MUSICA pass on one [n, n] integer image, on the image's device.

    Returns ``graded`` ([n, n] f32), ``out_u8`` (margin-cropped uint8),
    ``recon`` and ``cnr``; with ``cfg.enable_clahe`` also ``clahe_graded``;
    with ``want_intermediates`` also ``intermediates``, every stage under the
    JAX package's names.

    ``fused_sdev`` is the JAX package's ``hist_method="fused_sdev"``: the
    analysis computes each level's sdev and noise histogram in one kernel
    (``stats.sdev_and_noise_histograms``) instead of ``img_sdev`` and a
    histogram kernel.  Its outputs equal the default path's bit for bit.
    The JAX package's other ``hist_method`` values choose between TPU and
    CPU implementations, which the port decides from the tensor's device;
    only this one selects different work, so it is the only one ported."""
    return _forward(img_u16, cfg, want_intermediates, _span, fused_sdev)


def _forward(img_u16: torch.Tensor, cfg: MusicaConfig, want_intermediates: bool,
             phase, fused_sdev: bool) -> Dict[str, object]:
    """musica_forward's body; ``phase(name)`` is the context each phase
    runs in."""
    sd = _band_dtype(cfg)
    n = cfg.image_size
    if tuple(img_u16.shape) != (n, n):
        raise ValueError(f"image {tuple(img_u16.shape)} != cfg.image_size {n}")
    L = cfg.pyramid_levels
    inter: Dict[str, object] = {}

    # ---- phase 2: normalize -------------------------------------------------
    with phase("normalize"):
        # a strided view (the campaign's runner passes the raw transposed)
        # would give strided images, which the kernels refuse
        normalized, vmax, vmin = normalize.normalize_from_u16(img_u16.contiguous(), cfg.quirks)

    # ---- phase 3: pyramid reduce -------------------------------------------
    with phase("reduce"):
        bandpass, downs = pyramid.reduce_ladder(normalized, L)
        bandpass = [b.to(sd) for b in bandpass]

    # ---- phase 4: analysis --------------------------------------------------
    with phase("analysis"):
        bands = {i: bandpass[i].float() for i in cfg.analysis_levels}
        if fused_sdev:
            sdevs, hists, max_bins = stats.sdev_and_noise_histograms(bands, cfg)
        else:
            sdevs = stats.analysis_sdevs(bands)
            hists, max_bins = stats.analysis_noise_hists(sdevs, cfg)

    # ---- phase 5: apply -----------------------------------------------------
    # the contrast curves, each level's gain and the noise reduction of the
    # levels the expand reads (< cnr_level - 1; with intermediates also level
    # cnr_level - 1): one launch on a CUDA device (ops/cuda/contrast_apply.py)
    with phase("apply"):
        cnr = noise.img_cnr(sdevs[cfg.cnr_level], max_bins[cfg.cnr_level], cfg)
        cnrs = {lvl: (cnr, 0) for lvl in contrast_apply.nr_levels(cfg, want_intermediates)}
        bands_in, stage = contrast_apply.contrast_apply(bandpass, sdevs, max_bins, cnrs, cfg,
                                                        intermediates=want_intermediates)

    # ---- phase 6: pyramid expand -------------------------------------------
    with phase("expand"):
        if want_intermediates:
            # exp_lowpass_{i} needs every level's expand: a step a level
            recon = downs[L - 1]
            for i in range(L):
                band = bands_in[L - 1 - i]
                inter[f"exp_lowpass_{i}"] = pyramid.upsample_smooth(recon, band.shape[-1])
                recon = pyramid.upsample_add(recon, band)
        else:
            recon = pyramid.expand_ladder(downs[L - 1], bands_in)

    # ---- phase 7: gradation -------------------------------------------------
    # GRAD_WITH_LINEAR_IMAGE (shaders/img_linear.comp): the gradation
    # histogram and the tone map read the squared image
    with phase("gradation"):
        grad_input = recon * recon if cfg.grad_with_linear_image else recon
        if want_intermediates:
            # the relevance image itself is an intermediate
            relevant = noise.img_relevant(normalized, cnr, cfg)
            ghist = gradation.gradation_histogram(grad_input, relevant, cfg)
        else:
            ghist = gradation.gradation_histogram_fused_relevance(
                grad_input, normalized, cnr, cfg)
        gpx, gpy, tvals = gradation.gradation_curve(ghist, cfg)

    result: Dict[str, object] = {}
    if cfg.enable_clahe:
        # ENABLE_CLAHE grades the reconstruction itself, never the squared
        # image, into an output of its own; its histogram tests the
        # relevance inside the kernel (KH), so no relevance image is made
        with phase("clahe"):
            result["clahe_graded"] = clahe.clahe_grade_cnr(recon, normalized, cnr, cfg)

    # the tone map is elementwise, so cropping the graded image commutes
    with phase("tonemap"):
        graded, out_u8 = tonemap.tone_map(grad_input, gpx, gpy, cfg.out_margin)
    result.update({"graded": graded, "out_u8": out_u8, "recon": recon, "cnr": cnr})
    if want_intermediates:
        inter.update({
            "normalized": normalized,
            "relevant": relevant,
            "grad_hist": ghist,
            "grad_curve": (gpx, gpy, tvals),
            "sqrt_max": vmax, "sqrt_min": vmin,
        })
        if cfg.grad_with_linear_image:
            inter["linear"] = grad_input
        for i in cfg.analysis_levels:
            inter[f"noise_hist_{i}"] = hists[i]
        for i, b in enumerate(bandpass):
            inter[f"red_bandpass_{i}"] = b
        for i, d in enumerate(downs):
            inter[f"downsampled_{i}"] = d
        for i, sdv in sdevs.items():
            inter[f"sdev_{i}"] = sdv
        for i, mb in max_bins.items():
            inter[f"noise_max_bin_{i}"] = mb
        inter.update(stage)  # contrast_bandpass_*, nr_bandpass_*, contrast_curve_*
        result["intermediates"] = inter
    return result


def forward_batch(imgs_u16: torch.Tensor, cfg: MusicaConfig,
                  fused_sdev: bool = False) -> torch.Tensor:
    """[B, n, n] integer images -> [B, n-2m, n-2m] uint8, on their device,
    one image after another, eagerly."""
    return torch.stack([musica_forward(im, cfg, fused_sdev=fused_sdev)["out_u8"]
                        for im in imgs_u16])


def process_jit(img_u16: torch.Tensor, cfg: MusicaConfig,
                fused_sdev: bool = False) -> torch.Tensor:
    """One [n, n] integer image on its device -> the cropped uint8 image, a
    tensor of its own on that device: the replay of ``musica_forward``'s
    captured CUDA graph on a CUDA device, ``musica_forward`` on the CPU."""
    return process_batch_jit(img_u16[None], cfg, fused_sdev)[0]


def process_batch_jit(imgs_u16: torch.Tensor, cfg: MusicaConfig,
                      fused_sdev: bool = False) -> torch.Tensor:
    """[B, n, n] integer images -> [B, n-2m, n-2m] uint8, on their device:
    one graph replay an image, one image after another (``lax.map``'s order
    in the JAX package), each copied into its row of one output.  Equal to
    ``forward_batch`` bit for bit."""
    return graphs.run_batch(musica_forward, imgs_u16, cfg, fused_sdev)[0]


def to_device(imgs, device) -> torch.Tensor:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() "
                           "is False")
    return torch.as_tensor(np.asarray(imgs)).to(dev)


def process(img_u16, cfg: Optional[MusicaConfig], device,
            fused_sdev: bool = False) -> np.ndarray:
    """Host API mirroring the golden model's: one [n, n] uint16 array in,
    the cropped uint8 array out, computed on ``device`` by ``process_jit``."""
    img = to_device(img_u16, device)
    cfg = cfg or MusicaConfig(image_size=img.shape[-1])
    return process_jit(img, cfg, fused_sdev).cpu().numpy()


def process_batch(imgs_u16, cfg: Optional[MusicaConfig], device,
                  fused_sdev: bool = False) -> np.ndarray:
    """[B, n, n] uint16 array in, [B, n-2m, n-2m] uint8 out, on ``device``,
    by ``process_batch_jit``."""
    imgs = to_device(imgs_u16, device)
    cfg = cfg or MusicaConfig(image_size=imgs.shape[-1])
    return process_batch_jit(imgs, cfg, fused_sdev).cpu().numpy()


def timed_process(img_u16, cfg: Optional[MusicaConfig], device,
                  want_extras: bool = False, fused_sdev: bool = False):
    """Per-phase timed execution, the analogue of the reference's
    MEASURE_PROCESS (one fence per phase) and of the JAX package's
    ``timed_process``: the configured variant runs (``fused_sdev`` as in
    ``musica_forward``), each phase ends in a device synchronisation, so the
    timed run is slower than ``musica_forward`` and its ``out_u8`` is the
    same.

    Returns ``(out_u8, {norm, red, anly, aply, exp, grad, tot: ms})``; with
    ``want_extras`` also a dict of variant outputs as numpy arrays
    (``clahe_graded`` when ``cfg.enable_clahe``).  The input's copy to the
    device is not timed; the output's copy back is part of ``grad``."""
    img = to_device(img_u16, device)
    cfg = cfg or MusicaConfig(image_size=img.shape[-1])
    timer = _PhaseTimer(img.device)
    res = _forward(img, cfg, False, timer, fused_sdev)
    with timer("tonemap"):
        out = res["out_u8"].cpu().numpy()
        extras = ({"clahe_graded": res["clahe_graded"].cpu().numpy()}
                  if cfg.enable_clahe else {})
    times = dict(timer.times)
    times["tot"] = sum(times.values())
    if want_extras:
        return out, times, extras
    return out, times
