"""The MUSICA pipeline on PyTorch.  Port of the JAX package's
``models/musica.py`` (``musica_forward``, ``process``, a batch entry).

PyTorch runs eagerly, so the function below is the schedule: each stage is
a handful of device ops, and the histograms go through the CUDA kernels of
``ops/cuda/fused_hist.py`` when the image is on a CUDA device.  Histogram
argmaxes, curve points and t0/ta/t1 stay on the device as small tensors:
nothing in ``musica_forward`` waits for the host.  Each phase is a
``torch.profiler`` span named ``musica.<phase>`` (no cost without a
profiler; scripts/profile_torch.py reads them).

Phase map (reference -> here):
  2. normalize        -> ops.normalize (sqrt + quirk-exact global max/min)
  3. pyramid reduce   -> ops.pyramid (fused smooth+decimate; polyphase expand)
  4. image analysis   -> ops.stats (sdev, noise histograms + argmax) + curves
  5. apply            -> ops.curves (contrast gain), ops.noise (CNR, NR)
  6. pyramid expand   -> ops.pyramid
  7. gradation        -> ops.gradation (relevance-weighted histogram, curve)
  output              -> margin crop + x255 truncating u8 cast
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import MusicaConfig
from ..ops import curves, gradation, noise, normalize, pyramid, stats


def _check_supported(cfg: MusicaConfig) -> None:
    if cfg.storage != "float32" or cfg.enable_clahe or cfg.grad_with_linear_image:
        raise NotImplementedError(
            "the PyTorch port runs float32 storage without CLAHE or linear "
            "gradation (storage=%r, enable_clahe=%r, grad_with_linear_image=%r)"
            % (cfg.storage, cfg.enable_clahe, cfg.grad_with_linear_image))


def musica_forward(img_u16: torch.Tensor, cfg: MusicaConfig,
                   want_intermediates: bool = False) -> Dict[str, object]:
    """Full MUSICA pass on one [n, n] integer image, on the image's device.

    Returns ``graded`` ([n, n] f32), ``out_u8`` (margin-cropped uint8),
    ``recon`` and ``cnr``; with ``want_intermediates`` also
    ``intermediates``, every stage under the JAX package's names."""
    _check_supported(cfg)
    n = cfg.image_size
    if tuple(img_u16.shape) != (n, n):
        raise ValueError(f"image {tuple(img_u16.shape)} != cfg.image_size {n}")
    L = cfg.pyramid_levels
    dev = img_u16.device
    inter: Dict[str, object] = {}

    # ---- phase 2: normalize -------------------------------------------------
    with record_function("musica.normalize"):
        normalized, vmax, vmin = normalize.normalize_from_u16(img_u16, cfg.quirks)

    # ---- phase 3: pyramid reduce -------------------------------------------
    with record_function("musica.reduce"):
        bandpass, downs = pyramid.reduce_ladder(normalized, L)

    # ---- phase 4: analysis --------------------------------------------------
    with record_function("musica.analysis"):
        sdevs = {i: stats.img_sdev(bandpass[i]) for i in cfg.analysis_levels}
        hists, max_bins = stats.analysis_noise_hists(sdevs, cfg)
        no_bin = torch.zeros((), dtype=torch.int32, device=dev)
        curve_list = [curves.contrast_curve(max_bins.get(i, no_bin), lcf, hcf, cfg)
                      for i, (lcf, hcf) in enumerate(cfg.contrast_factors)]

    # ---- phase 5: apply -----------------------------------------------------
    with record_function("musica.apply"):
        cnr = noise.img_cnr(sdevs[cfg.cnr_level], max_bins[cfg.cnr_level], cfg)
        exp_bandpass = []
        for i in range(L):
            px, py = curve_list[i]
            if i in sdevs:
                exp_bandpass.append(
                    curves.contrast_curve_apply(bandpass[i], sdevs[i], px, py))
            else:
                # sdev is never computed for these levels in the reference;
                # the flat 2-point curve gives a constant hcf gain
                exp_bandpass.append(bandpass[i] * cfg.contrast_factors[i][1])
        nr_bandpass: Dict[int, torch.Tensor] = {}
        for lvl in range(cfg.cnr_level):
            lo_c, lo_f, hi_c, hi_f = cfg.noise_reduction_params[lvl]
            nr_bandpass[lvl] = noise.noise_reduction(
                exp_bandpass[lvl], cnr, lo_c, lo_f, hi_c, hi_f, cfg)

    # ---- phase 6: pyramid expand -------------------------------------------
    # only levels < cnr_level - 1 consume the noise-reduced bandpass
    with record_function("musica.expand"):
        recon = downs[L - 1]
        for i in range(L):
            lvl = L - 1 - i
            low = pyramid.upsample_smooth(recon, bandpass[lvl].shape[-1])
            band = nr_bandpass[lvl] if lvl < cfg.cnr_level - 1 else exp_bandpass[lvl]
            recon = low + band
            if want_intermediates:
                inter[f"exp_lowpass_{i}"] = low

    # ---- phase 7: gradation -------------------------------------------------
    with record_function("musica.gradation"):
        if want_intermediates:
            # the relevance image itself is part of the dump
            relevant = noise.img_relevant(normalized, cnr, cfg)
            ghist = gradation.gradation_histogram(recon, relevant, cfg)
        else:
            ghist = gradation.gradation_histogram_fused_relevance(
                recon, normalized, cnr, cfg)
        gpx, gpy, tvals = gradation.gradation_curve(ghist, cfg)

    # the tone map is elementwise, so cropping the graded image commutes
    with record_function("musica.tonemap"):
        graded = curves.curve_get_y_general(gpx, gpy, recon)
        m = cfg.out_margin
        out_u8 = curves.curve_apply_u8(graded[m:n - m, m:n - m])
    result = {"graded": graded, "out_u8": out_u8, "recon": recon, "cnr": cnr}
    if want_intermediates:
        inter.update({
            "normalized": normalized,
            "relevant": relevant,
            "grad_hist": ghist,
            "grad_curve": (gpx, gpy, tvals),
            "sqrt_max": vmax, "sqrt_min": vmin,
        })
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
        for i, eb in enumerate(exp_bandpass):
            inter[f"contrast_bandpass_{i}"] = eb
        for lvl, nb in nr_bandpass.items():
            inter[f"nr_bandpass_{lvl}"] = nb
        for i, (px, py) in enumerate(curve_list):
            inter[f"contrast_curve_{i}"] = (px, py)
        result["intermediates"] = inter
    return result


def forward_batch(imgs_u16: torch.Tensor, cfg: MusicaConfig) -> torch.Tensor:
    """[B, n, n] integer images -> [B, n-2m, n-2m] uint8, on their device,
    one image after another."""
    return torch.stack([musica_forward(im, cfg)["out_u8"] for im in imgs_u16])


def to_device(imgs, device) -> torch.Tensor:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() "
                           "is False")
    return torch.as_tensor(np.asarray(imgs)).to(dev)


def process(img_u16, cfg: Optional[MusicaConfig], device) -> np.ndarray:
    """Host API mirroring the golden model's: one [n, n] uint16 array in,
    the cropped uint8 array out, computed on ``device``."""
    img = to_device(img_u16, device)
    cfg = cfg or MusicaConfig(image_size=img.shape[-1])
    return musica_forward(img, cfg)["out_u8"].cpu().numpy()


def process_batch(imgs_u16, cfg: Optional[MusicaConfig], device) -> np.ndarray:
    """[B, n, n] uint16 array in, [B, n-2m, n-2m] uint8 out, on ``device``."""
    imgs = to_device(imgs_u16, device)
    cfg = cfg or MusicaConfig(image_size=imgs.shape[-1])
    return forward_batch(imgs, cfg).cpu().numpy()
