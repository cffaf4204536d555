"""The debug dump of the PyTorch port (the reference's ``debugProcess()``,
src/vk_processing.cpp:2661-2809): every intermediate image as an 8-bit BMP,
and the histogram and curve renders.

The port's own copy of ``dump_intermediates`` from the JAX package's
``utils/debug.py``; it writes the same file set with identical bytes
(``tests/test_torch_standalone.py``).  It takes numpy arrays: the CLI
converts the port's tensors first.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from . import render as render_shaders
from .io import save_bmp8, save_bmp_rgb


def _to_u8(img: np.ndarray, scale: float, offset: float) -> np.ndarray:
    """float -> u8 like VulkanState::downloadAndSaveImage
    (src/vk_state.cpp:809-856): (v - offset) / (scale - offset) * 255."""
    v = (img.astype(np.float32) - offset) / (scale - offset)
    return np.clip(v * 255.0, 0, 255).astype(np.uint8)


def dump_intermediates(inter: Dict[str, object], out_dir: str) -> None:
    """Write every stage image as BMP, matching debugProcess's naming and
    normalization (bandpass-like images use [-1, 1] -> [0, 255], others
    [0, 1]); histogram/curve data is rendered into 512x128 debug images like
    the reference's render shaders (noise_hist.bmp, grad_hist.bmp)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for name, val in inter.items():
        if isinstance(val, tuple):
            continue
        arr = np.asarray(val)
        if arr.ndim != 2:
            continue
        signed = any(k in name for k in ("bandpass", "sdev_"))
        u8 = _to_u8(arr, 1.0, -1.0 if signed else 0.0)
        save_bmp8(out / f"{name}.bmp", u8)
    # histogram / curve renders: pixel-faithful transcriptions of the GLSL
    # render shaders (utils/render.py; noise_hist_render.comp dispatched at
    # src/vk_processing.cpp:2346-2350, gradation_curve_debug_render.comp at
    # :2507-2511; dumped as noise_hist.bmp / grad_hist.bmp by debugProcess,
    # src/vk_processing.cpp:2761-2808)
    cnr_key = None
    for k in inter:
        if k.startswith("noise_hist_"):
            cnr_key = k  # keep last (== cnr level when present)
    if cnr_key is not None:
        h = np.asarray(inter[cnr_key])
        save_bmp_rgb(out / "noise_hist.bmp",
                     render_shaders.render_noise_hist(
                         h, int(h.max()), int(h.argmax()))[..., :3])
    if "grad_hist" in inter and "grad_curve" in inter:
        gpx, gpy, tvals = inter["grad_curve"]
        h = np.asarray(inter["grad_hist"])
        save_bmp_rgb(out / "grad_hist.bmp",
                     render_shaders.render_gradation_curve_debug(
                         h, int(h.max()), int(h.argmax()),
                         np.asarray(gpx), np.asarray(gpy),
                         *(float(t) for t in tvals))[..., :3])
    # per-level contrast-curve renders (contrast_curve_render.comp ->
    # constrastCurveImageStates, one 512x128 panel per pyramid level)
    for name, val in inter.items():
        if name.startswith("contrast_curve_") and isinstance(val, tuple):
            px, py = (np.asarray(v) for v in val)
            save_bmp_rgb(out / f"{name}.bmp",
                         render_shaders.render_contrast_curve(px, py)[..., :3])
