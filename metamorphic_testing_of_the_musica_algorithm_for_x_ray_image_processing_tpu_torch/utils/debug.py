"""The debug surface of the PyTorch port, its own copy of the JAX package's
``utils/debug.py``:

* ``dump_intermediates``, the reference's ``debugProcess()``
  (src/vk_processing.cpp:2661-2809): every intermediate image as an 8-bit
  BMP, and the histogram and curve renders; it writes the JAX package's file
  set with identical bytes (``tests/test_torch_standalone.py``) and takes
  numpy arrays: the callers convert the port's tensors first;
* ``render_curve`` and ``render_histogram``, quick NumPy panels of a curve
  and a histogram;
* ``StageTimer``, per-phase wall timing fenced on the device, the analogue
  of the reference's MEASURE_PROCESS fences.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from . import render as render_shaders
from .io import save_bmp8, save_bmp_rgb


def numpy_tree(v):
    """A tensor, or a tuple of them, as numpy arrays (tuples kept as
    tuples), copied to the host; numpy has no bf16, so bf16 bands are upcast
    to float32 (exact), as the JAX package's dump upcasts its bf16 arrays."""
    if isinstance(v, tuple):
        return tuple(numpy_tree(x) for x in v)
    return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()


def cnr_u8(cnr: np.ndarray) -> np.ndarray:
    """The CNR map as the reference's CNR_DEBUG image
    (shaders/cnr_debug.comp): clip(cnr * 255, 0, 255) truncated to u8, the
    input format of ``mean-cnr``."""
    return np.clip(np.asarray(cnr, np.float32) * 255.0, 0, 255).astype(np.uint8)


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


def render_curve(px: np.ndarray, py: np.ndarray, y_max: float = 3.0,
                 width: int = 512, height: int = 128) -> np.ndarray:
    """Render a (px, py) LUT as a 512x128 panel
    (shaders/contrast_curve_render.comp)."""
    img = np.zeros((height, width, 3), np.uint8)
    gx = np.linspace(0, 1, width)
    gy = np.interp(gx, px, py, left=0.0, right=0.0)
    yy = np.clip(((1.0 - gy / y_max) * (height - 1)).astype(int), 0, height - 1)
    img[yy, np.arange(width)] = (255, 255, 255)
    # unit-gain line for orientation
    uy = int(np.clip((1.0 - 1.0 / y_max) * (height - 1), 0, height - 1))
    img[uy, ::4] = (90, 90, 90)
    return img


def render_histogram(hist: np.ndarray, curve=None, markers=(),
                     width: int = 512, height: int = 128) -> np.ndarray:
    """Render histogram bars (+ optional piecewise-linear curve and vertical
    t-markers) into a [height, width, 3] u8 image, the NumPy equivalent of
    shaders/noise_hist_render.comp / gradation_curve_debug_render.comp:
    black background, white bars scaled to the peak (peak bin green), red
    baseline, red tone curve, marker lines for t0/ta/t1."""
    img = np.zeros((height, width, 3), np.uint8)
    hist = np.asarray(hist, np.float64)
    n = len(hist)
    peak_val = hist.max()
    peak_bin = int(hist.argmax())
    xs = (np.arange(width) * n) // width
    bar_h = (hist[xs] * (height / (peak_val + 1.0))).astype(int)
    bar_h = np.minimum(bar_h, height - 1)
    for x in range(width):
        color = (0, 255, 0) if xs[x] == peak_bin and peak_val > 0 else (255, 255, 255)
        if bar_h[x] > 0:
            img[height - bar_h[x] - 1:height - 1, x] = color
    img[height - 1, :] = (255, 0, 0)  # baseline row, as the shader draws
    if curve is not None:
        px, py = np.asarray(curve[0]), np.asarray(curve[1])
        gx = np.linspace(0, 1, width)
        gy = np.interp(gx, px, py, left=0.0, right=0.0)
        yy = np.clip(((1.0 - gy) * (height - 1)).astype(int), 0, height - 1)
        img[yy, np.arange(width)] = (255, 40, 40)
    for t in markers:
        x = int(np.clip(t, 0, 1) * (width - 1))
        img[:, x] = (60, 60, 255)
    return img


class StageTimer:
    """Per-phase wall timing, the analogue of the reference's MEASURE_PROCESS
    fences (src/vk_processing.cpp:2580-2596): ``mark`` waits for the devices
    of the CUDA tensors it is given (``torch.cuda.synchronize``; the JAX
    package waits with ``block_until_ready``) and takes the time since the
    previous mark.  CPU tensors and other values need no fence."""

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self._last = time.perf_counter()

    def mark(self, name: str, *tensors) -> None:
        for dev in {t.device for t in tensors
                    if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        self.stages[name] = (now - self._last) * 1e3
        self._last = now

    def summary(self) -> str:
        total = sum(self.stages.values())
        parts = [f"{k}: {v:.2f}" for k, v in self.stages.items()]
        return " \t ".join(parts) + f" \t tot: {total:.2f} (ms)"
