"""Pixel-faithful transcriptions of the 5 GLSL debug-render shaders.

The port's own copy of the JAX package's ``utils/render.py``: the debug dump
draws ``render_noise_hist``, ``render_gradation_curve_debug`` and
``render_contrast_curve``, the viewer also ``render_gradation_curve``, and
``render_img_histogram`` completes the set (its dispatch is commented out in
the reference, src/vk_processing.cpp:2306).  The dump's files are held
byte-identical to the JAX package's (``tests/test_torch_standalone.py``),
every render array-equal (``tests/test_torch_report.py``).

The reference renders histograms and curves into 512x128 rgba8 images
(``histRenderWidth/Height``, include/vk_processing.h:31-32).  These are
host-side debug ops (1 x 512 threads in the reference), so NumPy is the
right tool; every store, store *order*, uint conversion and out-of-bounds
drop is transcribed exactly, including:

* the ``barHeight == imageSize.y`` uint-underflow quirk: ``startY`` wraps to
  2^32-1 and the bar loop never executes (noise_hist_render.comp:54-56);
* ``gradation_curve_debug_render``'s bottom red pixel being overwritten by
  the black else-branch of the full-column loop;
* robust-access ``imageStore`` drops for y >= 128 (the t-marker loops run
  ``i < imageSize.x`` = 512 over a 128-high image,
  gradation_curve_debug_render.comp:104-123).

All functions return [128, 512, 4] uint8 RGBA (vec4(1,0,0,1) -> 255,0,0,255).
"""

from __future__ import annotations

import numpy as np

W, H = 512, 128  # histRenderWidth / histRenderHeight

BLACK = (0, 0, 0, 255)
WHITE = (255, 255, 255, 255)
RED = (255, 0, 0, 255)
GREEN = (0, 255, 0, 255)
BLUE = (0, 0, 255, 255)
YELLOW = (255, 255, 0, 255)
MAGENTA = (255, 0, 255, 255)


def _bar_height(value: int, max_value: int) -> int:
    """uint(float(value) * (float(H) / float(maxValue + 1))), clipped to
    H - 1 only when strictly greater than H (noise_hist_render.comp:52-53).

    Returns -1 for the barHeight == H case: startY = H - barHeight - 1
    underflows to 2^32 - 1 and the uint bar loop never runs.
    """
    bar = int(np.float32(value) * (np.float32(H) / np.float32(max_value + 1)))
    if bar > H:
        bar = H - 1
    if bar == H:
        return -1  # startY uint-underflow: bar loop body unreachable
    return bar


def _store(img: np.ndarray, x: int, y: int, color) -> None:
    """imageStore with robust-access OOB drop."""
    if 0 <= x < W and 0 <= y < H:
        img[y, x] = color


def render_noise_hist(hist: np.ndarray, max_value: int, max_bin: int,
                      ) -> np.ndarray:
    """shaders/noise_hist_render.comp:17-76.

    positionConversionFactor is hardcoded 1.0 (:19), so only bins [0, 512)
    of the 2048-bin noise histogram are shown.  Per column x: clear the
    column black, set the bottom pixel red, then draw the bar (green for the
    column containing max_bin, white otherwise) from
    ``startY = H - barHeight - 1`` for ``barHeight`` rows -- the bar never
    reaches row H-1, so the red baseline survives.
    """
    img = np.zeros((H, W, 4), np.uint8)
    hist = np.asarray(hist)
    for x in range(W):
        bin_pos = x  # uint(invocationPos * 1.0)
        value = int(hist[bin_pos])
        bar = _bar_height(value, max_value)
        img[:, x] = BLACK                      # full-column clear (:62-64)
        _store(img, x, H - 1, RED)             # baseline pixel (:66)
        if bar < 0:
            continue
        start_y = H - bar - 1
        # barWidth == 1: the x loop is a single iteration (:68)
        is_peak = (bin_pos <= max_bin) and (bin_pos + 1.0 > max_bin)
        color = GREEN if is_peak else WHITE
        for y in range(start_y, start_y + bar):
            _store(img, x, y, color)
    return img


def render_img_histogram(hist: np.ndarray, max_value: int, max_bin: int,
                         background: np.ndarray | None = None) -> np.ndarray:
    """shaders/img_histogram_render.comp:17-56 (compiled, dispatch commented
    out at src/vk_processing.cpp:2306).

    factor = 1024 / 512 = 2: column x samples bin 2x of the 1024-bin
    gradation histogram.  No background clear -- the writeonly rgba8 image
    keeps stale contents (``background``, default zeros).  Peak column is
    magenta when max_bin is in [2x, 2x + 2).
    """
    img = (np.zeros((H, W, 4), np.uint8) if background is None
           else background.copy())
    hist = np.asarray(hist)
    factor = np.float32(1024.0 / 512.0)
    for x in range(W):
        bin_pos = int(np.float32(x) * factor)
        value = int(hist[bin_pos])
        bar = _bar_height(value, max_value)
        _store(img, x, H - 1, RED)
        if bar < 0:
            continue
        start_y = H - bar - 1
        is_peak = (bin_pos <= max_bin) and (bin_pos + float(factor) > max_bin)
        color = MAGENTA if is_peak else WHITE
        for y in range(start_y, start_y + bar):
            _store(img, x, y, color)
    return img


def _get_y_f32(px: np.ndarray, py: np.ndarray, x: float) -> np.float32:
    """The render shaders' getY walk in f32
    (gradation_curve_debug_render.comp:37-46): first exact-x match, else the
    first bracketing segment's linear function evaluated at ``x - p1.x``;
    points[count] reads the next (zeroed) buffer slot.
    """
    px = np.asarray(px, np.float32)
    py = np.asarray(py, np.float32)
    n = len(px)
    x = np.float32(x)
    for i in range(n):
        if px[i] == x:
            return py[i]
        nx = px[i + 1] if i + 1 < n else np.float32(0.0)
        ny = py[i + 1] if i + 1 < n else np.float32(0.0)
        if px[i] <= x and nx >= x:
            with np.errstate(divide="ignore", invalid="ignore"):
                m = (ny - py[i]) / (nx - px[i])
            return np.float32(m * (x - px[i]) + py[i])
    return np.float32(0.0)


def render_gradation_curve_debug(hist: np.ndarray, max_value: int,
                                 max_bin: int, px: np.ndarray,
                                 py: np.ndarray, t0: float, ta: float,
                                 t1: float) -> np.ndarray:
    """shaders/gradation_curve_debug_render.comp:49-123 -- the gradation
    panel that actually renders each frame (src/vk_processing.cpp:2507-2511).

    Per column x: histogram bar for bin 2x over a black else-branch that
    covers the WHOLE column -- including row H-1, so the red baseline pixel
    stored just before is always overwritten (:79-92).  Then the t0 (red),
    ta (green), t1 (red) marker columns (loop bound 512 with OOB drops), and
    finally the blue curve pixel.
    """
    img = np.zeros((H, W, 4), np.uint8)
    hist = np.asarray(hist)
    factor = np.float32(1024.0 / 512.0)
    inv_bins = np.float32(1.0) / np.float32(512.0)
    for x in range(W):
        bin_pos = int(np.float32(x) * factor)
        value = int(hist[bin_pos])
        bar = _bar_height(value, max_value)
        _store(img, x, H - 1, RED)  # immediately painted over below (:77)
        start_y = H - bar - 1 if bar >= 0 else None
        is_peak = (bin_pos <= max_bin) and (bin_pos + float(factor) > max_bin)
        for y in range(H):
            if start_y is not None and start_y <= y < start_y + bar:
                img[y, x] = MAGENTA if is_peak else WHITE
            else:
                img[y, x] = BLACK
        # curve overlay
        curve_pos = np.float32(x) * inv_bins
        pos_x = int(curve_pos * np.float32(512.0) * np.float32(1.0))
        gy = _get_y_f32(px, py, curve_pos)
        pos_y = (H - 1) - int(np.float32(gy) * np.float32(H - 1))
        nxt = np.float32(x + 1) * inv_bins
        if curve_pos <= t0 < nxt:
            for i in range(W):       # i runs to 512; y >= 128 stores dropped
                _store(img, pos_x, i, RED)
        if curve_pos <= ta < nxt:
            for i in range(W):
                _store(img, pos_x, i, GREEN)
        if curve_pos <= t1 < nxt:
            for i in range(W):
                _store(img, pos_x, i, RED)
        _store(img, pos_x, pos_y, BLUE)
    return img


def render_gradation_curve(px: np.ndarray, py: np.ndarray, t0: float,
                           ta: float, t1: float,
                           background: np.ndarray | None = None) -> np.ndarray:
    """shaders/gradation_curve_render.comp:40-74 (compiled, not dispatched;
    the viewer's ``grad_curve`` panel).

    Standalone curve panel: t0/t1 red and ta YELLOW marker columns, then the
    white curve pixel.  No background clear (stale contents preserved).
    """
    img = (np.zeros((H, W, 4), np.uint8) if background is None
           else background.copy())
    inv_bins = np.float32(1.0) / np.float32(512.0)
    for x in range(W):
        curve_pos = np.float32(x) * inv_bins
        pos_x = int(curve_pos * np.float32(512.0) * np.float32(1.0))
        gy = _get_y_f32(px, py, curve_pos)
        pos_y = (H - 1) - int(np.float32(gy) * np.float32(H - 1))
        nxt = np.float32(x + 1) * inv_bins
        if curve_pos <= t0 < nxt:
            for i in range(W):
                _store(img, pos_x, i, RED)
        if curve_pos <= ta < nxt:
            for i in range(W):
                _store(img, pos_x, i, YELLOW)
        if curve_pos <= t1 < nxt:
            for i in range(W):
                _store(img, pos_x, i, RED)
        _store(img, pos_x, pos_y, WHITE)
    return img


def render_contrast_curve(px: np.ndarray, py: np.ndarray,
                          background: np.ndarray | None = None) -> np.ndarray:
    """shaders/contrast_curve_render.comp:13-31 (compiled, dispatch commented
    out at src/vk_processing.cpp:2322, "PERF: 0.40ms").

    The shader binds the contrast-curve POINT buffer but declares it as
    ``float curve[32]`` -- it plots the raw float view of the buffer, i.e.
    the first 16 (x, y) points interleaved, scaled by MAX_CURVE_VALUE = 4.
    32 sparse columns (x = 16 * thread): a red reference dot at
    y = uint(128 * 3/4) = 96, then the white value dot at
    ``y = 128 - uint(value * 32)`` -- value < 1/32 (including the zero
    padding) lands at y = 128 and is dropped by robust access.
    """
    img = (np.zeros((H, W, 4), np.uint8) if background is None
           else background.copy())
    floats = np.zeros(32, np.float32)
    inter = np.empty(2 * len(px), np.float32)
    inter[0::2] = np.asarray(px, np.float32)
    inter[1::2] = np.asarray(py, np.float32)
    floats[:min(32, len(inter))] = inter[:32]
    for t in range(32):
        value = floats[t]
        pos_x = int(np.float32(t) * (np.float32(W) / np.float32(32.0)))
        _store(img, pos_x,
               int(np.float32(H) * (np.float32(3.0) / np.float32(4.0))), RED)
        pos_y = H - int(value * (np.float32(H) / np.float32(4.0))) \
            if value >= 0 else None
        if pos_y is not None:
            _store(img, pos_x, pos_y, WHITE)
    return img
