"""Metamorphic input perturbations (the MRs) of the PyTorch port.

The port's own copy of the JAX package's ``testing/perturb.py``
(``test/metamorphic_test/script.py:49-141``), in NumPy, drawing from the
random generator in the same order, so that every perturbed raw is
byte-equal to the JAX package's for the same seed
(``tests/test_torch_harness.py``).  All functions take and return uint16
[n, n] arrays (the file-layout orientation, i.e. what ``save_raw`` writes).

The rotations do not use Pillow (the machines with the card do not have
it): ``rotate_nearest_u16`` and ``rotate_nearest_u8`` reproduce
``PIL.Image.rotate`` with its default nearest resampling bit for bit, on
the two paths Pillow takes (``libImaging/Geometry.c``): a float64 affine map
per pixel for 16-bit images, 16.16 fixed point for 8-bit ones.

Families and intensity schedules (script.py:383-657):
  * quantum (Poisson) noise, dose factors {0.1, 0.05, 0.025, 0.0125, 0.00625}
  * gaussian noise, sigma in {4, 16, 64, 256, 1024}
  * collimator shutters 200..1000 step 200 (outside = dose/100 + Poisson)
  * translation x/y 300..1500 step 300, 99th-percentile fill
  * rotation 9..45 deg step 9, 95th-percentile fill
"""

from __future__ import annotations

import math

import numpy as np

QUANTUM_FACTORS = (0.1, 0.05, 0.025, 0.0125, 0.00625)
GAUSSIAN_SIGMAS = (4.0, 16.0, 64.0, 256.0, 1024.0)
COLLIMATOR_SHUTTERS = (200, 400, 600, 800, 1000)
TRANSLATIONS = (300, 600, 900, 1200, 1500)
ROTATIONS = (9, 18, 27, 36, 45)


def _scaled(vals, size: int, base: int = 3072):
    """Scale pixel-count schedules for smaller-than-reference images."""
    if size == base:
        return tuple(vals)
    return tuple(max(1, int(round(v * size / base))) for v in vals)


def apply_quantum_noise(img: np.ndarray, scale_factor: float = 1.0,
                        rng=None) -> np.ndarray:
    """Poisson noise at a dose scale (script.py:49-58)."""
    rng = rng or np.random.default_rng(0)
    scaled = img.astype(np.float64) * scale_factor
    noisy = rng.poisson(scaled).astype(np.float32) / scale_factor
    return np.clip(noisy, 0, np.iinfo(np.uint16).max).astype(np.uint16)


def add_gaussian_noise(img: np.ndarray, mean: float, sigma: float,
                       rng=None) -> np.ndarray:
    """Additive gaussian noise (script.py:60-66)."""
    rng = rng or np.random.default_rng(0)
    noise = rng.normal(mean, sigma, img.shape).astype(np.int32)
    return np.clip(img.astype(np.int32) + noise, 0, 65535).astype(np.uint16)


def apply_collimator(img: np.ndarray, shutter_h: int, shutter_v: int,
                     rng=None) -> np.ndarray:
    """Simulated collimation (script.py:75-95): outside the shutter window the
    dose drops to 1/100 with Poisson statistics."""
    rng = rng or np.random.default_rng(0)
    low = apply_quantum_noise((img / 100.0).astype(np.uint16), 1.0, rng)
    out = low.copy()
    out[shutter_v:img.shape[0] - shutter_v,
        shutter_h:img.shape[1] - shutter_h] = \
        img[shutter_v:img.shape[0] - shutter_v,
            shutter_h:img.shape[1] - shutter_h]
    return out


def clamp_translation(img: np.ndarray, x_shift: int = 0, y_shift: int = 0) -> np.ndarray:
    """Translate with 99th-percentile fill (script.py:97-120).

    The reference crops a `margin`-trimmed copy, estimates the fill from a
    small bright corner patch, then pastes at the shift offset.
    """
    margin = 10
    bright = 2
    h, w = img.shape
    left = margin if x_shift > 0 else 0
    right = w - margin if x_shift < 0 else w
    top = margin if y_shift > 0 else 0
    bottom = h - margin if y_shift < 0 else h
    cropped = img[top:bottom, left:right]

    b_right = margin + bright if x_shift > 0 else w
    b_bottom = margin + bright if y_shift > 0 else h
    patch = img[top:b_bottom, left:b_right]
    fill = int(np.percentile(patch, 99))

    out = np.full_like(img, fill)
    y0, x0 = y_shift, x_shift
    ys = slice(max(0, y0), min(h, y0 + cropped.shape[0]))
    xs = slice(max(0, x0), min(w, x0 + cropped.shape[1]))
    out[ys, xs] = cropped[: ys.stop - ys.start, : xs.stop - xs.start]
    return out


def _rotation_matrix(w: int, h: int, degree: float):
    """The inverse affine map (destination -> source) that
    ``PIL.Image.rotate`` builds, about the centre (w/2, h/2), its entries
    rounded to 15 places, in Pillow's operation order."""
    angle = -math.radians(degree)
    a = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
         round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]
    cx, cy = w / 2, h / 2
    a[2] = a[0] * -cx + a[1] * -cy + a[2]
    a[5] = a[3] * -cx + a[4] * -cy + a[5]
    a[2] += cx
    a[5] += cy
    return a


def _transposed(img: np.ndarray, degree: float):
    """Pillow's fast paths: a copy at 0 degrees, a transpose at 180, and at
    90 and 270 where the image is square; None where it maps pixels."""
    angle = degree % 360.0
    if angle == 0:
        return img.copy()
    if angle == 180:
        return img[::-1, ::-1].copy()
    if angle in (90, 270) and img.shape[0] == img.shape[1]:
        return np.rot90(img, 1 if angle == 90 else -1).copy()
    return None


def rotate_nearest_u16(img: np.ndarray, degree: float, fillcolor: int = 0) -> np.ndarray:
    """``np.array(Image.fromarray(img).rotate(degree, fillcolor=fillcolor))``
    for a uint16 [h, w] image (Pillow mode ``I;16``), without Pillow: for
    each output pixel (x, y) the source point of (x + 0.5, y + 0.5) in
    float64, each coordinate truncated toward zero (negatives to -1); a
    source outside the image gives ``fillcolor``."""
    img = np.asarray(img, np.uint16)
    same = _transposed(img, degree)
    if same is not None:
        return same
    h, w = img.shape
    a = _rotation_matrix(w, h, degree)
    xin = np.arange(w, dtype=np.float64)[None, :] + 0.5
    yin = np.arange(h, dtype=np.float64)[:, None] + 0.5
    xx = a[0] * xin + a[1] * yin + a[2]
    yy = a[3] * xin + a[4] * yin + a[5]
    sx = np.where(xx < 0.0, -1, np.trunc(xx)).astype(np.int64)
    sy = np.where(yy < 0.0, -1, np.trunc(yy)).astype(np.int64)
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = np.full((h, w), fillcolor, np.uint16)
    out[inside] = img[sy[inside], sx[inside]]
    return out


def rotate_nearest_u8(img: np.ndarray, degree: float) -> np.ndarray:
    """``np.array(Image.fromarray(img).rotate(degree))`` for a uint8 [h, w]
    image (Pillow mode ``L``), without Pillow: Pillow's 16.16 fixed-point
    map, ``FIX(v) = floor(v * 65536 + 0.5)``, the source column of output
    pixel (x, y) ``(a2 + y * a1 + x * a0) >> 16`` with the half-pixel offset
    folded into a2 (and the row likewise); a source outside the image gives
    0."""
    img = np.asarray(img, np.uint8)
    same = _transposed(img, degree)
    if same is not None:
        return same
    h, w = img.shape
    a = _rotation_matrix(w, h, degree)
    corners = ((0, 0), (w, h), (0, h), (w, 0))
    if not all(abs(a[0] * x + a[1] * y + a[2]) < 32768.0
               and abs(a[3] * x + a[4] * y + a[5]) < 32768.0 for x, y in corners):
        raise ValueError(f"{w}x{h}: outside the range of Pillow's fixed-point map")

    def fix(v):
        return math.floor(v * 65536.0 + 0.5)

    a0, a1, a3, a4 = fix(a[0]), fix(a[1]), fix(a[3]), fix(a[4])
    a2 = fix(a[2] + a[1] * 0.5 + a[0] * 0.5)
    a5 = fix(a[5] + a[4] * 0.5 + a[3] * 0.5)
    x = np.arange(w, dtype=np.int64)[None, :]
    y = np.arange(h, dtype=np.int64)[:, None]
    sx = (a2 + y * a1 + x * a0) >> 16
    sy = (a5 + y * a4 + x * a3) >> 16
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = np.zeros((h, w), np.uint8)
    out[inside] = img[sy[inside], sx[inside]]
    return out


def clamp_rotate(img: np.ndarray, degree: float) -> np.ndarray:
    """Rotate with 95th-percentile fill after 100-px margin crop
    (script.py:122-141), nearest resampling as the harness's Pillow call
    (``rotate_nearest_u16``).

    The reference's margin is a fixed 100 px (it only ever saw 3072² inputs);
    on tiny campaign sizes that would empty the crop, so it is clamped to
    keep at least a 2x2 interior — sizes >= 202 behave exactly as the
    reference."""
    margin = min(100, (min(img.shape) - 2) // 2)
    cropped = img[margin:img.shape[0] - margin, margin:img.shape[1] - margin]
    fill = int(np.percentile(cropped, 95))
    rot = rotate_nearest_u16(cropped, degree, fillcolor=fill)
    out = np.full_like(img, fill)
    out[margin:margin + rot.shape[0], margin:margin + rot.shape[1]] = rot
    return out


def inner_rect_after_rotation(w: int, h: int, degree: float):
    """Largest axis-aligned inner rectangle after rotation, as computed by the
    harness for registration-normalized comparison (script.py:583-599)."""
    rad = math.radians(degree)
    new_w = w * abs(math.cos(rad)) + h * abs(math.sin(rad))
    new_h = h * abs(math.cos(rad)) + w * abs(math.sin(rad))
    inner_w = w * h / new_h if w < h else h * w / new_w
    inner_h = h * w / new_w if w < h else w * h / new_h
    left = (w - inner_w) / 2
    top = (h - inner_h) / 2
    return int(left), int(top), int((w + inner_w) / 2), int((h + inner_h) / 2)
