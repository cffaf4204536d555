"""Raw / BMP image IO of the PyTorch port.

The port's own copy of the JAX package's ``utils/io.py``, its NumPy paths
only (the port does not load the optional C++ codec under ``native/``, whose
files are byte-identical to these).  The tests hold both writers to
byte-identical files and both readers to equal arrays
(``tests/test_torch_standalone.py``).

Formats, as the reference writes and reads them:

* **Raw radiograph**: 256-byte header + ``size*size`` little-endian uint16
  (``test/standalone/main.cpp:57-75``, ``test/metamorphic_test/script.py:26-47``).
  The standalone CLI loads the row-major file into ``pixels[x*size + y]``,
  i.e. it processes the *transpose* of the file layout; ``load_raw`` exposes
  that via ``transpose=True`` (the CLI parity default).

* **8-bit single-channel BMP** output (written by stb_image_write in the
  reference, ``src/vk_processing.cpp:2636``), expanded to 24-bit BGR as stb
  does.

The readers and the in-memory encoder (``bmp_bytes``, the viewer's) are
NumPy too, where the JAX package uses Pillow: the machines with the card
have no Pillow.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

RAW_HEADER_BYTES = 256


def load_raw(path: str | os.PathLike, size: int = 3072,
             transpose: bool = True) -> np.ndarray:
    """Load a 256-byte-header little-endian uint16 raw radiograph.

    ``transpose=True`` reproduces the standalone CLI's de-interleave
    (``test/standalone/main.cpp:67-75``: ``pixels[x*size+y]`` from a row-major
    scan), so the returned array's axis 0 is the shader's ``x``.
    """
    data = np.fromfile(path, dtype=np.uint8)
    expected = RAW_HEADER_BYTES + size * size * 2
    if data.size != expected:
        raise ValueError(
            f"raw file {path}: {data.size} bytes, expected {expected} "
            f"(256-byte header + {size}x{size} uint16)")
    img = data[RAW_HEADER_BYTES:].view("<u2").reshape(size, size)
    return img.T.copy() if transpose else img.copy()


def load_raw_batch(paths, size: int = 3072, transpose: bool = True) -> np.ndarray:
    """Load many raws into one [B, size, size] array."""
    return np.stack([load_raw(p, size, transpose) for p in paths])


def save_raw(path: str | os.PathLike, img_u16: np.ndarray,
             transpose: bool = False) -> None:
    """Write the 256-byte-header raw format (header zero-filled, matching the
    harness's ``save_image``, ``test/metamorphic_test/script.py:38-47``)."""
    img = np.asarray(img_u16, dtype="<u2")
    if transpose:
        img = img.T
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x00" * RAW_HEADER_BYTES)
        f.write(np.ascontiguousarray(img).tobytes())


def save_bmp8(path: str | os.PathLike, img_u8: np.ndarray) -> None:
    """Write a single-channel uint8 image as BMP.

    stb_image_write expands 1-channel data to 24-bit BGR; so does this, so
    outputs are byte-compatible with the reference's BMPs when pixel values
    match.  ``img_u8`` is indexed [x, y] (shader convention); BMP rows are
    written bottom-up with y as the row, x as the column.
    """
    img = np.asarray(img_u8, dtype=np.uint8)
    _write_bmp24(path, np.repeat(img[..., None], 3, axis=-1))


def save_bmp_rgb(path: str | os.PathLike, img_rgb: np.ndarray) -> None:
    """Write an [h, w, 3] uint8 RGB image as 24-bit BMP (the histogram and
    curve debug renders)."""
    _write_bmp24(path, np.asarray(img_rgb, np.uint8))


def bmp_bytes(img_u8: np.ndarray) -> bytes:
    """An [h, w] u8 or [h, w, 3|4] rgb(a) image as the bytes of a 24-bit
    BMP file (a 4th channel is dropped), as ``save_bmp8`` and
    ``save_bmp_rgb`` write it."""
    img = np.asarray(img_u8, np.uint8)
    rgb = np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img[..., :3]
    return _bmp24(rgb)


def _write_bmp24(path, rgb: np.ndarray) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_bmp24(rgb))


def _bmp24(rgb: np.ndarray) -> bytes:
    h, w = rgb.shape[:2]
    row_bytes = w * 3
    pad = (-row_bytes) % 4
    data_size = (row_bytes + pad) * h
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM", 14 + 40 + data_size, 0, 0, 14 + 40,
        40, w, h, 1, 24, 0, data_size, 0, 0, 0, 0)
    body = bytearray()
    padding = b"\x00" * pad
    for row in range(h - 1, -1, -1):
        bgr = rgb[row][:, ::-1]  # BMP stores BGR
        body += np.ascontiguousarray(bgr).tobytes() + padding
    return header + bytes(body)


def load_bmp(path: str | os.PathLike) -> np.ndarray:
    """Read an uncompressed 8-, 24- or 32-bit BMP as a uint8 grayscale array
    [rows, cols], as the JAX package's reader does with Pillow's
    ``convert("L")`` (L = (19595 R + 38470 G + 7471 B + 2^15) >> 16)."""
    rgb = load_bmp_rgb(path).astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def load_bmp_rgb(path: str | os.PathLike) -> np.ndarray:
    """Read an uncompressed 8-, 24- or 32-bit BMP as a uint8 RGB array
    [rows, cols, 3], as the JAX package's reader does with Pillow's
    ``convert("RGB")``."""
    data = np.fromfile(path, dtype=np.uint8).tobytes()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    offset, dib = struct.unpack_from("<II", data, 10)
    w, h, _, bpp, compression = struct.unpack_from("<iiHHI", data, 18)
    if bpp not in (8, 24, 32) or compression not in (0, 3) or (compression == 3 and bpp != 32):
        raise ValueError(f"{path}: {bpp}-bit BMP with compression {compression} is not read")
    rows, stride = abs(h), (w * bpp // 8 + 3) // 4 * 4
    px = np.frombuffer(data, np.uint8, rows * stride, offset).reshape(rows, stride)
    if h > 0:  # stored bottom-up
        px = px[::-1]
    if bpp == 8:
        colours = struct.unpack_from("<I", data, 46)[0] or 256
        palette = np.frombuffer(data, np.uint8, 4 * colours, 14 + dib).reshape(colours, 4)
        bgr = palette[px[:, :w]][..., :3]
    else:
        bgr = px[:, :w * bpp // 8].reshape(rows, w, bpp // 8)[..., :3]
    return np.ascontiguousarray(bgr[..., ::-1])
