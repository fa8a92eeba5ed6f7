"""Image grids and PNG files, with numpy and the standard library only.

Counterpart of `pytorch_glow_tpu/utils/image.py` (`make_grid`,
`save_image_grid`).  The JAX package writes PNGs through Pillow; the port
writes them itself (`zlib` and `struct`), since Pillow may be missing where
the port runs.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type (grey, RGB, RGBA)


def make_grid(images: np.ndarray, ncol: int | None = None, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) uint8 -> one (GH, GW, C) uint8 grid image."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = ncol or int(math.ceil(math.sqrt(n)))
    nrow = int(math.ceil(n / ncol))
    grid = np.zeros((nrow * (h + pad) + pad, ncol * (w + pad) + pad, c), dtype=np.uint8)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0 : y0 + h, x0 : x0 + w] = images[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) uint8, C in {1, 3, 4} -> PNG bytes (8-bit,
    filter type 0 on every row)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"PNG image must be uint8, got {image.dtype}")
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, c = image.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"PNG image must have 1, 3 or 4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_image_grid(path: str, images: np.ndarray, ncol: int | None = None) -> None:
    """Write `make_grid(images, ncol)` to `path` as a PNG."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = encode_png(make_grid(images, ncol))
    with open(path, "wb") as f:
        f.write(data)
