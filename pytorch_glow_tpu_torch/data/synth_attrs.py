"""Synthetic images with measurable binary attributes: the offline proof
of the CelebA attribute-manipulation workflow.

A copy of `pytorch_glow_tpu/data/synth_attrs.py` (`attr_images`,
`measure_attributes`): for the same generator the images and attributes
are byte for byte the JAX package's.  Each of the three attributes has a
closed-form detector that is blind to the other two edits:

  bright       ±BRIGHT_DELTA on every channel, everywhere.
               Detector: mean of G,B over the border (outside the disk).
  red_tint     +RED_DELTA on the R channel only (when on).
               Detector: mean(R) − mean((G+B)/2) globally.
  center_disk  a gray disk (base + DISK_DELTA, all channels) of radius
               DISK_FRAC·min(H,W) at the image centre (when on).
               Detector: mean(centre) − mean(border).

Attributes are iid Bernoulli(1/2) per image, in ±1 as CelebA's are.
"""

from __future__ import annotations

import numpy as np

ATTR_NAMES = ["bright", "red_tint", "center_disk"]

BRIGHT_DELTA = 45.0  # ± on all channels → population score gap ≈ 90
RED_DELTA = 48.0  # + on R when on → gap ≈ 48
DISK_DELTA = 70.0  # disk gray offset → gap ≈ 70
DISK_FRAC = 0.25  # disk radius as a fraction of min(H, W)

# Expected detector-score gap (attr on minus attr off) per attribute.
ATTR_GAPS = np.array([2 * BRIGHT_DELTA, RED_DELTA, DISK_DELTA], np.float64)


def _disk_mask(h: int, w: int) -> np.ndarray:
    """Boolean (h, w): True inside the centered disk."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    r = DISK_FRAC * min(h, w)
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def attr_images(rng, batch_size: int, h: int, w: int, c: int):
    """(images uint8 (B,H,W,C), attrs ±1 int8 (B, 3)).

    Base: per-image mid-gray color + mild linear gradients + sensor noise
    (same regime as the `smooth` family — easily learnable by a small
    flow), then the three attribute edits above.
    """
    f32 = np.float32
    attrs = rng.random((batch_size, 3)) < 0.5  # (B, 3) bool

    yy, xx = np.mgrid[0:h, 0:w].astype(f32)
    yy, xx = yy / max(1, h - 1), xx / max(1, w - 1)
    base = rng.uniform(95, 160, size=(batch_size, 1, 1, c)).astype(f32)
    gy = rng.uniform(-25, 25, size=(batch_size, 1, 1, c)).astype(f32)
    gx = rng.uniform(-25, 25, size=(batch_size, 1, 1, c)).astype(f32)
    img = base + gy * yy[None, :, :, None] + gx * xx[None, :, :, None]

    bright = np.where(attrs[:, 0], f32(BRIGHT_DELTA), f32(-BRIGHT_DELTA))
    img += bright[:, None, None, None]
    if c >= 3:
        img[..., 0] += np.where(attrs[:, 1], f32(RED_DELTA), f32(0.0))[:, None, None]
    disk = _disk_mask(h, w)
    disk_on = attrs[:, 2][:, None, None] & disk[None]
    img += np.where(disk_on[..., None], f32(DISK_DELTA), f32(0.0))
    img += f32(2.0) * rng.standard_normal(img.shape, dtype=f32)
    images = np.clip(img, 0, 255).astype(np.uint8)
    return images, np.where(attrs, 1, -1).astype(np.int8)


def measure_attributes(images: np.ndarray) -> np.ndarray:
    """Closed-form detector scores (B, 3) for [bright, red_tint, center_disk].

    Each score responds ~1:1 to its attribute's pixel edit and is invariant
    to the other two edits (see module docstring).  Works on uint8 or float
    (B, H, W, C) arrays.
    """
    x = np.asarray(images, np.float64)
    b, h, w, c = x.shape
    disk = _disk_mask(h, w)
    border = ~disk
    if c >= 3:
        bright = x[:, border][:, :, 1:3].mean(axis=(1, 2))
        red = x[..., 0].mean(axis=(1, 2)) - x[..., 1:3].mean(axis=(1, 2, 3))
    else:
        bright = x[:, border].mean(axis=(1, 2))
        red = np.zeros(b)
    disk_score = x[:, disk].mean(axis=(1, 2)) - x[:, border].mean(axis=(1, 2))
    return np.stack([bright, red, disk_score], axis=1)
