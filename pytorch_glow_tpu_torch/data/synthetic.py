"""Deterministic synthetic image batches.

A numpy copy of `pytorch_glow_tpu/data/pipeline.py`'s synthetic source
(`_textured_images`, `_synthetic_batch`, `synthetic_batches`): for the same
seed and index the batches are byte for byte the JAX pipeline's.  The
`attr` family (data/synth_attrs.py) carries "attr" (B, 3) in ±1.  The
dataset dispatch is `data/pipeline.make_dataset`.
"""

from __future__ import annotations

import numpy as np

from pytorch_glow_tpu_torch.data.pipeline import (
    Batch,
    IndexedBatches,
    _process_rows,
)

SYNTHETIC_NAMES = {
    "synthetic": "uniform",
    "synthetic_smooth": "smooth",
    "synthetic_textured": "textured",
    "synthetic_attr": "attr",
}


def _textured_images(rng, batch_size: int, h: int, w: int, c: int) -> np.ndarray:
    """Multi-scale Gaussian textures with occluding rectangles and disks,
    plus mild sensor noise: real structure at several scales."""
    f32 = np.float32

    def unif(lo, hi, shape):
        return rng.random(shape, dtype=f32) * f32(hi - lo) + f32(lo)

    img = np.broadcast_to(unif(40, 215, (batch_size, 1, 1, c)), (batch_size, h, w, c)).copy()
    for k, amp in ((8, 55.0), (4, 30.0), (2, 15.0)):
        oh, ow = max(1, h // k), max(1, w // k)
        octave = rng.standard_normal((batch_size, oh, ow, c), dtype=f32)
        np.multiply(octave, f32(amp), out=octave)
        if h % oh == 0 and w % ow == 0:
            view = img.reshape(batch_size, oh, h // oh, ow, w // ow, c)
            view += octave[:, :, None, :, None, :]
        else:
            octave = octave.repeat(-(-h // oh), axis=1)[:, :h]
            octave = octave.repeat(-(-w // ow), axis=2)[:, :, :w]
            img += octave
    yy, xx = np.mgrid[0:h, 0:w].astype(f32)
    for _ in range(3):
        cy = unif(0, h, (batch_size, 1, 1))
        cx = unif(0, w, (batch_size, 1, 1))
        ry = unif(h / 8, h / 3, (batch_size, 1, 1))
        rx = unif(w / 8, w / 3, (batch_size, 1, 1))
        color = unif(0, 255, (batch_size, 1, 1, c))
        is_disk = rng.random((batch_size, 1, 1)) < 0.5
        dy = yy[None] - cy
        dy /= ry
        dx = xx[None] - cx
        dx /= rx
        inside_rect = np.abs(dy) < 0.8
        inside_rect &= np.abs(dx) < 0.8
        dy *= dy
        dx *= dx
        dy += dx
        inside_disk = dy < 1.0
        mask = np.where(is_disk, inside_disk, inside_rect)
        np.copyto(img, np.broadcast_to(color, img.shape), where=mask[..., None])
    img += f32(2.0) * rng.standard_normal(img.shape, dtype=f32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _synthetic_batch(i: int, batch_size: int, image_shape: tuple[int, int, int],
                     y_classes: int | None, seed: int, kind: str) -> Batch:
    """The i-th synthetic batch, derived from (seed, i) in O(1)."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, i)))
    h, w, c = image_shape
    if kind == "smooth":
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        yy, xx = yy / max(1, h - 1), xx / max(1, w - 1)
        base = rng.uniform(0, 255, size=(batch_size, 1, 1, c)).astype(np.float32)
        gy = rng.uniform(-80, 80, size=(batch_size, 1, 1, c)).astype(np.float32)
        gx = rng.uniform(-80, 80, size=(batch_size, 1, 1, c)).astype(np.float32)
        img = base + gy * yy[None, :, :, None] + gx * xx[None, :, :, None]
        img += rng.normal(0, 2.0, size=img.shape).astype(np.float32)
        image = np.clip(img, 0, 255).astype(np.uint8)
    elif kind == "textured":
        image = _textured_images(rng, batch_size, h, w, c)
    elif kind == "attr":
        from pytorch_glow_tpu_torch.data.synth_attrs import attr_images

        image, attrs = attr_images(rng, batch_size, h, w, c)
        return {"image": image, "attr": attrs}
    else:
        image = rng.integers(0, 256, size=(batch_size, h, w, c), dtype=np.uint8)
    batch: Batch = {"image": image}
    if y_classes:
        batch["label"] = rng.integers(0, y_classes, size=(batch_size,))
    return batch


def synthetic_batches(batch_size: int, image_shape: tuple[int, int, int],
                      y_classes: int | None = None, seed: int = 0,
                      kind: str = "uniform", shard: tuple[int, int] = (0, 1)) -> IndexedBatches:
    """Deterministic uint8 batches; infinite, O(1)-resumable.  kind
    "uniform" (noise, 8 bits/dim floor), "smooth" (colour gradients),
    "textured" (multi-scale textures with occluding shapes) or "attr"
    (three measurable binary attributes); row block `shard` = (i, n) of
    each batch."""
    pidx, pcount = shard
    lo, hi = _process_rows(batch_size, pidx, pcount)

    def batch_at(i: int) -> Batch:
        b = _synthetic_batch(i, batch_size, image_shape, y_classes, seed, kind)
        return {k: v[lo:hi] for k, v in b.items()} if pcount > 1 else b

    return IndexedBatches(batch_at)
