"""Sliced Wasserstein distance over Laplacian-pyramid patch descriptors.

A copy of `pytorch_glow_tpu/utils/swd.py` (numpy only, same defaults and
seeding, so the same arrays and seed give the same numbers bit for bit).

A sample-quality metric computable offline, with no pretrained feature
extractor, following the multi-scale SWD protocol of Karras et al. 2017
(Progressive GANs, arXiv:1710.10196 §5 / appendix A): per pyramid level,
extract 7x7 patch descriptors from real and generated sets,
channel-normalize each set, and estimate the Wasserstein-1 distance
between the two patch clouds by projecting onto random unit directions
and comparing sorted projections.

Lower is better; identical distributions give about 0.  Values are
reported x1e3 (the paper's convention).  It complements bits/dim: NLL
measures density fit, SWD whether samples match the data's patch
statistics at each scale.  Runs on the host, on uint8 batches the caller
already has.
"""

from __future__ import annotations

import numpy as np

_BLUR_1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _blur(x: np.ndarray) -> np.ndarray:
    """Separable 5-tap binomial blur over H and W of NHWC, reflect-padded."""
    pad = 2
    y = np.pad(x, ((0, 0), (pad, pad), (0, 0), (0, 0)), mode="reflect")
    out = np.zeros_like(x)
    for i, w in enumerate(_BLUR_1D):
        out += w * y[:, i : i + x.shape[1]]
    y = np.pad(out, ((0, 0), (0, 0), (pad, pad), (0, 0)), mode="reflect")
    out = np.zeros_like(x)
    for i, w in enumerate(_BLUR_1D):
        out += w * y[:, :, i : i + x.shape[2]]
    return out


def _pyr_down(x: np.ndarray) -> np.ndarray:
    return _blur(x)[:, ::2, ::2]


def _pyr_up(x: np.ndarray) -> np.ndarray:
    """2x nearest upsample followed by the binomial blur (smooth expand)."""
    up = np.repeat(np.repeat(x, 2, axis=1), 2, axis=2)
    return _blur(up)


def laplacian_pyramid(x: np.ndarray, min_size: int = 16) -> list[np.ndarray]:
    """Detail bands finest-first, plus the final low-pass base (>= min_size).

    x: float NHWC.  Each detail band keeps its level's resolution.
    """
    levels = []
    cur = x
    while min(cur.shape[1], cur.shape[2]) > min_size:
        down = _pyr_down(cur)
        levels.append(cur - _pyr_up(down))
        cur = down
    levels.append(cur)
    return levels


def _patch_descriptors(
    level: np.ndarray, patches_per_image: int, patch_size: int, rng: np.random.Generator
) -> np.ndarray:
    """(N * patches_per_image, patch_size**2 * C) random patches."""
    n, h, w, c = level.shape
    ph = min(patch_size, h)
    pw = min(patch_size, w)
    ys = rng.integers(0, h - ph + 1, size=(n, patches_per_image))
    xs = rng.integers(0, w - pw + 1, size=(n, patches_per_image))
    out = np.empty((n * patches_per_image, ph * pw * c), level.dtype)
    k = 0
    for i in range(n):
        img = level[i]
        for j in range(patches_per_image):
            out[k] = img[ys[i, j] : ys[i, j] + ph, xs[i, j] : xs[i, j] + pw].ravel()
            k += 1
    return out.reshape(n * patches_per_image, ph * pw, c)


def _normalize(desc: np.ndarray) -> np.ndarray:
    """Per-channel mean/std normalization across the whole patch set
    (each set normalized by its OWN statistics, as in the reference
    protocol — the metric then compares patch STRUCTURE, not raw gain)."""
    mean = desc.mean(axis=(0, 1), keepdims=True)
    std = desc.std(axis=(0, 1), keepdims=True) + 1e-8
    flat = (desc - mean) / std
    return flat.reshape(flat.shape[0], -1)


def _sliced_w1(
    a: np.ndarray, b: np.ndarray, n_projections: int, rng: np.random.Generator
) -> float:
    """Sliced Wasserstein-1 between two (n, d) descriptor clouds."""
    n = min(a.shape[0], b.shape[0])
    if a.shape[0] > n:
        a = a[rng.choice(a.shape[0], n, replace=False)]
    if b.shape[0] > n:
        b = b[rng.choice(b.shape[0], n, replace=False)]
    dirs = rng.standard_normal((a.shape[1], n_projections))
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True) + 1e-12
    pa = np.sort(a @ dirs, axis=0)
    pb = np.sort(b @ dirs, axis=0)
    return float(np.mean(np.abs(pa - pb)))


def sliced_wasserstein(
    real: np.ndarray,
    fake: np.ndarray,
    *,
    patches_per_image: int = 64,
    patch_size: int = 7,
    n_projections: int = 256,
    min_size: int = 16,
    seed: int = 0,
) -> dict[str, float]:
    """Multi-scale SWD between two uint8/float NHWC image sets.

    Returns {"swd_<res>": v, ..., "swd_avg": mean} with values x1e3.
    Patch locations, subsampling, and projection directions are drawn from
    one seeded generator — deterministic for fixed inputs + seed.
    """
    real = np.asarray(real, np.float32)
    fake = np.asarray(fake, np.float32)
    if real.shape[1:] != fake.shape[1:]:
        raise ValueError(f"shape mismatch: {real.shape} vs {fake.shape}")
    rng = np.random.default_rng(seed)
    pyr_r = laplacian_pyramid(real, min_size=min_size)
    pyr_f = laplacian_pyramid(fake, min_size=min_size)
    out: dict[str, float] = {}
    vals = []
    for lr, lf in zip(pyr_r, pyr_f):
        # One generator, but identical patch GEOMETRY draws per set so the
        # two clouds sample the same spatial process.
        geo_seed = rng.integers(0, 2**31)
        dr = _patch_descriptors(
            lr, patches_per_image, patch_size, np.random.default_rng(geo_seed)
        )
        df = _patch_descriptors(
            lf, patches_per_image, patch_size, np.random.default_rng(geo_seed)
        )
        v = _sliced_w1(_normalize(dr), _normalize(df), n_projections, rng) * 1e3
        out[f"swd_{lr.shape[1]}"] = v
        vals.append(v)
    out["swd_avg"] = float(np.mean(vals))
    return out
