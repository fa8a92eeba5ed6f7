"""Squeeze (space-to-depth) and channel split/cat, NHWC.

Counterpart of `pytorch_glow_tpu/ops/reshape.py`, with the same channel
order after `squeeze2d`: k = c * factor^2 + s1 * factor + s2.
"""

from __future__ import annotations

import torch


def squeeze2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/f, W/f, C*f^2)."""
    if factor == 1:
        return x
    b, h, w, c = x.shape
    if h % factor or w % factor:
        raise ValueError(f"squeeze2d: {(h, w)} not divisible by {factor}")
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (B, H/f, W/f, C, f, f)
    return x.reshape(b, h // factor, w // factor, c * factor * factor)


def unsqueeze2d(z: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Depth-to-space inverse of `squeeze2d`."""
    if factor == 1:
        return z
    b, h, w, c4 = z.shape
    c = c4 // (factor * factor)
    if c * factor * factor != c4:
        raise ValueError(f"unsqueeze2d: {c4} channels not divisible by {factor ** 2}")
    z = z.reshape(b, h, w, c, factor, factor)
    z = z.permute(0, 1, 4, 2, 5, 3)  # (B, H, f, W, f, C)
    return z.reshape(b, h * factor, w * factor, c)


def split_channel(x: torch.Tensor, mode: str = "simple") -> tuple[torch.Tensor, torch.Tensor]:
    """"simple": first half / second half; "cross": even / odd channels."""
    c = x.shape[-1]
    if mode in ("simple", "split"):
        return x[..., : c // 2], x[..., c // 2 :]
    if mode == "cross":
        return x[..., 0::2], x[..., 1::2]
    raise ValueError(f"unknown split mode: {mode}")


def cat_channel(a: torch.Tensor, b: torch.Tensor, mode: str = "simple") -> torch.Tensor:
    """Inverse of `split_channel`."""
    if mode in ("simple", "split"):
        return torch.cat([a, b], dim=-1)
    if mode == "cross":
        return torch.stack([a, b], dim=-1).reshape(*a.shape[:-1], 2 * a.shape[-1])
    raise ValueError(f"unknown split mode: {mode}")
