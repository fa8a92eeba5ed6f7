"""mfu.<mode>: the whole model's share of the card's bf16 peak over the
traced window: the forward's operations per image
(`flowbench.counts.forward_flops_per_image`) times the kind's factor (3 a
train step, recompute not counted; 1 a sampling call) times the
window's images, over its seconds, over 989 TFLOP/s a card.  The card's
name and power limit are printed beside it."""

import sys

from flowbench.counts import PEAK_BF16, forward_flops_per_image


def read(rec: dict, name: str) -> float | None:
    if rec["trace"] is None:
        return None
    ops = forward_flops_per_image(rec["glow"]) * rec["flops_factor"] * rec["images"]
    value = 100.0 * ops / rec["window_s"] / (PEAK_BF16 * rec["chips"])
    print(f"{name} {value!r} % on {rec['card']}, power limit {rec['power_limit']}",
          file=sys.stderr)
    return value
