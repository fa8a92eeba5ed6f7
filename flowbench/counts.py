"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the card's published peaks, a Glow forward's operations
per image, and the least time of one flow-step chain call.

`forward_flops_per_image` is a copy of the port's
`utils/summary.forward_flops_per_image`, and `bound_ms` of its
`ops/flowstep.bound_ms` (its operations and bytes); the tests in
`flowbench/tests/test_fb_counts.py` hold both equal to the port's at every
level of the benchmark's configurations.  Both take a configuration's
"glow" section as a plain dict.
"""

from __future__ import annotations

# Published NVIDIA H100 SXM peaks (data sheet, dense, at the 700 W limit).
PEAK_BF16 = 989e12  # FLOP/s, bf16 tensor cores
PEAK_F32 = 67e12  # FLOP/s, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # bytes/s, HBM3


def latent_shapes(glow: dict) -> list[tuple[int, int, int]]:
    """(H, W, C) each level's K steps see: squeezed, half split off below."""
    h, w, c = glow["image_shape"]
    shapes = []
    for i in range(glow["L"]):
        h, w, c = h // 2, w // 2, c * 4
        shapes.append((h, w, c))
        if i < glow["L"] - 1:
            c //= 2
    return shapes


def _cout(c: int, affine: bool) -> int:
    return c if affine else c // 2


def forward_flops_per_image(glow: dict) -> int:
    """2 * MACs of one forward pass: the coupling nets' three convs and the
    1x1 mixes; elementwise work is left out."""
    total = 0
    hidden = glow["hidden_channels"]
    affine = glow["flow_coupling"] == "affine"
    for h, w, c in latent_shapes(glow):
        per_pixel = 9 * (c // 2) * hidden + hidden * hidden + 9 * hidden * _cout(c, affine)
        if glow["flow_permutation"] == "invconv":
            per_pixel += c * c
        total += 2 * glow["K"] * h * w * per_pixel
    return total


def chain_counts(kind: str, b: int, h: int, w: int, c: int, hidden: int,
                 affine: bool) -> tuple[float, float, float]:
    """(bf16 operations, f32 operations, compulsory bytes) of one chain call
    ("forward", "reverse" or "backward") over a (b, h, w, c) activation.
    The backward recomputes the net and forms two more products a layer;
    bytes count each input read once and each output written once."""
    m, ch = b * h * w, c // 2
    cout = _cout(c, affine)
    net_w = hidden * (9 * ch + hidden + 9 * cout)
    vec = c * c + 2 * c + 4 * hidden + 2 * cout
    net = 2 * m * net_w
    weight_bytes = 4 * vec + 2 * net_w
    if kind == "backward":  # z, g_zn in, g_z out; g_ld in; 12 f32 grads out
        return 3 * net, 12 * m * c * c, 3 * 4 * m * c + 4 * b + weight_bytes + 4 * (vec + net_w)
    return net, 2 * m * c * c, 2 * 4 * m * c + 4 * b + weight_bytes  # z in, z out, logdet out


def bound_ms(kind: str, b: int, h: int, w: int, c: int, hidden: int,
             affine: bool) -> tuple[float, str]:
    """The least time of one chain call on the card and what bounds it:
    operations at their type's peak, or bytes at the memory rate."""
    bf16, f32, nbytes = chain_counts(kind, b, h, w, c, hidden, affine)
    t_ops = bf16 / PEAK_BF16 + f32 / PEAK_F32
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def call_bound_ms(glow: dict, b: int, kinds: tuple[str, ...]) -> float:
    """The summed least time of one model call's chain calls: K steps at
    every level, once for each chain kind the call runs (a train step:
    forward and backward; nll: forward; sample: reverse)."""
    affine = glow["flow_coupling"] == "affine"
    return sum(glow["K"] * bound_ms(kind, b, h, w, c, glow["hidden_channels"], affine)[0]
               for h, w, c in latent_shapes(glow) for kind in kinds)
