"""Seeded weights and seeds: every tensor of a Glow's lineage `state_dict`,
drawn on the device from the run's seed.

The names and shapes follow the reference lineage's layout, which the
port's `Glow` uses (`flow.layers.{j}` counts the parameter-free Squeeze
layers, then each level's K steps and its split, then `learn_top`), so the
port loads the dict with `load_state_dict` and the plain reference reads
it by name.  Every parameter is drawn, those Glow starts at zero too (the
coupling nets' last conv, the split priors, the learned top), at scales
that keep activations finite through the full depth without data-dependent
init.  Every 1x1 mix starts as a random rotation's LU factors, as Glow
starts it, its log-scales moved off zero.  The floats come from one
`torch.randn` call on a generator on the device and, for the mixes, one
normal draw, QR and LU per level.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flowbench.counts import latent_shapes


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of the run, from the run's seed and
    integer tags (any size: the driver's seeds pass 32 bits)."""
    return int(np.random.SeedSequence([seed, *tags]).generate_state(1, np.uint64)[0] >> 1)


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *tags))


# Stream tags, so that no two of a run's streams share a seed.
WEIGHTS, IMAGES, DDI_NOISE, SAMPLE_NOISE = 1, 2, 3, 4


def layout(glow: dict) -> list[tuple[str, tuple[int, ...], float, float]]:
    """(name, shape, std, mean) of every float tensor drawn from the normal
    in one call, in drawing order (the LU factors come apart, `draw`).  The coupling net's convs keep its activations' scale (conv1
    by its fan-in, conv2 by He's rule), its last conv gives outputs about
    a tenth of that; the flow's actnorms under an affine coupling lean
    towards volume preservation: sigmoid(raw + 2) shrinks the coupled half
    by about sigmoid(2) a step, so each actnorm grows its input by
    sigmoid(2) ** -0.5."""
    hidden = glow["hidden_channels"]
    affine = glow["flow_coupling"] == "affine"
    an_mean = -0.5 * math.log(1.0 / (1.0 + math.exp(-2.0))) if affine else 0.0
    out = []
    shapes = latent_shapes(glow)
    for (_, _, c), (steps, split) in zip(shapes, levels(glow)):
        ch, cout = c // 2, (c if affine else c // 2)
        for p in steps:
            out += [
                (p + "actnorm.bias", (1, c, 1, 1), 0.05, 0.0),
                (p + "actnorm.logs", (1, c, 1, 1), 0.02, an_mean),
                (p + "invconv.log_s", (c,), 0.02, 0.0),  # added to the rotation's
                (p + "f.0.weight", (hidden, ch, 3, 3), 1.0 / math.sqrt(9 * ch), 0.0),
                (p + "f.0.actnorm.bias", (1, hidden, 1, 1), 0.05, 0.0),
                (p + "f.0.actnorm.logs", (1, hidden, 1, 1), 0.05, 0.0),
                (p + "f.2.weight", (hidden, hidden, 1, 1), math.sqrt(2.0 / hidden), 0.0),
                (p + "f.2.actnorm.bias", (1, hidden, 1, 1), 0.05, 0.0),
                (p + "f.2.actnorm.logs", (1, hidden, 1, 1), 0.05, 0.0),
                (p + "f.4.weight", (cout, hidden, 3, 3), 0.1 / math.sqrt(4.5 * hidden), 0.0),
                (p + "f.4.bias", (cout,), 0.05, 0.0),
                (p + "f.4.logs", (cout, 1, 1), 0.02, 0.0),
            ]
        if split is not None:
            out += [(split + "conv.weight", (c, ch, 3, 3), 0.1 / math.sqrt(9 * ch), 0.0),
                    (split + "conv.bias", (c,), 0.05, 0.0),
                    (split + "conv.logs", (c, 1, 1), 0.02, 0.0)]
    if glow["learn_top"]:
        c2 = 2 * shapes[-1][2]
        out += [("learn_top.weight", (c2, c2, 3, 3), 0.05 / math.sqrt(9 * c2), 0.0),
                ("learn_top.bias", (c2,), 0.05, 0.0),
                ("learn_top.logs", (c2, 1, 1), 0.02, 0.0)]
    return out


def levels(glow: dict) -> list[tuple[list[str], str | None]]:
    """Per level, the `state_dict` prefix of each of its K steps and of its
    split (None on the last level)."""
    out, j = [], 0
    for i in range(glow["L"]):
        j += 1  # Squeeze
        steps = [f"flow.layers.{j + s}." for s in range(glow["K"])]
        j += glow["K"]
        split = None
        if i < glow["L"] - 1:
            split, j = f"flow.layers.{j}.", j + 1
        out.append((steps, split))
    return out


def _lu(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched LU with partial pivoting, a = P L U (L unit lower), as plain
    tensor operations (one column a step; CPU LAPACK's batched LU has been
    seen to hang under several threads)."""
    k, c, _ = a.shape
    a = a.clone()
    order = torch.arange(c, device=a.device).repeat(k, 1)
    rows = torch.arange(k, device=a.device)
    for j in range(c - 1):
        piv = j + a[:, j:, j].abs().argmax(dim=1)
        a[rows, j], a[rows, piv] = a[rows, piv].clone(), a[rows, j].clone()
        order[rows, j], order[rows, piv] = order[rows, piv].clone(), order[rows, j].clone()
        a[:, j + 1:, j] /= a[:, j:j + 1, j]
        a[:, j + 1:, j + 1:] -= a[:, j + 1:, j:j + 1] * a[:, j:j + 1, j + 1:]
    eye = torch.eye(c, device=a.device)
    perm = torch.nn.functional.one_hot(order, c).float().transpose(1, 2)
    return perm, torch.tril(a, -1) + eye, torch.triu(a)


@torch.no_grad()
def draw(glow: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The whole lineage `state_dict` of a Glow, drawn from `seed` on
    `device`: f32 tensors, views of one buffer, the permutations one-hot."""
    gen = generator(device, seed, WEIGHTS)
    table = layout(glow)
    total = sum(math.prod(shape) for _, shape, _, _ in table)
    flat = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    out, at = {}, 0
    for name, shape, std, mean in table:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        out[name] = t.mul_(std).add_(mean)
    for (_, _, c), (prefixes, _) in zip(latent_shapes(glow), levels(glow)):
        # Each step's mix: a random rotation's LU factors with partial
        # pivoting, W = P L U, as Glow initialises it, its log|diag U| moved
        # by the normal draw above so that log|det W| is not 0.
        q, r = torch.linalg.qr(torch.randn(len(prefixes), c, c, generator=gen, device=device))
        q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1)).unsqueeze(-2)
        perm, lower, upper = _lu(q)
        diag = torch.diagonal(upper, dim1=-2, dim2=-1)
        eye = torch.eye(c, device=device)
        mask = torch.tril(torch.ones(c, c, device=device), -1)
        for k, prefix in enumerate(prefixes):
            out[prefix + "invconv.p"] = perm[k]
            out[prefix + "invconv.lower"] = torch.tril(lower[k], -1)
            out[prefix + "invconv.upper"] = torch.triu(upper[k], 1)
            out[prefix + "invconv.log_s"].add_(torch.log(diag[k].abs()))
            out[prefix + "invconv.sign_s"] = torch.sign(diag[k])
            out[prefix + "invconv.l_mask"] = mask
            out[prefix + "invconv.eye"] = eye
    return out
