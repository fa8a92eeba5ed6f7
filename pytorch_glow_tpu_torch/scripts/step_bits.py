"""The fused flow step's outputs on seeded inputs, to hold two trees' kernels
to each other bit for bit.

    python -m pytorch_glow_tpu_torch.scripts.step_bits save OUT.pt
    python -m pytorch_glow_tpu_torch.scripts.step_bits compare A.pt B.pt

`save` runs K1 (forward: z and logdet), K2 (reverse) and K3 (backward:
g_z and the 12 weight grads) through `ops/flowstep`'s public wrappers at
`CASES`: every channel count the presets run (12 to 384), a ragged pixel
count, both couplings, on random bf16 steps from seed 0 whose coupling nets
are far from the identity, and seeded inputs; it writes every output to
OUT.pt (on the CPU).  `compare` prints, per output, whether two files hold
the same bits and else their largest difference, then one JSON line:
{"outputs": n, "bitwise": n_equal, "differ": [names]}.  Run `save` once
in each checkout (the card's, for the kernels; `--cpu` for the plain
versions) and `compare` the files.
"""

from __future__ import annotations

import argparse
import json

import torch

from pytorch_glow_tpu_torch.models.layers import FlowStep
from pytorch_glow_tpu_torch.ops import flowstep as fs

# (b, h, w, c, coupling): celeba64's four levels, celebahq256's levels 2-5
# (whole images), and an odd shape whose pixel count is no multiple of a
# tile.
CASES = [(8, 32, 32, 12, "affine"), (8, 16, 16, 24, "affine"), (8, 8, 8, 48, "affine"),
         (16, 4, 4, 96, "affine"), (8, 32, 32, 48, "additive"), (8, 16, 16, 96, "additive"),
         (8, 8, 8, 192, "additive"), (16, 4, 4, 384, "additive"), (8, 4, 4, 384, "affine"),
         (6, 5, 7, 6, "affine")]


def noisy_step(c: int, mode: str, gen: torch.Generator) -> FlowStep:
    step = FlowStep(c, 512, mode, torch.bfloat16, generator=gen)
    with torch.no_grad():
        for name, p in step.named_parameters():
            if not name.startswith("invconv."):
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return step


def save(path: str, device: str) -> dict:
    gen = torch.Generator().manual_seed(0)
    out = {}
    for b, h, w, c, mode in CASES:
        affine = mode == "affine"
        step = noisy_step(c, mode, gen).to(device)
        z, g_zn = (torch.randn(b, h, w, c, generator=gen).to(device) for _ in range(2))
        g_ld = torch.randn(b, generator=gen).to(device)
        tag = f"{b}x{h}x{w}x{c} {mode}"
        with torch.no_grad():
            wf = [t.contiguous() for t in fs.pack_weights(step, affine, False)]
            wr = [t.contiguous() for t in fs.pack_weights(step, affine, True)]
            zn, ld = fs.step_forward(wf, z, affine)
            out[f"{tag} forward z"], out[f"{tag} forward logdet"] = zn, ld
            out[f"{tag} reverse"] = fs.step_reverse(wr, zn, affine)
            g_z, grads = fs.step_backward(wf, z, g_zn, g_ld, affine)
        out[f"{tag} backward g_z"] = g_z
        for i, g in enumerate(grads):
            out[f"{tag} backward grad {i}"] = g
    out = {k: v.cpu() for k, v in out.items()}
    torch.save(out, path)
    print(f"saved {len(out)} outputs of {len(CASES)} cases to {path}")
    return out


def compare(path_a: str, path_b: str) -> dict:
    a, b = torch.load(path_a), torch.load(path_b)
    if set(a) != set(b):
        raise ValueError(f"the files hold other outputs: {sorted(set(a) ^ set(b))}")
    differ = []
    for name in a:
        same = torch.equal(a[name], b[name])
        if not same:
            differ.append(name)
        diff = 0.0 if same else float((a[name] - b[name]).abs().max())
        print(f"{name}: {'bitwise equal' if same else f'max |diff| {diff:.3e}'}")
    line = {"outputs": len(a), "bitwise": len(a) - len(differ), "differ": differ}
    print(json.dumps(line))
    return line


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("save")
    s.add_argument("out")
    s.add_argument("--cpu", action="store_true", help="the plain versions on the CPU")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = p.parse_args(argv)
    if args.cmd == "save":
        if not args.cpu and not torch.cuda.is_available():
            raise RuntimeError("step_bits save runs the kernels on the card (or --cpu)")
        return save(args.out, "cpu" if args.cpu else "cuda")
    return compare(args.a, args.b)


if __name__ == "__main__":
    main()
