"""Per-level timing of the fused flow-step kernels on the card.

    python -m pytorch_glow_tpu_torch.scripts.perf_fused_levels
    PF_PRESET=celebahq256 PF_BATCH=64 python -m pytorch_glow_tpu_torch.scripts.perf_fused_levels
    python -m pytorch_glow_tpu_torch.scripts.perf_fused_levels cifar10 --cpu \\
        --set glow.hidden_channels=8 --set glow.K=2 --batch 2 --n1 1 --n2 2

Counterpart of the JAX package's `scripts/perf_fused_levels.py`.  For each
level of a preset (`cfg.latent_shapes()`): step 0's weights from
`init_glow` at seed 0, packed (`ops/flowstep.pack_weights`), a seeded f32 z
(seed = the level), and one fused forward step (K1, or K4 where
`flowstep.tiling` says "band"), one fused reverse step (K2 / K4 reverse)
and one fused backward (K3 / K5, on a seeded cotangent and g_ld = 1),
each timed by two-N differencing on CUDA events (`_anatomy.two_n_ms`).
Beside each time: the direction's tiling, its bound (`flowstep.bound_ms`:
bf16 products at 989 TFLOP/s plus the f32 mix at 67 TFLOP/s, or bytes at
3.35 TB/s) with its limiting resource, the share of that bound, and the
JAX script's op count (its `flops`, every product counted at the bf16
peak) with the rate it gives, so that a level's share reads against the
JAX one, and the library yardstick: the same step as one unfused
`FlowStep` call in the preset's compute dtype (`models/layers.py`;
forward, reverse, and the forward plus `autograd.grad` for the backward),
timed the same way.  Then the totals weighted by K and the implied
forward, reverse and backward images/s.

`--split` instead splits the whole-image chains K1, K2 and K3 by kernel
(`_anatomy.chain_split`, torch.profiler, on the production launches that
the anatomy scripts' `CHAIN` lists name) at `SPLIT_SHAPES`, each beside
its library call's time: where the narrow, wide-channel levels lose their
time.

Knobs: the preset as an argument, else PF_PRESET (celeba64); --batch /
--n1 / --n2, else PF_BATCH (128), PF_N1 / PF_N2 (20 / 120).  Runs on the
card; `--cpu` runs the plain versions on CPU tensors (wall clock, for the
tests).  Prints the card's name and power limit first; `main` returns
{"card", "preset", "batch", "levels": [...], "totals": {...}}, or with
`--split` {"card", "splits": [...]}.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from pytorch_glow_tpu_torch.config import PRESETS
from pytorch_glow_tpu_torch.models.glow import init_glow
from pytorch_glow_tpu_torch.ops import flowstep as fs
from pytorch_glow_tpu_torch.scripts import _anatomy as A
from pytorch_glow_tpu_torch.scripts import perf_bwd_anatomy, perf_kernel_anatomy
from pytorch_glow_tpu_torch.scripts import perf_reverse_anatomy
from pytorch_glow_tpu_torch.utils.profiles import apply_overrides

DIRECTIONS = ("forward", "reverse", "backward")
LABEL = {"forward": "fwd", "reverse": "rev", "backward": "bwd"}
# `--split`'s shapes, (preset, level, batch): celebahq256's 32x32x48 and
# 4x4x384 (additive) and celeba64's 4x4x96 (affine) at the presets' batches.
SPLIT_SHAPES = (("celebahq256", 2, 64), ("celebahq256", 5, 64), ("celeba64", 3, 128))
# The production chains K1, K2 and K3 launch what S1-S3's `full` launches.
CHAINS = {"forward": perf_kernel_anatomy.CHAIN, "reverse": perf_reverse_anatomy.CHAIN,
          "backward": perf_bwd_anatomy.CHAIN}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("profile", nargs="?", default=None, help="preset name (PF_PRESET)")
    p.add_argument("--batch", type=int, default=None, help="PF_BATCH")
    p.add_argument("--n1", type=int, default=None, help="PF_N1")
    p.add_argument("--n2", type=int, default=None, help="PF_N2")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SEC.KEY=VAL", help="profile overrides")
    p.add_argument("--cpu", action="store_true", help="the plain versions on the CPU")
    p.add_argument("--split", action="store_true",
                   help="split K1-K3 by kernel at SPLIT_SHAPES (card only)")
    return p.parse_args(argv)


def jax_ops(b: int, h: int, w: int, c: int, hidden: int, affine: bool) -> int:
    """The JAX script's operation count of one step: its three net
    products and the mix (`scripts/perf_fused_levels.py`'s `flops`)."""
    ch = c // 2
    cout = c if affine else ch
    return 2 * b * h * w * (hidden * (9 * ch + hidden + 9 * cout) + c * c)


def operands(step, b: int, h: int, w: int, c: int, affine: bool, seed: int,
             device: torch.device) -> dict:
    """A level's operands: the step's weights packed for each direction, a
    seeded f32 z (seed = `seed`), a cotangent g_zn (the next draw) and
    g_ld = 1."""
    with torch.no_grad():
        wf = [t.contiguous() for t in fs.pack_weights(step, affine, False)]
        wr = [t.contiguous() for t in fs.pack_weights(step, affine, True)]
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn(b, h, w, c, generator=gen).to(device)
    g_zn = torch.randn(b, h, w, c, generator=gen).to(device)
    return {"wf": wf, "wr": wr, "z": z, "g_zn": g_zn, "g_ld": torch.ones(b, device=device)}


def fused_calls(ops: dict, affine: bool) -> dict:
    """One fused call per direction: K1/K4, K2/K4 reverse, K3/K5."""
    wf, wr, z = ops["wf"], ops["wr"], ops["z"]
    return {"forward": lambda: fs.step_forward(wf, z, affine),
            "reverse": lambda: fs.step_reverse(wr, z, affine),
            "backward": lambda: fs.step_backward(wf, z, ops["g_zn"], ops["g_ld"], affine)}


def library_calls(step, ops: dict) -> dict:
    """The yardstick per direction: one unfused `FlowStep` forward, its
    reverse, and the forward plus `autograd.grad` of z and every parameter
    on (g_zn, g_ld).  The forward and reverse run under no_grad."""
    z = ops["z"]
    zeros = torch.zeros(z.shape[0], device=z.device)
    params = [z.detach().requires_grad_(), *step.parameters()]

    def backward():
        with torch.enable_grad():
            out = step(params[0], zeros)
            torch.autograd.grad(out, params, (ops["g_zn"], ops["g_ld"]))

    return {"forward": lambda: step(z, zeros), "reverse": lambda: step.reverse(z),
            "backward": backward}


def time_level(step, b: int, h: int, w: int, c: int, affine: bool, seed: int, n1: int,
               n2: int, device: torch.device) -> dict:
    """One level's row: each direction's ms, tiling, bound and share, and
    its library call's ms."""
    cuda = device.type == "cuda"
    hidden = step.f[0].weight.shape[0]
    ops = operands(step, b, h, w, c, affine, seed, device)
    calls, library = fused_calls(ops, affine), library_calls(step, ops)
    row = {"shape": [h, w, c], "jax_ops": jax_ops(b, h, w, c, hidden, affine)}
    with torch.no_grad():
        for d in DIRECTIONS:
            ms = A.two_n_ms(calls[d], n1, n2, cuda)
            bound, by = fs.bound_ms(d, b, h, w, c, hidden, affine)
            row[d] = {"ms": ms, "tiling": fs.tiling(d, b, h, w, c, hidden, affine),
                      "bound_ms": bound, "bound_by": by, "share": bound / ms,
                      "library_ms": A.two_n_ms(library[d], n1, n2, cuda)}
    return row


def split(preset: str, level: int, b: int, n1: int, n2: int) -> dict:
    """K1, K2 and K3 at one level of a preset (whole-image chains), split by
    kernel, each beside its library call: {"preset", "level", "shape",
    "batch", direction: {"ms", "library_ms", "split": {label: ms} or None
    where the profiler dropped launches}}.  Card only."""
    cfg = PRESETS[preset].glow
    affine = cfg.flow_coupling == "affine"
    h, w, c = cfg.latent_shapes()[level]
    model = init_glow(cfg, torch.Generator().manual_seed(0), "cuda")
    step = model._levels[level][0][0]
    ops = operands(step, b, h, w, c, affine, level, torch.device("cuda"))
    calls, library = fused_calls(ops, affine), library_calls(step, ops)
    out = {"preset": preset, "level": level, "shape": [h, w, c], "batch": b}
    with torch.no_grad():
        for d in DIRECTIONS:
            tiling = fs.tiling(d, b, h, w, c, cfg.hidden_channels, affine)
            if tiling != "whole":
                raise ValueError(f"{preset} level {level} {d}: {tiling} tiling, not a whole chain")
            out[d] = {"ms": A.two_n_ms(calls[d], n1, n2),
                      "library_ms": A.two_n_ms(library[d], n1, n2),
                      "split": A.chain_split(calls[d], CHAINS[d])}
            r = out[d]
            parts = ("not measured" if r["split"] is None else ", ".join(
                f"{label} {ms * 1e3:.1f}" for label, ms in r["split"].items()))
            print(f"split {preset} level {level} ({h}x{w}x{c}, b={b}) {LABEL[d]}: "
                  f"{r['ms'] * 1e3:.1f} us, library {r['library_ms'] * 1e3:.1f} us; by kernel, "
                  f"us: {parts}", flush=True)
    return out


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    preset = args.profile or os.environ.get("PF_PRESET", "celeba64")
    b, n1, n2 = A.knobs(args.batch, args.n1, args.n2, 20, 120, prefix="PF")
    device = torch.device("cpu" if args.cpu else "cuda")
    card = A.card() if device.type == "cuda" else "cpu"
    print(f"card: {card}", flush=True)
    if args.split:
        if device.type != "cuda":
            raise ValueError("--split reads torch.profiler's device times and needs the card")
        return {"card": card, "splits": [split(p, li, bb, n1, n2)
                                         for p, li, bb in SPLIT_SHAPES]}
    cfg = apply_overrides(PRESETS[preset], args.overrides).glow
    affine = cfg.flow_coupling == "affine"
    print(f"device: {torch.cuda.get_device_name(0) if device.type == 'cuda' else 'cpu'}  "
          f"preset={preset} b={b} N={n1},{n2} hidden={cfg.hidden_channels} "
          f"{cfg.flow_coupling} K={cfg.K}", flush=True)
    model = init_glow(cfg, torch.Generator().manual_seed(0), device)
    levels = []
    totals = {d: 0.0 for d in DIRECTIONS}
    total_bound = {d: 0.0 for d in DIRECTIONS}
    total_library = {d: 0.0 for d in DIRECTIONS}
    total_ops = 0
    for li, (h, w, c) in enumerate(cfg.latent_shapes()):
        row = time_level(model._levels[li][0][0], b, h, w, c, affine, li, n1, n2, device)
        levels.append(row)
        total_ops += row["jax_ops"] * cfg.K
        parts = []
        for d in DIRECTIONS:
            r = row[d]
            totals[d] += r["ms"] * cfg.K
            total_bound[d] += r["bound_ms"] * cfg.K
            total_library[d] += r["library_ms"] * cfg.K
            parts.append(f"{LABEL[d]} {r['ms'] * 1e3:9.1f} us ({r['tiling']}; bound "
                         f"{r['bound_ms'] * 1e3:8.1f} us {r['bound_by']}, "
                         f"{100 * r['share']:5.1f}%; library {r['library_ms'] * 1e3:9.1f} us)")
        rate = row["jax_ops"] / row["forward"]["ms"] / 1e9
        print(f"level {li} ({h}x{w}x{c}): " + "  ".join(parts)
              + f"  JAX ops {row['jax_ops']:.4g}: fwd {rate:7.1f} TFLOP/s "
              f"({100 * 1e12 * rate / fs.PEAK_BF16:5.1f}% of bf16 peak)  (x K={cfg.K})",
              flush=True)
    out_totals = {}
    for d in DIRECTIONS:
        out_totals[d] = {"ms": totals[d], "bound_ms": total_bound[d],
                         "share": total_bound[d] / totals[d], "library_ms": total_library[d],
                         "images_per_sec": 1e3 * b / totals[d]}
    print("\nK-weighted: " + "  ".join(
        f"{LABEL[d]} {out_totals[d]['ms']:8.3f} ms ({100 * out_totals[d]['share']:5.1f}% of bound "
        f"{out_totals[d]['bound_ms']:.3f} ms; library {out_totals[d]['library_ms']:.3f} ms)"
        for d in DIRECTIONS)
        + f"  JAX ops fwd {total_ops / totals['forward'] / 1e9:.1f} TFLOP/s", flush=True)
    print("implied img/s: " + "  ".join(
        f"{LABEL[d]} {out_totals[d]['images_per_sec']:.0f}" for d in DIRECTIONS), flush=True)
    return {"card": card, "preset": preset, "batch": b, "n": [n1, n2], "levels": levels,
            "totals": out_totals}


if __name__ == "__main__":
    main()
