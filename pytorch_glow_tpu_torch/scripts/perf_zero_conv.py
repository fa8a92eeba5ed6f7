"""The unfused bf16 coupling net's zero conv, and what the unfused path
costs: the "library" yardsticks of PERF.md's kernel table and the unfused
celeba64 train step, with an older checkout's in turns.

    python -m pytorch_glow_tpu_torch.scripts.perf_zero_conv [--parent DIR]

Needs a CUDA card.  Prints the card's name and power limit (nvidia-smi),
then one JSON line per arm.  Each arm is a subprocess that imports the
package of its tree (this checkout, or `--parent`'s), in the order P C C P
(C alone without `--parent`):

* `library_ms`: one unfused bf16 `FlowStep` call on CUDA events at the shape
  each kernel row of PERF.md is timed at, as `chip_smoke.py` times its
  library column: K1 / K2 the forward / reverse at celeba64 level 0 (b=64,
  32x32x12, affine), K3 the forward and `autograd.grad` at b=128, K4 / K5
  at celebahq256's first band level (b=64, 128x128x12, additive), S1-S3
  the forward, reverse and backward at b=128;
* `train_step_ms`: the unfused celeba64 train step at b=128 (the preset
  with `flowstep_impl="xla"`, synthetic textured data), the median of 5
  after a warm-up step, and its peak `max_memory_allocated`.

Last, in this process, the zero conv layer alone at celeba64 level 0,
b=128 (131072 pixels, 512 -> 12 channels, 3x3), forward and forward +
backward: "bf16_conv" (cuDNN bf16, the output rounded to bf16: the
unrepaired layer), "f32_conv" (a true-f32 conv on the bf16-rounded
operands, with its f32 backward) and "Conv2dZeros" (this tree's layer:
the weight packed by tap, one bf16 product with an f32 result, then the
nine taps added in f32; the bf16 conv's backward), each with the max
|diff| of its output from f32_conv's.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
SEED = 0


def median_ms(fn, torch, reps: int = 5, inner: int = 3) -> float:
    """Median over `reps` of the mean time of `inner` calls, CUDA events."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def pin(torch) -> None:
    """chip_smoke.py's settings: no TF32, deterministic cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


def library_ms(torch) -> dict:
    from pytorch_glow_tpu_torch.models.layers import FlowStep

    gen = torch.Generator().manual_seed(SEED)
    out = {}
    for names, b, (h, w, c), mode in (
            (("K1", "K2", None), 64, (32, 32, 12), "affine"),
            (("S1", "S2", "K3"), 128, (32, 32, 12), "affine"),
            (("K4", None, "K5"), 64, (128, 128, 12), "additive")):
        step = FlowStep(c, 512, mode, torch.bfloat16, generator=gen)
        with torch.no_grad():
            for name, p in step.named_parameters():
                if not name.startswith("invconv."):
                    p.add_(0.05 * torch.randn(p.shape, generator=gen))
        step = step.cuda()
        z, gzn = (torch.randn(b, h, w, c, generator=gen).cuda() for _ in range(2))
        gld = torch.randn(b, generator=gen).cuda()
        zeros = torch.zeros(b, device="cuda")
        fwd, rev, bwd = names
        with torch.no_grad():
            out[fwd] = median_ms(lambda: step(z, zeros), torch)
            if rev:
                out[rev] = median_ms(lambda: step.reverse(z), torch)
        params = [z.detach().requires_grad_(), *step.parameters()]

        def backward():
            res = step(params[0], zeros)
            torch.autograd.grad(res, params, (gzn, gld))

        if bwd:
            out[bwd] = median_ms(backward, torch)
        if bwd == "K3":
            out["S3"] = out["K3"]
        del step, z, gzn, params
        torch.cuda.empty_cache()
    return out


def train_step_ms(torch, out_dir: str) -> tuple[float, float]:
    import dataclasses

    from pytorch_glow_tpu_torch import PRESETS, build
    from pytorch_glow_tpu_torch.train import step as steplib

    prof = PRESETS["celeba64"]
    prof = prof.replace(glow=dataclasses.replace(prof.glow, flowstep_impl="xla"),
                        data=dataclasses.replace(prof.data, name="synthetic_textured"),
                        out_dir=out_dir)
    built = build(prof)
    t = prof.train
    step_fn = steplib.make_train_step(prof.glow, built.tx, t.ema_decay, built.schedule)
    batches = [next(built.data)["image"] for _ in range(6)]
    built.data.close()
    state, _ = step_fn(built.state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for batch in batches[1:]:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step_fn(state, batch)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), torch.cuda.max_memory_allocated() / 2**30


def worker(tree: str, arm: str) -> None:
    sys.path.insert(0, tree)
    import torch

    pin(torch)
    lib = library_ms(torch)
    with tempfile.TemporaryDirectory() as out_dir:
        ms, peak = train_step_ms(torch, out_dir)
    print(json.dumps({"arm": arm, "tree": tree, "library_ms": lib, "train_step_ms": ms,
                      "train_peak_gib": peak}), flush=True)


def zero_conv_ms(torch) -> dict:
    """The three zero-conv layers at celeba64 level 0, b=128."""
    import torch.nn.functional as F

    from pytorch_glow_tpu_torch.models.layers import Conv2dZeros

    gen = torch.Generator().manual_seed(SEED + 1)
    b, h, w, hidden, cout = 128, 32, 32, 512, 12
    x = torch.relu(torch.randn(b, h, w, hidden, generator=gen)).bfloat16().cuda()
    layer = Conv2dZeros(hidden, cout)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    layer = layer.cuda()
    weight = layer.weight
    g = torch.randn(b, h, w, cout, generator=gen).cuda()

    def scaled(y):
        return (y + layer.bias) * torch.exp(layer.logs.view(-1) * 3.0)

    def bf16_conv(x):
        y = F.conv2d(x.permute(0, 3, 1, 2), weight.bfloat16(), padding=1)
        return scaled(y.permute(0, 2, 3, 1).float())

    def f32_conv(x):
        y = F.conv2d(x.float().permute(0, 3, 1, 2), weight.bfloat16().float(), padding=1)
        return scaled(y.permute(0, 2, 3, 1))

    with torch.no_grad():
        want = f32_conv(x)
    xg = x.detach().requires_grad_()
    out = {}
    for name, fn in (("bf16_conv", bf16_conv), ("f32_conv", f32_conv), ("Conv2dZeros", layer)):
        with torch.no_grad():
            err = float((fn(x) - want).abs().max())
            fwd = median_ms(lambda fn=fn: fn(x), torch)
        both = median_ms(lambda fn=fn: torch.autograd.grad(fn(xg), (xg, weight), g), torch)
        out[name] = {"forward_ms": fwd, "forward_backward_ms": both,
                     "max_abs_diff_vs_f32_conv": err}
    return out


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--parent", default=None, help="an older checkout, timed in turns")
    p.add_argument("--worker", nargs=2, metavar=("TREE", "ARM"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(*args.worker)
        return {}
    import torch

    if not torch.cuda.is_available():
        sys.exit("perf_zero_conv: needs a CUDA card")
    print(f"card: {card_line()}", flush=True)
    arms = [("parent", os.path.abspath(args.parent))] if args.parent else []
    change = [("change", REPO)]
    order = [*arms, *change, *change, *arms] if arms else change
    runs = []
    for arm, tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree, arm],
                              cwd=tree, capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            raise RuntimeError(f"arm {arm} ({tree}) failed:\n{proc.stdout[-3000:]}\n"
                               f"{proc.stderr[-3000:]}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    pin(torch)
    zc = zero_conv_ms(torch)
    print(json.dumps({"zero_conv_celeba64_level0_b128": zc}), flush=True)
    return {"runs": runs, "zero_conv": zc}


if __name__ == "__main__":
    main()
