#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

1. Reads the card (name and power limit from nvidia-smi), pins f32 math to
   true f32 (no TF32) and cuDNN to deterministic algorithms.
2. Builds the hand-written flow-step kernels (`csrc/flowstep.cu`) with nvcc.
3. Holds each kernel against its plain PyTorch version on the same CUDA
   tensors at every celeba64 level shape (hidden 512, b=64) and two odd
   shapes, both directions, affine and additive coupling, with the repo's
   bf16 bounds (tests/test_flowstep_pallas.py): elementwise atol/rtol 5e-2,
   mean |diff| < 2e-3, logdet atol 2e-1 / rtol 2e-2; and the per-step
   round-trip under the kernel to 2e-5.
4. Serves the celeba64 preset at full width (K=32, L=4, hidden 512) with
   random weights from a seed: `init_glow`, DDI on a uint8 batch, then an
   Inferer answers nll on 64 images, a T=0.7 sample of 64 and a
   reconstruct, with the kernels' launch counts checked against K*L per
   request; reconstruct exact to 2e-4; fused nll against the unfused
   PyTorch path within rtol 2e-2.  Then, with the zero-convs perturbed so
   every coupling depends on the data, nll against the unfused path again.
5. Times the kernel and the plain path with CUDA events (median of reps
   after warm-up): each level's step, nll and sample images/s.

Prints a JSON line of per-kernel results, the card line, and last
`{"ok": true, "device": {...}}`.  Exits non-zero, with no result line,
without a CUDA device or when any check fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 64
LEVEL_SHAPES = [(32, 32, 12), (16, 16, 24), (8, 8, 48), (4, 4, 96)]
ODD_SHAPES = [(5, 7, 6), (3, 5, 16)]
ODD_BATCH = 6
KERNEL_SOURCE = "pytorch_glow_tpu_torch/csrc/flowstep.cu"
TPU_KERNEL = "pytorch_glow_tpu/ops/flowstep_pallas.py:248"


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


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


def noisy_step(c: int, mode: str, generator, torch):
    """A random flow step whose coupling net is far from the identity."""
    from pytorch_glow_tpu_torch.models.layers import FlowStep

    step = FlowStep(c, 512, mode, torch.bfloat16, generator=generator)
    with torch.no_grad():
        for name, p in step.named_parameters():
            if not name.startswith("invconv."):
                p.add_(0.05 * torch.randn(p.shape, generator=generator))
    return step.cuda()


def check_kernels(torch, fs, results: dict) -> None:
    """Kernel vs plain version for every level shape and the odd shapes."""
    gen = torch.Generator().manual_seed(SEED + 10)
    cases = [(BATCH, *shape) for shape in LEVEL_SHAPES] + [(ODD_BATCH, *shape) for shape in ODD_SHAPES]
    cases = [(b, h, w, c, mode, noisy_step(c, mode, gen, torch))
             for b, h, w, c in cases for mode in ("affine", "additive")]

    for b, h, w, c, mode, step in cases:
        affine = mode == "affine"
        z = torch.randn(b, h, w, c, generator=gen).cuda()
        with torch.no_grad():
            wf = fs.pack_weights(step, affine, reverse=False)
            wr = fs.pack_weights(step, affine, reverse=True)
            zk, ldk = fs.step_forward(wf, z, affine)
            zr, ldr = fs.step_forward_ref(wf, z, affine)
            xk = fs.step_reverse(wr, zk, affine)
            xr = fs.step_reverse_ref(wr, zk, affine)
        torch.cuda.synchronize()
        tag = f"{b}x{h}x{w}x{c} {mode}"
        fwd_err = (zk - zr).abs()
        rev_err = (xk - xr).abs()
        rt_err = float((xk - z).abs().max())
        for name, got, want, err in (("forward", zk, zr, fwd_err), ("reverse", xk, xr, rev_err)):
            require(bool(torch.isfinite(got).all()), f"{tag} {name}: non-finite output")
            require(bool((err <= 5e-2 + 5e-2 * want.abs()).all()),
                    f"{tag} {name}: max |diff| {float(err.max())} beyond atol/rtol 5e-2")
            require(float(err.mean()) < 2e-3, f"{tag} {name}: mean |diff| {float(err.mean())}")
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], float(err.max()))
        ld_err = (ldk - ldr).abs()
        require(bool((ld_err <= 2e-1 + 2e-2 * ldr.abs()).all()),
                f"{tag}: logdet |diff| {float(ld_err.max())}")
        require(rt_err <= 2e-5, f"{tag}: step round-trip error {rt_err}")
        print(f"kernel {tag}: fwd max {float(fwd_err.max()):.3e} mean {float(fwd_err.mean()):.3e}"
              f" | logdet max {float(ld_err.max()):.3e} | rev max {float(rev_err.max()):.3e}"
              f" mean {float(rev_err.mean()):.3e} | round-trip {rt_err:.3e}")

        if b == BATCH and affine:
            times = {
                "forward": (median_ms(lambda: fs.step_forward(wf, z, affine), torch),
                            median_ms(lambda: fs.step_forward_ref(wf, z, affine), torch)),
                "reverse": (median_ms(lambda: fs.step_reverse(wr, zk, affine), torch),
                            median_ms(lambda: fs.step_reverse_ref(wr, zk, affine), torch)),
            }
            for name, (ms, plain_ms) in times.items():
                print(f"time step {name} {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
                if (h, w, c) == LEVEL_SHAPES[0]:
                    results[name]["ms"], results[name]["plain_ms"] = ms, plain_ms


def compare_nll(inf, plain_inf, images, what: str) -> None:
    """Fused-kernel nll against the unfused PyTorch layers, the repo's rtol 2e-2."""
    nll, nll_plain = inf.nll(images), plain_inf.nll(images)
    rel = float(((nll - nll_plain).abs() / nll_plain.abs()).max())
    print(f"nll fused vs unfused PyTorch path ({what}): max rel diff {rel:.3e}, "
          f"mean bits/dim {float(nll.mean()):.6f} vs {float(nll_plain.mean()):.6f}")
    require(rel <= 2e-2, f"fused nll vs plain path rel diff {rel} ({what})")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from pytorch_glow_tpu_torch import PRESETS, Inferer, init_glow
    from pytorch_glow_tpu_torch.ops import _build
    from pytorch_glow_tpu_torch.ops import flowstep as fs

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s")

    cfg = PRESETS["celeba64"].glow
    t0 = time.perf_counter()
    model = init_glow(cfg, torch.Generator().manual_seed(SEED), "cuda")
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(rng.integers(0, 256, (BATCH, *cfg.image_shape), dtype="uint8")).cuda()
    cuda_gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    model.ddi_init(model.dequantize(model.preprocess(images), cuda_gen))
    torch.cuda.synchronize()
    print(f"init + DDI (celeba64, K={cfg.K}, L={cfg.L}, hidden {cfg.hidden_channels}, "
          f"b={BATCH}): {time.perf_counter() - t0:.2f} s")

    results = {d: {"max_abs_err": 0.0, "ms": None, "plain_ms": None} for d in ("forward", "reverse")}
    check_kernels(torch, fs, results)

    # -- the main path: an Inferer answers nll, sample and reconstruct -------
    steps = cfg.K * cfg.L
    inf = Inferer(model)
    x = model.preprocess(images)
    fs.reset_launches()
    nll = inf.nll(images)
    torch.cuda.synchronize()
    after_nll = dict(fs.launches)
    with torch.no_grad():
        xs = model.sample(BATCH, 0.7, cuda_gen)
        imgs = model.postprocess(xs)
    torch.cuda.synchronize()
    after_sample = dict(fs.launches)
    with torch.no_grad():
        rec = model.reconstruct(x)
    rec_u8 = inf.reconstruct(images)
    torch.cuda.synchronize()
    launches = dict(fs.launches)
    print(f"launches: after nll {after_nll}, after sample {after_sample}, "
          f"after reconstruct x2 {launches} (K*L = {steps})")
    require(nll.shape == (BATCH,) and bool(torch.isfinite(nll).all()), "nll finite, shape (64,)")
    require(after_nll == {"forward": steps, "reverse": 0}, f"nll launches {after_nll}")
    require(bool(torch.isfinite(xs).all()), "sample finite")
    require(imgs.dtype == torch.uint8 and imgs.shape == (BATCH, *cfg.image_shape), "sample images")
    require(after_sample == {"forward": steps, "reverse": steps}, f"sample launches {after_sample}")
    require(launches == {"forward": 3 * steps, "reverse": 3 * steps}, f"reconstruct launches {launches}")
    rec_err = float((rec - x).abs().max())
    bin_err = int((rec_u8.int() - images.int()).abs().max())
    in_range = float(((xs >= 0) & (xs <= 1)).float().mean())
    print(f"nll bits/dim: mean {float(nll.mean()):.6f} min {float(nll.min()):.6f} "
          f"max {float(nll.max()):.6f}")
    print(f"sample T=0.7: float range [{float(xs.min()):.4f}, {float(xs.max()):.4f}], "
          f"share in [0,1] {in_range:.4f}")
    print(f"reconstruct: max |x - rec| {rec_err:.3e}, max uint8 diff {bin_err}")
    require(rec_err <= 2e-4, f"reconstruct error {rec_err}")
    require(bin_err <= 1, f"reconstruct uint8 diff {bin_err}")

    plain = init_glow(dataclasses.replace(cfg, flowstep_impl="xla"), device="cuda")
    plain.load_state_dict(model.state_dict())
    plain_inf = Inferer(plain)
    compare_nll(inf, plain_inf, images, "init + DDI")

    nll_ms = median_ms(lambda: inf.nll(images), torch, reps=3, inner=1)
    nll_plain_ms = median_ms(lambda: plain_inf.nll(images), torch, reps=3, inner=1)
    smp_ms = median_ms(lambda: inf.sample(BATCH, 0.7, cuda_gen), torch, reps=3, inner=1)
    smp_plain_ms = median_ms(lambda: plain_inf.sample(BATCH, 0.7, cuda_gen), torch, reps=3, inner=1)
    print(f"time nll b={BATCH}: kernel {nll_ms:.3f} ms ({BATCH * 1e3 / nll_ms:.1f} img/s), "
          f"plain {nll_plain_ms:.3f} ms ({BATCH * 1e3 / nll_plain_ms:.1f} img/s)")
    print(f"time sample b={BATCH} T=0.7: kernel {smp_ms:.3f} ms ({BATCH * 1e3 / smp_ms:.1f} img/s), "
          f"plain {smp_plain_ms:.3f} ms ({BATCH * 1e3 / smp_plain_ms:.1f} img/s)")
    print(f"card for these times: {card}")

    # -- couplings that depend on the data ------------------------------------
    # init + DDI leaves every zero-conv at 0, so f()'s output does not reach
    # z.  Perturbed zero-convs make every coupling data-dependent; kept small,
    # since a random flow with strongly data-dependent scales is unstable in
    # reverse (0.01 sends a T=0.7 sample to NaN on the plain path too).
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".f.4." in name:
                p.add_(0.003 * torch.randn(p.shape, generator=gen).cuda())
    plain.load_state_dict(model.state_dict())
    compare_nll(inf, plain_inf, images, "perturbed zero-convs")
    with torch.no_grad():
        rec = model.reconstruct(x)
    print(f"perturbed zero-convs: reconstruct max |x - rec| {float((rec - x).abs().max()):.3e} "
          f"(bf16 coupling: not bit-exact once f() depends on z1; see PERF.md)")
    require(bool(torch.isfinite(rec).all()), "perturbed reconstruct finite")

    kernels = [
        {"name": f"flowstep_{d}", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": TPU_KERNEL, "launches": launches[d], **results[d]}
        for d in ("forward", "reverse")
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
