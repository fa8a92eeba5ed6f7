#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card.

    python3 chip_smoke.py [--profile]

1. Reads the card (name and power limit from nvidia-smi), pins f32 math to
   true f32 (no TF32) and cuDNN to deterministic algorithms.
2. Builds the hand-written flow-step kernels (`csrc/*.cu`) with nvcc, one
   process per source.
3. Holds each kernel against its plain PyTorch version on the same CUDA
   tensors at every celeba64 level shape (hidden 512, b=64) and two odd
   shapes, both directions, affine and additive coupling, with the repo's
   bf16 bounds (tests/test_flowstep_pallas.py): elementwise atol/rtol 5e-2,
   mean |diff| < 2e-3, logdet atol 2e-1 / rtol 2e-2; and the per-step
   round-trip under the kernel to 2e-5.  Times each step beside its plain
   version and the library yardstick (one unfused bf16 `FlowStep` call).
4. Serves the celeba64 preset at full width (K=32, L=4, hidden 512) with
   random weights from a seed: `init_glow`, DDI on a uint8 batch, then an
   Inferer answers nll on 64 images, a T=0.7 sample of 64 and a
   reconstruct, with the kernels' launch counts checked against K*L per
   request; reconstruct exact to 2e-4; fused nll against the unfused
   PyTorch path within rtol 2e-2.  Then, with the zero-convs perturbed so
   every coupling depends on the data, nll against the unfused path again.
5. Times the kernel and the plain path with CUDA events (median of reps
   after warm-up): each level's step, nll and sample images/s.
6. Holds the backward kernel (`csrc/flowstep_bwd.cu`) against
   `step_backward_ref` at every celeba64 level shape at b=128 and the odd
   shapes, affine and additive: g_z and each weight grad within 5e-2 of the
   plain version's largest magnitude (g_z also elementwise rtol 5e-2 and
   mean |diff| < 2e-3 of that scale: the repo's gradient bound on
   scale-normalised grads, since the plain version's own sum order moves
   g_z by more than an absolute 5e-2 at full width; that noise floor, the
   plain version on the CPU against it on the card, is printed for the
   first images of every case); a second launch bitwise equal.  Times it
   beside the plain version and the library yardstick (an unfused bf16
   `FlowStep` forward plus `autograd.grad`).
7. Trains the celeba64 preset at full width, b=128, with synthetic
   textured data: `build` then one `train` call of steps_per_call=5,
   with K*L backward launches per step; then one `loss_fn` on the fused
   and on the unfused path (cuDNN bf16 through autograd) and the unfused
   path at f32 coupling: non-zero coupling grads, and every parameter's
   fused grad no further (relative l2) from the f32 grad than 1.5x the
   unfused bf16 grad's distance plus 1e-3; then 3 steps from one state on
   both paths, grad_norm within rtol 2e-2 at each step and losses within
   rtol 2e-2 after the third; and the train step's time, images/s and
   peak memory on both paths.

With --profile, also prints torch.profiler's device time by kernel, and
the device's idle share, for one fused and one unfused train step.

Prints a JSON line of per-kernel results, the card line, and last
`{"ok": true, "device": {...}}`.  Exits non-zero, with no result line,
without a CUDA device or when any check fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 64
TRAIN_BATCH = 128
LEVEL_SHAPES = [(32, 32, 12), (16, 16, 24), (8, 8, 48), (4, 4, 96)]
ODD_SHAPES = [(5, 7, 6), (3, 5, 16)]
ODD_BATCH = 6
KERNEL_SOURCE = "pytorch_glow_tpu_torch/csrc/flowstep.cu"
TPU_KERNEL = "pytorch_glow_tpu/ops/flowstep_pallas.py:248"
BWD_SOURCE = "pytorch_glow_tpu_torch/csrc/flowstep_bwd.cu"
BWD_TPU_KERNEL = "pytorch_glow_tpu/ops/flowstep_pallas.py:701"
# Published H100 SXM peaks at 700 W: dense bf16 tensor cores, f32 outside
# them, HBM3.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def bound_ms(kind: str, b: int, h: int, w: int, c: int, hidden: int, affine: bool):
    """The least time one flow-step kernel call could take on the card: the
    larger of its operations over the peak rate of their type (the coupling
    net's bf16 products, the f32 mix) and its compulsory bytes (each input
    read once, each output written once) over the memory rate.  The
    backward recomputes the net and forms two more products per layer, as
    the JAX kernel's cost estimate counts it (flowstep_pallas.py:1178)."""
    m, ch = b * h * w, c // 2
    cout = c if affine else ch
    net_w = hidden * (9 * ch + hidden + 9 * cout)
    vec = c * c + 2 * c + 4 * hidden + 2 * cout
    net = 2 * m * net_w
    weight_bytes = 4 * vec + 2 * net_w
    if kind == "backward":  # z, g_zn in, g_z out; g_ld in; 12 f32 grads out
        bf16, f32 = 3 * net, 12 * m * c * c
        nbytes = 3 * 4 * m * c + 4 * b + weight_bytes + 4 * (vec + net_w)
    else:  # z in, z_next out, logdet out
        bf16, f32 = net, 2 * m * c * c
        nbytes = 2 * 4 * m * c + 4 * b + weight_bytes
    t_ops = bf16 / PEAK_BF16 + f32 / PEAK_F32
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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
            zeros = torch.zeros(b, device=z.device)
            with torch.no_grad():
                times = {
                    "forward": (median_ms(lambda: fs.step_forward(wf, z, affine), torch),
                                median_ms(lambda: fs.step_forward_ref(wf, z, affine), torch),
                                median_ms(lambda: step(z, zeros), torch)),
                    "reverse": (median_ms(lambda: fs.step_reverse(wr, zk, affine), torch),
                                median_ms(lambda: fs.step_reverse_ref(wr, zk, affine), torch),
                                median_ms(lambda: step.reverse(zk), torch)),
                }
            for name, (ms, plain_ms, lib_ms) in times.items():
                bound, by = bound_ms(name, b, h, w, c, 512, affine)
                print(f"time step {name} {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"library {lib_ms:.4f} ms, bound {bound:.4f} ms ({by})")
                if (h, w, c) == LEVEL_SHAPES[0]:
                    results[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                         bound_ms=bound, bound_by=by)


def check_backward(torch, fs, results: dict) -> None:
    """Backward kernel vs plain version at every level shape (b=128) and
    the odd shapes, affine and additive; bitwise repeat; noise floor of the
    plain version itself; times beside the plain version and the library."""
    gen = torch.Generator().manual_seed(SEED + 20)
    cases = ([(TRAIN_BATCH, *shape) for shape in LEVEL_SHAPES]
             + [(ODD_BATCH, *shape) for shape in ODD_SHAPES])
    worst = 0.0
    for b, h, w, c in cases:
        for mode in ("affine", "additive"):
            affine = mode == "affine"
            step = noisy_step(c, mode, gen, torch)
            z, gzn = (torch.randn(b, h, w, c, generator=gen).cuda() for _ in range(2))
            gld = torch.randn(b, generator=gen).cuda()
            with torch.no_grad():
                wf = fs.pack_weights(step, affine, reverse=False)
                gz, grads = fs.step_backward(wf, z, gzn, gld, affine)
                gz2, grads2 = fs.step_backward(wf, z, gzn, gld, affine)
                rz, rgrads = fs.step_backward_ref(wf, z, gzn, gld, affine)
            torch.cuda.synchronize()
            tag = f"{b}x{h}x{w}x{c} {mode}"
            require(torch.equal(gz, gz2) and all(torch.equal(a, a2) for a, a2 in zip(grads, grads2)),
                    f"{tag} backward: a second launch differs")
            scale = float(rz.abs().max())
            err = (gz - rz).abs()
            require(bool(torch.isfinite(gz).all()), f"{tag} backward: non-finite g_z")
            require(bool((err <= 5e-2 * scale + 5e-2 * rz.abs()).all()),
                    f"{tag} backward: g_z max |diff| {float(err.max())} at scale {scale}")
            require(float(err.mean()) < 2e-3 * scale,
                    f"{tag} backward: g_z mean |diff| {float(err.mean())} at scale {scale}")
            rel = [float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
                   for g, r in zip(grads, rgrads)]
            for i, (g, r) in enumerate(zip(grads, rgrads)):
                gmax = float((g - r).abs().max())
                require(bool(torch.isfinite(g).all()), f"{tag} backward: non-finite grad {i}")
                require(gmax <= 5e-2 * float(r.abs().max()),
                        f"{tag} backward: weight grad {i} max |diff| {gmax}")
            worst = max(worst, float(err.max()))
            # The plain version's own sum-order noise, CPU vs card, on the
            # first images (g_z of an image depends on that image alone).
            nb = max(1, min(b, 4096 // (h * w)))
            with torch.no_grad():
                cz, _ = fs.step_backward_ref([t.cpu() for t in wf], z[:nb].cpu(), gzn[:nb].cpu(),
                                             gld[:nb].cpu(), affine)
            floor = float((cz.cuda() - rz[:nb]).abs().max())
            print(f"backward {tag}: g_z max {float(err.max()):.3e} mean {float(err.mean()):.3e} "
                  f"scale {scale:.3f} | weight grads max rel {max(rel):.2e} | noise floor "
                  f"(plain CPU vs card, {nb} images) g_z max {floor:.3e}, kernel on them "
                  f"{float(err[:nb].max()):.3e}")

            if b == TRAIN_BATCH and affine:
                params = [z.detach().requires_grad_(), *step.parameters()]
                zeros = torch.zeros(b, device=z.device)

                def library():
                    out = step(params[0], zeros)
                    torch.autograd.grad(out, params, (gzn, gld))

                ms = median_ms(lambda: fs.step_backward(wf, z, gzn, gld, affine), torch)
                plain_ms = median_ms(lambda: fs.step_backward_ref(wf, z, gzn, gld, affine), torch)
                lib_ms = median_ms(library, torch)
                bound, by = bound_ms("backward", b, h, w, c, 512, affine)
                print(f"time step backward {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"library {lib_ms:.4f} ms, bound {bound:.4f} ms ({by})")
                if (h, w, c) == LEVEL_SHAPES[0]:
                    results["backward"].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                               bound_ms=bound, bound_by=by)
    results["backward"]["max_abs_err"] = worst


def clone_state(state: dict, model) -> dict:
    """A train state on `model` with copies of the optimizer state and EMA."""
    out = {**state, "model": model,
           "opt_state": {k: v.clone() for k, v in state["opt_state"].items()}}
    if "ema" in state:
        out["ema"] = [e.clone() for e in state["ema"]]
    return out


def train_step_ms(step_fn, state, batches, torch):
    """Median CUDA-event time of single train steps over `batches` (after
    one warm-up step), and the peak memory of those steps."""
    state, _ = step_fn(state, batches[0])
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
    return statistics.median(times), torch.cuda.max_memory_allocated()


def profile_step(step_fn, state, batch, torch, what: str) -> None:
    """Device time by kernel over one train step (torch.profiler), and the
    share of the step's wall time the device sat idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile {what} train step: wall {wall_ms:.3f} ms (profiler on), device busy "
          f"{busy_ms:.3f} ms in {sum(e.count for e in events)} kernels, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  {e.key[:100]}")


def check_training(torch, fs, card: str, profiling: bool = False) -> dict:
    """The training path: celeba64 at full width, b=128."""
    from pytorch_glow_tpu_torch import PRESETS, build, init_glow, train
    from pytorch_glow_tpu_torch.train import step as steplib

    profile = PRESETS["celeba64"]
    profile = profile.replace(data=dataclasses.replace(profile.data, name="synthetic_textured"))
    cfg, t = profile.glow, profile.train
    require(t.batch_size == TRAIN_BATCH, f"celeba64 batch {t.batch_size}")
    steps = cfg.K * cfg.L
    t0 = time.perf_counter()
    built = build(profile)
    torch.cuda.synchronize()
    print(f"train build (celeba64, K={cfg.K}, L={cfg.L}, hidden {cfg.hidden_channels}, "
          f"b={t.batch_size}, steps_per_call={t.steps_per_call}): {time.perf_counter() - t0:.2f} s")

    # -- the main path: one train call --------------------------------------
    fs.reset_launches()
    result = train(built, num_steps=t.steps_per_call, quiet=True)
    torch.cuda.synchronize()
    launches = dict(fs.launches)
    print(f"train: {result}; launches {launches} (K*L = {steps} per step)")
    require(result["final_step"] == t.steps_per_call and math.isfinite(result["loss"]),
            f"train result {result}")
    require(launches == {"forward": t.steps_per_call * steps, "reverse": 0,
                         "backward": t.steps_per_call * steps}, f"train launches {launches}")

    # -- fault 1: every coupling net gets gradients through the kernels, and
    # every parameter's grad is as close to the f32 grad as the unfused
    # bf16 path's -----------------------------------------------------------
    model = built.state["model"]
    plain_cfg = dataclasses.replace(cfg, flowstep_impl="xla")
    plain = init_glow(plain_cfg)
    plain.load_state_dict(model.state_dict())
    x = model.preprocess(torch.from_numpy(next(built.data)["image"]).cuda())

    def param_grads(m):
        params = list(m.parameters())
        loss, _ = m.loss_fn(x, torch.Generator(device="cuda").manual_seed(SEED))
        got = torch.autograd.grad(loss, params, allow_unused=True)
        return [g if g is not None else torch.zeros_like(p) for g, p in zip(got, params)]

    fused_g, plain_g = param_grads(model), param_grads(plain)
    ref = init_glow(dataclasses.replace(plain_cfg, compute_dtype="float32"))
    ref.load_state_dict(model.state_dict())
    ref_g = param_grads(ref)
    del ref
    names = [n for n, _ in model.named_parameters()]
    coupling = [i for i, n in enumerate(names) if ".f." in n and n.endswith("weight")]
    dead = [names[i] for i in coupling if not bool((fused_g[i] != 0).any())]
    bad = [n for n, g in zip(names, fused_g) if not bool(torch.isfinite(g).all())]
    print(f"coupling weight grads: {len(coupling)} tensors, {len(dead)} all-zero; "
          f"{len(bad)} of {len(names)} parameter grads non-finite")
    require(not dead and not bad, f"coupling grads all-zero {dead[:3]} or non-finite {bad[:3]}")
    # Both bf16 paths round the coupling net, in different orders, so their
    # grads differ by bf16 noise (up to 0.17 of the largest magnitude in the
    # deepest levels' conv1 weights, for the unfused path against f32 too).
    # A wrong gradient is off by its own size.  So each tensor's fused grad
    # must be no further from the f32-coupling grad than 1.5x the unfused
    # bf16 grad's distance, plus 1e-3, in relative l2: |g - ref| / |ref|.
    def rel_l2(g, r):
        d, n = float((g - r).norm()), float(r.norm())
        return d / n if n > 0 else (0.0 if d == 0 else math.inf)

    def rel_max(g, r):
        d, n = float((g - r).abs().max()), float(r.abs().max())
        return d / n if n > 0 else (0.0 if d == 0 else math.inf)

    rows = [(rel_l2(f, r), rel_l2(p, r), rel_max(f, p), n)
            for n, f, p, r in zip(names, fused_g, plain_g, ref_g)]
    over = [(fr, pr, n) for fr, pr, _, n in rows if fr > 1.5 * pr + 1e-3]
    worst_f = max(rows)
    worst_p = max(rows, key=lambda r: r[1])
    worst_fp = max(rows, key=lambda r: r[2])
    print(f"parameter grads, one loss_fn at b={t.batch_size}, {len(rows)} tensors, relative l2 "
          f"to the f32-coupling grads: fused worst {worst_f[0]:.3e} ({worst_f[3]}), unfused bf16 "
          f"worst {worst_p[1]:.3e} ({worst_p[3]}), fused / unfused worst "
          f"{max(fr / max(pr, 1e-30) for fr, pr, _, _ in rows):.3f}; fused vs unfused bf16 "
          f"max |diff| / max |unfused| worst {worst_fp[2]:.3e} ({worst_fp[3]})")
    require(not over, f"fused grads further from f32 than 1.5x unfused bf16 + 1e-3: {over[:3]}")
    del fused_g, plain_g, ref_g

    # -- 3 steps from one state: fused vs unfused ---------------------------
    schedule = built.schedule
    fused_step = steplib.make_train_step(cfg, built.tx, t.ema_decay, schedule, t.augment_flip)
    plain_step = steplib.make_train_step(plain_cfg, built.tx, t.ema_decay, schedule,
                                         t.augment_flip)
    state_f = built.state
    state_p = clone_state(state_f, plain)
    # The unfused path fits at the preset's batch (about 27 GiB at b=128).
    # Losses within rtol 2e-2 after 3 steps (tests/test_flowstep_pallas.py:492),
    # and the raw grads' global norm within rtol 2e-2 at every step.
    print(f"fused vs unfused, 3 steps from one state on the same batches, b={t.batch_size}")
    for _ in range(3):
        batch = torch.from_numpy(next(built.data)["image"]).cuda()
        state_f, mf = fused_step(state_f, batch)
        state_p, mp = plain_step(state_p, batch)
        lf, lp = float(mf["loss"]), float(mp["loss"])
        nf, np_ = float(mf["grad_norm"]), float(mp["grad_norm"])
        print(f"train step {state_f['step']}: loss fused {lf:.6f} unfused {lp:.6f} "
              f"(rel {abs(lf - lp) / abs(lp):.2e}), grad_norm {nf:.6f} vs {np_:.6f} "
              f"(rel {abs(nf - np_) / abs(np_):.2e})")
        require(math.isfinite(nf) and abs(nf - np_) <= 2e-2 * abs(np_),
                f"fused vs unfused grad_norm at step {state_f['step']}: {nf} vs {np_}")
    require(math.isfinite(lf) and abs(lf - lp) <= 2e-2 * abs(lp),
            f"fused vs unfused loss after 3 steps: {lf} vs {lp}")

    # -- times: train step, fused and unfused -------------------------------
    batches = [torch.from_numpy(next(built.data)["image"]).cuda() for _ in range(4)]
    del state_p
    fused_ms, fused_mem = train_step_ms(fused_step, state_f, batches, torch)
    plain_ms, plain_mem = train_step_ms(plain_step, clone_state(state_f, plain), batches, torch)
    b = t.batch_size
    print(f"time train step b={b}: fused {fused_ms:.3f} ms ({b * 1e3 / fused_ms:.1f} img/s, "
          f"peak {fused_mem / 2**30:.2f} GiB), unfused {plain_ms:.3f} ms "
          f"({b * 1e3 / plain_ms:.1f} img/s, peak {plain_mem / 2**30:.2f} GiB)")
    print(f"card for these times: {card}")
    if profiling:
        profile_step(fused_step, state_f, batches[0], torch, "fused")
        profile_step(plain_step, clone_state(state_f, plain), batches[0], torch, "unfused")
    return launches


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

    results = {d: {"max_abs_err": 0.0, "ms": None, "plain_ms": None, "bound_ms": None,
                   "bound_by": None, "library_ms": None}
               for d in ("forward", "reverse", "backward")}
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
    require(after_nll == {"forward": steps, "reverse": 0, "backward": 0},
            f"nll launches {after_nll}")
    require(bool(torch.isfinite(xs).all()), "sample finite")
    require(imgs.dtype == torch.uint8 and imgs.shape == (BATCH, *cfg.image_shape), "sample images")
    require(after_sample == {"forward": steps, "reverse": steps, "backward": 0},
            f"sample launches {after_sample}")
    require(launches == {"forward": 3 * steps, "reverse": 3 * steps, "backward": 0},
            f"reconstruct launches {launches}")
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
    del plain, plain_inf, inf, model

    # -- the training path ----------------------------------------------------
    check_backward(torch, fs, results)
    train_launches = check_training(torch, fs, card, "--profile" in sys.argv[1:])

    # Launches: forward and reverse from the serving run, backward from the
    # training run (its forward launches are checked and printed above).
    launches["backward"] = train_launches["backward"]
    print(f"training-run launches: {train_launches}")
    kernels = [
        {"name": f"flowstep_{d}", "route": "cuda",
         "source": BWD_SOURCE if d == "backward" else KERNEL_SOURCE,
         "replaces": BWD_TPU_KERNEL if d == "backward" else TPU_KERNEL,
         "launches": launches[d], **results[d]}
        for d in ("forward", "reverse", "backward")
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
