"""What the three anatomy scripts share: the celeba64 level-0 step, the
bound (`flowstep.bound_ms`), two-N differencing and the per-kernel split
of a chain.  The timing tools `perf_fused_levels`, `perf_breakdown` and
`bench_train` take their knobs, the card line and two-N differencing from
here too.

Every variant is timed by two-N differencing: CUDA events around N1 and
then N2 back-to-back launches on one stream, each count warmed up once and
timed best of 3, t = (t2 - t1) / (N2 - N1), so the per-call host time and
the first launch's latency cancel.  Outputs and scratch are allocated once,
outside the loops (`anatomy.make_buffers`).
"""

from __future__ import annotations

import os
import subprocess
import time

import torch

from pytorch_glow_tpu_torch.config import PRESETS
from pytorch_glow_tpu_torch.models.glow import init_glow
from pytorch_glow_tpu_torch.ops import anatomy, flowstep as fs

HH = WW = 32
C = 12
HIDDEN = 512
# bf16 operations per pixel of the coupling net's three products: conv1
# (K = 9 * C/2), conv2 (K = HIDDEN) and the tap-packed conv3 (N = 9 * C).
CONV1_OPS, CONV2_OPS, CONV3_OPS = (2 * HIDDEN * k for k in (9 * C // 2, HIDDEN, 9 * C))
# The wgmma/TMA GEMM core's kernel (csrc/gemm_sm90.cuh), and the coupling
# net's launches in order (csrc/flowstep_common.cuh `launch_net`) as
# `chain_split` lists them: the patch staging, then the three products.
CORE = "sm90::gemm_kernel"
NET = [("stage_patches_kernel", "conv1 patch staging", 0),
       (CORE, "conv1 GEMM (staged patches)", CONV1_OPS), (CORE, "conv2 GEMM", CONV2_OPS),
       (CORE, "conv3 GEMM (tap-packed)", CONV3_OPS)]
# direction: (its variants in order, its launch)
VARIANTS = {"forward": (anatomy.FORWARD, anatomy.forward_variant),
            "reverse": (anatomy.REVERSE, anatomy.reverse_variant),
            "backward": (anatomy.BACKWARD, anatomy.backward_variant)}


def knobs(batch: int | None, n1: int | None, n2: int | None, n1_default: int,
          n2_default: int, prefix: str = "KA") -> tuple[int, int, int]:
    """The batch and the two launch counts: arguments, else <prefix>_BATCH /
    <prefix>_N1 / <prefix>_N2 from the environment, else 128 and the
    defaults."""
    batch = batch or int(os.environ.get(f"{prefix}_BATCH", "128"))
    n1 = n1 or int(os.environ.get(f"{prefix}_N1", str(n1_default)))
    n2 = n2 or int(os.environ.get(f"{prefix}_N2", str(n2_default)))
    if n2 <= n1:
        raise ValueError(f"two-N differencing needs N2 > N1, got {n1}, {n2}")
    return batch, n1, n2


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them; raises
    without a CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("these scripts time the CUDA kernels and need a CUDA card")
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def operands(direction: str, b: int) -> dict:
    """The scripts' operands on the card, as `report` takes them:
    celeba64's level-0 step 0 from `init_glow` with seed 0, packed for
    `direction` (affine); z (b, 32, 32, 12) normal from seed 1 and, for the
    backward, g_zn the next draw and g_ld = 1; matmul_only's staged patches
    from seed 3."""
    cfg = PRESETS["celeba64"].glow
    model = init_glow(cfg, torch.Generator().manual_seed(0), "cuda")
    step = model._levels[0][0][0]
    with torch.no_grad():
        weights = [t.contiguous() for t in fs.pack_weights(step, True, direction == "reverse")]
    gen = torch.Generator().manual_seed(1)
    out = {"weights": weights, "z": torch.randn(b, HH, WW, C, generator=gen).cuda()}
    if direction == "backward":
        out["g_zn"] = torch.randn(b, HH, WW, C, generator=gen).cuda()
        out["g_ld"] = torch.ones(b, device="cuda")
    out["patches"] = anatomy.staged_patches(b, HH, WW, C, torch.Generator().manual_seed(3))
    return out


def two_n_ms(fn, n1: int, n2: int, cuda: bool = True) -> float:
    """Device time per call of fn by two-N differencing (module docstring).
    With `cuda` False (a tool's CPU run, for the tests) the wall time of n2
    calls over n2, best of 3: a CPU's wall clock under other load can read
    fewer ms for more calls, so it is not differenced."""
    if not cuda:
        fn()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n2):
                fn()
            best = min(best, 1e3 * (time.perf_counter() - t0) / n2)
        return best

    def run(n: int) -> float:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop))
        return best

    t1, t2 = run(n1), run(n2)
    if t2 <= t1:
        raise RuntimeError(f"two-N differencing read {t1} ms for {n1} calls and {t2} ms for "
                           f"{n2}: no time per call")
    return (t2 - t1) / (n2 - n1)


def chain_split(fn, chain: list[tuple[str, str, int]],
                reps: int = 5) -> dict[str, float] | None:
    """Device ms per call of each labelled part of a chain (torch.profiler):
    `chain` lists the chain's launches in order as (kernel function name,
    or names that may launch there joined by "|", label, bf16 operations
    per pixel); parts with one label are summed.
    Kernels that no chain name matches (a wrapper's own copies and fills
    around its C entry, such as the backward's weight transposes) are left
    out.  A trace can miss the kernels of its first milliseconds, so it
    spans 2 * reps calls and the last `reps` are read, and one that holds
    fewer launches than that is taken again, up to three traces; None (not
    measured) if the third holds fewer too; raises unless the launches read
    are the chain's in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    want = [name.split("|") for name, _, _ in chain] * reps
    names = {n for alternatives in want for n in alternatives}
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2 * reps):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                          and any(n in e.name for n in names)),
                         key=lambda e: e.time_range.start)
        if len(kernels) >= len(want):
            break
    else:
        print(f"the per-kernel split is not measured: three profiler traces held {len(kernels)} "
              f"of the {len(want)} launches read", flush=True)
        return None
    kernels = kernels[-len(want):]
    names = [e.name for e in kernels]
    if len(kernels) != len(want) or not all(any(w in n for w in ws)
                                            for ws, n in zip(want, names)):
        raise RuntimeError(f"the trace's last {len(kernels)} kernels are not the chain's "
                           f"{len(chain)} x {reps}: {names[:len(chain) + 2]}")
    split: dict[str, float] = {}
    for i, e in enumerate(kernels):
        label = chain[i % len(chain)][1]
        split[label] = split.get(label, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return split


def _copy(out):
    """A launch's outputs, copied out of the timing loop's buffers."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_copy(t) for t in out)


def report(title: str, direction: str, b: int, n1: int, n2: int, operands: dict,
           chain: list[tuple[str, str, int]]) -> dict:
    """Time each variant of `direction` on `operands` (the keyword
    arguments of `anatomy.<direction>_variant` but the variant and the
    buffers), print one row each, the bound and `full`'s per-kernel split
    (with each GEMM's bf16 rate).  Returns {"rows": [...], "split": {...}
    or None where the traces dropped launches,
    "bound_ms": ..., "outputs": {variant: what one more launch returned,
    copied}, "operands": operands}, so that a caller can hold each timed
    variant against its plain version."""
    variants, fn = VARIANTS[direction]
    bound = fs.bound_ms(direction, b, HH, WW, C, HIDDEN, True)[0]
    print(f"card: {card()}", flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} level-0 {title} {HH}x{WW} c={C} "
          f"hidden={HIDDEN} b={b} N={n1},{n2}", flush=True)
    bufs = anatomy.make_buffers(direction, operands["weights"], operands["z"])

    def launch(variant: str):
        return fn(variant, **operands, buffers=bufs)

    rows, outputs, base = [], {}, None
    key = f"anatomy_{direction}"
    with torch.no_grad():
        for variant in variants:
            before = anatomy.launches[key]
            ms = two_n_ms(lambda: launch(variant), n1, n2)
            base = base or ms
            row = {"variant": variant, "ms": ms, "bound_share": bound / ms,
                   "vs_full": (ms - base) / base, "launches": anatomy.launches[key] - before}
            rows.append(row)
            outputs[variant] = _copy(launch(variant))
            print(f"{variant:12s}: {ms * 1e3:9.2f} us  ({100 * row['bound_share']:5.2f}% of "
                  f"bound, {100 * row['vs_full']:+6.1f}% time vs full, {row['launches']} "
                  "launches)", flush=True)
        print(f"bound (bf16 {fs.PEAK_BF16:.3g} FLOP/s, f32 {fs.PEAK_F32:.3g}, "
              f"{fs.PEAK_BYTES:.3g} B/s): {bound * 1e3:9.2f} us", flush=True)
        split = chain_split(lambda: launch("full"), chain)
    if split is not None:
        total = sum(split.values())
        print(f"full, device time by kernel (torch.profiler, {total * 1e3:.2f} us per call):",
              flush=True)
        ops = {label: n * b * HH * WW for _, label, n in chain if n}
        for label, ms in split.items():
            rate = (f"  {ops[label] / ms / 1e9:6.1f} TFLOP/s, "
                    f"{1e3 * ops[label] / ms / fs.PEAK_BF16:4.1%} of the bf16 peak"
                    if label in ops else "")
            print(f"  {label:44s} {ms * 1e3:9.2f} us  {100 * ms / total:5.1f}%{rate}", flush=True)
    return {"rows": rows, "split": split, "bound_ms": bound, "outputs": outputs,
            "operands": operands}
