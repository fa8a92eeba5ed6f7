"""Host and device time of the LU 1x1 conv calls (`ops/invconv_fused.py`,
K6a/K6b).

    python -m pytorch_glow_tpu_torch.scripts.perf_invconv

At the cifar10 level shapes (b=256: 65536x12, 16384x24, 4096x48), each
alone:

  forward    `invconv_lu_forward(x, lu)`
  reverse    `invconv_lu_reverse(y, lu)` (the two triangular solves included)
  backward   one `_LUForward.backward` through the autograd engine:
             `torch.autograd.grad(y, leaves, g, retain_graph=True)` on the
             forward's output, x and the float factors as leaves
  layer      `InvConv1x1LU(impl="pallas").forward(x4)`, the layer's own
             per-call work (`lu_params`) included

two host times in microseconds, medians over reps: "call",
`time.perf_counter` around the call alone, from an idle device (what the
host spends before it can issue the next launch); "synced", around the
call and a `torch.cuda.synchronize` (the call, the device's work and the
sync's latency).  Then the device time of the K6 kernels of one forward
and one reverse call (no grad), and of one `torch.matmul(x, W.T)`, by
`device_ms` (by CUDA events, `queued_ms`, where the profiler's traces
hold none of them).  Last, under `torch.no_grad`, the "call" time of each
kernel's autograd Function (`_LUForward.apply`, `_Mix.apply`) against its
launcher called directly (`_launch_forward`, `_launch_mix`), in rounds
Function, direct, direct, Function: what the wrappers save by launching
without the Function where autograd records nothing; and in the same way
each kernel called through its `torch.library` op (`ops/library.py`, what
an exported graph calls) against its launcher called directly (what the
live path calls): K6a and K6b at each shape, and the flow step's K1 and K2
at celeba64 level 0 (b=64, 32x32x12, hidden 512), the weights packed once.
Prints the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

from pytorch_glow_tpu_torch.models.layers import InvConv1x1LU
from pytorch_glow_tpu_torch.ops import invconv as ic
from pytorch_glow_tpu_torch.ops import invconv_fused as icf

SHAPES = [(65536, 12), (16384, 24), (4096, 48)]
REPS = 200
# The kernels of `csrc/invconv.cu`, by function name.
K6_KERNELS = ("narrow_kernel", "build_kernel", "mix_kernel")


def device_ms(fn, names: tuple[str, ...] = (), reps: int = 20) -> float:
    """Device ms per call of `fn` (torch.profiler): for each kernel it
    launches (only those whose name holds one of `names`, if given), the
    median device time of that kernel's launches in a trace of `reps`
    calls, summed over the kernels; each kernel launched once per call.  A
    trace can drop launches, most often at its start and at times all of
    them, so medians are read rather than a sum over the trace, and a
    trace that holds none is taken again, up to three traces.  When all
    three hold none, the time is `queued_ms(fn)` instead (every kernel of
    the call, `names` or not), and a line says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_kernel: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and (not names or any(n in e.name for n in names)):
                by_kernel.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
        if by_kernel:
            return sum(statistics.median(times) for times in by_kernel.values())
    ms = queued_ms(fn, reps)
    print(f"device time by CUDA events, every kernel of the call ({ms:.4f} ms): three "
          "profiler traces held none of its kernels", flush=True)
    return ms


def queued_ms(fn, reps: int = 20, spin_cycles: int = 20_000_000) -> float:
    """Device ms per call of `fn` by CUDA events: `reps` calls queued
    behind a spinning kernel (`torch.cuda._sleep`, about 10 ms on an H100),
    so that the host has issued them all before the device reaches the
    first, and the events time the device's back-to-back work.  If the
    host took longer to queue them than the device spun, the spin is
    doubled and the calls timed again, up to three times; raises if it
    never kept ahead."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        spun, start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        spun.record()
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        stop.synchronize()
        if host_ms < spun.elapsed_time(start):
            return start.elapsed_time(stop) / reps
        spin_cycles *= 2
    raise RuntimeError(f"the host took {host_ms:.3f} ms to queue {reps} calls, longer than "
                       "the device spun")


def host_us(fn, reps: int = REPS) -> tuple[float, float]:
    """-> (median us of the call alone, median us of the call plus a sync)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    call, synced = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        call.append(t1 - t0)
        synced.append(t2 - t0)
    return 1e6 * statistics.median(call), 1e6 * statistics.median(synced)


def function_vs_direct(x, lu, y, w_inv) -> dict[str, list[float]]:
    """Under no grad, the median call us of each kernel's autograd Function
    and of its launcher alone, two rounds each, in the order Function,
    direct, direct, Function."""
    fns = {"K6a Function": lambda: icf._LUForward.apply(x, *lu),
           "K6a direct": lambda: icf._launch_forward(x, *lu),
           "K6b Function": lambda: icf._Mix.apply(y, w_inv),
           "K6b direct": lambda: icf._launch_mix(y, w_inv)}
    got: dict[str, list[float]] = {name: [] for name in fns}
    with torch.no_grad():
        for route in ("Function", "direct", "direct", "Function"):
            for kernel in ("K6a", "K6b"):
                got[f"{kernel} {route}"].append(host_us(fns[f"{kernel} {route}"])[0])
    return got


def op_vs_direct(fns: dict) -> dict[str, list[float]]:
    """Under no grad, the median call us of each kernel through its op and
    through its launcher, `fns` = {kernel: (op call, direct call)}, two
    rounds each in the order op, direct, direct, op."""
    got: dict[str, list[float]] = {f"{k} {r}": [] for k in fns for r in ("op", "direct")}
    with torch.no_grad():
        for route in ("op", "direct", "direct", "op"):
            for kernel, (op, direct) in fns.items():
                got[f"{kernel} {route}"].append(host_us(op if route == "op" else direct)[0])
    return got


def flowstep_op_vs_direct() -> dict[str, list[float]]:
    """`op_vs_direct` of K1 and K2 at celeba64 level 0, b=64."""
    from pytorch_glow_tpu_torch.models.layers import FlowStep
    from pytorch_glow_tpu_torch.ops import flowstep as fs
    from pytorch_glow_tpu_torch.ops import library

    gen = torch.Generator().manual_seed(0)
    step = FlowStep(12, 512, "affine", torch.bfloat16, 1.0, gen).cuda()
    z = torch.randn(64, 32, 32, 12, generator=gen).cuda()
    with torch.no_grad():
        fwd = fs.pack_weights(step, True, False)
        rev = fs.pack_weights(step, True, True)
    return op_vs_direct({
        "K1": (lambda: library.flowstep_forward(z, True, fwd),
               lambda: fs.step_forward(fwd, z, True)),
        "K2": (lambda: library.flowstep_reverse(z, True, rev),
               lambda: fs.step_reverse(rev, z, True))})


def _print_rounds(what: str, routes: dict) -> None:
    print(f"{what}, call us by round: " + ", ".join(
        f"{k} {' / '.join(f'{t:.1f}' for t in v)}" for k, v in routes.items()))


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("perf_invconv needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    device_ms(lambda: torch.zeros(1, device="cuda"))  # the profiler's first trace
    rows = {}
    for n, c in SHAPES:
        conv = InvConv1x1LU(c, gen, impl="pallas").cuda()
        with torch.no_grad():
            lu = conv.lu_params()
            w = conv.matrix()
        x = torch.randn(n, c, generator=gen).cuda()
        g = torch.randn(n, c, generator=gen).cuda()
        with torch.no_grad():
            y, _ = icf.invconv_lu_forward(x, lu)
        leaves = [t.detach().clone().requires_grad_() for t in (x, lu.l_raw, lu.u_raw,
                                                                lu.log_s)]
        lu_g = lu._replace(l_raw=leaves[1], u_raw=leaves[2], log_s=leaves[3])
        y_g, _ = icf.invconv_lu_forward(leaves[0], lu_g)
        x4 = x.view(1, 1, n, c)
        with torch.no_grad():
            got = {
                "forward": host_us(lambda: icf.invconv_lu_forward(x, lu)),
                "reverse": host_us(lambda: icf.invconv_lu_reverse(y, lu)),
                "layer": host_us(lambda: conv(x4)),
            }
            dev = {"forward": device_ms(lambda: icf.invconv_lu_forward(x, lu), K6_KERNELS),
                   "reverse": device_ms(lambda: icf.invconv_lu_reverse(y, lu), K6_KERNELS),
                   "torch.matmul": device_ms(lambda: torch.matmul(x, w.T))}
        got["backward"] = host_us(lambda: torch.autograd.grad(y_g, leaves, g, retain_graph=True))
        with torch.no_grad():
            w_inv = ic.lu_inverse(lu)
        routes = function_vs_direct(x, lu, y, w_inv)
        from pytorch_glow_tpu_torch.ops import library

        ops = op_vs_direct({"K6a": (lambda: library.invconv_lu_forward(x, *lu),
                                    lambda: icf._launch_forward(x, *lu)),
                            "K6b": (lambda: library.invconv_mix(y, w_inv),
                                    lambda: icf._launch_mix(y, w_inv))})
        for what in ("forward", "reverse", "backward", "layer"):
            call, synced = got[what]
            print(f"host {what} {n}x{c}: call {call:.1f} us, synced {synced:.1f} us")
        print(f"device {n}x{c}: " + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in dev.items()))
        _print_rounds(f"no grad {n}x{c}", routes)
        _print_rounds(f"op vs direct {n}x{c}", ops)
        rows[(n, c)] = {"host_us": got, "device_ms": dev, "function_vs_direct_us": routes,
                        "op_vs_direct_us": ops}
    rows["flowstep"] = flowstep_op_vs_direct()
    _print_rounds("op vs direct, flow step celeba64 level 0 b=64", rows["flowstep"])
    print(f"card for these times: {card}")
    return rows


if __name__ == "__main__":
    main()
