"""Where the ms of the celeba64 forward and sample go, component by
component, on the card's device and on the launch thread.

    python -m pytorch_glow_tpu_torch.scripts.perf_breakdown
    python -m pytorch_glow_tpu_torch.scripts.perf_breakdown --cpu --batch 2 --n1 1 --n2 2 \\
        --full-n1 1 --full-n2 2 --set glow.hidden_channels=8 --set glow.K=2

Counterpart of the JAX package's `scripts/perf_breakdown.py`: celeba64 at
b=128, random weights from seed 0, DDI on a uint8 batch from seed 1.

- The full paths: `log_prob`, `sample` at T=0.7 and `reconstruct`, N =
  3 / 13 (`--full-n1` / `--full-n2`).
- Per level, on the unfused modules of step 0 (`models/layers.py`), N =
  20 / 120 (`--n1` / `--n2`), on a seeded f32 z (seed = the level): the
  coupling forward and reverse at the preset's compute dtype
  (`FlowStep.coupling_forward` / `coupling_reverse`), the LU mix and its
  reverse (`InvConv1x1LU`, at the preset's `invconv_impl`) and `ActNorm`.
  Each is multiplied by K and summed, and the sums are set against the
  full paths.
- Level 0's coupling net: conv1 (3x3, c/2 -> hidden, with its actnorm),
  conv2 (1x1, hidden -> hidden) and conv3 (`Conv2dZeros`), at the compute
  dtype.

Eager PyTorch has no jit that hides the launch, so each item has two
numbers, and a third where it can be read.  `device_ms`: two-N
differencing on CUDA events, the N calls issued back to back
(`_anatomy.two_n_ms`), so the stream's time per call, which includes any
wait for the host.  `host_ms`: the launch thread's wall time to issue N2
calls with no sync, divided by N2.  `busy_ms`: the device's own time,
two-N over at most 2 and 6 calls (`BUSY_N`) queued behind a spinning
kernel (`torch.cuda._sleep`) sized to outlast their issue, so that the
events time back-to-back work; None ("not measured") where the host
could not stay ahead of the spin (a call that syncs, or more launches
than the launch queue holds: the full paths, where it is not
attempted).  An item is host-bound where `host_ms` is larger than
`busy_ms`.

Runs on the card; `--cpu` runs on CPU tensors (wall clock; `busy_ms` not
measured), for the tests.  Prints the card's name and power limit first;
`main` returns {"card", "full": {...}, "levels": [...], "sums": {...},
"component_sum": {...}, "conv": {...}}, each item {"device_ms",
"host_ms", "busy_ms"}.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from pytorch_glow_tpu_torch.config import PRESETS
from pytorch_glow_tpu_torch.models.glow import init_glow
from pytorch_glow_tpu_torch.scripts import _anatomy as A
from pytorch_glow_tpu_torch.utils.profiles import apply_overrides

TEMPERATURE = 0.7
COMPONENTS = ("coupling", "coup_rev", "invconv", "invconv_rev", "actnorm")
# The counts `busy_ms` queues, at most: more calls of a component than this
# would fill the launch queue behind the spin and block the host.
BUSY_N = (2, 6)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--n1", type=int, default=20, help="the components' smaller N")
    p.add_argument("--n2", type=int, default=120)
    p.add_argument("--full-n1", type=int, default=3, help="the full paths' smaller N")
    p.add_argument("--full-n2", type=int, default=13)
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SEC.KEY=VAL", help="overrides of the celeba64 profile")
    p.add_argument("--cpu", action="store_true", help="run on CPU tensors")
    return p.parse_args(argv)


def components(step, b: int):
    """The unfused step's parts as callables of z, each returning what the
    JAX function the JAX script times returns: `actnorm_forward`'s y,
    `mix_channels` over `lu_assemble` / `lu_inverse`, and
    `coupling_forward`'s (out, logdet) / `coupling_reverse`'s out."""
    def coupling(z):
        return step.coupling_forward(z, torch.zeros(b, device=z.device))

    return {"coupling": coupling,
            "coup_rev": step.coupling_reverse,
            "invconv": lambda z: step.permutation(z)[0],
            "invconv_rev": step.permutation.reverse,
            "actnorm": lambda z: step.actnorm(z)[0]}


def host_ms(fn, n: int) -> float:
    """The launch thread's ms per call: the wall time to issue n calls with
    no sync, divided by n (best of 3)."""
    best = float("inf")
    for _ in range(3):
        _sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, 1e3 * (time.perf_counter() - t0) / n)
    _sync()
    return best


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _spin_cycles_per_ms() -> float:
    """`torch.cuda._sleep` cycles per ms of device time on this card."""
    cycles = 10_000_000
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(cycles)
    start.record()
    torch.cuda._sleep(cycles)
    stop.record()
    stop.synchronize()
    return cycles / start.elapsed_time(stop)


def busy_ms(fn, n1: int, n2: int, issue_ms: float, cycles_per_ms: float) -> float | None:
    """The device's ms per call: two-N over n1 and n2 calls queued behind a
    spin of 1.5 times their issue time (`issue_ms` a call) plus 2 ms,
    doubled once where the host fell behind it; None where it fell behind
    twice (a call that syncs, or more launches than the launch queue
    holds)."""
    def run(n: int) -> float | None:
        cycles = int(cycles_per_ms * (1.5 * issue_ms * n + 2.0))
        for _ in range(2):
            spun, start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            torch.cuda.synchronize()
            spun.record()
            torch.cuda._sleep(cycles)
            start.record()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            issued = 1e3 * (time.perf_counter() - t0)
            stop.record()
            stop.synchronize()
            if issued < spun.elapsed_time(start):
                return start.elapsed_time(stop)
            cycles *= 2
        return None

    t1 = run(n1)
    t2 = None if t1 is None else run(n2)
    if t2 is None or t2 <= t1:
        return None
    return (t2 - t1) / (n2 - n1)


class Timer:
    """The three numbers of the module docstring for a callable."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.cycles_per_ms = _spin_cycles_per_ms() if cuda else None

    def __call__(self, fn, n1: int, n2: int, busy: bool = True) -> dict:
        """`busy` False: the device's own time is not attempted (None)."""
        with torch.no_grad():
            device = A.two_n_ms(fn, n1, n2, self.cuda)
            host = host_ms(fn, n2)
            if self.cuda and busy:
                busy = busy_ms(fn, min(n1, BUSY_N[0]), min(n2, BUSY_N[1]), host,
                               self.cycles_per_ms)
            else:
                busy = None
        return {"device_ms": device, "host_ms": host, "busy_ms": busy}


def _fmt(t: dict) -> str:
    busy = "not measured" if t["busy_ms"] is None else f"{t['busy_ms'] * 1e3:.0f}"
    bound = "" if t["busy_ms"] is None else (
        ", host-bound" if t["host_ms"] > t["busy_ms"] else ", device-bound")
    return (f"{t['device_ms'] * 1e3:.0f} us (host {t['host_ms'] * 1e3:.0f}, busy {busy}"
            f"{bound})")


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    cuda = device.type == "cuda"
    card = A.card() if cuda else "cpu"
    print(f"card: {card}", flush=True)
    cfg = apply_overrides(PRESETS["celeba64"], args.overrides).glow
    b, n1, n2 = args.batch, args.n1, args.n2
    fn1, fn2 = args.full_n1, args.full_n2
    for lo, hi in ((n1, n2), (fn1, fn2)):
        if hi <= lo:
            raise ValueError(f"two-N differencing needs N2 > N1, got {lo}, {hi}")
    print(f"device: {torch.cuda.get_device_name(0) if cuda else 'cpu'}  batch={b}  "
          f"N={n1},{n2}  full N={fn1},{fn2}  ({cfg.compute_dtype} coupling, "
          f"invconv_impl={cfg.invconv_impl})", flush=True)
    h, w, c = cfg.image_shape
    model = init_glow(cfg, torch.Generator().manual_seed(0), device)
    x_u8 = torch.randint(0, 256, (b, h, w, c), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1)).to(device)
    x = model.preprocess(x_u8)
    model.ddi_init(x)
    timer = Timer(cuda)

    # -- the full paths ------------------------------------------------------------
    gen = torch.Generator(device=device).manual_seed(2)
    # One call issues more launches than the launch queue holds, so the
    # host cannot run ahead of a spin: the device's own time is not read.
    full = {
        "forward": timer(lambda: model.log_prob(x)["nll"], fn1, fn2, busy=False),
        "sample": timer(lambda: model.sample(b, TEMPERATURE, gen), fn1, fn2, busy=False),
        "recon": timer(lambda: model.reconstruct(x), fn1, fn2, busy=False),
    }
    for name, t in full.items():
        print(f"full {name:8s} {_fmt(t)}  ({1e3 * b / t['device_ms']:8.0f} img/s)", flush=True)

    # -- the components of one step, per level ---------------------------------------
    levels = []
    sums = {k: {"device_ms": 0.0, "host_ms": 0.0, "busy_ms": 0.0} for k in COMPONENTS}
    for li, (lh, lw, lc) in enumerate(cfg.latent_shapes()):
        z = torch.randn(b, lh, lw, lc, generator=torch.Generator().manual_seed(li)).to(device)
        parts = components(model._levels[li][0][0], b)
        row = {k: timer(lambda f=f: f(z), n1, n2) for k, f in parts.items()}
        levels.append({"shape": [lh, lw, lc], **row})
        for k, t in row.items():
            for key, v in t.items():
                s = sums[k][key]
                sums[k][key] = None if s is None or v is None else s + v * cfg.K
        print(f"level {li} ({lh}x{lw}x{lc}): "
              + "  ".join(f"{k} {_fmt(t)}" for k, t in row.items()) + f"  (x K={cfg.K})",
              flush=True)
    print("\nK-weighted sums (ms): " + "  ".join(
        f"{k} {v['device_ms']:.2f} (host {v['host_ms']:.2f})" for k, v in sums.items()))
    fwd = {key: _sum(sums, ("coupling", "invconv", "actnorm"), key) for key in sums["actnorm"]}
    rev = {key: _sum(sums, ("coup_rev", "invconv_rev", "actnorm"), key) for key in sums["actnorm"]}
    print(f"component sum: fwd {fwd['device_ms']:.1f} ms, host {fwd['host_ms']:.1f} "
          f"(full {full['forward']['device_ms']:.1f}, host {full['forward']['host_ms']:.1f})   "
          f"rev {rev['device_ms']:.1f} ms, host {rev['host_ms']:.1f} (full sample "
          f"{full['sample']['device_ms']:.1f}, host {full['sample']['host_ms']:.1f})", flush=True)

    # -- level 0's coupling net ---------------------------------------------------------
    lh, lw, lc = cfg.latent_shapes()[0]
    step = model._levels[0][0][0]
    dtype = step.compute_dtype
    z1 = torch.randn(b, lh, lw, lc // 2,
                     generator=torch.Generator().manual_seed(9)).to(device, dtype)
    hbuf = torch.randn(b, lh, lw, cfg.hidden_channels,
                       generator=torch.Generator().manual_seed(10)).to(device, dtype)
    net = step.f  # conv1, ReLU, conv2, ReLU, conv3
    conv = {"conv1": timer(lambda: net[0](z1), n1, n2),
            "conv2": timer(lambda: net[2](hbuf), n1, n2),
            "conv3": timer(lambda: net[4](hbuf), n1, n2)}
    hid = cfg.hidden_channels
    print(f"\nlevel-0 coupling internals ({lh}x{lw}, w={hid}, {cfg.compute_dtype}):")
    for name, what in (("conv1", f"3x3 {lc // 2}->{hid}"), ("conv2", f"1x1 {hid}->{hid}"),
                       ("conv3", f"3x3 {hid}->{lc} (zeros)")):
        print(f"  {name} {what}: {_fmt(conv[name])}", flush=True)
    return {"card": card, "batch": b, "full": full, "levels": levels, "sums": sums,
            "component_sum": {"forward": fwd, "reverse": rev}, "conv": conv}


def _sum(sums: dict, keys, key: str):
    vals = [sums[k][key] for k in keys]
    return None if any(v is None for v in vals) else sum(vals)


if __name__ == "__main__":
    main()
