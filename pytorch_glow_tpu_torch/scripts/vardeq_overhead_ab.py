"""In one process: the train step's cost of variational dequantization
(`models/vardeq.py`) against uniform, at a preset's full size.

Counterpart of `scripts/vardeq_overhead_ab.py`.  Each arm builds the
preset's model with `glow.dequant` set (random weights from seed 0, DDI on
a random uint8 batch), then times `steps_per_call` chained train steps per
call: one warm-up call, then two-N differencing (n1 = 2 and n2 = 6 calls,
the device synchronised after each run), so that fixed per-run costs
cancel.  Prints one JSON line per arm and the overhead in percent.

    python -m pytorch_glow_tpu_torch.scripts.vardeq_overhead_ab [--preset cifar10] [--spc 5]
    python -m pytorch_glow_tpu_torch.scripts.vardeq_overhead_ab --cpu --batch-size 4 \\
        --set glow.hidden_channels=8 --set glow.K=2

Environment defaults as the JAX script's: AB_PRESET (cifar10), AB_SPC (5),
AB_BATCH (the preset's batch).  On the card unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default=os.environ.get("AB_PRESET", "cifar10"))
    p.add_argument("--spc", type=int, default=int(os.environ.get("AB_SPC", "5")))
    p.add_argument("--batch-size", type=int,
                   default=int(os.environ["AB_BATCH"]) if os.environ.get("AB_BATCH") else None)
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SEC.KEY=VAL", help="profile overrides")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def run(prof, spc: int, batch: int, device) -> dict:
    """The train step's images/s and ms of `prof` (module docstring)."""
    import torch

    from pytorch_glow_tpu_torch.models.glow import init_glow
    from pytorch_glow_tpu_torch.train import step as steplib
    from pytorch_glow_tpu_torch.train.optim import make_optimizer, make_schedule

    g = prof.glow
    gen = torch.Generator().manual_seed(0)
    model = init_glow(g, gen, device)
    tx = make_optimizer(prof.optim, prof.train)
    x = torch.randint(0, 256, (batch, *g.image_shape), generator=gen, dtype=torch.uint8)
    dq = torch.Generator(device=device).manual_seed(2)
    model.ddi_init(model.dequantize(model.preprocess(x.to(device)), dq))
    state = steplib.init_state(model, tx, prof.train.ema_decay)
    step_n = steplib.make_train_step_n(g, tx, spc, prof.train.ema_decay,
                                       make_schedule(prof.optim))
    batches = torch.randint(0, 256, (spc, batch, *g.image_shape), generator=gen,
                            dtype=torch.uint8).to(device)
    y = None
    if g.y_condition:
        labels = torch.randint(0, g.y_classes, (spc, batch), generator=gen)
        y = torch.nn.functional.one_hot(labels, g.y_classes).float().to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    state, metrics = step_n(state, batches, y)
    loss0 = float(metrics["loss"])
    first_s = time.perf_counter() - t0

    def calls(n: int):
        nonlocal state
        sync()
        t = time.perf_counter()
        for _ in range(n):
            state, m = step_n(state, batches, y)
        sync()
        return time.perf_counter() - t, m

    n1, n2 = 2, 6
    t1, _ = calls(n1)
    t2, metrics = calls(n2)
    per_step = (t2 - t1) / ((n2 - n1) * spc)
    return {"impl": g.flowstep_impl, "remat": g.remat,
            "train_images_per_sec": round(batch / per_step, 1),
            "ms_per_step": round(1000 * per_step, 2), "first_call_s": round(first_s, 1),
            "loss0": round(loss0, 4), "loss": round(float(metrics["loss"]), 4),
            "grad_norm": round(float(metrics["grad_norm"]), 4),
            "raw_wall_s": [round(t1, 3), round(t2, 3)]}


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    from pytorch_glow_tpu_torch.config import PRESETS
    from pytorch_glow_tpu_torch.utils.profiles import apply_overrides

    prof = apply_overrides(PRESETS[args.preset], args.overrides)
    batch = args.batch_size or prof.train.batch_size
    device = torch.device("cpu" if args.cpu else "cuda")
    kind = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    print(f"# vardeq-overhead A/B: {args.preset} b={batch} spc={args.spc} on {kind}", flush=True)
    out = {}
    for dequant in ("uniform", "variational"):
        p = prof.replace(glow=dataclasses.replace(prof.glow, dequant=dequant))
        r = run(p, args.spc, batch, device)
        r["dequant"] = dequant
        out[dequant] = r
        print(json.dumps(r), flush=True)
    u, v = (out[k]["train_images_per_sec"] for k in ("uniform", "variational"))
    summary = {"overhead_pct": round(100.0 * (u - v) / u, 2)}
    print(json.dumps(summary), flush=True)
    return {**out, **summary}


if __name__ == "__main__":
    main()
