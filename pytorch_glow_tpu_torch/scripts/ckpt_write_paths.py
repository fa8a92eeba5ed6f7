"""What a snapshot written on a second thread costs the train loop, by
write path, at a preset's full size on the card.

The train step is bound by its launch thread, and a writer thread in the
same process shares the GIL with it.  This script builds the preset's
train state (random weights from seed 0).  For each variant below, `--reps`
times in turns, it starts the variant right after a train step and times
the next `--steps` train steps on the fused kernels (each ending on a host
read of its loss), then as many steps with nothing in flight.  A variant's
cost to the loop is its start plus the first sum less the second; the
first step after the start is where a writer's Python work lands.

  manager     `CheckpointManager.save`: the capture (one pinned buffer a
              dtype, filled by one device-to-host copy after a `torch.cat`
              on the card) and the write on its thread, the tensor entries'
              pickled bytes reused (`utils/checkpoint._pickle_module`)
  plain       the same with a plain `torch.save`, which pickles every
              tensor at every save
  copy        the capture alone, no thread
  flat        a thread writing the captured views with `torch.save` to a
              path (no capture: the buffers hold the last one)
  raw         a thread writing the buffers' bytes alone (`os.write`)
  file        a thread writing one pinned host tensor a state entry with
              `torch.save` to an open file object (each storage goes
              through Python)

Prints the card's name and power limit, then one JSON line a variant: the
medians over the reps of the cost and of the first step's excess over the
median step alone, and every rep's step times.

    python -m pytorch_glow_tpu_torch.scripts.ckpt_write_paths [--preset celeba64] [--reps 4]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time

VARIANTS = ("manager", "plain", "copy", "flat", "raw", "file")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="celeba64")
    p.add_argument("--steps", type=int, default=4, help="steps timed from each start")
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--variants", default=",".join(VARIANTS))
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    from pytorch_glow_tpu_torch.config import PRESETS
    from pytorch_glow_tpu_torch.models.glow import init_glow
    from pytorch_glow_tpu_torch.ops import _build
    from pytorch_glow_tpu_torch.scripts.ckpt_stall_ab import card_line
    from pytorch_glow_tpu_torch.train import step as steplib
    from pytorch_glow_tpu_torch.train.optim import make_optimizer
    from pytorch_glow_tpu_torch.utils import checkpoint as ck

    print(f"# card: {card_line()}", flush=True)
    _build.library()
    prof = PRESETS[args.preset]
    g, t = prof.glow, prof.train
    gen = torch.Generator().manual_seed(0)
    model = init_glow(g, gen, "cuda")
    tx = make_optimizer(prof.optim, t)
    state = steplib.init_state(model, tx, t.ema_decay, t.seed)
    step_fn = steplib.make_train_step(g, tx, t.ema_decay)
    batch = torch.randint(0, 256, (t.batch_size, *g.image_shape), generator=gen,
                          dtype=torch.uint8).cuda()
    out_dir = tempfile.mkdtemp(prefix="ckpt_write_paths_")
    manager = ck.CheckpointManager(os.path.join(out_dir, "manager"), keep=1)
    staging: dict = {}
    host, _ = ck._capture(manager._snapshot(0, state, None, {}), staging)
    torch.cuda.synchronize()
    separate = {f"t{i}": x.clone().pin_memory() for i, x in enumerate(ck._tensors(host))}
    buffers = list(staging["flats"].values())
    real_save_file = ck._save_file

    def write(kind: str) -> None:
        target = os.path.join(out_dir, f"{kind}.pt")
        if kind == "flat":
            torch.save(host, target)
        elif kind == "raw":
            fd = os.open(target, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
            try:
                for b in buffers:
                    os.write(fd, b.view(torch.uint8).numpy().data)
            finally:
                os.close(fd)
        elif kind == "file":
            with open(target, "wb") as f:
                torch.save(separate, f)

    def timed_step() -> float:
        nonlocal state
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["loss"])
        return 1e3 * (time.perf_counter() - t0)

    def run(kind: str) -> dict:
        t0 = time.perf_counter()
        thread = None
        if kind in ("manager", "plain"):
            if kind == "plain":
                ck._save_file = lambda snap, path, staging: torch.save(snap, path)
            manager.save(0, state, None, {})
        elif kind == "copy":
            ck._capture(manager._snapshot(0, state, None, {}), staging)
        else:
            thread = threading.Thread(target=write, args=(kind,))
            thread.start()
        start_ms = 1e3 * (time.perf_counter() - t0)
        with_it = [timed_step() for _ in range(args.steps)]
        if thread is not None:
            thread.join()
        manager.wait()
        ck._save_file = real_save_file
        torch.cuda.synchronize()
        alone = [timed_step() for _ in range(args.steps)]
        return {"start_ms": start_ms, "steps_ms": with_it, "alone_ms": alone,
                "cost_ms": start_ms + sum(with_it) - sum(alone),
                "first_excess_ms": with_it[0] - statistics.median(alone)}

    for _ in range(2):  # the kernels' first calls
        timed_step()
    manager.save(0, state, None, {}, wait=True)  # its buffers' allocation
    kinds = args.variants.split(",")
    runs: dict = {k: [] for k in kinds}
    try:
        for rep in range(args.reps):
            for kind in (kinds if rep % 2 == 0 else kinds[::-1]):
                runs[kind].append(run(kind))
    finally:
        manager.close()
        shutil.rmtree(out_dir, ignore_errors=True)
    rows = []
    for kind in kinds:
        row = {"variant": kind,
               "median_cost_ms": statistics.median(r["cost_ms"] for r in runs[kind]),
               "median_first_excess_ms": statistics.median(r["first_excess_ms"]
                                                           for r in runs[kind]),
               "bytes": sum(b.numel() * b.element_size() for b in buffers),
               "tensors": len(separate), "reps": runs[kind]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
