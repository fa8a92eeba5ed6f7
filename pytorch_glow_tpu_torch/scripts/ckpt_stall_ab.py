"""How long a snapshot holds up the train loop, at a preset's full size.

Counterpart of `scripts/ckpt_stall_ab.py`.  Builds the preset's train state
(random weights from seed 0, the optimizer's state, the EMA) on the card
(`--cpu` for a CPU run), then saves it through the port's asynchronous
`CheckpointManager` into a temporary directory, removed at the end.  Each
of `--reps` rounds times a background save, its drain and a synchronous
save of the same state; then one best save.  Prints the card's name and
power limit (nvidia-smi) first, then one JSON object:

  save_return_s       what `save()` holds up the loop: the call (the
                      capture: host-buffer copies queued on the stream and
                      the writer thread started) and the device sync that
                      completes the copy, which the next step's kernels
                      would queue behind anyway
  drain_s             the rest of the background write after that
                      (`wait()`): `torch.save`, the move into place, the
                      prune
  sync_save_s         `save(..., wait=True)`: the whole save in the loop,
                      what the port did before its saves went to a thread
  best_save_return_s  the same as save_return_s for `maybe_save_best`
  best_save_total_s   the best save through its `wait()` (the write and
                      best.json)
  state_mb            bytes of the snapshot's tensors (parameters,
                      optimizer state, EMA) / 1e6
  stall_pct           save_return_s as a share of the wall time of
                      `checkpoint_gap` steps at `--imgs-per-sec`

The first round pays the host buffers' allocation: the steady figures are
the minimum over the later rounds (all rounds where there is one), and
`reps` holds every round.

    python -m pytorch_glow_tpu_torch.scripts.ckpt_stall_ab celeba64 --imgs-per-sec 400
    python -m pytorch_glow_tpu_torch.scripts.ckpt_stall_ab cifar10 --cpu --reps 2 \\
        --set glow.hidden_channels=8 --set glow.K=2
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("profile", help="preset name")
    p.add_argument("--imgs-per-sec", type=float, default=None,
                   help="the preset's measured train rate, for stall_pct")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--dir", default=None,
                   help="where the temporary snapshot directory goes (default: the system's)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SEC.KEY=VAL", help="profile overrides")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def train_state(prof, device):
    """The preset's train state on `device`, and its snapshot's tensor bytes."""
    import torch

    from pytorch_glow_tpu_torch.models.glow import init_glow
    from pytorch_glow_tpu_torch.train import step as steplib
    from pytorch_glow_tpu_torch.train.optim import make_optimizer

    t = prof.train
    model = init_glow(prof.glow, torch.Generator().manual_seed(0), device)
    state = steplib.init_state(model, make_optimizer(prof.optim, t), t.ema_decay, t.seed)
    tensors = [*model.state_dict().values(), *state["opt_state"].values(),
               *state.get("ema", [])]
    return state, sum(x.numel() * x.element_size() for x in tensors)


def measure(state, directory: str, reps: int, profile: dict, device) -> dict:
    """The module docstring's times of saving `state` under `directory`."""
    import torch

    from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    background = CheckpointManager(f"{directory}/background", keep=2)
    waited = CheckpointManager(f"{directory}/waited", keep=2)
    rows = []
    for i in range(reps):
        row = {"save_return_s": timed(lambda: background.save(100 + i, state, None, profile))}
        row["drain_s"] = timed(background.wait)
        row["sync_save_s"] = timed(lambda: waited.save(100 + i, state, None, profile, wait=True))
        rows.append(row)
    best_return_s = timed(lambda: background.maybe_save_best(999, state, 1.0, None, profile))
    best_total_s = best_return_s + timed(background.wait)
    if background.best_info() != {"step": 999, "metric": 1.0}:
        raise RuntimeError(f"the best save did not land: {background.best_info()}")
    background.close()
    waited.close()
    steady = rows[1:] or rows
    return {**{k: min(r[k] for r in steady) for k in rows[0]},
            "best_save_return_s": best_return_s, "best_save_total_s": best_total_s,
            "reps": rows}


def main(argv=None) -> dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    from pytorch_glow_tpu_torch.config import PRESETS
    from pytorch_glow_tpu_torch.utils.profiles import apply_overrides, profile_to_dict

    prof = apply_overrides(PRESETS[args.profile], args.overrides)
    device = torch.device("cpu" if args.cpu else "cuda")
    print(f"# card: {'cpu' if args.cpu else card_line()}", flush=True)
    state, state_bytes = train_state(prof, device)
    directory = tempfile.mkdtemp(prefix="ckpt_stall_", dir=args.dir)
    try:
        times = measure(state, directory, args.reps, profile_to_dict(prof), device)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    out = {"profile": prof.name, "platform": device.type,
           "kind": "cpu" if args.cpu else torch.cuda.get_device_name(0),
           "state_mb": state_bytes / 1e6, "state_bytes": state_bytes, **times}
    if args.imgs_per_sec:
        t = prof.train
        gap_wall = t.checkpoint_gap * t.batch_size / args.imgs_per_sec
        out["checkpoint_gap_wall_s"] = gap_wall
        out["stall_pct"] = 100 * out["save_return_s"] / gap_wall
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
