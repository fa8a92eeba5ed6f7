"""Multi-rank drill on the CPU: N gloo ranks train one model over a
(data, model) mesh through `build` -> `train`, save a snapshot, and resume.

Counterpart of `scripts/multihost_smoke.py`.  Checks: every rank logs the
same global loss (each rank's rows assemble one global batch, and the
gradient all-reduce keeps the replicas equal), rank 0 writes the snapshot
every rank took part in, and a second build on every rank resumes from it
and trains on.

  python -m pytorch_glow_tpu_torch.scripts.multihost_smoke [--nprocs 2] [--model 1]

Prints one JSON line {"multihost_smoke": "OK", "procs": [...]}; exits
non-zero when a check fails.  About 10 s with two ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from pytorch_glow_tpu_torch.scripts import _smoke_common as sc

STEPS, RESUME_TO = 6, 8


def profile(out_dir: str, model: int, num_steps: int):
    from pytorch_glow_tpu_torch.config import (
        DataConfig, GlowConfig, MeshConfig, OptimConfig, Profile, TrainConfig,
    )

    return Profile(
        name="mh-smoke",
        glow=GlowConfig(image_shape=(8, 8, 3), hidden_channels=16, K=2, L=2),
        optim=OptimConfig(lr=1e-3, warmup_steps=10),
        train=TrainConfig(batch_size=16, num_steps=num_steps, scalar_log_gap=2, plot_gap=0,
                          checkpoint_gap=STEPS, num_sample_images=2, seed=0),
        data=DataConfig(name="synthetic"),
        mesh=MeshConfig(model=model),
        out_dir=out_dir,
    )


def child(argv) -> None:
    args, rest = sc.rank_args(argv)
    out_dir, model = rest[0], int(rest[1])
    sc.install_child_watchdog()
    sc.init_gloo(args.rank, args.world, args.store)
    import torch.distributed as dist

    from pytorch_glow_tpu_torch.train.builder import build
    from pytorch_glow_tpu_torch.train.trainer import train

    built = build(profile(out_dir, model, STEPS), device="cpu")
    first = train(built, quiet=True)
    again = build(profile(out_dir, model, RESUME_TO), device="cpu")
    second = train(again, quiet=True)
    print(json.dumps({"rank": args.rank, "mesh": again.mesh.shape, "loss": first["loss"],
                      "final_step": first["final_step"], "resumed": again.resumed,
                      "start_step": again.start_step, "resumed_to": second["final_step"],
                      "resumed_loss": second["loss"]}), flush=True)
    dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nprocs", type=int, default=2)
    p.add_argument("--model", type=int, default=1, help="the mesh's model axis")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="mh_smoke_") as tmp:
        outs = sc.run_ranks(["-m", "pytorch_glow_tpu_torch.scripts.multihost_smoke", "--child", os.path.join(tmp, "out"),
                             str(args.model)], args.nprocs, os.path.join(tmp, "store"))
        procs = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        snapshots = sorted(os.listdir(os.path.join(tmp, "out", "mh-smoke", "checkpoints")))
    losses = {o["loss"] for o in procs}
    ok = (len(losses) == 1 and len({o["resumed_loss"] for o in procs}) == 1
          and all(o["final_step"] == STEPS and o["resumed"] and o["start_step"] == STEPS
                  and o["resumed_to"] == RESUME_TO for o in procs)
          and snapshots == [f"{STEPS}.pt", f"{RESUME_TO}.pt"])
    print(json.dumps({"multihost_smoke": "OK" if ok else "FAILED", "procs": procs,
                      "snapshots": snapshots}))
    return 0 if ok else 1


if __name__ == "__main__":
    if "--child" in sys.argv:
        sys.argv.remove("--child")
        child(sys.argv[1:])
    else:
        sys.exit(main())
