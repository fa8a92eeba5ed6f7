"""Multi-rank TFRecord drill on the CPU: two gloo ranks read disjoint rows
of tfds-layout shards that together partition an epoch, resume a stream
from its saved position, and train one model with the same loss.

Counterpart of `scripts/multihost_tfrecord_smoke.py`.  The parent writes
80 records with the port's own writer (`data/tfrecord.write_tfds_shards`),
each PNG carrying its record index in pixel [0, 0, R]; each rank scans
one epoch through `make_dataset` with its mesh's data shard.

  python -m pytorch_glow_tpu_torch.scripts.multihost_tfrecord_smoke

Prints one JSON line {"multihost_tfrecord_smoke": "OK", "per_proc_records":
[40, 40], ...}; exits non-zero when a check fails.  About 10 s.
"""

from __future__ import annotations

import io
import json
import os
import sys
import tempfile

import numpy as np

from pytorch_glow_tpu_torch.scripts import _smoke_common as sc

MODULE = "pytorch_glow_tpu_torch.scripts.multihost_tfrecord_smoke"
N_TRAIN, SIZE, BATCH = 80, 16, 16


def write_id_encoded_tfds(root: str) -> None:
    """tfds-style shards whose PNG images carry the record index in pixel
    [0, 0, R] (PNG is lossless, so the ids survive decoding)."""
    from PIL import Image

    from pytorch_glow_tpu_torch.data.tfrecord import write_tfds_shards

    rng = np.random.default_rng(0)

    def examples():
        for k in range(N_TRAIN):
            img = rng.integers(0, 256, (SIZE, SIZE, 3), np.uint8)
            img[0, 0, 0] = k
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            yield {"image": [buf.getvalue()], "label": [k % 10]}

    write_tfds_shards(root, "cifar10", "train", examples(), num_shards=2)


def child(argv) -> None:
    args, rest = sc.rank_args(argv)
    root, out_dir = rest
    sc.install_child_watchdog()
    sc.init_gloo(args.rank, args.world, args.store)
    import torch.distributed as dist

    from pytorch_glow_tpu_torch.config import (
        DataConfig, GlowConfig, OptimConfig, Profile, TrainConfig,
    )
    from pytorch_glow_tpu_torch.data.pipeline import make_dataset
    from pytorch_glow_tpu_torch.parallel.mesh import make_mesh
    from pytorch_glow_tpu_torch.train.builder import build
    from pytorch_glow_tpu_torch.train.trainer import train

    glow_cfg = GlowConfig(image_shape=(SIZE, SIZE, 3), hidden_channels=16, K=2, L=2)
    train_cfg = TrainConfig(batch_size=BATCH, seed=0)
    data_cfg = DataConfig(name="cifar10", root=root, image_size=SIZE, loader="native")
    shard = make_mesh().shard
    it = make_dataset(data_cfg, glow_cfg, train_cfg, shard=shard)
    ids: list[int] = []
    for _ in range(N_TRAIN // BATCH):
        b = next(it)
        if b["image"].shape != (BATCH // args.world, SIZE, SIZE, 3):
            raise AssertionError(f"rank {args.rank} batch {b['image'].shape}")
        ids.extend(int(v) for v in b["image"][:, 0, 0, 0])
    state = it.get_state()
    want = next(it)["image"]
    again = make_dataset(data_cfg, glow_cfg, train_cfg, shard=shard)
    again.set_state(state)
    resume_ok = bool(np.array_equal(next(again)["image"], want))

    p = Profile(name="mh-tfr", glow=glow_cfg, optim=OptimConfig(lr=1e-3, warmup_steps=10),
                train=TrainConfig(batch_size=BATCH, num_steps=4, scalar_log_gap=2, plot_gap=0,
                                  checkpoint_gap=0, seed=0),
                data=data_cfg, out_dir=out_dir)
    result = train(build(p, device="cpu"), quiet=True)
    print(json.dumps({"rank": args.rank, "ids": ids, "resume_ok": resume_ok,
                      "loss": result["loss"]}), flush=True)
    dist.destroy_process_group()


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="mh_tfr_") as tmp:
        root = os.path.join(tmp, "tfds")
        write_id_encoded_tfds(root)
        outs = sc.run_ranks(["-m", MODULE, "--child", root, os.path.join(tmp, "out")], 2,
                            os.path.join(tmp, "store"))
    procs = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    id_sets = [set(o["ids"]) for o in procs]
    ok = (id_sets[0].isdisjoint(id_sets[1]) and set().union(*id_sets) == set(range(N_TRAIN))
          and all(len(o["ids"]) == N_TRAIN // 2 for o in procs)
          and all(o["resume_ok"] for o in procs) and len({o["loss"] for o in procs}) == 1)
    print(json.dumps({"multihost_tfrecord_smoke": "OK" if ok else "FAILED",
                      "per_proc_records": [len(o["ids"]) for o in procs],
                      "losses": [o["loss"] for o in procs]}))
    return 0 if ok else 1


if __name__ == "__main__":
    if "--child" in sys.argv:
        sys.argv.remove("--child")
        child(sys.argv[1:])
    else:
        sys.exit(main())
