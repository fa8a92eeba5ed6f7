"""Compile check and multi-device dry run of the port.

Counterpart of the repository's `__graft_entry__.py`:

entry()               -> (fn, example_args): the forward NLL of the
                         paper-scale CIFAR-10 Glow (K=32, L=3, width 512,
                         bf16 coupling), on the card unless device="cpu".
dryrun_multichip(n)   -> ONE real training step (loss, grads, the gradient
                         all-reduce, the Adam update) over n gloo ranks on
                         the CPU at tiny shapes: the batch over "data" (DP)
                         and, when n is even, the coupling nets' hidden
                         channels over "model" (TP).  Spatial sharding is
                         not ported (ROADMAP).

  python -m pytorch_glow_tpu_torch.graft_entry [n]     # dryrun_multichip(n), 8 by default
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

MODULE = "pytorch_glow_tpu_torch.graft_entry"


def entry(device: str = "cuda"):
    """(fn, (model, batch, generator)): fn -> (loss, per-image nll)."""
    from pytorch_glow_tpu_torch.config import PRESETS
    from pytorch_glow_tpu_torch.models.glow import init_glow

    cfg = PRESETS["cifar10"].glow
    model = init_glow(cfg, torch.Generator().manual_seed(0), device)
    batch = torch.zeros(16, 32, 32, 3, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(1)

    def fwd(model, batch, gen):
        x = model.preprocess(batch)
        loss, _ = model.loss_fn(x, gen)
        return loss, model.log_prob(x)["nll"]

    return fwd, (model, batch, gen)


def _child(argv) -> None:
    from pytorch_glow_tpu_torch.scripts import _smoke_common as sc

    args, _ = sc.rank_args(argv)
    sc.install_child_watchdog(300)
    sc.init_gloo(args.rank, args.world, args.store)
    import torch.distributed as dist

    from pytorch_glow_tpu_torch.config import GlowConfig, MeshConfig, OptimConfig, TrainConfig
    from pytorch_glow_tpu_torch.models.glow import init_glow
    from pytorch_glow_tpu_torch.parallel import mesh as meshlib
    from pytorch_glow_tpu_torch.train import step as steplib
    from pytorch_glow_tpu_torch.train.optim import make_optimizer

    n = args.world
    model_par = 2 if n % 2 == 0 and n > 1 else 1
    mesh = meshlib.make_mesh(MeshConfig(data=n // model_par, model=model_par))
    cfg = GlowConfig(image_shape=(8, 8, 3), hidden_channels=32, K=2, L=2)
    tx = make_optimizer(OptimConfig(lr=1e-3, warmup_steps=10), TrainConfig(batch_size=2 * n))
    model = init_glow(cfg, torch.Generator().manual_seed(0), "cpu")
    meshlib.put_global(model.state_dict().values())
    meshlib.shard_model(model, mesh)
    if mesh.tp:
        tx.global_norm = meshlib.global_norm_fn(mesh, steplib.trainable(model))
    state = steplib.init_state(model, tx)
    batch = torch.rand(2 * n, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    _, lo, hi = steplib.global_rows(mesh, batch.shape[0] // mesh.data)
    model.ddi_init(batch[lo:hi])
    state, metrics = steplib.make_train_step(cfg, tx, mesh=mesh)(state, batch[lo:hi])
    loss = float(metrics["loss"])
    if not torch.isfinite(torch.tensor(loss)):
        raise FloatingPointError(f"non-finite loss {metrics}")
    print(json.dumps({"rank": args.rank, "mesh": mesh.shape, "loss": loss,
                      "step": state["step"]}), flush=True)
    dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> dict:
    """One train step over `n_devices` gloo ranks; raises unless every rank
    ends with the same finite loss at step 1.  Returns rank 0's line."""
    from pytorch_glow_tpu_torch.scripts import _smoke_common as sc

    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        outs = sc.run_ranks(["-m", MODULE, "--child"], n_devices, os.path.join(tmp, "store"))
    lines = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    if len({line["loss"] for line in lines}) != 1 or any(line["step"] != 1 for line in lines):
        raise RuntimeError(f"ranks disagree: {lines}")
    mesh = lines[0]["mesh"]
    print(f"dryrun_multichip OK: mesh={mesh} (dp{' x tp' if mesh['model'] > 1 else ''}) "
          f"loss={lines[0]['loss']:.4f} step={lines[0]['step']}")
    return lines[0]


if __name__ == "__main__":
    if "--child" in sys.argv:
        sys.argv.remove("--child")
        _child(sys.argv[1:])
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
