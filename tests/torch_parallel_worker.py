"""One rank of a multi-rank test of the port on the CPU (gloo).

Run by `tests/test_torch_parallel.py` through
`pytorch_glow_tpu_torch/scripts/_smoke_common.run_ranks`:

  python tests/torch_parallel_worker.py <task> <io dir> --rank R --world N --store DIR

It reads `<io dir>/in.pt` (torch tensors and plain values), runs `task` on
this rank's rows over the (data, model) mesh given there, and writes
`<io dir>/out<R>.pt` with full (gathered) tensors.  It imports torch and
the port, never JAX: the test process holds the numbers against JAX.

Tasks:
  ddi_loss     DDI on the rank's rows of `x`, then the per-image nll of the
               DDI'd model (all ranks' rows gathered).
  steps        `len(batches)` train steps from `sd` (make_train_step on the
               mesh): each step's loss, grad_norm and lr, the params and the
               EMA after them, and the elements this rank stores of the
               trainables, of each flat optimizer vector and of the EMA.
  build_train  `build(profile)` then `train(num_steps)`: the build's resume
               state (with `restored`, also its model, optimizer state and
               EMA gathered), the result, the params and the stream
               position; with `async_save`, then a background save of the
               trained state on the mesh and a restore of it on every rank.
  collectives  on the model group: `gather_from_model` of this rank's
               slices of the (tensor, dim) pairs `full`, whole (`partial`
               False) and sharded (True), with the gradients of
               rank-seeded cotangents; the halo exchange of `rows`-row slabs of `slab_x`
               with k rows of each side for each (k, rows) of `exchange`.
  spatial      spatial sharding (`shard_spatial`, a mesh made with
               spatial=True): DDI, log_prob, reconstruct and sample (from
               explicit noise and from a generator) of `cfg` on the rank's
               rows; the same for `fused_cfg` without DDI; and the halo
               exchange's forward and backward on slabs of `slab_x`.
  serve        load the SPMD artifact at `path` (no mesh of its own) and
               serve `x`: nll, encode and a sample, whole on every rank.
  export       `export_artifact` of `cfg` on the mesh (its shards and row
               slabs) into `dir`/rank<R>, `functions` at batch `batch`.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pytorch_glow_tpu_torch.scripts import _smoke_common as sc  # noqa: E402


def _model(cfg_d: dict, sd: dict, mesh):
    import torch

    from pytorch_glow_tpu_torch.config import GlowConfig
    from pytorch_glow_tpu_torch.models.glow import init_glow
    from pytorch_glow_tpu_torch.parallel import mesh as meshlib

    cfg = GlowConfig(**{**cfg_d, "image_shape": tuple(cfg_d["image_shape"])})
    model = init_glow(cfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(sd)
    meshlib.put_global(model.state_dict().values())
    meshlib.shard_model(model, mesh)
    return cfg, model


def _rows(x, mesh):
    per = x.shape[0] // mesh.data
    return x[mesh.data_rank * per:(mesh.data_rank + 1) * per]


def _mesh_info(model, mesh) -> dict:
    from pytorch_glow_tpu_torch.parallel import mesh as meshlib

    return {"mesh": (mesh.data, mesh.model, mesh.data_rank, mesh.model_rank),
            "shard_shapes": {n: tuple(p.shape) for n, p in model.named_parameters()
                             if meshlib.param_pspec(n, mesh.tp) is not None}}


def ddi_loss(inp: dict, mesh) -> dict:
    from pytorch_glow_tpu_torch.parallel import distributed as pd
    from pytorch_glow_tpu_torch.parallel import mesh as meshlib

    _, model = _model(inp["cfg"], inp["sd"], mesh)
    model.ddi_init(_rows(inp["x"], mesh))
    nll = model.log_prob(_rows(inp["x"], mesh))["nll"].detach()
    return {"ddi": meshlib.gather_params(model.state_dict(), mesh),
            "nll": pd.all_gather_cat(nll, 0, mesh.data_group), **_mesh_info(model, mesh)}


def steps(inp: dict, mesh) -> dict:
    from pytorch_glow_tpu_torch.config import OptimConfig, TrainConfig
    from pytorch_glow_tpu_torch.parallel import mesh as meshlib
    from pytorch_glow_tpu_torch.train import step as steplib
    from pytorch_glow_tpu_torch.train.optim import make_optimizer, make_schedule

    cfg, model = _model(inp["cfg"], inp["sd"], mesh)
    ocfg, tcfg = OptimConfig(**inp["optim"]), TrainConfig(**inp["train"])
    tx = make_optimizer(ocfg, tcfg)
    if mesh.tp:
        tx.global_norm = meshlib.global_norm_fn(mesh, steplib.trainable(model))
    state = steplib.init_state(model, tx, tcfg.ema_decay, tcfg.seed)
    train_step = steplib.make_train_step(cfg, tx, tcfg.ema_decay, make_schedule(ocfg),
                                         tcfg.augment_flip, mesh)
    metrics = []
    for batch in inp["batches"]:
        state, m = train_step(state, _rows(batch, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    stored = {"params": sum(p.numel() for _, p in steplib.trainable(model)),
              "ema": sum(e.numel() for e in state["ema"]),
              **{f"opt.{k}": v.numel() for k, v in state["opt_state"].items() if v.dim() == 1}}
    return {"metrics": metrics,
            "params": meshlib.gather_params(model.state_dict(), mesh),
            "ema": meshlib.gather_params(steplib.ema_params(state), mesh),
            "stored": stored, **_mesh_info(model, mesh)}


def build_train(inp: dict, mesh) -> dict:
    from pytorch_glow_tpu_torch.parallel import mesh as meshlib
    from pytorch_glow_tpu_torch.train import step as steplib
    from pytorch_glow_tpu_torch.train.builder import build
    from pytorch_glow_tpu_torch.train.trainer import train
    from pytorch_glow_tpu_torch.utils.profiles import profile_from_dict

    built = build(profile_from_dict(inp["profile"]), device="cpu")
    out = {"resumed": built.resumed, "start_step": built.start_step,
           "start_data_state": built.data.get_state()}
    if inp.get("restored"):  # copies: training updates the unsharded tensors in place
        st, mesh = built.state, built.mesh
        named = steplib.trainable(st["model"])
        out["restored"] = {
            "model": {k: t.clone() for k, t in
                      meshlib.gather_params(st["model"].state_dict(), mesh).items()},
            "opt_state": {k: (meshlib.gather_flat(v, named, mesh) if v.dim() == 1 else v).clone()
                          for k, v in st["opt_state"].items()},
            "ema": [t.clone() for t in meshlib.gather_params(
                dict(zip([n for n, _ in named], st["ema"])), mesh).values()]}
    out["result"] = train(built, num_steps=inp["num_steps"], quiet=True)
    out["params"] = meshlib.gather_params(built.state["model"].state_dict(), built.mesh)
    out["mesh"] = (built.mesh.data, built.mesh.model, built.mesh.data_rank, built.mesh.model_rank)
    if inp.get("async_save"):
        from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager

        ckpt = CheckpointManager(os.path.join(built.profile.out_dir, "async"), mesh=built.mesh)
        ckpt.save(100, built.state, built.data.get_state(), {})
        snap = ckpt.restore("cpu")  # drains rank 0's write, then a barrier
        out["async_restore"] = {"step": snap["step"], "model": snap["model"],
                                "data_states": snap["data_states"]}
        ckpt.close()
    return out


def spatial(inp: dict, mesh) -> dict:
    import torch

    from pytorch_glow_tpu_torch.parallel import distributed as pd
    from pytorch_glow_tpu_torch.parallel import mesh as meshlib
    from pytorch_glow_tpu_torch.parallel import spatial as sp

    def gathered(t):
        return pd.all_gather_cat(t.detach(), 0, mesh.data_group)

    out = {"mesh": (mesh.data, mesh.model, mesh.data_rank, mesh.model_rank)}
    for key in ("cfg", "fused_cfg"):
        _, model = _model(inp[key], inp["sd" if key == "cfg" else "fused_sd"], mesh)
        x = _rows(inp["x"], mesh)
        if key == "cfg":
            model.ddi_init(x)
            out["ddi"] = meshlib.gather_params(model.state_dict(), mesh)
        out[key] = {"sharded": list(model._sharded), **_mesh_info(model, mesh)}
        with torch.no_grad():
            out[key]["nll"] = gathered(model.log_prob(x)["nll"])
            out[key]["recon"] = gathered(model.reconstruct(x))
            noise = [_rows(n, mesh) for n in inp["noise"]]
            out[key]["sample"] = gathered(model.sample(noise[0].shape[0], 0.7, noise=noise))
            gen = torch.Generator().manual_seed(5)
            out[key]["sample_gen"] = gathered(model.sample(x.shape[0], 0.7, gen))
    results = []
    for k, rows in inp["exchange"]:
        whole = inp["slab_x"][:, :rows * mesh.model].clone().requires_grad_()
        padded = sp.exchange(sp.shard_rows(whole, mesh), k, mesh)
        cot = torch.randn(padded.shape, generator=torch.Generator().manual_seed(mesh.model_rank))
        (grad,) = torch.autograd.grad(padded, whole, cot)
        results.append({"padded": padded.detach(), "cot": cot, "grad": grad})
    out["exchange"] = results
    return out


def collectives(inp: dict, mesh) -> dict:
    import torch

    from pytorch_glow_tpu_torch.models.layers import gather_from_model
    from pytorch_glow_tpu_torch.parallel import spatial as sp

    gen = torch.Generator().manual_seed(mesh.model_rank)
    cots = [torch.randn(t.shape, generator=gen) for t, _ in inp["full"]]
    out = {"mesh": (mesh.data, mesh.model, mesh.data_rank, mesh.model_rank), "cots": cots}
    for partial in (False, True):
        shards = [(t.chunk(mesh.model, dim)[mesh.model_rank].clone().requires_grad_(), dim)
                  for t, dim in inp["full"]]
        full = gather_from_model(shards, mesh.model_group, partial)
        grads = torch.autograd.grad(full, [t for t, _ in shards], cots)
        out["partial" if partial else "whole"] = {"full": [f.detach() for f in full],
                                                  "grads": list(grads)}
    results = []
    for k, rows in inp["exchange"]:
        whole = inp["slab_x"][:, :rows * mesh.model].clone().requires_grad_()
        padded = sp.exchange(sp.shard_rows(whole, mesh), k, mesh)
        pcot = torch.randn(padded.shape,
                           generator=torch.Generator().manual_seed(10 + mesh.model_rank))
        (grad,) = torch.autograd.grad(padded, whole, pcot)
        results.append({"padded": padded.detach(), "cot": pcot, "grad": grad})
    out["exchange"] = results
    return out


def export(inp: dict, mesh) -> dict:
    import torch.distributed as dist

    from pytorch_glow_tpu_torch import serve as servelib

    _, model = _model(inp["cfg"], inp["sd"], mesh)
    out = os.path.join(inp["dir"], f"rank{dist.get_rank()}")
    servelib.export_artifact(model, None, out, inp["batch"], tuple(inp["functions"]))
    return {"dir": out, "holds_shards": model.holds_shards, **_mesh_info(model, mesh)}


def serve(inp: dict, mesh) -> dict:
    from pytorch_glow_tpu_torch import serve as servelib

    m = servelib.load_artifact(inp["path"])
    x = inp["x"]
    return {"nll": m.nll(x), "encode": m.encode(x), "sample": m.sample(seed=7, temperature=0.5)}


TASKS = {"ddi_loss": ddi_loss, "steps": steps, "build_train": build_train, "spatial": spatial,
         "collectives": collectives, "export": export, "serve": serve}


def main() -> None:
    args, rest = sc.rank_args()
    task, io = rest
    sc.install_child_watchdog(300)
    sc.init_gloo(args.rank, args.world, args.store)
    import torch
    import torch.distributed as dist

    from pytorch_glow_tpu_torch.config import MeshConfig
    from pytorch_glow_tpu_torch.parallel import mesh as meshlib

    inp = torch.load(os.path.join(io, "in.pt"), weights_only=False)
    mesh = None if task in ("build_train", "serve") else meshlib.make_mesh(MeshConfig(*inp["mesh"]),
                                                                 inp.get("spatial", False))
    out = TASKS[task](inp, mesh)
    torch.save(out, os.path.join(io, f"out{args.rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
