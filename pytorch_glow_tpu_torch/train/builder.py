"""Builder: profile -> model, optimizer, train/eval steps, data streams,
the serving functions and checkpoints.

Counterpart of `pytorch_glow_tpu/train/builder.py` `build` for one device:
the model from the profile's seed, the optimizer chain, the train step
(`steps_per_call` steps per call), the eval steps, the sample /
reconstruct / SWD functions, the train stream (`data/pipeline.py`'s host
batches, built and moved to the device `profile.data.prefetch` batches
ahead on a thread of their own by `DevicePrefetch`), the test split's
host stream when `eval_gap` is set (not prefetched, as in the JAX
package), and the rolling snapshots under out_dir/name/checkpoints.  With
a snapshot there, the model, optimizer state, EMA, step and the stream's
position come from it and DDI is skipped: the newest
(`restore="latest"`), or the best-eval one (`restore="best"`; with none
recorded, the newest, and a printed line says so).  A saved stream
position the stream cannot take (a JAX snapshot's `{"grain": ...}`, or
none) is replaced by replaying `start_step + 1` batches, with a printed
line.  Otherwise the data-dependent actnorm init runs on the first batch
with dequantization noise seeded from seed + 1, and the EMA is seeded
from the post-DDI parameters.

Eval, sampling and reconstruction run on the serving config: on the card,
a profile on the unfused flow step at bf16 serves through the fused
kernels, as the JAX builder switches to its Pallas kernel on the TPU.  They
run on one eval copy of the model (`Built.serving`, made at first use on
the same device), into which the trainer loads the EMA or the live
weights, so the live model is never swapped.

Under an initialised `torch.distributed` group (`parallel/distributed.
maybe_initialize`) the build runs on every rank, on that rank's device,
over the mesh of `profile.mesh` (`parallel/mesh.py`): every rank
initialises from the seed, `put_global` makes the state rank 0's, a
snapshot is restored whole on every rank, and `shard_model` keeps the
rank's tensor-parallel slices.  Each rank's streams give its data
coordinate's rows of each global batch (model peers read the same rows);
DDI runs on those rows with the global batch's statistics; the train and
eval steps reduce over the data group.  The eval copy holds full
(gathered) weights.  With `glow.shard_spatial` the model group shards
image rows instead of the coupling nets (`parallel/spatial.py`): the
train step, DDI and the eval copy (eval, samples, reconstructions, SWD)
all run their sharded levels on row slabs.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Callable, Iterator

import torch
import torch.distributed as dist

from pytorch_glow_tpu_torch.config import GlowConfig, Profile
from pytorch_glow_tpu_torch.data.pipeline import DevicePrefetch, make_dataset
from pytorch_glow_tpu_torch.models.glow import Glow, init_glow
from pytorch_glow_tpu_torch.parallel import mesh as meshlib
from pytorch_glow_tpu_torch.train import step as steplib
from pytorch_glow_tpu_torch.train.optim import Optimizer, make_optimizer, make_schedule
from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager


@dataclass
class Built:
    profile: Profile
    tx: Optimizer
    state: dict
    train_step: Callable
    data: DevicePrefetch
    device: torch.device
    schedule: Callable
    ckpt: CheckpointManager
    serve_cfg: GlowConfig
    eval_step_n: Callable
    sample_fn: Callable
    reconstruct_fn: Callable
    swd_sample_fn: Callable | None = None
    eval_data: Iterator | None = None
    start_step: int = 0
    resumed: bool = False
    restored: str | None = None  # "best" | "latest" | None
    eval_model: Glow | None = None
    mesh: meshlib.Mesh | None = None

    def serving(self, state_dict: dict) -> Glow:
        """The eval copy on `serve_cfg` (made at first use), holding
        `state_dict`."""
        if self.eval_model is None:
            gen = torch.Generator().manual_seed(self.profile.train.seed)
            self.eval_model = init_glow(self.serve_cfg, gen, self.device)
            if self.mesh is not None and self.mesh.spatial:
                self.eval_model.set_mesh(self.mesh)
        self.eval_model.load_state_dict(state_dict)
        return self.eval_model


def labels_to_onehot(batch: dict, profile: Profile) -> torch.Tensor | None:
    """A batch's class labels as the y-conditional model takes them, f32
    (B, y_classes) on the batch's device: CelebA's +-1 "attr" as {0, 1},
    an int "label" one-hot (all zeros where it lies outside [0,
    y_classes), as `jax.nn.one_hot` gives), else zeros; None for an
    unconditional profile."""
    g = profile.glow
    if not g.y_condition:
        return None
    if "attr" in batch:
        return (torch.as_tensor(batch["attr"]) > 0).float()
    if "label" in batch:
        label = torch.as_tensor(batch["label"])
        return (label[:, None] == torch.arange(g.y_classes, device=label.device)).float()
    image = torch.as_tensor(batch["image"])
    return torch.zeros(image.shape[0], g.y_classes, device=image.device)


def serving_config(g: GlowConfig, device: torch.device) -> GlowConfig:
    """The config eval, sampling and reconstruction run on: the fused flow
    step on the card for a bf16 profile on the unfused one."""
    if g.flowstep_impl == "xla" and g.compute_dtype == "bfloat16" and device.type == "cuda":
        return dataclasses.replace(g, flowstep_impl="pallas")
    return g


def _resume_stream(host, saved, start_step: int) -> None:
    """Put the host stream where the snapshot's run left it: its saved
    state, or, where the stream cannot take that state, `start_step + 1`
    batches replayed (DDI took the first)."""
    if saved is not None:
        try:
            host.set_state(saved)
            return
        except (KeyError, TypeError, ValueError) as e:
            print(f"[build] saved data state incompatible with the current loader "
                  f"({type(e).__name__}: {e}); replaying {start_step + 1} batches instead",
                  flush=True)
    else:
        print(f"[build] the snapshot has no data state; replaying {start_step + 1} batches",
              flush=True)
    for _ in range(start_step + 1):
        next(host)


def build(profile: Profile, device: torch.device | str = "cuda",
          restore: str = "latest") -> Built:
    """Everything `train` needs, on `device`: the card unless the caller
    passes "cpu".  `restore`: "latest" resumes from the newest snapshot
    when there is one; "best" loads the best-eval snapshot, or the newest
    when no best was recorded (printed, and `Built.restored` says which).
    Under an initialised process group every rank calls it, each with its
    own device."""
    g, t = profile.glow, profile.train
    device = torch.device(device)
    if restore not in ("latest", "best"):
        raise ValueError(f"unknown restore: {restore!r} (latest | best)")
    mesh = (meshlib.make_mesh(profile.mesh, spatial=g.shard_spatial) if dist.is_initialized()
            else None)
    shard = mesh.shard if mesh is not None else (0, 1)
    tx = make_optimizer(profile.optim, t)
    model = init_glow(g, torch.Generator().manual_seed(t.seed), device)
    schedule = make_schedule(profile.optim)
    if t.steps_per_call > 1:
        for gap_name in ("scalar_log_gap", "plot_gap", "checkpoint_gap", "eval_gap"):
            gap = getattr(t, gap_name)
            if gap % t.steps_per_call:
                raise ValueError(f"{gap_name}={gap} must be a multiple of "
                                 f"steps_per_call={t.steps_per_call}")
        train_step = steplib.make_train_step_n(g, tx, t.steps_per_call, t.ema_decay, schedule,
                                               t.augment_flip, mesh)
    else:
        train_step = steplib.make_train_step(g, tx, t.ema_decay, schedule, t.augment_flip, mesh)

    ckpt = CheckpointManager(os.path.join(profile.out_dir, profile.name, "checkpoints"),
                             t.keep_checkpoints, mesh)
    host = make_dataset(profile.data, g, t, shard=shard)
    eval_data = make_dataset(profile.data, g, t, split="test", shard=shard) if t.eval_gap else None
    snapshot, restored = None, None
    if restore == "best":
        snapshot, restored = ckpt.restore_best(device), "best"
        if snapshot is None:
            print(f"[build] no best snapshot recorded under {ckpt.best_directory}; "
                  f"restoring the latest instead", flush=True)
    if snapshot is None:
        snapshot, restored = ckpt.restore(device), "latest"
    if snapshot is not None:
        model.load_state_dict(snapshot["model"])
    if mesh is not None:
        meshlib.put_global(model.state_dict().values())
        meshlib.shard_model(model, mesh)
        if mesh.tp:
            tx.global_norm = meshlib.global_norm_fn(mesh, steplib.trainable(model))
    state = steplib.init_state(model, tx, t.ema_decay, t.seed)
    if snapshot is not None:
        named = steplib.trainable(model)
        opt_state = snapshot["opt_state"]
        if mesh is not None and mesh.tp:
            opt_state = {k: (meshlib.shard_flat(v, named, mesh) if v.dim() == 1 else v)
                         for k, v in opt_state.items()}
        state.update(step=snapshot["step"], seed=snapshot["seed"], opt_state=opt_state)
        _resume_stream(host, _data_state(snapshot, mesh), state["step"])
        if "ema" in state:
            # A snapshot of a run without an EMA seeds it from the restored
            # trainables, as a fresh EMA start at this step.
            ema = snapshot["ema"]
            if ema is None:
                state["ema"] = [p.detach().clone() for _, p in named]
            else:
                full = dict(zip([n for n, _ in named], ema))
                state["ema"] = list((meshlib.shard_params(full, mesh) if mesh is not None
                                     else full).values())
    data = DevicePrefetch(host, device, profile.data.prefetch)
    if snapshot is None:
        restored = None
        first = model.preprocess(next(data)["image"])
        n, lo, hi = steplib.global_rows(mesh, first.shape[0])
        gen = torch.Generator(device=device).manual_seed(t.seed + 1)
        noise = model.dequant_noise((n, *first.shape[1:]), gen, device)
        model.ddi_init(model.dequantize(first, noise=None if noise is None else noise[lo:hi]))
        if "ema" in state:
            state["ema"] = [p.detach().clone() for _, p in steplib.trainable(model)]
    serve_g = serving_config(g, device)
    local_batch = t.batch_size // shard[1]
    # T=1.0 is the density-matched temperature: SWD scores whether samples
    # match the data's per-scale patch statistics.
    swd_sample_fn = (steplib.make_sample_fn(serve_g, min(t.swd_images, local_batch), 1.0)
                     if t.swd_gap else None)
    return Built(profile=profile, tx=tx, state=state, train_step=train_step, data=data,
                 device=device, schedule=schedule, ckpt=ckpt, serve_cfg=serve_g,
                 eval_step_n=steplib.make_eval_step_n(serve_g, mesh),
                 sample_fn=steplib.make_sample_fn(serve_g, t.num_sample_images,
                                                  t.sample_temperature),
                 reconstruct_fn=steplib.make_reconstruct_fn(serve_g),
                 swd_sample_fn=swd_sample_fn, eval_data=eval_data, start_step=state["step"],
                 resumed=snapshot is not None, restored=restored, mesh=mesh)


def _data_state(snapshot: dict, mesh: meshlib.Mesh | None):
    """This rank's saved stream position: its own where the snapshot's run
    had as many ranks, else rank 0's."""
    states = snapshot.get("data_states")
    rank = dist.get_rank() if mesh is not None else 0
    if states is not None and len(states) == (dist.get_world_size() if mesh is not None else 1):
        return states[rank]
    return snapshot.get("data_state")
