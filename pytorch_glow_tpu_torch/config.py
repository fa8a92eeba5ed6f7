"""Typed configuration for the PyTorch Glow port.

A copy of `pytorch_glow_tpu/config.py`'s dataclasses and `PRESETS`, with the
same field names, defaults and preset values (tests/test_torch_config.py
compares them field for field).  The JAX package's `config` module cannot be
imported here without pulling in JAX through its package `__init__`.

How the port reads the knobs that name JAX machinery:

* `flowstep_impl="pallas"`: the fused flow-step kernel.  On a CUDA tensor
  that is the hand-written kernel chain in `csrc/` (whole-batch, or row
  bands where the whole batch's staging is large, `ops/flowstep.tiling`);
  on a CPU tensor its plain PyTorch version (`ops/flowstep.py`).
* `flowstep_impl="xla"`: unfused layer math (`models/layers.py`) at
  `compute_dtype`.
* `remat`: on the unfused path, each flow step runs under activation
  checkpointing while grad is enabled (not under DDI), as the JAX package
  checkpoints its scan body.  The fused path has nothing to add: its
  autograd Function saves only each step's input and the backward kernel
  recomputes the step.
* `invconv_impl="pallas"`: on the unfused path (and so under DDI, which
  always runs it), the LU 1x1 conv runs through the hand-written kernels
  of `csrc/invconv.cu` on a CUDA tensor (`ops/invconv_fused.py`), its
  plain version on a CPU tensor; "xla": the plain f32 math.  The fused
  flow step carries its own mix and ignores it, as the JAX package does.
* `flow_permutation` / `lu_decomposed`: the LU 1x1 conv, the plain 1x1
  conv, or a fixed shuffle / reverse (`models/layers.make_permutation`).
* `shard_spatial`: on a mesh whose model axis is larger than 1, each
  level's image rows are split over it (`parallel/spatial.py`), with the
  coupling nets tensor-parallel over the same model group, as without it
  (`parallel/mesh.py`).
* `invconv_precision`, `scan_unroll`: kept for field parity; the port
  reads neither.  The 1x1 mix and its backward always run in full f32,
  where the JAX package may drop the backward's MXU passes to "high".
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class GlowConfig:
    """Model shape (reference profile section "Glow")."""

    image_shape: tuple[int, int, int] = (32, 32, 3)  # (H, W, C), NHWC
    hidden_channels: int = 512
    K: int = 32  # flow steps per level
    L: int = 3  # levels
    actnorm_scale: float = 1.0
    flow_permutation: str = "invconv"  # invconv | shuffle | reverse
    flow_coupling: str = "affine"  # affine | additive
    lu_decomposed: bool = True
    learn_top: bool = True
    y_condition: bool = False
    y_classes: int = 40
    y_multi_class: bool = True
    weight_y: float = 0.01
    n_bits_x: int = 8
    dequant: str = "uniform"  # uniform | gaussian | variational | none
    vardeq_steps: int = 4
    vardeq_width: int = 64
    vardeq_context_width: int = 32
    compute_dtype: str = "float32"  # coupling-net compute: float32 | bfloat16
    remat: bool = False
    invconv_impl: str = "xla"
    invconv_precision: str = "highest"
    flowstep_impl: str = "xla"  # xla (unfused layers) | pallas (fused kernel)
    scan_unroll: int = 1
    shard_spatial: bool = False

    @property
    def n_bins(self) -> float:
        return float(2**self.n_bits_x)

    def latent_shapes(self) -> list[tuple[int, int, int]]:
        """Per-level activation shape AFTER squeeze (what the K steps see)."""
        h, w, c = self.image_shape
        shapes = []
        for i in range(self.L):
            h, w, c = h // 2, w // 2, c * 4
            shapes.append((h, w, c))
            if i < self.L - 1:
                c = c // 2
        return shapes

    @property
    def final_latent_shape(self) -> tuple[int, int, int]:
        return self.latent_shapes()[-1]


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer + schedule (reference profile section "Optim")."""

    name: str = "adam"  # adam | adamax
    lr: float = 1e-3
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    schedule: str = "warmup"  # warmup (linear) | noam | constant
    warmup_steps: int = 4000


@dataclass(frozen=True)
class TrainConfig:
    """Training cadence (reference profile section "Train")."""

    batch_size: int = 64
    grad_accum: int = 1
    steps_per_call: int = 1
    num_steps: int = 100_000
    max_grad_clip: float = 5.0
    max_grad_norm: float = 100.0
    scalar_log_gap: int = 50
    plot_gap: int = 1000
    checkpoint_gap: int = 2000
    eval_gap: int = 0
    eval_batches: int = 8
    keep_checkpoints: int = 3
    seed: int = 0
    num_sample_images: int = 16
    sample_temperature: float = 0.7
    temperature_anneal_steps: int = 0
    ema_decay: float = 0.0
    augment_flip: bool = False
    swd_gap: int = 0
    swd_images: int = 256
    skip_nonfinite_updates: int = 100
    profile_step: int = 0
    profile_num_steps: int = 3
    debug_nans: bool = False
    step_timeout_s: float = 0.0


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection (reference profile section "Data")."""

    name: str = "cifar10"
    root: str = ""
    image_size: int = 32
    num_workers: int = 8
    prefetch: int = 2
    loader: str = "auto"
    grain_workers: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh shape (data x model)."""

    data: int = -1  # -1: all remaining devices
    model: int = 1

    def shape(self, n_devices: int) -> tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        return (data, model)


@dataclass(frozen=True)
class Profile:
    """One experiment = the reference's whole JSON profile."""

    name: str = "default"
    glow: GlowConfig = field(default_factory=GlowConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    out_dir: str = "results"

    def replace(self, **kw) -> "Profile":
        return dataclasses.replace(self, **kw)


# The JAX package's named presets, value for value.
PRESETS: dict[str, Profile] = {
    "tiny-cifar10": Profile(
        name="tiny-cifar10",
        glow=GlowConfig(image_shape=(32, 32, 3), hidden_channels=128, K=8, L=3),
        train=TrainConfig(batch_size=64),
        data=DataConfig(name="cifar10", image_size=32),
    ),
    "cifar10": Profile(
        name="cifar10",
        glow=GlowConfig(
            image_shape=(32, 32, 3),
            hidden_channels=512,
            K=32,
            L=3,
            compute_dtype="bfloat16",
            invconv_precision="high",
            flowstep_impl="pallas",
        ),
        train=TrainConfig(batch_size=256, steps_per_call=5, eval_gap=1000,
                          ema_decay=0.9999, swd_gap=2000,
                          step_timeout_s=1800.0),
        optim=OptimConfig(schedule="noam"),
        data=DataConfig(name="cifar10", image_size=32),
    ),
    "celeba64": Profile(
        name="celeba64",
        glow=GlowConfig(
            image_shape=(64, 64, 3),
            hidden_channels=512,
            K=32,
            L=4,
            compute_dtype="bfloat16",
            invconv_precision="high",
            flowstep_impl="pallas",
        ),
        train=TrainConfig(batch_size=128, sample_temperature=0.7,
                          steps_per_call=5, eval_gap=2000,
                          ema_decay=0.9999, swd_gap=2000,
                          temperature_anneal_steps=4000,
                          step_timeout_s=1800.0),
        optim=OptimConfig(schedule="noam"),
        data=DataConfig(name="celeba", image_size=64),
    ),
    "imagenet64-cond": Profile(
        name="imagenet64-cond",
        glow=GlowConfig(
            image_shape=(64, 64, 3),
            hidden_channels=512,
            K=48,
            L=4,
            y_condition=True,
            y_classes=1000,
            y_multi_class=False,
            compute_dtype="bfloat16",
            invconv_precision="high",
            flowstep_impl="pallas",
            remat=True,
        ),
        train=TrainConfig(batch_size=128, steps_per_call=5, eval_gap=2000,
                          ema_decay=0.9999, swd_gap=2000,
                          step_timeout_s=1800.0),
        optim=OptimConfig(schedule="noam"),
        data=DataConfig(name="imagenet64", image_size=64),
    ),
    "celebahq256": Profile(
        name="celebahq256",
        glow=GlowConfig(
            image_shape=(256, 256, 3),
            hidden_channels=512,
            K=32,
            L=6,
            n_bits_x=5,
            flow_coupling="additive",
            compute_dtype="bfloat16",
            invconv_precision="high",
            flowstep_impl="pallas",
            remat=True,
            shard_spatial=True,
        ),
        train=TrainConfig(batch_size=64, sample_temperature=0.7,
                          steps_per_call=1, eval_gap=2000,
                          ema_decay=0.9999, swd_gap=2000,
                          step_timeout_s=1800.0),
        optim=OptimConfig(lr=1e-4, schedule="noam"),
        data=DataConfig(name="celebahq", image_size=256),
        mesh=MeshConfig(data=-1, model=1),
    ),
}
