"""pytorch_glow_tpu_torch — the PyTorch / CUDA port of `pytorch_glow_tpu`.

Multi-scale Glow in PyTorch for one NVIDIA H100: the serving path (forward
NLL, temperature sampling, exact reconstruction, data-dependent actnorm
init) and the training path (`build(profile)` -> `train(built)`: loss,
optimizer chain, train step, synthetic data, snapshots and resume, and at
the trainer's boundaries held-out eval, best snapshots, sample grids and
SWD), with
each flow step in hand-written CUDA kernels for sm_90a (`csrc/flowstep*.cu`)
and, with `invconv_impl="pallas"` on the unfused path, the LU 1x1 conv too
(`csrc/invconv.cu`), beside their plain PyTorch versions on CPU tensors.
JSON profiles load through `utils/profiles.py`; the CLIs are
`python -m pytorch_glow_tpu_torch.cli.train` and `...cli.infer`.  The
flow-step anatomy studies (variant chains of the kernels, `csrc/anatomy.cu`)
run on the card as `python -m pytorch_glow_tpu_torch.scripts.perf_*_anatomy`.

Imports `torch`, never `jax`; the JAX package beside it is the reference the
port is tested against.
"""

from pytorch_glow_tpu_torch.config import (
    DataConfig,
    GlowConfig,
    MeshConfig,
    OptimConfig,
    PRESETS,
    Profile,
    TrainConfig,
)
from pytorch_glow_tpu_torch.inference import Inferer
from pytorch_glow_tpu_torch.models.glow import (
    Glow,
    ddi_init,
    init_glow,
    log_prob,
    loss_fn,
    sample,
)
from pytorch_glow_tpu_torch.train.builder import Built, build
from pytorch_glow_tpu_torch.train.optim import make_optimizer
from pytorch_glow_tpu_torch.train.trainer import train

__version__ = "0.1.0"

__all__ = [
    "Built",
    "DataConfig",
    "Glow",
    "GlowConfig",
    "Inferer",
    "MeshConfig",
    "OptimConfig",
    "PRESETS",
    "Profile",
    "TrainConfig",
    "build",
    "ddi_init",
    "init_glow",
    "log_prob",
    "loss_fn",
    "make_optimizer",
    "sample",
    "train",
]
