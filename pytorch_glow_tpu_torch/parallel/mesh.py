"""The (data, model) device mesh and its sharding rules.

Counterpart of `pytorch_glow_tpu/parallel/mesh.py`.  The mesh is a
`DeviceMesh` over the world's ranks, row-major: rank = d * model + m.

* "data": each data coordinate trains on its rows of the global batch;
  the gradient is mean-all-reduced over the data group (the counterpart
  of GSPMD's gradient psum, and of the fused backward's in-kernel psum).
* "model": with model > 1 (`Mesh.tp`), Megatron-style tensor
  parallelism over the coupling net's hidden channels, as JAX's
  `param_pspec` shards them: conv1's weight on its output dim 0 and its
  actnorm, conv2's weight on its input dim 1; everything else is
  replicated, and so are the optimizer's moments and the EMA of each
  entry as its parameter is.  model=1 (pure DP) is the default.

With `glow.shard_spatial` (`make_mesh(..., spatial=True)`, `Mesh.spatial`)
the same "model" axis also shards the image rows of every level whose
height divides it (`parallel/spatial.py`), as JAX applies both at once.
The two uses collide in the coupling nets of a sharded level, where
model peers hold different rows: there the nets gather their shards and
run the whole hidden width on the rank's rows, and the backward
reduce-scatters the shards' gradients (`models/layers.gather_from_model`,
GSPMD's resolution of the same conflict; the fused path gathers a level's
shards in one collective).  On a level that runs whole, model peers hold
the same rows and the nets stay column / row parallel
(`models/layers.CouplingNet`).  Only a model that holds shards
(`Glow.holds_shards`, set by `shard_model`) gathers: an eval copy holding
whole weights on a spatial mesh (`Glow.set_mesh` alone) does not.

The rules name the port's `state_dict` keys: the flow steps' coupling nets
`flow.layers.{j}.f.0` (conv1) and `f.2` (conv2); the variational
dequantizer's nets stay replicated, as in the JAX rules.  `shard_params`
keeps this rank's slice of a full state dict, `gather_params` puts the
full tensors back; snapshots hold gathered, mesh-independent tensors.

`put_global` makes one value identical on every rank: rank 0's, broadcast
(the counterpart of `mesh.put_global`, which places a host value every
process already holds).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterable

import torch
import torch.distributed as dist

from pytorch_glow_tpu_torch.config import MeshConfig
from pytorch_glow_tpu_torch.parallel import distributed as pd

DATA_AXIS = "data"
MODEL_AXIS = "model"

# state_dict key -> the dim its tensor is sharded on over "model".
_TP_RULES = (
    (re.compile(r"^flow\.layers\.\d+\.f\.0\.weight$"), 0),  # (H, ch, 3, 3)
    (re.compile(r"^flow\.layers\.\d+\.f\.0\.actnorm\.(bias|logs)$"), 1),  # (1, H, 1, 1)
    (re.compile(r"^flow\.layers\.\d+\.f\.2\.weight$"), 1),  # (H, H, 1, 1)
)


@dataclass
class Mesh:
    """This rank's view of the (data, model) mesh."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object
    spatial: bool = False  # image rows over "model" too (glow.shard_spatial)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def shard(self) -> tuple[int, int]:
        """(index, count) of this rank's rows of a global batch."""
        return self.data_rank, self.data

    @property
    def tp(self) -> bool:
        return self.model > 1


def make_mesh(cfg: MeshConfig | None = None, spatial: bool = False) -> Mesh:
    """The mesh of `cfg.shape(world size)` over the initialised default
    process group (data=-1: world // model); `spatial`: its model group
    shards image rows as well as the coupling nets' hidden channels."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    world = dist.get_world_size()
    data, model = (cfg or MeshConfig()).shape(world)
    if data * model != world:
        raise ValueError(f"mesh (data={data}, model={model}) does not cover {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    d, m = dm.get_coordinate()
    return Mesh(dm, data, model, d, m, dm.get_group(DATA_AXIS), dm.get_group(MODEL_AXIS),
                spatial)


def param_pspec(name: str, tp: bool) -> int | None:
    """The dim `name`'s tensor is sharded on over "model", or None
    (replicated).  Everything is replicated without tensor parallelism."""
    if not tp:
        return None
    for pattern, dim in _TP_RULES:
        if pattern.match(name):
            return dim
    return None


def shard_params(sd: dict[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's slice of each tensor of a full state dict (the others as
    they are)."""
    out = {}
    for name, t in sd.items():
        dim = param_pspec(name, mesh.tp)
        if dim is not None:
            if t.shape[dim] % mesh.model:
                raise ValueError(f"{name}: {tuple(t.shape)} does not split {mesh.model} ways "
                                 f"on dim {dim}")
            t = t.chunk(mesh.model, dim)[mesh.model_rank].clone()
        out[name] = t
    return out


@torch.no_grad()
def gather_params(sd: dict[str, torch.Tensor], mesh: Mesh | None) -> dict[str, torch.Tensor]:
    """The full tensors of a (sharded) state dict; collective over the model
    group.  Without tensor parallelism `sd` itself."""
    if mesh is None or not mesh.tp:
        return sd
    return {name: (t if (dim := param_pspec(name, True)) is None
                   else pd.all_gather_cat(t, dim, mesh.model_group))
            for name, t in sd.items()}


def _numels(named: list[tuple[str, torch.Tensor]], mesh: Mesh, full: bool) -> list[int]:
    scale = [mesh.model if full and param_pspec(n, True) is not None else 1 for n, _ in named]
    return [p.numel() * s for (_, p), s in zip(named, scale)]


@torch.no_grad()
def gather_flat(flat: torch.Tensor, named: list[tuple[str, torch.Tensor]],
                mesh: Mesh | None) -> torch.Tensor:
    """A flat vector laid out over this rank's parameters `named` (the
    optimizer's moments) -> the same over the full parameters."""
    if mesh is None or not mesh.tp:
        return flat
    parts = torch.split(flat, _numels(named, mesh, full=False))
    out = []
    for (name, p), part in zip(named, parts):
        dim = param_pspec(name, True)
        out.append(part if dim is None else
                   pd.all_gather_cat(part.view(p.shape), dim, mesh.model_group).reshape(-1))
    return torch.cat(out)


def shard_flat(flat: torch.Tensor, named: list[tuple[str, torch.Tensor]],
               mesh: Mesh | None) -> torch.Tensor:
    """The inverse of `gather_flat`: a full flat vector -> this rank's."""
    if mesh is None or not mesh.tp:
        return flat
    parts = torch.split(flat, _numels(named, mesh, full=True))
    out = []
    for (name, p), part in zip(named, parts):
        dim = param_pspec(name, True)
        if dim is not None:
            shape = list(p.shape)
            shape[dim] *= mesh.model
            part = part.view(shape).chunk(mesh.model, dim)[mesh.model_rank].reshape(-1)
        out.append(part)
    return torch.cat(out)


@torch.no_grad()
def put_global(tensors: Iterable[torch.Tensor]) -> None:
    """Every rank's `tensors` replaced in place by rank 0's."""
    if not dist.is_initialized():
        return
    for t in tensors:
        pd.broadcast_(t, 0)


def shard_model(model, mesh: Mesh) -> None:
    """Put `model` (full, identical on every rank) on the mesh: its
    tensor-parallel parameters keep this rank's slice (`model.holds_shards`),
    then `Glow.set_mesh` wires the coupling nets to the model group, DDI
    and the fused path to the mesh, and under spatial sharding the sharded
    levels to row slabs."""
    if mesh.tp:
        local = shard_params(dict(model.named_parameters()), mesh)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if param_pspec(name, True) is not None:
                    p.data = local[name]
        model.holds_shards = True
    model.set_mesh(mesh)


def global_norm_fn(mesh: Mesh, named: list[tuple[str, torch.Tensor]]):
    """-> flat gradient -> its global l2 norm over the whole model: the
    sharded entries' sum of squares all-reduced over the model group, the
    replicated entries counted once."""
    mask = torch.cat([torch.full((p.numel(),), param_pspec(n, True) is not None,
                                 dtype=torch.bool, device=p.device) for n, p in named])

    def norm(g: torch.Tensor) -> torch.Tensor:
        # `where`, not boolean indexing: an index by mask waits for the
        # device (its size), twice a call, and the step calls this twice.
        sq = g.float().square()
        sharded = pd.all_reduce_(torch.where(mask, sq, 0.0).sum(), mesh.model_group)
        return torch.sqrt(sharded + torch.where(mask, 0.0, sq).sum())

    return norm
