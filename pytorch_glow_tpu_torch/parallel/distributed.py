"""Process-group start-up and the collectives the port uses.

Counterpart of `pytorch_glow_tpu/parallel/distributed.py`.  A multi-device
run is one process per card, started by `torchrun`, which exports
WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT; `maybe_initialize`
turns that environment into a `torch.distributed` process group.  Single
processes (no torchrun environment) never pay for it.

Unlike the JAX function, a failed initialisation raises: under torchrun,
carrying on alone would leave N independent runs writing into one output
directory.

The collectives here take a group and work in place on any tensor; on a
group of one they return at once (the result is the input).  The gloo
backend runs all_reduce and broadcast on CUDA tensors but not all_gather,
so under gloo a CUDA tensor goes through a host copy for every collective:
that is how two ranks share one card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def multihost_env() -> bool:
    """True under torchrun's environment (WORLD_SIZE and MASTER_ADDR set, a
    world of one included, so that a one-rank torchrun runs the collective
    path), unless GLOW_TPU_MULTIHOST=off."""
    if os.environ.get("GLOW_TPU_MULTIHOST", "auto") == "off":
        return False
    return bool(os.environ.get("WORLD_SIZE")) and bool(os.environ.get("MASTER_ADDR"))


def local_device(cpu: bool = False) -> torch.device:
    """This rank's device: the CPU, or cuda:LOCAL_RANK (modulo the visible
    cards, so that ranks may share one card under gloo)."""
    if cpu:
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def maybe_initialize(device: torch.device | str, backend: str | None = None) -> bool:
    """Initialise the default process group from torchrun's environment:
    NCCL for a CUDA device, gloo for the CPU, or `backend` when given.  A
    CUDA device becomes the current one first.  Returns False (and does
    nothing) outside torchrun's environment; raises when initialisation
    fails."""
    if not multihost_env():
        return False
    if dist.is_initialized():
        return True
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} ({' | '.join(BACKENDS)})")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, **kwargs)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def comm_device() -> torch.device:
    """Where a small tensor made for a collective on the default group
    lives: the current card under NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _staged(t: torch.Tensor, group) -> bool:
    """Whether `t` goes through a host copy for a collective on `group`."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce `t` in place over `group`; returns `t`."""
    if dist.get_world_size(group) == 1:
        return t
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def mean_(t: torch.Tensor, group) -> torch.Tensor:
    """`t` replaced in place by its mean over `group` (a sum, then a
    division by the group's size)."""
    n = dist.get_world_size(group)
    return t if n == 1 else all_reduce_(t, group).div_(n)


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Rank `src`'s (a global rank) `t` into every rank's `t`, in place."""
    if dist.get_world_size(group) == 1:
        return t
    if _staged(t, group):
        host = t.cpu()
        dist.broadcast(host, src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src, group=group)
    return t


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `t` of `group`, concatenated along `dim` in group-rank
    order."""
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    if _staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's `t` over `group`, whose dim 0 holds one
    equal slice per rank (the layout `all_gather_cat` puts together along
    dim 0): this rank's slice.  NCCL reduce-scatters; gloo has no
    reduce-scatter, so there the whole sum is all-reduced (through the
    host for a CUDA tensor) and sliced."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    size = t.shape[0] // n
    if dist.get_backend(group) == "gloo":
        total = all_reduce_(t.detach().clone(), group)
        return total[dist.get_rank(group) * size:(dist.get_rank(group) + 1) * size]
    out = t.new_empty(size, *t.shape[1:])
    dist.reduce_scatter_tensor(out, t.detach().contiguous(), group=group)
    return out
