"""Spatial sharding: the image rows of a level over the mesh's "model" group.

Counterpart of `pytorch_glow_tpu/models/glow.py` `_maybe_shard_spatial`,
which constrains each level's (B, H, W, C) activations to shard H over
"model" and leaves GSPMD to insert the 3x3 convs' halo exchanges.  Here
the model (`models/glow.py`) shards and exchanges itself, with the
functions of this module.

Which levels (`level_sharded`): with `cfg.shard_spatial`, a mesh made for
it (`parallel/mesh.make_mesh(..., spatial=True)`) whose model group has
n > 1 ranks, and a level of H rows with H % n == 0, as in
JAX, and besides H / n >= HALO (2), the rows a flow step's band needs of
each neighbour.  A slab shorter than the halo would need the neighbour's
neighbour's rows; instead such a level (at L=6 with n=4, the deepest, one
row a rank) runs whole on every rank: `gather_rows` before it and
`shard_rows` after it in decode.  The sharded levels are the shallow ones
(H halves each level), so encode leaves them once and decode enters them
once.  Model rank m holds rows [m H/n, (m+1) H/n) of a sharded level;
the batch stays on "data".

Autograd convention: a tensor every model peer holds whole is computed
identically by each, and its cotangent on each rank is the whole, true
one.  A slab's cotangent is the true cotangent of the rank's rows.  So:

* `shard_rows` (whole -> the rank's rows): backward all-gathers the slabs'
  cotangents into the whole one.
* `gather_rows` (slab -> whole): backward keeps the rank's rows.
* `sum_partial` (a per-rank partial, e.g. the logdet of a slab's pixels ->
  their sum over the group): backward is the identity.
* `exchange` (slab -> the slab with k rows of each neighbour above and
  below): backward sends the halo rows' cotangents back to their owners,
  which add them to their own rows.  Rows beyond the image (above rank 0,
  below rank n-1) are absent: they come back as zeros, which the 3x3
  convs' SAME padding reads as the reference does, and which the fused
  band chain never reads (it masks on the absolute image row,
  `ops/flowstep.Slab`).

A parameter used on a slab (a sharded level's flow steps and split prior)
gets the gradient of the rank's rows only; `partial_mask` marks those
entries of the flat gradient, which the train step sums over the model
group (`train/step.py`), as K3's in-kernel psum sums the row partials in
JAX.  Every other parameter's gradient is already whole on every rank.

Transport: point-to-point, `dist.batch_isend_irecv` with each neighbour;
under gloo a CUDA tensor is staged through the host (gloo sends CPU
tensors), as `parallel/distributed.py` stages its collectives.  A failed
send or receive raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pytorch_glow_tpu_torch.ops.flowstep import HALO
from pytorch_glow_tpu_torch.parallel import distributed as pd


def level_sharded(cfg, mesh, rows: int) -> bool:
    """Whether a level of `rows` rows runs on row slabs over `mesh`'s model
    group (module docstring)."""
    if mesh is None or not cfg.shard_spatial or not mesh.spatial or mesh.model < 2:
        return False
    return rows % mesh.model == 0 and rows // mesh.model >= HALO


def own_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's rows of a whole (B, H, ...) tensor (a view, no autograd
    rule of its own: for draws and other leaves)."""
    s = t.shape[1] // mesh.model
    return t[:, mesh.model_rank * s:(mesh.model_rank + 1) * s]


class _ShardRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return own_rows(t, mesh).contiguous()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return pd.all_gather_cat(g, 1, ctx.mesh.model_group), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return pd.all_gather_cat(t, 1, mesh.model_group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return own_rows(g, ctx.mesh), None


class _SumPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh) -> torch.Tensor:
        return pd.all_reduce_(t.detach().clone(), mesh.model_group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def shard_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Whole (B, H, W, C) -> the rank's (B, H/n, W, C) slab."""
    return _ShardRows.apply(t, mesh)


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's slab -> the whole tensor, slabs in model-rank order."""
    return _GatherRows.apply(t, mesh)


def sum_partial(t: torch.Tensor, mesh) -> torch.Tensor:
    """A per-rank partial (the terms of the rank's rows) -> its sum over
    the model group, on every rank."""
    return _SumPartial.apply(t, mesh)


def _swap(mesh, sends: dict[int, torch.Tensor], recvs: dict[int, torch.Tensor]) -> None:
    """Send sends[peer] to and receive recvs[peer] from each model-group
    neighbour (peer = model rank), all at once; receives fill in place."""
    group = mesh.model_group
    staged = any(t.is_cuda for t in (*sends.values(), *recvs.values())) \
        and dist.get_backend(group) == "gloo"
    host_recvs = {p: (t.cpu() if staged else t) for p, t in recvs.items()}
    ops = [dist.P2POp(dist.isend, (t.cpu() if staged else t.contiguous()),
                      dist.get_global_rank(group, p), group) for p, t in sends.items()]
    ops += [dist.P2POp(dist.irecv, host_recvs[p], dist.get_global_rank(group, p), group)
            for p in recvs]
    if not ops:
        return
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        for p, t in recvs.items():
            t.copy_(host_recvs[p])


def _neighbours(mesh) -> tuple[int | None, int | None]:
    m = mesh.model_rank
    return (m - 1 if m > 0 else None), (m + 1 if m < mesh.model - 1 else None)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, k: int, mesh) -> torch.Tensor:
        ctx.k, ctx.mesh = k, mesh
        s = x.shape[1]
        if s < k:
            raise ValueError(f"a slab of {s} rows cannot give its neighbours {k} rows")
        b, _, w, c = x.shape
        out = x.new_zeros(b, s + 2 * k, w, c)
        out[:, k:k + s] = x
        up, down = _neighbours(mesh)
        sends, recvs = {}, {}
        if up is not None:  # my first rows are its bottom halo; its last rows my top
            sends[up], recvs[up] = x[:, :k].contiguous(), x.new_empty(b, k, w, c)
        if down is not None:
            sends[down], recvs[down] = x[:, s - k:].contiguous(), x.new_empty(b, k, w, c)
        _swap(mesh, sends, recvs)
        if up is not None:
            out[:, :k] = recvs[up]
        if down is not None:
            out[:, k + s:] = recvs[down]
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        k, mesh = ctx.k, ctx.mesh
        s = g.shape[1] - 2 * k
        b, _, w, c = g.shape
        grad = g[:, k:k + s].clone()
        up, down = _neighbours(mesh)
        sends, recvs = {}, {}
        if up is not None:  # my top halo's cotangent belongs to the rank above
            sends[up], recvs[up] = g[:, :k].contiguous(), g.new_empty(b, k, w, c)
        if down is not None:
            sends[down], recvs[down] = g[:, k + s:].contiguous(), g.new_empty(b, k, w, c)
        _swap(mesh, sends, recvs)
        if up is not None:
            grad[:, :k] += recvs[up]
        if down is not None:
            grad[:, s - k:] += recvs[down]
        return grad, None, None


def exchange(x: torch.Tensor, k: int, mesh) -> torch.Tensor:
    """The rank's (B, S, W, C) slab -> (B, S + 2k, W, C): k rows of the
    rank above, the slab, k rows of the rank below (zeros beyond the
    image)."""
    return _Exchange.apply(x, k, mesh)


def partial_mask(model, named: list[tuple[str, torch.Tensor]]) -> torch.Tensor | None:
    """A bool mask over the flat gradient of `named` (the trainable
    parameters, in order): True where the parameter is used on a slab, so
    that its gradient is the rank's rows' partial; None when no level of
    `model` is sharded."""
    modules = model.sharded_modules()
    if not modules:
        return None
    ids = {id(p) for m in modules for p in m.parameters()}
    return torch.cat([torch.full((p.numel(),), id(p) in ids, dtype=torch.bool, device=p.device)
                      for _, p in named])
