"""JAX parameter pytree -> the port's `state_dict`, with numpy only.

Counterpart of the export half of `pytorch_glow_tpu/utils/torch_migrate.py`:
the same key table (`flow.layers.{j}` counting Squeeze layers, `learn_top`)
and layout conversions (conv weights HWIO -> (out, in, kh, kw), per-channel
vectors to the lineage's broadcast shapes, the LU permutation index to a
one-hot P with P[i, p_idx[i]] = 1; a plain 1x1 conv's weight and a fixed
permutation's index pair as they are).  `Glow.load_state_dict` of the result
makes the port compute what JAX computes on those parameters.

Takes the pytree with numpy leaves (`jax.tree.map(np.asarray, params)`);
`LUParams` may arrive as the NamedTuple or as a dict.

A y-conditional model's heads `top.project_ycond` / `top.project_class`
go under the lineage's names, `project_ycond.{weight,bias,logs}` and
`project_class.*`, the weight transposed to (out, in).  The lineage has no
variational dequantizer, so its subtree goes under the port's own names
(`models/vardeq.py`):

  JAX `vardeq`                               port `state_dict`
  ctx.conv{1,2}.{w, actnorm.bias, .logs}    vardeq.ctx.conv{1,2}.{weight, actnorm.bias, .logs}
  steps[i].conv1 / conv2 / conv3            vardeq.steps.{i}.0 / .2 / .4 (as a flow step's f)
  final.bias, final.logs                    vardeq.bias, vardeq.logs  (4C each)
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pytorch_glow_tpu_torch.config import GlowConfig


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _vec4(x) -> np.ndarray:
    return _f32(x).reshape(1, -1, 1, 1)


def _conv_w(w) -> np.ndarray:
    """(kh, kw, in, out) -> (out, in, kh, kw)."""
    return np.transpose(_f32(w), (3, 2, 0, 1))


def _conv2d(prefix: str, p: dict, out: dict) -> None:
    out[f"{prefix}.weight"] = _conv_w(p["w"])
    out[f"{prefix}.actnorm.bias"] = _vec4(p["actnorm"]["bias"])
    out[f"{prefix}.actnorm.logs"] = _vec4(p["actnorm"]["logs"])


def _conv2d_zeros(prefix: str, p: dict, out: dict) -> None:
    out[f"{prefix}.weight"] = _conv_w(p["w"])
    out[f"{prefix}.bias"] = _f32(p["b"])
    out[f"{prefix}.logs"] = _f32(p["logs"]).reshape(-1, 1, 1)


def _linear_zeros(prefix: str, p: dict, out: dict) -> None:
    out[f"{prefix}.weight"] = _f32(p["w"]).T
    out[f"{prefix}.bias"] = _f32(p["b"])
    out[f"{prefix}.logs"] = _f32(p["logs"])


def _coupling_net(prefix: str, cp: dict, out: dict) -> None:
    _conv2d(f"{prefix}.0", cp["conv1"], out)
    _conv2d(f"{prefix}.2", cp["conv2"], out)
    _conv2d_zeros(f"{prefix}.4", cp["conv3"], out)


def _vardeq(p: dict, out: dict) -> None:
    _conv2d("vardeq.ctx.conv1", p["ctx"]["conv1"], out)
    _conv2d("vardeq.ctx.conv2", p["ctx"]["conv2"], out)
    for i, net in enumerate(p["steps"]):
        _coupling_net(f"vardeq.steps.{i}", net, out)
    out["vardeq.bias"] = _f32(p["final"]["bias"])
    out["vardeq.logs"] = _f32(p["final"]["logs"])


def _lu_field(lu: Any, name: str) -> np.ndarray:
    return np.asarray(lu[name] if isinstance(lu, dict) else getattr(lu, name))


def _step(prefix: str, sp: dict, out: dict, mode: str = "invconv") -> None:
    """One flow step; `mode` is `flow_permutation`, which names a fixed
    permutation's submodule."""
    out[f"{prefix}.actnorm.bias"] = _vec4(sp["actnorm"]["bias"])
    out[f"{prefix}.actnorm.logs"] = _vec4(sp["actnorm"]["logs"])
    _permutation(prefix, sp["perm"], out, mode)
    _coupling_net(f"{prefix}.f", sp["coupling"], out)


def _permutation(prefix: str, perm: dict, out: dict, mode: str) -> None:
    if "w" in perm:  # plain 1x1 conv
        out[f"{prefix}.invconv.weight"] = _f32(perm["w"])
        return
    if "idx" in perm:  # fixed: shuffle | reverse
        out[f"{prefix}.{mode}.indices"] = np.asarray(perm["idx"], np.int64)
        out[f"{prefix}.{mode}.indices_inverse"] = np.asarray(perm["inv_idx"], np.int64)
        return
    lu = perm["lu"]
    log_s = _f32(_lu_field(lu, "log_s"))
    c = log_s.shape[0]
    p_mat = np.zeros((c, c), np.float32)
    p_mat[np.arange(c), _lu_field(lu, "p_idx").astype(np.int64)] = 1.0
    out[f"{prefix}.invconv.p"] = p_mat
    out[f"{prefix}.invconv.sign_s"] = _f32(_lu_field(lu, "sign_s"))
    out[f"{prefix}.invconv.lower"] = np.tril(_f32(_lu_field(lu, "l_raw")), -1)
    out[f"{prefix}.invconv.log_s"] = log_s
    out[f"{prefix}.invconv.upper"] = np.triu(_f32(_lu_field(lu, "u_raw")), 1)
    out[f"{prefix}.invconv.l_mask"] = np.tril(np.ones((c, c), np.float32), -1)
    out[f"{prefix}.invconv.eye"] = np.eye(c, dtype=np.float32)


def _index(tree: Any, k: int) -> Any:
    """Step k of a K-stacked pytree (dicts, NamedTuples, arrays)."""
    if isinstance(tree, dict):
        return {key: _index(v, k) for key, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _index(getattr(tree, f), k) for f in tree._fields}
    return np.asarray(tree)[k]


def state_dict_from_jax(params: dict, cfg: GlowConfig) -> dict[str, torch.Tensor]:
    """JAX params (numpy leaves) -> the port's `state_dict`."""
    out: dict[str, np.ndarray] = {}
    j = 0
    for level in params["levels"]:
        j += 1  # Squeeze
        for k in range(cfg.K):
            _step(f"flow.layers.{j}", _index(level["steps"], k), out, cfg.flow_permutation)
            j += 1
        if level["split"] is not None:
            _conv2d_zeros(f"flow.layers.{j}.conv", level["split"]["prior_conv"], out)
            j += 1
    top = params["top"]
    if "learn_top" in top:
        _conv2d_zeros("learn_top", top["learn_top"], out)
    if "project_ycond" in top:
        _linear_zeros("project_ycond", top["project_ycond"], out)
        _linear_zeros("project_class", top["project_class"], out)
    if "vardeq" in params:
        _vardeq(params["vardeq"], out)
    return {key: torch.from_numpy(np.array(v, copy=True)) for key, v in out.items()}
