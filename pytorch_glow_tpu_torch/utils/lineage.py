"""Snapshots of the reference lineage (PyTorch `state_dict` files) to and from
the port.

Counterpart of `pytorch_glow_tpu/utils/torch_migrate.py`.  The port's
modules already carry the lineage's names (`models/glow.py`), so the key
table is the port's own `state_dict`:

  flow.layers.{j}.actnorm.{bias,logs} (1,C,1,1)        a flow step's actnorm
  flow.layers.{j}.invconv.{p,sign_s,lower,log_s,upper,  the LU 1x1 conv (P one-hot,
      l_mask,eye}                                        L, U strictly triangular)
  flow.layers.{j}.invconv.weight (C,C)                  the plain 1x1 conv
  flow.layers.{j}.{shuffle|reverse}.indices[_inverse]   a fixed permutation
  flow.layers.{j}.f.{0,2}.weight, .actnorm.{bias,logs}  the coupling net's convs
  flow.layers.{j}.f.4.{weight,bias,logs}                its zero conv
  flow.layers.{j}.conv.{weight,bias,logs}               a Split2d's prior
  learn_top.*, project_ycond.*, project_class.*         the top prior, class heads

where {j} counts the paramless Squeeze layers.  `import_state_dict` takes a
lineage `state_dict` whose flow layers may be numbered otherwise: it
matches the param-bearing `flow.layers.{j}` groups in ascending j against
the L*K + (L-1) the config implies, checks each group's kind (a step has
`actnorm.bias`, a split `conv.weight`), and brings every tensor to the
port's shape (per-channel vectors from any broadcast shape, P from a
one-hot matrix or an index vector, the LU triangles masked).  It strips
DataParallel's "module." prefix and applies `rename` prefix rewrites for
forks whose names deviate.  The LU masks (`l_mask`, `eye`) are constants,
and a fixed permutation's sibling name (`shuffle` for `reverse`) is taken
when the other is missing.  The lineage has no variational dequantizer: an
import into a `dequant="variational"` config keeps the fresh model's
zero-init flow, which is exactly the uniform dequantization the snapshot
was trained with.  `export_state_dict` writes the port's weights under the
same names, without the dequantizer.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import torch

# Container keys under which the lineage's train-loop snapshots nest the
# model's state_dict ({"graph": ..., "optim": ..., "global_step": N}).
STATE_DICT_KEYS = ("graph", "model", "state_dict", "model_state_dict", "net")
STEP_KEYS = ("global_step", "step")
_GROUP = re.compile(r"^flow\.layers\.(\d+)\.(.+)$")
_CONSTANTS = ("invconv.l_mask", "invconv.eye")


def load_torch_snapshot(path: str) -> tuple[dict[str, Any], int]:
    """A lineage snapshot file -> (state_dict, global_step): a bare
    state_dict, or a container dict holding one."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(obj, dict):
        raise ValueError(f"unsupported snapshot object: {type(obj)}")
    step = next((obj[k] for k in STEP_KEYS if isinstance(obj.get(k), int)), 0)
    if obj and all(isinstance(v, torch.Tensor) or hasattr(v, "__array__") for v in obj.values()):
        return dict(obj), step
    for k in STATE_DICT_KEYS:
        inner = obj.get(k)
        if isinstance(inner, dict) and inner:
            return dict(inner), step
    raise ValueError(f"no state_dict found in snapshot (top-level keys: {sorted(obj)[:8]}; "
                     f"looked under {STATE_DICT_KEYS})")


def save_torch_snapshot(path: str, state_dict: Mapping[str, torch.Tensor], step: int = 0) -> None:
    """A lineage-style container snapshot: {"graph": state_dict, "global_step"}."""
    torch.save({"graph": dict(state_dict), "global_step": int(step)}, path)


def _groups(sd: Mapping[str, Any]) -> list[dict[str, Any]]:
    """The `flow.layers.{j}.` key groups, in ascending j."""
    groups: dict[int, dict[str, Any]] = {}
    for key, val in sd.items():
        m = _GROUP.match(key)
        if m:
            groups.setdefault(int(m.group(1)), {})[m.group(2)] = val
    return [groups[j] for j in sorted(groups)]


def _like(value, ref: torch.Tensor, name: str) -> torch.Tensor:
    """`value` as a tensor of `ref`'s shape and dtype (any shape of the same
    size: the lineage's broadcast shapes of per-channel vectors)."""
    t = torch.as_tensor(value).detach().cpu()
    if t.numel() != ref.numel():
        raise ValueError(f"{name}: expected {tuple(ref.shape)}, got {tuple(t.shape)}")
    return t.reshape(ref.shape).to(ref.dtype).clone()


def _permutation(value, c: int, name: str) -> torch.Tensor:
    """P as a one-hot (C, C) matrix (P @ M == M[p_idx]) from a one-hot
    matrix or an index vector."""
    t = torch.as_tensor(value).detach().cpu()
    if t.dim() == 2:
        if t.shape != (c, c):
            raise ValueError(f"{name}: permutation matrix must be ({c},{c}), got {tuple(t.shape)}")
        idx = t.argmax(dim=1)
    else:
        idx = t.reshape(-1).long()
    if sorted(idx.tolist()) != list(range(c)):
        raise ValueError(f"{name}: not a permutation of range({c})")
    p = torch.zeros(c, c)
    p[torch.arange(c), idx] = 1.0
    if t.dim() == 2 and not torch.equal(t.float(), p):
        raise ValueError(f"{name}: not a permutation matrix")
    return p


def _layer_prefixes(reference: Mapping[str, torch.Tensor]) -> list[str]:
    """The port's param-bearing `flow.layers.{j}` prefixes, in order."""
    js = sorted({int(m.group(1)) for m in map(_GROUP.match, reference) if m})
    return [f"flow.layers.{j}" for j in js]


def import_state_dict(sd: Mapping[str, Any], reference: Mapping[str, torch.Tensor],
                      rename: Mapping[str, str] | None = None) -> dict[str, torch.Tensor]:
    """A lineage state_dict -> the port's, shaped as `reference` (the
    `state_dict` of a `Glow` built from the target config)."""
    clean: dict[str, Any] = {}
    for key, val in sd.items():
        if key.startswith("module."):
            key = key[len("module."):]
        for old, new in (rename or {}).items():
            if key.startswith(old):
                key = new + key[len(old):]
        clean[key] = val
    groups = _groups(clean)
    prefixes = _layer_prefixes(reference)
    if len(groups) != len(prefixes):
        raise ValueError(f"snapshot has {len(groups)} param-bearing flow layers, the config "
                         f"implies {len(prefixes)} (K steps per level and L - 1 splits; "
                         f"Squeeze layers carry no parameters)")
    source: dict[str, Any] = {k: v for k, v in clean.items() if not _GROUP.match(k)}
    for gi, (group, prefix) in enumerate(zip(groups, prefixes)):
        want = {k[len(prefix) + 1:] for k in reference if k.startswith(prefix + ".")}
        kind = "actnorm.bias" if "actnorm.bias" in want else "conv.weight"
        if kind not in group:
            what = "a FlowStep (actnorm.bias)" if kind == "actnorm.bias" else "a Split2d (conv.weight)"
            raise ValueError(f"flow layer group {gi}: expected {what}, found keys "
                             f"{sorted(group)[:4]}")
        for name in want:
            mode = name.split(".")[0]
            sibling = {"shuffle": "reverse", "reverse": "shuffle"}.get(mode)
            if name not in group and sibling and f"{sibling}{name[len(mode):]}" in group:
                group[name] = group[f"{sibling}{name[len(mode):]}"]
            if name in group:
                source[f"{prefix}.{name}"] = group[name]
    out: dict[str, torch.Tensor] = {}
    for key, ref in reference.items():
        if key.startswith("vardeq."):
            out[key] = ref.clone()  # zero-init: exactly uniform dequantization
            continue
        if key not in source:
            if key.endswith(_CONSTANTS):
                out[key] = ref.clone()
                continue
            raise ValueError(f"snapshot lacks {key}")
        value = source[key]
        if key.endswith("invconv.p"):
            out[key] = _permutation(value, ref.shape[0], key)
        elif key.endswith("invconv.lower"):
            out[key] = torch.tril(_like(value, ref, key), -1)
        elif key.endswith("invconv.upper"):
            out[key] = torch.triu(_like(value, ref, key), 1)
        else:
            out[key] = _like(value, ref, key)
    return out


def export_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The port's `state_dict` -> the lineage's: the same names, on the CPU,
    the LU triangles masked, without the variational dequantizer."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith("vardeq."):
            continue
        value = value.detach().cpu().clone()
        if key.endswith("invconv.lower"):
            value = torch.tril(value, -1)
        elif key.endswith("invconv.upper"):
            value = torch.triu(value, 1)
        out[key] = value
    return out
