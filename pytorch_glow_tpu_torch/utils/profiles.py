"""JSON profile loading: a copy of `pytorch_glow_tpu/utils/profiles.py`
built on the port's own `config` (the JAX package's module cannot be
imported without pulling in JAX through its package `__init__`).

A profile JSON maps section-by-section onto the Profile dataclasses:

    {"name": "...", "glow": {...}, "optim": {...}, "train": {...},
     "data": {...}, "mesh": {...}, "out_dir": "..."}

Unknown keys raise (typo safety); a profile may also just name a preset:
    {"preset": "cifar10", "train": {"batch_size": 128}}  — preset + overrides.
The reference lineage's capitalised-section hparams JSONs are detected and
converted (`convert_lineage_profile`), as the JAX package converts them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from pytorch_glow_tpu_torch.config import (
    DataConfig,
    GlowConfig,
    MeshConfig,
    OptimConfig,
    PRESETS,
    Profile,
    TrainConfig,
)

_SECTIONS = {
    "glow": GlowConfig,
    "optim": OptimConfig,
    "train": TrainConfig,
    "data": DataConfig,
    "mesh": MeshConfig,
}


def _build_section(cls, base, overrides: dict[str, Any]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(overrides) - set(fields)
    if unknown:
        raise KeyError(f"{cls.__name__}: unknown keys {sorted(unknown)}")
    coerced = {}
    for k, v in overrides.items():
        if isinstance(v, list):
            v = tuple(v)
        coerced[k] = v
    return dataclasses.replace(base, **coerced)


def profile_from_dict(d: dict[str, Any]) -> Profile:
    d = dict(d)
    preset = d.pop("preset", None)
    base = PRESETS[preset] if preset else Profile()
    kwargs: dict[str, Any] = {}
    for key, cls in _SECTIONS.items():
        if key in d:
            kwargs[key] = _build_section(cls, getattr(base, key), d.pop(key))
    for scalar in ("name", "out_dir"):
        if scalar in d:
            kwargs[scalar] = d.pop(scalar)
    if d:
        raise KeyError(f"profile: unknown sections {sorted(d)}")
    return base.replace(**kwargs)


# ---------------------------------------------------------------------------
# Reference-lineage profile format (auto-detected, converted transparently)
# ---------------------------------------------------------------------------
#
# The reference parameterizes runs with capitalized-section hparams JSONs
# (upstream:profile/*.json — sections Glow/Data/Optim/Train/Device/Infer/Dir;
# SURVEY.md §2.1 #3).  `load_profile` detects that shape and converts it so
# `train.py their_profile.json` works unchanged for a switching user.  Key
# names are [M]-confidence recall (the reference mount is empty, SURVEY.md
# §0); keys with no equivalent here (Device lists, Infer, Dir subkeys) are
# reported and dropped, not fatal — unlike our native format, which stays
# typo-strict.


def is_lineage_profile(d: dict[str, Any]) -> bool:
    return "Glow" in d and "glow" not in d


def convert_lineage_profile(d: dict[str, Any], name: str = "imported") -> dict[str, Any]:
    """Reference-lineage hparams dict -> our profile dict."""
    dropped: list[str] = []

    def take(section: dict, mapping: dict[str, str], out: dict, prefix: str):
        for src, val in section.items():
            if src in mapping:
                out[mapping[src]] = val
            else:
                dropped.append(f"{prefix}.{src}")

    out: dict[str, Any] = {"name": name}
    glow: dict[str, Any] = {}
    take(d.get("Glow", {}), {
        "image_shape": "image_shape", "hidden_channels": "hidden_channels",
        "K": "K", "L": "L", "actnorm_scale": "actnorm_scale",
        "flow_permutation": "flow_permutation", "flow_coupling": "flow_coupling",
        "LU_decomposed": "lu_decomposed", "learn_top": "learn_top",
        "y_condition": "y_condition", "y_classes": "y_classes",
        "n_bits_x": "n_bits_x", "weight_y": "weight_y",
    }, glow, "Glow")
    shape = glow.get("image_shape")
    if shape and len(shape) == 3 and shape[0] in (1, 3) and shape[2] not in (1, 3):
        glow["image_shape"] = [shape[1], shape[2], shape[0]]  # CHW -> HWC
    crit = d.get("Criterion", {})
    if "y_condition" in crit:
        glow["y_multi_class"] = "multi" in str(crit["y_condition"])
    dropped.extend(f"Criterion.{k}" for k in crit if k != "y_condition")
    out["glow"] = glow

    data: dict[str, Any] = {}
    take(d.get("Data", {}), {
        "dataset": "name", "dataset_root": "root", "root": "root",
        "num_workers": "num_workers",
    }, data, "Data")
    if glow.get("image_shape"):
        data.setdefault("image_size", glow["image_shape"][0])
    out["data"] = data

    optim: dict[str, Any] = {}
    osec = dict(d.get("Optim", {}))
    if "name" in osec:
        optim["name"] = osec.pop("name")
    args = osec.pop("args", {})
    for src, dst in (("lr", "lr"), ("betas", "betas"), ("eps", "eps")):
        if src in args:
            optim[dst] = args[src]
    dropped.extend(f"Optim.args.{k}" for k in args if k not in ("lr", "betas", "eps"))
    sched = osec.pop("Schedule", osec.pop("schedule", {})) or {}
    sname = str(sched.get("name", ""))
    if "noam" in sname:
        optim["schedule"] = "noam"
    elif "constant" in sname:
        optim["schedule"] = "constant"
    elif sname:
        optim["schedule"] = "warmup"
    sargs = sched.get("args", {})
    for k in ("warmup_steps", "warmup"):
        if k in sargs:
            optim["warmup_steps"] = int(sargs[k])
    dropped.extend(
        f"Optim.Schedule.args.{k}" for k in sargs
        if k not in ("warmup_steps", "warmup")
    )
    dropped.extend(f"Optim.{k}" for k in osec)
    out["optim"] = optim

    train: dict[str, Any] = {}
    take(d.get("Train", {}), {
        "batch_size": "batch_size", "num_batches": "num_steps",
        "num_steps": "num_steps", "max_grad_clip": "max_grad_clip",
        "max_grad_norm": "max_grad_norm", "scalar_log_gap": "scalar_log_gap",
        "plot_gap": "plot_gap", "checkpoint_gap": "checkpoint_gap",
        "max_checkpoints": "keep_checkpoints",
        "num_plot_samples": "num_sample_images",
    }, train, "Train")
    for k in ("max_grad_clip", "max_grad_norm"):
        if train.get(k) is None and k in train:
            train[k] = 0.0  # lineage null = disabled
    out["train"] = train

    dirsec = d.get("Dir", {})
    if "log_root" in dirsec:
        out["out_dir"] = dirsec["log_root"]
        dropped.extend(f"Dir.{k}" for k in dirsec if k != "log_root")
    else:
        dropped.extend(f"Dir.{k}" for k in dirsec)
    dropped.extend(
        f"{sec}.*" for sec in ("Device", "Infer") if sec in d
    )
    if dropped:
        print(
            f"[profile] reference-lineage format converted; no equivalent "
            f"for: {', '.join(sorted(dropped))} (the port runs on one card, "
            f"so Device lists have no counterpart)"
        )
    return out


def apply_overrides(prof: Profile, assignments: list[str]) -> Profile:
    """CLI `--set section.key=value` overrides on a resolved profile.

    `value` is parsed as JSON when possible (numbers, bools, lists, null),
    otherwise taken as a bare string — `--set data.name=image_folder`,
    `--set optim.lr=2e-4`, `--set glow.image_shape=[64,64,3]`.  Top-level
    scalars go without a dot (`--set out_dir=results/run2`).  Unknown
    sections/keys raise, same typo discipline as the JSON loader.
    """
    for a in assignments:
        lhs, sep, raw = a.partition("=")
        if not sep:
            raise KeyError(f"--set expects section.key=value, got {a!r}")
        try:
            val: Any = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        section, dot, key = lhs.partition(".")
        if not dot:
            if section not in ("name", "out_dir"):
                raise KeyError(
                    f"--set: unknown top-level key {section!r} "
                    f"(sections: {sorted(_SECTIONS)}, scalars: name, out_dir)"
                )
            prof = prof.replace(**{section: str(val)})
            continue
        if section not in _SECTIONS:
            raise KeyError(
                f"--set: unknown section {section!r} (have {sorted(_SECTIONS)})"
            )
        base = getattr(prof, section)
        prof = prof.replace(
            **{section: _build_section(_SECTIONS[section], base, {key: val})}
        )
    return prof


def load_profile(path: str) -> Profile:
    with open(path) as f:
        d = json.load(f)
    if is_lineage_profile(d):
        stem = os.path.splitext(os.path.basename(path))[0]
        d = convert_lineage_profile(d, name=stem)
    return profile_from_dict(d)


def profile_to_dict(p: Profile) -> dict[str, Any]:
    return dataclasses.asdict(p)


def save_profile(path: str, p: Profile) -> None:
    with open(path, "w") as f:
        json.dump(profile_to_dict(p), f, indent=2, default=list)
        f.write("\n")
