"""What the benchmark takes from the program under test,
`pytorch_glow_tpu_torch`: its configuration types, its model loaded with
the benchmark's weights, and the card it runs on; and the process's start,
from which set-up is timed.  The kinds import the
program's entry points themselves; nothing here or there imports the JAX
package."""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

from pytorch_glow_tpu_torch.config import GlowConfig, OptimConfig, TrainConfig
from pytorch_glow_tpu_torch.models.glow import Glow, init_glow


def _process_start() -> float:
    """The wall-clock time at which this process started."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


START = _process_start()


def stamp(what: str) -> None:
    """A set-up phase's end, in seconds since the process started."""
    print(f"set-up: {what} at {time.time() - START:.3f} s", file=sys.stderr, flush=True)


def configs(config: dict) -> tuple[GlowConfig, OptimConfig, TrainConfig]:
    """The configuration file's sections as the program's dataclasses."""
    glow = dict(config["glow"], image_shape=tuple(config["glow"]["image_shape"]))
    optim = dict(config["optim"], betas=tuple(config["optim"]["betas"]))
    return GlowConfig(**glow), OptimConfig(**optim), TrainConfig(**config["train"])


def model(cfg: GlowConfig, state: dict[str, torch.Tensor], device) -> Glow:
    """The program's model on `device` holding `state` (a lineage
    `state_dict`; strict: every name and shape has to match)."""
    m = init_glow(cfg, None, device)
    m.load_state_dict(state)
    return m


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card(device) -> tuple[str, str]:
    """The card's name as torch gives it, and its power limit as
    nvidia-smi reads it ("unknown" where it cannot)."""
    if torch.device(device).type != "cuda":
        return "cpu", "none"
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30, check=True)
        limit = proc.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "unknown"
    return torch.cuda.get_device_name(device), limit
