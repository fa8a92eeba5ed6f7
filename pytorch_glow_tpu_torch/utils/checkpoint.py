"""Rolling training snapshots with `torch.save`.

Counterpart of `pytorch_glow_tpu/utils/checkpoint.py` (orbax there).  A
snapshot is one file, `<directory>/<step>.pt`, holding everything a
resumed run needs to continue bit for bit:

* "step", "seed";
* "model": the model's `state_dict` (parameters, DDI'd actnorms, the
  permutations' buffers);
* "opt_state": the optimizer's state dict of tensors;
* "ema": the EMA trainables (a list in `trainable` order), or None;
* "data_state": the host stream's position (`IndexedBatches.get_state`);
* "profile": the profile as a dict (`profile_to_dict`).

No random state is saved: each step's generators are derived from (seed,
step) alone (`train/step.step_generator`), so a resumed run draws the same
noise.  Each snapshot is written to a temporary file in the same directory
and moved into place with `os.replace`, so a crash mid-write never leaves a
broken `<step>.pt`; then all but the newest `keep` are deleted.

Best-checkpoint tracking (the snapshot of lowest held-out eval bits/dim)
waits for held-out eval.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self._keep = max(1, keep)

    def steps(self) -> list[int]:
        """Steps with a snapshot on disk, ascending."""
        if not os.path.isdir(self.directory):
            return []
        found = (_NAME.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state: dict, data_state: dict | None, profile: dict) -> str:
        """Write the snapshot of `state` at `step`; keep the newest `keep`."""
        snapshot: dict[str, Any] = {
            "step": int(step),
            "seed": int(state["seed"]),
            "model": state["model"].state_dict(),
            "opt_state": state["opt_state"],
            "ema": state.get("ema"),
            "data_state": data_state,
            "profile": profile,
        }
        os.makedirs(self.directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(snapshot, f)
            os.replace(tmp, self.path(step))
        except BaseException:
            os.unlink(tmp)
            raise
        for old in self.steps()[:-self._keep]:
            os.remove(self.path(old))
        return self.path(step)

    def restore(self, device: torch.device | str) -> dict | None:
        """The newest snapshot with its tensors on `device`, or None when
        there is none."""
        step = self.latest_step()
        if step is None:
            return None
        return torch.load(self.path(step), map_location=device, weights_only=True)
