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

Best-snapshot tracking (the snapshot of lowest held-out eval bits/dim, as
the JAX package's `maybe_save_best` / `restore_best`): a sibling directory
`<directory>-best/` holds one `<step>.pt`, the same dict as a rolling
snapshot, and `best.json` of {"step", "metric"}.  A new best is written in
the order that leaves a consistent pair after a crash at any point: its
`<step>.pt` (temporary file, `os.replace`), then `best.json` (the same),
then the older `.pt` files are deleted.  Where `best.json` names a step
that is not on disk, `restore_best` loads the newest best file there and
prints a warning.  The port saves synchronously, so the JAX package's
bookkeeping of asynchronous best saves (`_best_pending`, commit threads)
has no counterpart here.

On a mesh (`CheckpointManager(..., mesh)`), every rank takes part in a
save and rank 0 alone writes: the tensors are gathered first
(`parallel/mesh.gather_params`, the optimizer's flat moments by
`gather_flat`), so a snapshot is mesh-independent and restores onto any
mesh, one rank included, as orbax restores onto another sharding.  Each
rank's stream position goes in as "data_states" (by global rank; the
counterpart of the JAX sidecars `step_*.p{i}.json`).  The best-save
decision is rank 0's, broadcast to all; every write, and each prune, is
followed by a barrier, so no rank restores or prunes a half-written file.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any

import torch
import torch.distributed as dist

from pytorch_glow_tpu_torch.parallel import distributed as pd
from pytorch_glow_tpu_torch.parallel import mesh as meshlib

_NAME = re.compile(r"^(\d+)\.pt$")


def _steps(directory: str) -> list[int]:
    """Steps with a `<step>.pt` in `directory`, ascending."""
    if not os.path.isdir(directory):
        return []
    found = (_NAME.match(name) for name in os.listdir(directory))
    return sorted(int(m.group(1)) for m in found if m)


def _write_atomic(path: str, write) -> None:
    """`write(file)` into a temporary file beside `path`, then move it there."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _load(path: str, device: torch.device | str) -> dict:
    return torch.load(path, map_location=device, weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, mesh: meshlib.Mesh | None = None):
        self.directory = os.path.abspath(directory)
        self.best_directory = self.directory + "-best"
        self._keep = max(1, keep)
        self.mesh = mesh

    @property
    def _writer(self) -> bool:
        return self.mesh is None or dist.get_rank() == 0

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()

    def steps(self) -> list[int]:
        """Steps with a snapshot on disk, ascending."""
        return _steps(self.directory)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def _snapshot(self, step: int, state: dict, data_state: dict | None,
                  profile: dict) -> dict[str, Any]:
        """The snapshot dict of `state`, its tensors gathered (collective)."""
        mesh = self.mesh
        model = state["model"]
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        ema = state.get("ema")
        if ema is not None:
            ema = list(meshlib.gather_params(dict(zip([n for n, _ in named], ema)), mesh).values())
        opt_state = {k: (meshlib.gather_flat(v, named, mesh) if v.dim() == 1 else v)
                     for k, v in state["opt_state"].items()}
        snapshot: dict[str, Any] = {
            "step": int(step),
            "seed": int(state["seed"]),
            "model": meshlib.gather_params(model.state_dict(), mesh),
            "opt_state": opt_state,
            "ema": ema,
            "data_state": data_state,
            "profile": profile,
        }
        if mesh is not None:
            states = [None] * dist.get_world_size()
            dist.all_gather_object(states, data_state)
            snapshot["data_states"] = states
        return snapshot

    def _write(self, directory: str, step: int, state: dict, data_state: dict | None,
               profile: dict) -> None:
        snapshot = self._snapshot(step, state, data_state, profile)
        if self._writer:
            os.makedirs(directory, exist_ok=True)
            _write_atomic(os.path.join(directory, f"{step}.pt"),
                          lambda f: torch.save(snapshot, f))

    def save(self, step: int, state: dict, data_state: dict | None, profile: dict) -> str:
        """Write the snapshot of `state` at `step`; keep the newest `keep`."""
        self._write(self.directory, step, state, data_state, profile)
        if self._writer:
            for old in self.steps()[:-self._keep]:
                os.remove(self.path(old))
        self._barrier()
        return self.path(step)

    def restore(self, device: torch.device | str) -> dict | None:
        """The newest snapshot with its tensors on `device`, or None when
        there is none."""
        step = self.latest_step()
        if step is None:
            return None
        return _load(self.path(step), device)

    # -- the best snapshot ----------------------------------------------------

    def _best_json(self) -> str:
        return os.path.join(self.best_directory, "best.json")

    def best_info(self) -> dict | None:
        """{"step": int, "metric": float} of the best snapshot, or None."""
        if not os.path.isfile(self._best_json()):
            return None
        with open(self._best_json()) as f:
            return json.load(f)

    def maybe_save_best(self, step: int, state: dict, metric: float,
                        data_state: dict | None, profile: dict) -> bool:
        """Save `state` as the best snapshot iff `metric` (lower is better,
        e.g. eval bits/dim) improves on the stored best; True when it did."""
        prev = self.best_info()
        should = prev is None or float(metric) < float(prev["metric"])
        if self.mesh is not None:
            # Rank 0's decision: the ranks must enter the gather together.
            flag = torch.tensor([int(should)], dtype=torch.int32, device=pd.comm_device())
            should = bool(pd.broadcast_(flag, 0).item())
        if not should:
            return False
        self._write(self.best_directory, step, state, data_state, profile)
        if self._writer:
            info = json.dumps({"step": int(step), "metric": float(metric)}).encode()
            _write_atomic(self._best_json(), lambda f: f.write(info))
            for old in _steps(self.best_directory):
                if old != step:
                    os.remove(os.path.join(self.best_directory, f"{old}.pt"))
        self._barrier()
        return True

    def restore_best(self, device: torch.device | str) -> dict | None:
        """The best snapshot with its tensors on `device`, or None when no
        best was recorded (or none of its files is on disk)."""
        info = self.best_info()
        if info is None:
            return None
        on_disk = _steps(self.best_directory)
        step = int(info["step"])
        if step not in on_disk:
            if not on_disk:
                return None
            print(f"[checkpoint] warning: best.json names step {step}, which is not on disk; "
                  f"restoring the newest best snapshot there, step {on_disk[-1]}", flush=True)
            step = on_disk[-1]
        return _load(os.path.join(self.best_directory, f"{step}.pt"), device)
