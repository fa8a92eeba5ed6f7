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
prints a warning.

Saves are asynchronous, as the JAX package's orbax saves are.  `save` and
`maybe_save_best` return once the snapshot is captured (`_capture`): its
tensors copied on the calling thread, on the current stream, into one
pinned host buffer a dtype (allocated at a manager's first save into a
directory, then reused; a synchronous copy for CPU tensors), its
`data_state` and `profile` deep-copied.  Stream order puts the copy before
the next step's in-place updates; a CUDA event recorded after it is what
the writer thread waits on before `torch.save`, so the loop never waits
for the copy.  The write, the move into place and the prune run in that
thread, one write in flight per directory: a save that arrives while its
directory's previous write runs waits for it first, as orbax does.
`save(..., wait=True)` returns after the file is in place.  The writer
shares the GIL with the launch thread, so it does little in Python: the
snapshot's tensors view a few storages, not one each; `torch.save` to a
path writes each storage from C++ with the GIL released; and the pickled
bytes of the tensor entries, the same at every save into a directory, are
made once and reused (`_pickle_module`).  A loaded snapshot's tensors get
storages of their own again (`_load`).
The thread is not a daemon, so an interpreter that exits finishes the
write; a process that is re-exec'd or killed abandons it, and its
temporary file never replaces a snapshot (`_NAME` ignores it).

The best save keeps the JAX manager's bookkeeping: until its `best.json`
lands, the metric of the write in flight (`_best_pending`) stands in for
it in `best_info`; the writer moves `best.json` only to a lower metric (an
out-of-order commit leaves it); a failed best write rolls its marker back
and is logged and kept on `last_best_error` when the manager next joins
(`_join_best`), without stopping the run.  A failed rolling write raises at
the next `save`, `wait`, `close` or restore, as orbax raises in
`wait_until_finished`.  `wait()` and `close()` drain every write, and
`restore` / `restore_best` drain this manager's writes first.

On a mesh (`CheckpointManager(..., mesh)`), every rank takes part in a
save and rank 0 alone writes: the tensors are gathered first
(`parallel/mesh.gather_params`, the optimizer's flat moments by
`gather_flat`), so a snapshot is mesh-independent and restores onto any
mesh, one rank included, as orbax restores onto another sharding.  Each
rank's stream position goes in as "data_states" (by global rank; the
counterpart of the JAX sidecars `step_*.p{i}.json`).  The best-save
decision is rank 0's, broadcast to all.  The gathers and the broadcast stay
collective calls on every rank's calling thread; only rank 0's write goes
to its thread, which issues no collective.  `wait()`, `save(...,
wait=True)` and a restore after a save end on a barrier, so no rank
restores a half-written file.
"""

from __future__ import annotations

import copy
import io
import json
import os
import pickle
import re
import sys
import tempfile
import threading
import types
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
    """`write(tmp)` to a temporary file beside `path`, then move it there."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _save_file(snapshot: dict, path: str, staging: dict) -> None:
    """`torch.save` of a captured snapshot, its tensor entries pickled
    once a staging layout (`_pickle_module`)."""
    if "pickle_module" not in staging:
        staging["pickle_module"] = _pickle_module(staging)
    torch.save(snapshot, path, pickle_module=staging["pickle_module"])


def _pickle_module(staging: dict):
    """The pickle module `torch.save` runs on a snapshot captured into
    `staging`: a file `torch.load` reads as any other, written with little
    Python work on the writer thread, which shares the GIL with the launch
    thread.

    Pickling the snapshot's thousands of tensors is nearly all of
    `torch.save`'s Python work.  Their entries ("model", "opt_state",
    "ema") pickle to the same bytes at every save into `staging`: the same
    views of the same buffers.  So each top-level entry is pickled on its
    own, without a memo (`fast`), which makes the pieces independent; the
    tensor entries' pieces are kept in `staging` and reused.  torch's own
    `persistent_id` numbers the storages in the order it meets them, so the
    buffers are registered first, in a fixed order, at every save."""
    storages = [torch.storage.TypedStorage(wrap_storage=flat.untyped_storage(), dtype=flat.dtype,
                                           _internal=True)
                for flat in staging["flats"].values()]
    pieces: dict[str, bytes] = {}

    class Pickler(pickle.Pickler):
        def __init__(self, file, *args, **kwargs):
            super().__init__(file, *args, **kwargs)
            self._file = file

        def _piece(self, value) -> bytes:
            buf = io.BytesIO()
            inner = pickle.Pickler(buf, protocol=2)
            inner.persistent_id = self.persistent_id
            inner.fast = True
            inner.dump(value)
            return buf.getvalue()[2:-1]  # without PROTO 2 and STOP

        def dump(self, obj):
            for storage in storages:
                self.persistent_id(storage)
            parts = [b"\x80\x02}("]  # PROTO 2, EMPTY_DICT, MARK
            for key, value in obj.items():
                piece = pieces.get(key)
                if piece is None:
                    piece = self._piece(value)
                    if _tensors(value):
                        pieces[key] = piece
                parts += [self._piece(key), piece]
            parts.append(b"u.")  # SETITEMS, STOP
            self._file.write(b"".join(parts))

    return types.SimpleNamespace(__name__="snapshot_pickle", Pickler=Pickler)


def _write_bytes(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _leaves(value, path: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """(path, tensor) of the tensors in a nest of dicts, lists and tuples,
    in order."""
    if isinstance(value, torch.Tensor):
        return [(path, value.detach())]
    if isinstance(value, dict):
        return [leaf for k, v in value.items() for leaf in _leaves(v, (*path, k))]
    if isinstance(value, (list, tuple)):
        return [leaf for i, v in enumerate(value) for leaf in _leaves(v, (*path, i))]
    return []


def _tensors(value) -> list[torch.Tensor]:
    return [t for _, t in _leaves(value)]


def _replace(value, tensors):
    """`value` with its tensors taken, in order, from the iterator
    `tensors`, and everything else deep-copied."""
    if isinstance(value, torch.Tensor):
        return next(tensors)
    if isinstance(value, dict):
        return {k: _replace(v, tensors) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_replace(v, tensors) for v in value)
    return copy.deepcopy(value)


def _load(path: str, device: torch.device | str) -> dict:
    """A snapshot with its tensors on `device`, each in a storage of its own
    (a written snapshot's tensors view one storage a dtype)."""
    snapshot = torch.load(path, map_location=device, weights_only=True)
    return _replace(snapshot, (t if t.untyped_storage().nbytes() == t.numel() * t.element_size()
                               else t.clone() for t in _tensors(snapshot)))


def _read_json(path: str) -> dict | None:
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def _capture(snapshot: dict, staging: dict) -> tuple[dict, torch.cuda.Event | None]:
    """A copy of `snapshot` whose tensors are views into one host buffer a
    dtype, and the event after the copies on the current stream (None when
    no tensor is on the card); everything else deep-copied.

    The buffers (pinned when the tensors are on the card) and their views
    live in `staging`, made at the first capture and reused while the
    tensors' places, dtypes and shapes hold.  On the card each dtype's
    tensors are gathered into one device buffer (`torch.cat`) and copied to
    the host in one transfer.  One storage a dtype keeps `torch.save`'s
    per-storage work on the writer thread, which holds the GIL, to a few
    records."""
    leaves = _leaves(snapshot)
    tensors = [t for _, t in leaves]
    cuda = [t.device for t in tensors if t.is_cuda]
    device = cuda[0] if cuda else torch.device("cpu")
    layout = [(path, t.dtype, t.shape) for path, t in leaves]
    if staging.get("layout") != layout:
        staging.clear()
        sizes: dict[torch.dtype, int] = {}
        for _, dtype, shape in layout:
            sizes[dtype] = sizes.get(dtype, 0) + shape.numel()
        flats = {d: torch.empty(n, dtype=d, pin_memory=bool(cuda)) for d, n in sizes.items()}
        offsets = dict.fromkeys(sizes, 0)
        views = []
        for _, dtype, shape in layout:
            o = offsets[dtype]
            views.append(flats[dtype][o:o + shape.numel()].view(shape))
            offsets[dtype] = o + shape.numel()
        staging.update(layout=layout, flats=flats, views=views)
    for dtype, flat in staging["flats"].items():
        parts = [t.reshape(-1).to(device) for t in tensors if t.dtype == dtype]
        if cuda:
            flat.copy_(torch.cat(parts), non_blocking=True)
        else:
            torch.cat(parts, out=flat)
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return _replace(snapshot, iter(staging["views"])), event


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, mesh: meshlib.Mesh | None = None):
        self.directory = os.path.abspath(directory)
        self.best_directory = self.directory + "-best"
        self._keep = max(1, keep)
        self.mesh = mesh
        # Host buffers of the captured snapshots, by directory.
        self._staging: dict[str, dict] = {}
        # The rolling write in flight and the failure of the last one.
        self._rolling: threading.Thread | None = None
        self._rolling_error: tuple[int, BaseException] | None = None
        # Whether a save started since the last barrier (`wait`).
        self._dirty = False
        # The best save's bookkeeping, as the JAX manager's: the metric of
        # the write in flight, its thread, and the failures that
        # `_join_best` surfaces.
        self._best_pending: dict | None = None
        self._best_threads: list[threading.Thread] = []
        self._best_lock = threading.Lock()
        self._best_errors: list[BaseException] = []
        self.last_best_error: BaseException | None = None

    @property
    def _writer(self) -> bool:
        return self.mesh is None or dist.get_rank() == 0

    @property
    def writing(self) -> bool:
        """Whether a write of this manager is still running."""
        return any(t.is_alive() for t in [self._rolling, *self._best_threads] if t is not None)

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

    def _start(self, directory: str, snapshot: dict, target, *args) -> threading.Thread:
        """Capture `snapshot` into `directory`'s buffers and run
        `target(host_snapshot, event, staging, *args)` in a writer thread."""
        staging = self._staging.setdefault(directory, {})
        host, event = _capture(snapshot, staging)
        thread = threading.Thread(target=target, args=(host, event, staging, *args),
                                  daemon=False, name="glow-snapshot-writer")
        thread.start()
        return thread

    # -- the rolling snapshots -------------------------------------------------

    def _write_rolling(self, snapshot: dict, event, staging: dict, step: int) -> None:
        try:
            if event is not None:
                event.synchronize()
            os.makedirs(self.directory, exist_ok=True)
            _write_atomic(self.path(step), lambda tmp: _save_file(snapshot, tmp, staging))
            for old in self.steps()[:-self._keep]:
                os.remove(self.path(old))
        except BaseException as e:  # raised on the caller's thread at the next join
            self._rolling_error = (step, e)

    def _join_rolling(self) -> BaseException | None:
        """Wait for the rolling write in flight; its failure, if it failed."""
        if self._rolling is not None:
            self._rolling.join()
            self._rolling = None
        failed, self._rolling_error = self._rolling_error, None
        if failed is None:
            return None
        step, e = failed
        error = RuntimeError(f"the background write of snapshot {step} to {self.directory} "
                             f"failed: {type(e).__name__}: {e}")
        error.__cause__ = e
        return error

    def save(self, step: int, state: dict, data_state: dict | None, profile: dict,
             wait: bool = False) -> str:
        """Capture the snapshot of `state` at `step` and write it in the
        background, keeping the newest `keep`; with `wait`, return after the
        file is in place.  Raises the failure of the previous rolling write."""
        error = self._join_rolling()
        if error is not None:
            raise error
        snapshot = self._snapshot(step, state, data_state, profile)
        self._dirty = True
        if self._writer:
            self._rolling = self._start(self.directory, snapshot, self._write_rolling, step)
        if wait:
            error = self._join_rolling()
            self._barrier()
            if error is not None:
                raise error
        return self.path(step)

    def restore(self, device: torch.device | str) -> dict | None:
        """The newest snapshot with its tensors on `device`, or None when
        there is none; this manager's writes drained first."""
        if self._dirty:
            self.wait()
        step = self.latest_step()
        if step is None:
            return None
        return _load(self.path(step), device)

    # -- draining --------------------------------------------------------------

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()

    def wait(self, barrier: bool = True) -> None:
        """Wait for every write in flight, then (on a mesh, unless `barrier`
        is False) for the other ranks.  A failed best write is logged and
        kept on `last_best_error`; a failed rolling write raises."""
        error = self._join_rolling()
        self._join_best()
        if barrier:
            self._barrier()
            self._dirty = False
        if error is not None:
            raise error

    def close(self) -> None:
        """`wait()`, then free the host buffers."""
        try:
            self.wait()
        finally:
            self._staging.clear()

    # -- the best snapshot ----------------------------------------------------

    def _best_json(self) -> str:
        return os.path.join(self.best_directory, "best.json")

    def best_info(self) -> dict | None:
        """{"step": int, "metric": float} of the best snapshot, or None: the
        best save in flight while it beats the one on disk."""
        with self._best_lock:
            disk = _read_json(self._best_json())
            pending = self._best_pending
            if pending is not None and (disk is None or pending["metric"] < disk["metric"]):
                return dict(pending)
            return disk

    def _write_best(self, snapshot: dict, event, staging: dict, info: dict) -> None:
        step = info["step"]
        path = os.path.join(self.best_directory, f"{step}.pt")
        try:
            if event is not None:
                event.synchronize()
            os.makedirs(self.best_directory, exist_ok=True)
            _write_atomic(path, lambda tmp: _save_file(snapshot, tmp, staging))
            with self._best_lock:
                disk = _read_json(self._best_json())
                # Only forward: an out-of-order commit leaves a better best.
                moved = disk is None or info["metric"] < disk["metric"]
                if moved:
                    data = json.dumps(info).encode()
                    _write_atomic(self._best_json(), lambda tmp: _write_bytes(tmp, data))
                if self._best_pending is info:
                    self._best_pending = None
            if moved:
                for old in _steps(self.best_directory):
                    if old != step:
                        os.remove(os.path.join(self.best_directory, f"{old}.pt"))
            elif int(disk["step"]) != step:
                os.remove(path)
        except BaseException as e:  # disk full, ...: roll the marker back
            with self._best_lock:
                if self._best_pending is info:
                    self._best_pending = None
                self._best_errors.append(e)

    def _join_best(self) -> None:
        for thread in self._best_threads:
            thread.join()
        self._best_threads.clear()
        with self._best_lock:
            errors, self._best_errors = self._best_errors, []
        for e in errors:
            print(f"[checkpoint] warning: a background best-snapshot save failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
        if errors:
            self.last_best_error = errors[-1]

    def maybe_save_best(self, step: int, state: dict, metric: float,
                        data_state: dict | None, profile: dict) -> bool:
        """Save `state` as the best snapshot iff `metric` (lower is better,
        e.g. eval bits/dim) improves on the best so far, the save in flight
        included; True when it did.  The write runs in the background."""
        prev = self.best_info()
        should = prev is None or float(metric) < float(prev["metric"])
        if self.mesh is not None:
            # Rank 0's decision: the ranks must enter the gather together.
            flag = torch.tensor([int(should)], dtype=torch.int32, device=pd.comm_device())
            should = bool(pd.broadcast_(flag, 0).item())
        if not should:
            return False
        snapshot = self._snapshot(step, state, data_state, profile)
        self._dirty = True
        if self._writer:
            # One write in flight per directory: its buffers are reused.
            self._join_best()
            info = {"step": int(step), "metric": float(metric)}
            with self._best_lock:
                self._best_pending = info
            self._best_threads.append(
                self._start(self.best_directory, snapshot, self._write_best, info))
        return True

    def restore_best(self, device: torch.device | str) -> dict | None:
        """The best snapshot with its tensors on `device`, or None when no
        best was recorded (or none of its files is on disk); this manager's
        writes drained first."""
        if self._dirty:
            self.wait()
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
