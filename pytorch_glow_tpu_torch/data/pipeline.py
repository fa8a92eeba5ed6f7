"""Host data pipeline: index-addressable batch sources, the dataset
dispatch, and the prefetcher that moves batches to the card on a thread of
its own.

Counterpart of `pytorch_glow_tpu/data/pipeline.py`.  Every source is
index-addressable: `batch_at(i)` derives the i-th global batch in O(1) from
(seed, i), per-epoch permutations from `SeedSequence((seed, epoch))`, so the
stream's whole state is one integer and resume is `set_state({"next_index":
k})`.  For the same files and seed, the batches are byte for byte the JAX
package's with `loader="native"` (its indexed path).  Batches are uint8 NHWC
numpy on the host; `DevicePrefetch` hands them to the consumer as torch
tensors on the device.

Sources (`make_dataset`, in the JAX package's order): the synthetic
families (data/synthetic.py), TFRecord shards (data/tfrecord.py),
downsampled-ImageNet npz shards, the CIFAR-10 python pickles, CelebA
folders (data/celeba.py), any image folder (data/folder.py), then uniform
synthetic data with a printed line when the dataset is not on disk.

Grain is not used: `loader="auto"` and `"native"` give the indexed order,
and `"grain"` only insists that the dataset is on disk.  With
`DataConfig.grain_workers > 0` the train stream's batches are built in
worker processes (data/workers.py), in the same order.  With `shard=(i,
n)` (a mesh's data coordinate and size, `parallel/mesh.Mesh.shard`) each
source builds only row block i of n of every global batch, so ranks that
share a data coordinate (model peers) read the same rows.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from pytorch_glow_tpu_torch.config import DataConfig, GlowConfig, TrainConfig
from pytorch_glow_tpu_torch.utils import spans

Batch = dict[str, np.ndarray]

# Seed-stream tag so the train and test draws never collide.
TEST_SEED_OFFSET = 0x7E57


# ---------------------------------------------------------------------------
# Checkpointable indexed iterator
# ---------------------------------------------------------------------------


class IndexedBatches:
    """Iterator over an O(1) index-addressable batch function.

    `batch_at(i)` returns the i-th batch, or None at the end of a finite
    split.  The state is the single integer `next_index`."""

    def __init__(self, batch_at: Callable[[int], Batch | None], start: int = 0):
        self._batch_at = batch_at
        self._i = start

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        b = self._batch_at(self._i)
        if b is None:
            raise StopIteration
        self._i += 1
        return b

    def get_state(self) -> dict:
        return {"next_index": self._i}

    def set_state(self, state: dict) -> None:
        self._i = int(state["next_index"])


def _process_rows(global_batch: int, pidx: int, pcount: int) -> tuple[int, int]:
    """Row range [lo, hi) of the global batch owned by data shard `pidx`."""
    if global_batch % pcount:
        raise ValueError(f"batch {global_batch} does not split over {pcount} data shards")
    per = global_batch // pcount
    return pidx * per, (pidx + 1) * per


# ---------------------------------------------------------------------------
# CIFAR-10 (python pickle format)
# ---------------------------------------------------------------------------


def _find_cifar_dir(root: str) -> str | None:
    for c in (root, os.path.join(root, "cifar-10-batches-py")):
        if c and os.path.isfile(os.path.join(c, "data_batch_1")):
            return c
    return None


def load_cifar10(root: str, split: str = "train") -> tuple[np.ndarray, np.ndarray] | None:
    """-> (images uint8 (N,32,32,3), labels int64 (N,)) or None if absent.
    The pickles are CIFAR-10's own files, read as the JAX package reads
    them; point `root` only at files of that set."""
    d = _find_cifar_dir(root)
    if d is None:
        return None
    files = [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
    imgs, labels = [], []
    for f in files:
        with open(os.path.join(d, f), "rb") as fh:
            entry = pickle.load(fh, encoding="bytes")
        imgs.append(entry[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.append(np.asarray(entry[b"labels"]))
    return np.concatenate(imgs).astype(np.uint8), np.concatenate(labels)


def epoch_permutation(seed: int, epoch: int, n: int, shuffle: bool) -> np.ndarray:
    """The global example order of one epoch, derived from (seed, epoch)."""
    if not shuffle:
        return np.arange(n)
    return np.random.default_rng(np.random.SeedSequence((seed, epoch))).permutation(n)


def array_batches(images: np.ndarray, labels: np.ndarray | None, batch_size: int,
                  seed: int = 0, shuffle: bool = True, drop_remainder: bool = True,
                  repeat: bool = True, shard: tuple[int, int] = (0, 1)) -> IndexedBatches:
    """Epoch-shuffled batches over in-memory arrays; infinite if `repeat`;
    row block `shard` of each full batch."""
    n = images.shape[0]
    end = n - (n % batch_size) if drop_remainder else n
    bpe = -(-end // batch_size)  # batches per epoch
    pidx, pcount = shard
    lo, hi = _process_rows(batch_size, pidx, pcount)

    def batch_at(i: int) -> Batch | None:
        epoch, k = divmod(i, bpe)
        if not repeat and epoch >= 1:
            return None
        order = epoch_permutation(seed, epoch, n, shuffle)
        idx = order[k * batch_size: min((k + 1) * batch_size, end)]
        if pcount > 1 and len(idx) == batch_size:
            idx = idx[lo:hi]  # this process's rows of the global batch
        b: Batch = {"image": images[idx]}
        if labels is not None:
            b["label"] = labels[idx]
        return b

    return IndexedBatches(batch_at)


# ---------------------------------------------------------------------------
# Downsampled ImageNet (npz shards: train_data_batch_*.npz / val_data*.npz)
# ---------------------------------------------------------------------------


def load_imagenet_npz(root: str, size: int,
                      split: str = "train") -> tuple[np.ndarray, np.ndarray] | None:
    """'data' (N, size*size*3) CHW-flattened uint8 and 1-based 'labels'."""
    import glob as globlib

    pattern = "train_data_batch_*.npz" if split == "train" else "val_data*.npz"
    files = sorted(globlib.glob(os.path.join(root, pattern)))
    if not files:
        return None
    imgs, labels = [], []
    for f in files:
        d = np.load(f)
        imgs.append(d["data"].reshape(-1, 3, size, size).transpose(0, 2, 3, 1).astype(np.uint8))
        labels.append(np.asarray(d["labels"]) - 1)
    return np.concatenate(imgs), np.concatenate(labels)


# ---------------------------------------------------------------------------
# Dataset dispatch
# ---------------------------------------------------------------------------


def _on_disk(data_cfg: DataConfig, glow_cfg: GlowConfig, train_cfg: TrainConfig,
             split: str, shard: tuple[int, int]):
    """The indexed stream of a dataset on disk, or None."""
    from pytorch_glow_tpu_torch.data import tfrecord

    bs = train_cfg.batch_size
    it = tfrecord.tfds_batches(data_cfg, glow_cfg, train_cfg, split, shard)
    if it is not None:
        return it
    if data_cfg.name == "imagenet64":
        loaded = load_imagenet_npz(data_cfg.root, data_cfg.image_size, split)
        if loaded is not None:
            # The test split cycles deterministically (the trainer's eval
            # takes a few batches at each boundary).
            return array_batches(*loaded, bs, seed=train_cfg.seed, shuffle=split == "train",
                                 shard=shard)
    if data_cfg.name == "cifar10":
        loaded = load_cifar10(data_cfg.root, split)
        if loaded is not None:
            return array_batches(*loaded, bs, seed=train_cfg.seed, shuffle=split == "train",
                                 shard=shard)
    if data_cfg.name in ("celeba", "celebahq"):
        from pytorch_glow_tpu_torch.data.celeba import celeba_batches

        it = celeba_batches(data_cfg, glow_cfg, train_cfg, split, shard)
        if it is not None:
            return it
    if data_cfg.name == "image_folder":
        from pytorch_glow_tpu_torch.data.folder import image_folder_batches

        return image_folder_batches(data_cfg, glow_cfg, train_cfg, split, shard)
    return None


def make_dataset(data_cfg: DataConfig, glow_cfg: GlowConfig, train_cfg: TrainConfig,
                 split: str = "train", shard: tuple[int, int] = (0, 1)) -> Any:
    """The host batch stream of a profile: an iterator of {"image": uint8
    (B,H,W,C), ...} numpy batches with `get_state()` / `set_state()`.

    Synthetic names first; then the loader choice (`"grain"` raises when
    the dataset is not on disk); then the on-disk sources; else uniform
    synthetic data with a printed line.  With `grain_workers > 0` the train
    split's batches come from that many worker processes
    (data/workers.py), in the same order.  `shard` = (i, n): row block i of
    n of every batch (the whole batch by default)."""
    from pytorch_glow_tpu_torch.data.synthetic import SYNTHETIC_NAMES, synthetic_batches

    bs = train_cfg.batch_size
    seed = train_cfg.seed + (TEST_SEED_OFFSET if split != "train" else 0)
    y_classes = glow_cfg.y_classes if glow_cfg.y_condition else None
    if data_cfg.loader not in ("auto", "native", "grain"):
        raise ValueError(f"unknown loader {data_cfg.loader!r} (auto | native | grain)")
    if data_cfg.grain_workers > 0 and split == "train":
        from pytorch_glow_tpu_torch.data.workers import WorkerBatches

        inline = dataclasses.replace(data_cfg, grain_workers=0)
        make_dataset(inline, glow_cfg, train_cfg, split, shard)  # a missing source raises here
        return WorkerBatches(inline, glow_cfg, train_cfg, split, data_cfg.grain_workers, shard)
    if data_cfg.name in SYNTHETIC_NAMES:
        # The test split draws a different stream of the same family.
        return synthetic_batches(bs, glow_cfg.image_shape, y_classes, seed=seed,
                                 kind=SYNTHETIC_NAMES[data_cfg.name], shard=shard)
    it = _on_disk(data_cfg, glow_cfg, train_cfg, split, shard)
    if it is not None:
        return it
    if data_cfg.loader == "grain":
        raise RuntimeError(f"loader='grain' requested but no grain source for "
                           f"'{data_cfg.name}' under root='{data_cfg.root}'")
    print(f"[data] dataset '{data_cfg.name}' not found under root="
          f"'{data_cfg.root}'; using synthetic data")
    return synthetic_batches(bs, glow_cfg.image_shape, y_classes, seed=seed, shard=shard)


# ---------------------------------------------------------------------------
# Device prefetch
# ---------------------------------------------------------------------------


class _Slot:
    """One pinned host staging buffer per batch key, and the event of the
    last host-to-device copy out of it."""

    def __init__(self):
        self.pinned: dict[str, torch.Tensor] = {}
        self.copied: torch.cuda.Event | None = None

    def stage(self, key: str, arr: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(arr))
        buf = self.pinned.get(key)
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = self.pinned[key] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        return buf


class DevicePrefetch:
    """A background thread builds host batches and moves them to `device`,
    `size` batches ahead of the consumer.

    On a CUDA device the thread copies each batch into one of `size + 1`
    pinned staging slots (a slot is refilled only after its last copy's
    event has completed), issues the host-to-device copy with
    `non_blocking=True` on a stream of its own and records an event; the
    consumer's stream waits on that event, and each tensor is marked with
    `record_stream` on the consumer's stream so the caching allocator does
    not hand its memory out while the consumer's kernels may still read it.
    On the CPU it is a plain thread queue of `torch.from_numpy` tensors.

    `next()` records a `data.wait` span (`utils/spans.py`) from the queue's
    get through the consumer stream's wait, marked `starved` when the queue
    was empty on entry.

    `get_state()` is the state of the stream as consumed: each batch's
    inner state is captured when it is built and surfaced when it is
    returned.  A worker error re-raises in the consumer with its own type.
    `close()` stops the thread and drops the batches in flight; it is
    idempotent, and a later `next()` starts a new thread from the consumed
    position."""

    def __init__(self, it, device: torch.device | str = "cuda", size: int = 2):
        if size < 1:
            raise ValueError(f"prefetch size must be at least 1, got {size}")
        self._inner = it
        self._device = torch.device(device)
        self._size = size
        self._queue: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        self._lingering: threading.Thread | None = None  # outlived close()'s timeout
        self._stop = threading.Event()
        self._consumed = None  # the inner state after the last consumed batch
        self._stream = None
        self._slots: list[_Slot] = []

    # -- checkpoint state -----------------------------------------------------

    def get_state(self):
        """State of the stream as consumed: restoring it yields exactly the
        batches `next` has not returned yet."""
        if self._consumed is not None:
            return self._consumed
        return self._inner.get_state() if hasattr(self._inner, "get_state") else None

    def set_state(self, state) -> None:
        if self._thread is not None:
            raise RuntimeError("set_state must precede iteration (or follow close())")
        if state is None:
            return
        if not hasattr(self._inner, "set_state"):
            raise ValueError("inner iterator is not checkpointable")
        self._inner.set_state(state)
        self._consumed = None

    # -- the producer -----------------------------------------------------------

    def _to_device(self, batch: Batch, n: int):
        if self._device.type != "cuda":
            return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, None
        slot = self._slots[n % len(self._slots)]
        if slot.copied is not None:
            slot.copied.synchronize()  # the last copy out of this slot is done
        with torch.cuda.stream(self._stream):
            out = {k: slot.stage(k, v).to(self._device, non_blocking=True)
                   for k, v in batch.items()}
            slot.copied = torch.cuda.Event()
            slot.copied.record(self._stream)
        return out, slot.copied

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _work(self):
        stateful = hasattr(self._inner, "get_state")
        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            for n, batch in enumerate(self._inner):
                if self._stop.is_set():
                    return
                dev, event = self._to_device(batch, n)
                state = self._inner.get_state() if stateful else None
                if not self._put((dev, event, state)):
                    return
            self._put(StopIteration())
        except BaseException as e:  # re-raised in the consumer
            self._put(e)

    def _start(self):
        if self._lingering is not None:
            self._lingering.join()
            self._lingering = None
        if self._consumed is not None:
            self._inner.set_state(self._consumed)  # back to the consumed position
        elif hasattr(self._inner, "get_state"):
            self._consumed = self._inner.get_state()
        if self._device.type == "cuda" and self._stream is None:
            if self._device.index is None:  # the caller's current card
                self._device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self._device)
            self._slots = [_Slot() for _ in range(self._size + 1)]
        self._stop.clear()
        self._queue = queue.Queue(maxsize=self._size)
        self._thread = threading.Thread(target=self._work, daemon=True, name="glow-prefetch")
        self._thread.start()

    # -- the consumer -------------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        if self._thread is None:
            self._start()
        with spans.span("data.wait"):
            spans.annotate(starved=self._queue.empty())
            item = self._queue.get()
            if isinstance(item, BaseException):
                self._queue.put(item)  # every later next() raises it too
                raise item
            batch, event, state = item
            if event is not None:
                consumer = torch.cuda.current_stream(self._device)
                consumer.wait_event(event)
                for t in batch.values():
                    t.record_stream(consumer)
        if state is not None:
            self._consumed = state
        return batch

    def close(self, timeout: float | None = None) -> None:
        """Stop the thread, waiting up to `timeout` seconds (no limit by
        default) for the batch it is building; drop the batches in flight,
        and close the inner stream where it has a `close`.  Safe to call
        more than once."""
        thread, self._thread = self._thread, None
        if thread is not None:
            self._stop.set()
            deadline = None if timeout is None else time.monotonic() + timeout
            while thread.is_alive() and (deadline is None or time.monotonic() < deadline):
                try:  # unblock a producer waiting on a full queue
                    while True:
                        self._queue.get_nowait()
                except queue.Empty:
                    pass
                thread.join(0.05)
            if thread.is_alive():
                self._lingering = thread
        if hasattr(self._inner, "close"):
            self._inner.close()
