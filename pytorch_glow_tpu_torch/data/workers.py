"""Worker-process batch building: the counterpart of the JAX package's
Grain worker decode (`DataConfig.grain_workers > 0`).

`WorkerBatches` runs a `torch.utils.data.DataLoader(batch_size=None,
num_workers=grain_workers)` over `_IndexedSource`, whose item `i` is the
indexed stream's batch `i`: each spawned worker rebuilds the profile's
stream (`pipeline.make_dataset` with no workers) and seeks it.  So the
batches, and their order, are those of the in-process path, and the
state is `{"next_index": k}` as consumed.  The order is the JAX package's
indexed path's, not Grain's `IndexSampler`'s, so a JAX snapshot's
`{"grain": ...}` data state does not restore here (`train/builder.build`
replays instead).
"""

from __future__ import annotations

import sys

from pytorch_glow_tpu_torch.config import DataConfig, GlowConfig, TrainConfig


def _keep(item):
    """The DataLoader's collate: the batch as the source built it (numpy)."""
    return item


class _IndexedSource:
    """Map-style dataset: item `i` is batch `i` of the profile's indexed
    stream, built lazily in each worker from the (picklable) configs."""

    def __init__(self, data_cfg: DataConfig, glow_cfg: GlowConfig, train_cfg: TrainConfig,
                 split: str, shard: tuple[int, int]):
        self._cfgs = (data_cfg, glow_cfg, train_cfg, split, shard)
        self._it = None

    def __getitem__(self, i: int):
        if self._it is None:
            from pytorch_glow_tpu_torch.data.pipeline import make_dataset

            self._it = make_dataset(*self._cfgs)
        self._it.set_state({"next_index": int(i)})
        return next(self._it, None)


class WorkerBatches:
    """The indexed stream's batches from `workers` spawned processes, in
    order.  `close()` stops the workers; the next `next()` starts them
    again from the consumed position."""

    def __init__(self, data_cfg: DataConfig, glow_cfg: GlowConfig, train_cfg: TrainConfig,
                 split: str, workers: int, shard: tuple[int, int] = (0, 1)):
        if workers < 1:
            raise ValueError(f"workers must be at least 1, got {workers}")
        self._source = _IndexedSource(data_cfg, glow_cfg, train_cfg, split, shard)
        self._workers = workers
        self._next = 0
        self._it = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._it is None:
            from torch.utils.data import DataLoader

            loader = DataLoader(self._source, batch_size=None, collate_fn=_keep,
                                sampler=range(self._next, sys.maxsize),
                                num_workers=self._workers, multiprocessing_context="spawn")
            self._it = iter(loader)
        batch = next(self._it)
        if batch is None:  # the end of a finite split
            self.close()
            raise StopIteration
        self._next += 1
        return batch

    def get_state(self) -> dict:
        return {"next_index": self._next}

    def set_state(self, state: dict) -> None:
        self.close()
        self._next = int(state["next_index"])

    def close(self) -> None:
        it, self._it = self._it, None
        if it is not None:
            it._shutdown_workers()

    def __del__(self):
        self.close()
