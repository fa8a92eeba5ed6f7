"""Generic on-disk image-folder dataset and the folder batching engine.

A copy of `pytorch_glow_tpu/data/folder.py`: for the same files, seed and
decoder the batches are byte for byte the JAX package's.
`DataConfig(name="image_folder", root=...)` trains on any directory of
JPEG/PNG images, in one of two layouts:

    root/*.jpg|png            -> unlabeled images
    root/<class>/*.jpg|png    -> labeled; sorted subdir order = label index

Without a partition file, the split is a deterministic last-5%-by-filename
holdout (per class when labeled).

`folder_batches`, shared with data/celeba.py, decodes with the native C++
decoder (data/native_loader.py) when it builds, one batch ahead, else with
a Pillow thread pool; per-epoch global shuffle, O(1) index-state resume,
and one data shard's rows of each batch (`shard`).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np

from pytorch_glow_tpu_torch.config import DataConfig, GlowConfig, TrainConfig

_EXTS = (".jpg", ".jpeg", ".png")


def load_image(path: str, size: int) -> np.ndarray:
    """Center-crop to square + bilinear resize, uint8 HWC (Pillow, for
    hosts where the native decoder is unavailable).  Pillow's BILINEAR
    antialiases when it downscales; the native decoder does not."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding images without the native decoder needs Pillow") from e

    img = Image.open(path).convert("RGB")
    w, h = img.size
    s = min(w, h)
    img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
    img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def holdout_split(files: list[str], split: str) -> list[str]:
    """Deterministic last-5% holdout (sorted order): test takes the final
    max(1, n//20) files, train the exact complement."""
    k = max(1, len(files) // 20)
    if split != "train":
        return files[-k:]
    return files[:-k] if len(files) > k else files


def _image_entries(d: str) -> list[str]:
    return sorted(
        e for e in os.listdir(d) if e.lower().endswith(_EXTS)
    )


class ImageFolder:
    """Indexable generic image-folder dataset (see module docstring)."""

    meta_key = "label"

    def __init__(self, root: str, image_size: int, split: str = "train"):
        if not os.path.isdir(root):
            raise FileNotFoundError(f"no such directory: {root}")
        self.image_size = image_size
        self.img_dir = root
        files: list[str] = []
        labels: list[int] = []
        class_names = []
        for d in sorted(os.listdir(root)):
            if not os.path.isdir(os.path.join(root, d)):
                continue
            entries = _image_entries(os.path.join(root, d))
            if not entries:
                continue
            ci = len(class_names)
            class_names.append(d)
            for f in holdout_split(entries, split):
                files.append(os.path.join(d, f))
                labels.append(ci)
        self.class_names = class_names
        if files:
            self.files = files
            self.labels: np.ndarray | None = np.asarray(labels, np.int64)
        else:
            flat = _image_entries(root)
            if not flat:
                raise FileNotFoundError(f"no images under {root}")
            self.files = holdout_split(flat, split)
            self.labels = None

    def __len__(self) -> int:
        return len(self.files)

    def path(self, i: int) -> str:
        return os.path.join(self.img_dir, self.files[i])

    def get(self, i: int) -> tuple[np.ndarray, np.int64 | None]:
        img = load_image(self.path(i), self.image_size)
        return img, (None if self.labels is None else self.labels[i])

    def meta_cols(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        if self.labels is None:
            return {}
        return {"label": self.labels[idx]}


def folder_batches(
    ds,
    data_cfg: DataConfig,
    train_cfg: TrainConfig,
    split: str = "train",
    meta_cols: Callable[[np.ndarray], dict] | None = None,
    shard: tuple[int, int] = (0, 1),
):
    """Shuffled uint8 batches over any folder dataset exposing `__len__`,
    `path(i)`, and `image_size`; native C++ decode (double-buffered batch
    lookahead) or thread-pool Pillow; O(1)-resumable; row block `shard` =
    (i, n) of each batch.  `meta_cols(idx) -> dict` appends extra per-row
    columns (CelebA attrs, class labels).  Returns None on an empty epoch.
    """
    from pytorch_glow_tpu_torch.data import native_loader as nl
    from pytorch_glow_tpu_torch.data.pipeline import (
        IndexedBatches,
        _process_rows,
        epoch_permutation,
    )

    use_native = nl.available()
    pool = None if use_native else ThreadPoolExecutor(
        max_workers=max(1, data_cfg.num_workers)
    )
    native_pool = (
        nl.DecodePool(ds.image_size, threads=data_cfg.num_workers)
        if use_native else None
    )
    pending: dict[int, int] = {}  # batch index -> in-flight decode job id
    bs = train_cfg.batch_size
    n = len(ds)
    bpe = n // bs  # full batches per epoch (drop remainder)
    if bpe == 0:
        return None
    shuffle = split == "train"
    pidx, pcount = shard
    lo, hi = _process_rows(bs, pidx, pcount)

    def batch_indices(i: int) -> np.ndarray:
        # Test split cycles deterministically (periodic eval islices a few
        # batches per eval); train shuffles per epoch.
        epoch, k = divmod(i, bpe)
        order = epoch_permutation(train_cfg.seed, epoch, n, shuffle)
        idx = order[k * bs : (k + 1) * bs]
        if pcount > 1:
            idx = idx[lo:hi]  # this process decodes only its rows
        return idx

    def submit(i: int) -> int:
        return native_pool.submit([ds.path(j) for j in batch_indices(i)])

    def batch_at(i: int):
        idx = batch_indices(i)
        if use_native:
            # GIL-free C++ decode; batch i was usually submitted while
            # batch i-1 was being consumed (double-buffered lookahead).
            for stale in [b for b in pending if b != i]:
                native_pool.wait(pending.pop(stale))  # non-sequential access
            job = pending.pop(i, None)
            batch = {"image": native_pool.wait(job if job is not None else submit(i))}
            pending[i + 1] = submit(i + 1)
        else:
            paths = [ds.path(j) for j in idx]
            batch = {
                "image": np.stack(
                    list(pool.map(lambda p: load_image(p, ds.image_size), paths))
                )
            }
        if meta_cols is not None:
            batch.update(meta_cols(idx))
        return batch

    return IndexedBatches(batch_at)


def image_folder_batches(
    data_cfg: DataConfig,
    glow_cfg: GlowConfig,
    train_cfg: TrainConfig,
    split: str = "train",
    shard: tuple[int, int] = (0, 1),
):
    """`pipeline.make_dataset`'s entry for `name="image_folder"`; None when
    the root holds no images."""
    try:
        ds = ImageFolder(data_cfg.root, data_cfg.image_size, split)
    except (FileNotFoundError, NotADirectoryError):
        return None
    return folder_batches(ds, data_cfg, train_cfg, split, ds.meta_cols, shard)
