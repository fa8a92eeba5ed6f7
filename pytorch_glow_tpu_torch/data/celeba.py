"""CelebA (and CelebA-HQ) image-folder dataset with 40 binary attributes.

A copy of `pytorch_glow_tpu/data/celeba.py`: an image directory and
`list_attr_celeba.txt` give uint8 NHWC batches with "attr" (B, 40) in ±1;
`list_eval_partition.txt` picks the split when present, else a last-5%
holdout.  The JAX package's quirks are kept for parity: without a
partition file the train split is `files[: -len(files) // 20]`, which can
drop one image more than the test split takes.  Batching and decode are
data/folder.py's.
"""

from __future__ import annotations

import os

import numpy as np

from pytorch_glow_tpu_torch.config import DataConfig, GlowConfig, TrainConfig

ATTR_FILE = "list_attr_celeba.txt"
PARTITION_FILE = "list_eval_partition.txt"


def parse_attr_file(path: str) -> tuple[list[str], dict[str, np.ndarray], list[str]]:
    """-> (filenames, {filename: (40,) int8 +-1}, attribute_names)."""
    with open(path) as f:
        lines = f.read().splitlines()
    # Format: count line, header line of attr names, then rows.
    attr_names = lines[1].split()
    files, attrs = [], {}
    for line in lines[2:]:
        parts = line.split()
        if not parts:
            continue
        fname = parts[0]
        vec = np.asarray([int(v) for v in parts[1:]], dtype=np.int8)
        files.append(fname)
        attrs[fname] = vec
    return files, attrs, attr_names


def _load_image(path: str, size: int) -> np.ndarray:
    from pytorch_glow_tpu_torch.data.folder import load_image

    return load_image(path, size)


def parse_partition_file(path: str) -> dict[str, int]:
    """Standard CelebA split file: filename -> 0 (train) / 1 (val) / 2 (test)."""
    out: dict[str, int] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                out[parts[0]] = int(parts[1])
    return out


class CelebAFolder:
    """Indexable dataset: images dir (+ optional attr file) on disk.

    `split` uses the official list_eval_partition.txt when present; without
    it, a deterministic last-5%-by-filename holdout serves as the test set
    so eval never sees training images.
    """

    meta_key = "attr"

    def __init__(self, root: str, image_size: int, split: str = "train"):
        self.image_size = image_size
        img_dir = None
        for cand in (os.path.join(root, "img_align_celeba"), root):
            if os.path.isdir(cand):
                entries = [
                    e
                    for e in sorted(os.listdir(cand))
                    if e.lower().endswith((".jpg", ".jpeg", ".png"))
                ]
                if entries:
                    img_dir = cand
                    self.files = entries
                    break
        if img_dir is None:
            raise FileNotFoundError(f"no images under {root}")
        self.img_dir = img_dir
        attr_path_candidates = [
            os.path.join(root, ATTR_FILE),
            os.path.join(os.path.dirname(root.rstrip("/")), ATTR_FILE),
        ]
        self.attrs = None
        self.attr_names: list[str] = []
        for p in attr_path_candidates:
            if os.path.isfile(p):
                _, self.attrs, self.attr_names = parse_attr_file(p)
                break
        # Split discipline: official partition file, else last-5% holdout.
        part_candidates = [
            os.path.join(root, PARTITION_FILE),
            os.path.join(os.path.dirname(root.rstrip("/")), PARTITION_FILE),
        ]
        partition = None
        for p in part_candidates:
            if os.path.isfile(p):
                partition = parse_partition_file(p)
                break
        if partition is not None:
            want = {0} if split == "train" else {2}
            picked = [f for f in self.files if partition.get(f, 0) in want]
            if picked:  # partition file may not cover synthetic test trees
                self.files = picked
        elif split != "train":
            self.files = self.files[-max(1, len(self.files) // 20) :]
        elif len(self.files) >= 20:
            self.files = self.files[: -len(self.files) // 20]

    def __len__(self) -> int:
        return len(self.files)

    def path(self, i: int) -> str:
        return os.path.join(self.img_dir, self.files[i])

    def get(self, i: int) -> tuple[np.ndarray, np.ndarray | None]:
        fname = self.files[i]
        img = _load_image(os.path.join(self.img_dir, fname), self.image_size)
        attr = self.attrs.get(fname) if self.attrs is not None else None
        return img, attr

    def meta_cols(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        if self.attrs is None:
            return {}
        return {"attr": np.stack([self.attrs[self.files[j]] for j in idx])}


def celeba_batches(
    data_cfg: DataConfig,
    glow_cfg: GlowConfig,
    train_cfg: TrainConfig,
    split: str = "train",
    shard: tuple[int, int] = (0, 1),
):
    """Shuffled uint8 batches (data/folder.py's engine), infinite, cycling
    unshuffled for the test split; O(1)-resumable; row block `shard` of
    each batch.  None if the dataset is not on disk."""
    from pytorch_glow_tpu_torch.data.folder import folder_batches

    try:
        ds = CelebAFolder(data_cfg.root, data_cfg.image_size, split)
    except (FileNotFoundError, NotADirectoryError):
        return None
    return folder_batches(ds, data_cfg, train_cfg, split, ds.meta_cols, shard)
