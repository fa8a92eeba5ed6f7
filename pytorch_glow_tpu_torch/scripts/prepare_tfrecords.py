"""Write a folder or pickle dataset as tfds-style TFRecord shards, once, so
that training reads them through the TFRecord path (indexed access, no
walk of a large directory per run).

    python -m pytorch_glow_tpu_torch.scripts.prepare_tfrecords celeba /data/celeba \
        /data/celeba_tfr --shards 16 --image-size 64   # pre-resized: far smaller reads
    python -m pytorch_glow_tpu_torch.scripts.prepare_tfrecords image_folder /data/lsun /data/lsun_tfr
    python -m pytorch_glow_tpu_torch.scripts.prepare_tfrecords cifar10 /data/cifar10 /data/cifar_tfr

Counterpart of the repository's `scripts/prepare_tfrecords.py`, over the
port's writer (`data/tfrecord.write_tfds_shards`: its own Example encoder
and masked CRC32C framing, no TensorFlow) and the port's loaders; it
writes the same bytes.  Features per record:

  image        the original encoded file bytes, or a PNG re-encoded with
               Pillow when --image-size is given (short-side resize and
               centre crop, the training-time convention); always PNG for
               cifar10
  label        int64 class index (image_folder class subdirectories, cifar10)
  attributes   CelebA's 40 +-1 attributes (the delta workflow reads them back)

Point the profile's `data.root` at the output directory, with `--name` the
profile's `data.name`.
"""

from __future__ import annotations

import argparse
import io

import numpy as np


def _resized_png(path: str, size: int) -> bytes:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    if (w, h) != (size, size):
        scale = size / min(w, h)
        img = img.resize(
            (max(size, round(w * scale)), max(size, round(h * scale))),
            Image.BILINEAR,
        )
        w, h = img.size
        left, top = (w - size) // 2, (h - size) // 2
        img = img.crop((left, top, left + size, top + size))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _array_png(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _image_bytes(path: str, image_size: int | None) -> bytes:
    if image_size:
        return _resized_png(path, image_size)
    with open(path, "rb") as f:
        return f.read()


def _examples(kind: str, src: str, split: str, image_size: int | None):
    if kind == "cifar10":
        from pytorch_glow_tpu_torch.data.pipeline import load_cifar10

        loaded = load_cifar10(src, split)
        if loaded is None:
            raise SystemExit(f"no CIFAR-10 pickles under {src}")
        images, labels = loaded
        for i in range(images.shape[0]):
            ex = {"image": _array_png(images[i])}
            if labels is not None:
                ex["label"] = int(labels[i])
            yield ex
        return
    if kind == "celeba":
        from pytorch_glow_tpu_torch.data.celeba import CelebAFolder

        folder = CelebAFolder(src, image_size or 64, split)
        for i in range(len(folder)):
            ex = {"image": _image_bytes(folder.path(i), image_size)}
            if folder.attrs is not None:
                ex["attributes"] = np.asarray(
                    folder.attrs[folder.files[i]], np.int64
                )
            yield ex
        return
    if kind == "image_folder":
        from pytorch_glow_tpu_torch.data.folder import ImageFolder

        folder = ImageFolder(src, image_size or 64, split)
        for i in range(len(folder)):
            ex = {"image": _image_bytes(folder.path(i), image_size)}
            if folder.labels is not None:
                ex["label"] = int(folder.labels[i])
            yield ex
        return
    raise SystemExit(f"unknown dataset kind '{kind}'")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=["celeba", "image_folder", "cifar10"])
    p.add_argument("src", help="source dataset root")
    p.add_argument("out", help="output directory for the shards")
    p.add_argument("--name", default=None,
                   help="dataset name in the shard filenames (default: kind; "
                        "use the profile's data.name so discovery matches)")
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--splits", default="train,test")
    p.add_argument("--image-size", type=int, default=0,
                   help="pre-resize + center-crop and re-encode as PNG "
                        "(0 = copy the original encoded bytes)")
    args = p.parse_args(argv)

    from pytorch_glow_tpu_torch.data import tfrecord

    name = args.name or args.kind
    counts = {}
    for split in args.splits.split(","):
        split = split.strip()
        n = 0

        def counted():
            nonlocal n
            for ex in _examples(args.kind, args.src, split, args.image_size):
                n += 1
                if n % 5000 == 0:
                    print(f"[prepare] {split}: {n} records...", flush=True)
                yield ex

        paths = tfrecord.write_tfds_shards(
            args.out, name, split, counted(), num_shards=args.shards
        )
        counts[split] = n
        print(f"[prepare] {split}: {n} records -> {len(paths)} shard(s) "
              f"under {args.out}", flush=True)
    print({"name": name, "out": args.out, "counts": counts})
    return counts


if __name__ == "__main__":
    main()
