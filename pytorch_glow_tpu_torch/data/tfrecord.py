"""tfds-layout TFRecord shards: a pure-Python reader, CRC32C and writer,
and the O(1)-resumable batch stream over them.

A copy of `pytorch_glow_tpu/data/tfrecord.py`: the TFRecord framing is a
length-prefixed container and tf.train.Example a three-level protobuf,
parsed here with a small wire-format walker, so nothing needs TensorFlow.
One pass over each shard builds an (offset, length) index; after that
every record is random-access, so batches are index-addressable and the
stream's state is one integer.  Epoch shuffles derive from (seed, epoch)
as in `pipeline.array_batches`.  The writer computes the masked CRC32C
TensorFlow's readers verify; the reader does not check it.  Images decode
with Pillow.
"""

from __future__ import annotations

import glob as globlib
import io
import os
import struct
import threading

import numpy as np

from pytorch_glow_tpu_torch.config import DataConfig, GlowConfig, TrainConfig

# ---------------------------------------------------------------------------
# TFRecord container framing
# ---------------------------------------------------------------------------

_HEADER = struct.Struct("<QI")  # u64 payload length + u32 masked-crc(length)


def index_tfrecord(path: str) -> list[tuple[int, int]]:
    """One streaming pass -> [(payload_offset, payload_length), ...]."""
    out: list[tuple[int, int]] = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos < size:
            header = f.read(_HEADER.size)
            if len(header) < _HEADER.size:
                raise ValueError(f"{path}: truncated record header at {pos}")
            (length, _len_crc) = _HEADER.unpack(header)
            payload_off = pos + _HEADER.size
            out.append((payload_off, length))
            pos = payload_off + length + 4  # + payload crc32c
            f.seek(pos)
    return out


def read_record(f, offset: int, length: int) -> bytes:
    f.seek(offset)
    return f.read(length)


# ---------------------------------------------------------------------------
# Minimal tf.train.Example wire-format parser
# ---------------------------------------------------------------------------
#
# Example       { Features features = 1; }
# Features      { map<string, Feature> feature = 1; }   (repeated MapEntry)
# MapEntry      { string key = 1; Feature value = 2; }
# Feature       { BytesList = 1 | FloatList = 2 | Int64List = 3 }
# BytesList     { repeated bytes value = 1; }
# FloatList     { repeated float value = 1 [packed]; }
# Int64List     { repeated int64 value = 1 [packed]; }


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _walk(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's fields.
    value: int for varint, bytes for length-delimited, bytes for 32/64-bit."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _parse_feature(buf: bytes):
    """Feature message -> list of bytes / floats / ints."""
    for field, wire, val in _walk(buf):
        if field == 1:  # BytesList
            return [v for f2, _, v in _walk(val) if f2 == 1]
        if field == 2:  # FloatList
            floats: list[float] = []
            for f2, w2, v in _walk(val):
                if f2 != 1:
                    continue
                if w2 == 2:  # packed
                    floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
                else:  # unpacked 32-bit
                    floats.append(struct.unpack("<f", v)[0])
            return floats
        if field == 3:  # Int64List
            ints: list[int] = []
            for f2, w2, v in _walk(val):
                if f2 != 1:
                    continue
                if w2 == 2:  # packed varints
                    p = 0
                    while p < len(v):
                        x, p = _read_varint(v, p)
                        ints.append(x - (1 << 64) if x >= 1 << 63 else x)
                else:
                    ints.append(v - (1 << 64) if v >= 1 << 63 else v)
            return ints
    return []


def parse_example(payload: bytes) -> dict[str, list]:
    """Serialized tf.train.Example -> {feature_name: values}."""
    out: dict[str, list] = {}
    for field, _, val in _walk(payload):
        if field != 1:  # Features
            continue
        for f2, _, entry in _walk(val):
            if f2 != 1:  # map entry
                continue
            key = None
            feature: list = []
            for f3, _, v in _walk(entry):
                if f3 == 1:
                    key = v.decode("utf-8")
                elif f3 == 2:
                    feature = _parse_feature(v)
            if key is not None:
                out[key] = feature
    return out


# ---------------------------------------------------------------------------
# TFRecord writing, with the masked CRC32C TensorFlow's readers verify
# ---------------------------------------------------------------------------

_CRC_TABLE: list[int] | None = None


def _crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli).  google_crc32c's C extension when present;
    a table-driven pure-Python fallback otherwise (one-time prep cost)."""
    try:
        import google_crc32c

        return google_crc32c.value(data)
    except ImportError:
        global _CRC_TABLE
        if _CRC_TABLE is None:
            tbl = []
            for i in range(256):
                c = i
                for _ in range(8):
                    c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
                tbl.append(c)
            _CRC_TABLE = tbl
        crc = 0xFFFFFFFF
        for b in data:
            crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord's rotated+offset crc mask."""
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field (wire type 2)."""
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _encode_feature(values) -> bytes:
    """-> serialized Feature message.  bytes -> BytesList, int -> Int64List,
    float -> FloatList (scalars or lists of one kind)."""
    if isinstance(values, np.ndarray):
        values = values.tolist()  # numpy scalars -> python ints/floats
    elif not isinstance(values, (list, tuple)):
        values = [values]
    if not values:
        raise ValueError("empty feature value")
    if isinstance(values[0], bytes):
        return _ld(1, b"".join(_ld(1, v) for v in values))
    if isinstance(values[0], (bool, int)) or hasattr(values[0], "__index__"):
        body = b"".join(
            _varint(8) + _varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in values
        )  # field 1, wire 0 (unpacked varints — all proto parsers accept)
        return _ld(3, body)
    if isinstance(values[0], float) or hasattr(values[0], "__float__"):
        body = b"".join(
            b"\x0d" + struct.pack("<f", float(v)) for v in values
        )  # field 1, wire 5 (unpacked fixed32)
        return _ld(2, body)
    raise TypeError(f"unsupported feature type {type(values[0])}")


def encode_example(features: dict) -> bytes:
    """{name: bytes | int | float | list thereof} -> serialized
    tf.train.Example (inverse of parse_example; round-trip tested)."""
    entries = b"".join(
        _ld(1, _ld(1, k.encode("utf-8")) + _ld(2, _encode_feature(v)))
        for k, v in features.items()
    )
    return _ld(1, entries)


def write_tfrecord(path: str, payloads) -> int:
    """Write serialized records in TFRecord framing (with valid masked
    CRC32C, so TF readers verify clean).  Returns the record count."""
    n = 0
    with open(path, "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))
            n += 1
    return n


def write_tfds_shards(root: str, name: str, split: str, examples,
                      num_shards: int = 1) -> list[str]:
    """Write `examples` (iterable of feature dicts) as tfds-named shards:
    <root>/<name>-<split>.tfrecord-NNNNN-of-NNNNN, round-robin."""
    os.makedirs(root, exist_ok=True)
    paths = [
        os.path.join(
            root, f"{name}-{split}.tfrecord-{s:05d}-of-{num_shards:05d}"
        )
        for s in range(num_shards)
    ]
    files = [open(p, "wb") for p in paths]
    try:
        for i, ex in enumerate(examples):
            payload = encode_example(ex)
            f = files[i % num_shards]
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))
    finally:
        for f in files:
            f.close()
    return paths


# ---------------------------------------------------------------------------
# tfds-layout dataset -> IndexedBatches
# ---------------------------------------------------------------------------


class _ShardSet:
    """Random access over the concatenated records of shard files.

    Thread-safe: reads use `os.pread` (a positioned read on a raw fd), since
    a shared seek+read handle interleaves positions across threads."""

    def __init__(self, paths: list[str]):
        self.paths = sorted(paths)
        self._index: list[tuple[int, int, int]] = []  # (file_i, offset, length)
        for fi, p in enumerate(self.paths):
            self._index.extend((fi, off, ln) for off, ln in index_tfrecord(p))
        self._fds: dict[int, int] = {}
        self._open_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._index)

    def read(self, i: int) -> bytes:
        fi, off, ln = self._index[i]
        fd = self._fds.get(fi)
        if fd is None:
            with self._open_lock:
                fd = self._fds.get(fi)
                if fd is None:
                    fd = self._fds[fi] = os.open(self.paths[fi], os.O_RDONLY)
        return os.pread(fd, ln, off)

    def __getstate__(self):
        # Picklable across worker processes: the (file, offset, length)
        # index travels; fds re-open lazily in the worker.
        d = self.__dict__.copy()
        d["_fds"] = {}
        d["_open_lock"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._open_lock = threading.Lock()

    def __del__(self):
        for fd in getattr(self, "_fds", {}).values():
            try:
                os.close(fd)
            except OSError:
                pass


def find_tfds_shards(root: str, name: str, split: str) -> list[str]:
    """tfds naming: <root>/[**/]<name>-<split>.tfrecord-NNNNN-of-NNNNN.
    Also accepts generic <split>*.tfrecord* for hand-rolled shard dirs."""
    if not root or not os.path.isdir(root):
        return []
    # Fixed-depth globs only (tfds nests <root>/<name>/<version>/shards):
    # a recursive ** walk would scan e.g. a 200k-file CelebA tree on every
    # make_dataset call for nothing.
    for pat in (f"{name}-{split}.tfrecord*", f"{split}*.tfrecord*"):
        for depth in range(3):
            hits = globlib.glob(os.path.join(root, *([ "*" ] * depth), pat))
            if hits:
                return sorted(hits)
    return []


def find_split_shards(data_cfg: DataConfig, split: str) -> list[str]:
    """Shards for a profile split, with the tfds naming quirks folded in
    (cifar10 calls the held-out split "test"; most others "validation")."""
    paths = find_tfds_shards(data_cfg.root, data_cfg.name, split)
    if not paths and split == "test":
        paths = find_tfds_shards(data_cfg.root, data_cfg.name, "validation")
    return paths


def _decode_image(values: list, size: int) -> np.ndarray:
    """tfds "image" feature: encoded PNG/JPEG bytes.  Resized (bilinear,
    short-side then center-crop, matching data/celeba.py) when the on-disk
    resolution differs from the profile's."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding TFRecord images needs Pillow") from e

    img = Image.open(io.BytesIO(values[0]))
    img = img.convert("RGB")
    if img.size != (size, size):
        w, h = img.size
        scale = size / min(w, h)
        img = img.resize((max(size, round(w * scale)), max(size, round(h * scale))),
                         Image.BILINEAR)
        w, h = img.size
        left, top = (w - size) // 2, (h - size) // 2
        img = img.crop((left, top, left + size, top + size))
    return np.asarray(img, dtype=np.uint8)


def tfds_batches(
    data_cfg: DataConfig,
    glow_cfg: GlowConfig,
    train_cfg: TrainConfig,
    split: str = "train",
    shard: tuple[int, int] = (0, 1),
):
    """IndexedBatches over a tfds-prepared TFRecord directory (row block
    `shard` of each batch), or None when
    `data_cfg.root` holds no matching shards.  Train split: epoch-shuffled,
    infinite; test split: deterministic order, also cycling — the trainer's
    periodic eval islices a few batches per eval boundary across the run
    (same contract as array_batches)."""
    from pytorch_glow_tpu_torch.data.pipeline import (
        IndexedBatches, _process_rows, epoch_permutation,
    )

    tfds_split = split
    paths = find_split_shards(data_cfg, split)
    if not paths:
        return None
    shards = _ShardSet(paths)
    n = len(shards)
    bs = train_cfg.batch_size
    if n < bs:
        raise ValueError(
            f"tfds dataset under {data_cfg.root} has {n} records < "
            f"batch_size {bs}"
        )
    size = data_cfg.image_size
    bpe = n // bs  # drop remainder
    shuffle = split == "train"
    seed = train_cfg.seed
    pidx, pcount = shard
    lo, hi = _process_rows(bs, pidx, pcount)

    def batch_at(i: int):
        epoch, k = divmod(i, bpe)
        order = epoch_permutation(seed, epoch, n, shuffle)
        idx = order[k * bs : (k + 1) * bs]
        if pcount > 1:
            idx = idx[lo:hi]
        images, labels, attrs = [], [], []
        has_label = has_attr = True
        for j in idx:
            ex = parse_example(shards.read(int(j)))
            if "image" not in ex:
                raise ValueError(
                    f"record {j} has no 'image' feature (keys: {sorted(ex)})"
                )
            images.append(_decode_image(ex["image"], size))
            if "label" in ex and ex["label"]:
                labels.append(int(ex["label"][0]))
            else:
                has_label = False
            # CelebA-style +-1 attribute vectors ride along as "attr".
            if "attributes" in ex and ex["attributes"]:
                attrs.append(np.asarray(ex["attributes"], np.int64))
            else:
                has_attr = False
        batch = {"image": np.stack(images)}
        if has_label and labels:
            batch["label"] = np.asarray(labels, np.int64)
        if has_attr and attrs:
            batch["attr"] = np.stack(attrs)
        return batch

    print(
        f"[data] tfds TFRecords: {len(paths)} shard(s), {n} records "
        f"({data_cfg.name}/{tfds_split}) under {data_cfg.root}"
    )
    return IndexedBatches(batch_at)
