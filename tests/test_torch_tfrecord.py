"""The port's TFRecord reader, CRC32C and writer against the JAX
package's: shards the port writes read back in JAX and the reverse, and the
tfds-layout batch streams byte for byte (two epochs and after `set_state`
mid-epoch), with and without a resize; the port's `prepare_tfrecords` CLI
writes the JAX script's bytes, and the port reads its shards back."""

import importlib.util
import io
import os

import numpy as np
import pytest
from PIL import Image

from pytorch_glow_tpu.data import tfrecord as jtfr
from pytorch_glow_tpu_torch.data import tfrecord as ttfr
from test_torch_data import _streams, assert_streams_equal, write_celeba, write_image_folder

N_TRAIN, N_TEST = 24, 8


def _png(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _examples(n, seed, h, w, attrs=False):
    rng = np.random.default_rng(seed)
    for k in range(n):
        ex = {"image": _png(rng.integers(0, 256, (h, w, 3), np.uint8)), "label": k % 10,
              "id": f"ex{k}".encode()}
        if attrs:
            ex["attributes"] = rng.choice([-1, 1], 40).tolist()
        yield ex


@pytest.fixture(scope="module", params=["port", "jax"])
def tfds_root(request, tmp_path_factory):
    """cifar10-<split>.tfrecord-0000N-of-0000N shards of 10x12 PNGs with
    labels and 40 ±1 attributes, written by either package's writer."""
    writer = ttfr if request.param == "port" else jtfr
    root = tmp_path_factory.mktemp(f"tfds_{request.param}")
    writer.write_tfds_shards(str(root), "cifar10", "train",
                             _examples(N_TRAIN, 0, 10, 12, attrs=True), num_shards=2)
    writer.write_tfds_shards(str(root), "cifar10", "test",
                             _examples(N_TEST, 1, 10, 12, attrs=True), num_shards=1)
    return str(root)


@pytest.mark.parametrize("split,size", [("train", 8), ("train", 10), ("test", 8)])
def test_tfds_batches_equal_jax(tfds_root, split, size):
    """Each package reads the other's shards as it reads its own: the same
    records, decoded and (where 10x12 differs from size^2) resized by
    Pillow, in the same order."""
    assert_streams_equal("cifar10", tfds_root, size, 4, split,
                         count=2 * ((N_TRAIN if split == "train" else N_TEST) // 4))
    port, _ = _streams("cifar10", tfds_root, size, 4, split)
    b = next(port)
    assert b["image"].shape == (4, size, size, 3)
    assert b["label"].dtype == np.int64 and b["attr"].shape == (4, 40)


def test_records_and_parse_equal_jax(tfds_root):
    paths = ttfr.find_tfds_shards(tfds_root, "cifar10", "train")
    assert paths == jtfr.find_tfds_shards(tfds_root, "cifar10", "train") and len(paths) == 2
    for p in paths:
        index = ttfr.index_tfrecord(p)
        assert index == jtfr.index_tfrecord(p)
        with open(p, "rb") as f:
            for off, ln in index:
                payload = ttfr.read_record(f, off, ln)
                assert ttfr.parse_example(payload) == jtfr.parse_example(payload)
    shards = ttfr._ShardSet(paths)
    assert len(shards) == N_TRAIN
    assert shards.read(N_TRAIN - 1) == jtfr._ShardSet(paths).read(N_TRAIN - 1)


@pytest.mark.parametrize("data", [b"", b"a", b"123456789", bytes(range(256)) * 3])
def test_crc32c_and_encoding_equal_jax(data):
    assert ttfr._crc32c(data) == jtfr._crc32c(data)
    assert ttfr._masked_crc(data) == jtfr._masked_crc(data)
    ex = {"image": data or b"x", "label": [3, -1, 2 ** 40], "score": [0.5, -2.25], "n": 7}
    assert ttfr.encode_example(ex) == jtfr.encode_example(ex)
    back = ttfr.parse_example(ttfr.encode_example(ex))
    assert back == {"image": [data or b"x"], "label": [3, -1, 2 ** 40], "score": [0.5, -2.25],
                    "n": [7]}


def test_write_tfrecord_is_byte_equal(tmp_path):
    payloads = [ttfr.encode_example(ex) for ex in _examples(5, 3, 4, 4)]
    assert ttfr.write_tfrecord(str(tmp_path / "port.tfrecord"), payloads) == 5
    jtfr.write_tfrecord(str(tmp_path / "jax.tfrecord"), payloads)
    assert (tmp_path / "port.tfrecord").read_bytes() == (tmp_path / "jax.tfrecord").read_bytes()


def test_decode_names_pillow_when_missing(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="needs Pillow"):
        ttfr._decode_image([_png(np.zeros((4, 4, 3), np.uint8))], 4)


def test_too_few_records_raises_as_jax(tfds_root):
    from pytorch_glow_tpu_torch.config import DataConfig, GlowConfig, TrainConfig

    with pytest.raises(ValueError, match="records < batch_size"):
        ttfr.tfds_batches(DataConfig(name="cifar10", root=tfds_root, image_size=8),
                          GlowConfig(image_shape=(8, 8, 3)), TrainConfig(batch_size=64), "train")


def _jax_prepare():
    """The repository's scripts/prepare_tfrecords.py, loaded by path."""
    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "prepare_tfrecords.py")
    spec = importlib.util.spec_from_file_location("jax_prepare_tfrecords", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kind,size", [("celeba", 8), ("celeba", 0), ("image_folder", 8)])
def test_prepare_tfrecords_cli_writes_the_jax_script_bytes(tmp_path, kind, size):
    from pytorch_glow_tpu_torch.config import DataConfig, GlowConfig, TrainConfig
    from pytorch_glow_tpu_torch.scripts import prepare_tfrecords

    src = (write_celeba(tmp_path / "src", ".png", True) if kind == "celeba"
           else write_image_folder(tmp_path / "src"))
    argv = [kind, src, None, "--name", "celeba", "--shards", "2", "--image-size", str(size)]
    counts = prepare_tfrecords.main([a if a else str(tmp_path / "port") for a in argv])
    assert counts == _jax_prepare().main([a if a else str(tmp_path / "jax") for a in argv])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 4
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    if size:
        batches = ttfr.tfds_batches(DataConfig(name="celeba", root=str(tmp_path / "port"),
                                               image_size=size),
                                    GlowConfig(image_shape=(size, size, 3)),
                                    TrainConfig(batch_size=4), "train")
        batch = next(batches)
        assert batch["image"].shape == (4, size, size, 3)
        assert ("attr" in batch) == (kind == "celeba")
