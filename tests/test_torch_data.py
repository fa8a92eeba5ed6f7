"""The port's data layer against the JAX package's: every source's batches
byte for byte (the JAX side on its indexed path, `loader="native"`, with its
own native decoder or Pillow), over two epochs and after `set_state` mid-
epoch; the prefetcher's consumed-state accounting, error propagation and
close; the worker-process loader; `build`'s resume and its replay
fallback; a tiny trainer run from CIFAR pickles with and without the
prefetcher; `cli.infer nll` on dataset files."""

import dataclasses
import os
import pickle
import time

import numpy as np
import pytest
import torch
from PIL import Image

from pytorch_glow_tpu.config import DataConfig as JDataConfig
from pytorch_glow_tpu.config import GlowConfig as JGlowConfig
from pytorch_glow_tpu.config import TrainConfig as JTrainConfig
from pytorch_glow_tpu.data import native_loader as jnl
from pytorch_glow_tpu.data import pipeline as jpipeline
from pytorch_glow_tpu_torch import DataConfig, GlowConfig, Profile, TrainConfig, build, train
from pytorch_glow_tpu_torch.data import native_loader as tnl
from pytorch_glow_tpu_torch.data import pipeline as tpipeline
from pytorch_glow_tpu_torch.data.workers import WorkerBatches

CIFAR_TRAIN, CIFAR_TEST = 12, 10  # images per data_batch_* file, in test_batch


def write_cifar10(root, seed=0, per_file=CIFAR_TRAIN, test=CIFAR_TEST):
    """CIFAR-10's python-pickle layout: data_batch_1..5 and test_batch with
    b"data" (N, 3072) CHW-flattened uint8 and b"labels"."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for name, n in [*((f"data_batch_{i}", per_file) for i in range(1, 6)), ("test_batch", test)]:
        entry = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                 b"labels": rng.integers(0, 10, n).tolist()}
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(entry, f)
    return str(root)


def write_imagenet(root, size=8, seed=1):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for name, n in (("train_data_batch_1.npz", 14), ("train_data_batch_2.npz", 11),
                    ("val_data.npz", 9)):
        np.savez(os.path.join(root, name),
                 data=rng.integers(0, 256, (n, 3 * size * size), dtype=np.uint8),
                 labels=rng.integers(1, 1001, n))
    return str(root)


def _save_image(path, rng, h, w):
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if path.endswith(".png"):
        Image.fromarray(img).save(path)
    else:
        Image.fromarray(img).save(path, quality=90)


def write_celeba(root, ext, partition, n=30, seed=2):
    """img_align_celeba/ of 20x24 images, list_attr_celeba.txt with 40 ±1
    attributes, and, with `partition`, list_eval_partition.txt (the last
    8 images in the test split)."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "img_align_celeba")
    os.makedirs(img_dir, exist_ok=True)
    names = [f"{i:06d}{ext}" for i in range(1, n + 1)]
    for name in names:
        _save_image(os.path.join(img_dir, name), rng, 24, 20)
    attr_names = [f"attr_{k}" for k in range(40)]
    with open(os.path.join(root, "list_attr_celeba.txt"), "w") as f:
        f.write(f"{n}\n{' '.join(attr_names)}\n")
        for name in names:
            f.write(name + " " + " ".join(str(v) for v in rng.choice([-1, 1], 40)) + "\n")
    if partition:
        with open(os.path.join(root, "list_eval_partition.txt"), "w") as f:
            for i, name in enumerate(names):
                f.write(f"{name} {2 if i >= n - 8 else 0}\n")
    return str(root)


def write_image_folder(root, seed=3):
    """Two class subdirectories, PNG and JPEG, of different sizes."""
    rng = np.random.default_rng(seed)
    for cls, ext, n in (("cat", ".png", 13), ("dog", ".jpg", 11)):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for i in range(n):
            _save_image(os.path.join(root, cls, f"{i:03d}{ext}"), rng, 18 + i % 3, 16)
    return str(root)


def _streams(name, root, size, batch, split, seed=5, loader="native"):
    port = tpipeline.make_dataset(DataConfig(name=name, root=root, image_size=size, loader=loader),
                                  GlowConfig(image_shape=(size, size, 3)),
                                  TrainConfig(batch_size=batch, seed=seed), split=split)
    ref = jpipeline.make_dataset(JDataConfig(name=name, root=root, image_size=size,
                                             loader="native"),
                                 JGlowConfig(image_shape=(size, size, 3)),
                                 JTrainConfig(batch_size=batch, seed=seed), split=split)
    return port, ref


def assert_same_batch(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {k}")


def assert_streams_equal(name, root, size, batch, split="train", count=None, resume_at=None):
    """Two epochs (or `count` batches) byte for byte, then a fresh pair of
    streams set to `resume_at` (mid-epoch) on both sides."""
    port, ref = _streams(name, root, size, batch, split)
    count = count or 2 * (len(_epoch_len(name, root, size, split)) // batch)
    for i in range(count):
        assert_same_batch(next(port), next(ref), f"{name} {split} batch {i}")
    assert port.get_state() == ref.get_state() == {"next_index": count}
    port, ref = _streams(name, root, size, batch, split)
    k = resume_at if resume_at is not None else count // 2 + 1
    port.set_state({"next_index": k})
    ref.set_state({"next_index": k})
    for i in range(3):
        assert_same_batch(next(port), next(ref), f"{name} {split} after set_state({k}) {i}")


def _epoch_len(name, root, size, split):
    """The split's examples, counted as the source counts them."""
    if name == "cifar10":
        return tpipeline.load_cifar10(root, split)[0]
    if name == "imagenet64":
        return tpipeline.load_imagenet_npz(root, size, split)[0]
    if name in ("celeba", "celebahq"):
        from pytorch_glow_tpu_torch.data.celeba import CelebAFolder

        return CelebAFolder(root, size, split).files
    from pytorch_glow_tpu_torch.data.folder import ImageFolder

    return ImageFolder(root, size, split).files


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    return write_cifar10(tmp_path_factory.mktemp("cifar"))


@pytest.fixture
def decoder(request, monkeypatch):
    """"native": both packages' C++ decoders; "pillow": both on Pillow."""
    if request.param == "native":
        if not (tnl.available() and jnl.available()):
            pytest.skip(f"native decoder unavailable: {tnl.build_error() or jnl.build_error()}")
    else:
        monkeypatch.setattr(tnl, "available", lambda: False)
        monkeypatch.setattr(jnl, "available", lambda: False)
    return request.param


# ---------------------------------------------------------------------------
# Every source, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", ["train", "test"])
def test_cifar10_pickles_equal_jax(cifar_dir, split):
    assert_streams_equal("cifar10", cifar_dir, 32, 4, split)
    port, _ = _streams("cifar10", cifar_dir, 32, 4, split)
    b = next(port)
    assert b["image"].shape == (4, 32, 32, 3) and b["label"].dtype == np.int64


def test_imagenet_npz_equal_jax(tmp_path):
    root = write_imagenet(tmp_path)
    for split in ("train", "test"):
        assert_streams_equal("imagenet64", root, 8, 4, split)


@pytest.mark.parametrize("ext,partition,decoder", [
    (".png", True, "native"), (".jpg", False, "native"),
    (".png", False, "pillow"), (".jpg", True, "pillow"),
], indirect=["decoder"])
def test_celeba_folder_equal_jax(tmp_path, ext, partition, decoder):
    root = write_celeba(tmp_path, ext, partition)
    assert_streams_equal("celeba", root, 8, 4, "train")
    if partition:
        assert_streams_equal("celeba", root, 8, 4, "test", count=4, resume_at=1)
    port, _ = _streams("celeba", root, 8, 4, "train")
    b = next(port)
    assert b["attr"].shape == (4, 40) and set(np.unique(b["attr"])) <= {-1, 1}


def test_celeba_train_split_keeps_the_jax_quirk(tmp_path):
    """Without a partition file the train split is files[: -n // 20]: with
    30 files it drops 2 though the test split takes 1."""
    from pytorch_glow_tpu_torch.data.celeba import CelebAFolder

    root = write_celeba(tmp_path, ".png", partition=False)
    assert len(CelebAFolder(root, 8, "train")) == 28
    assert len(CelebAFolder(root, 8, "test")) == 1


@pytest.mark.parametrize("decoder", ["native", "pillow"], indirect=True)
def test_image_folder_with_classes_equal_jax(tmp_path, decoder):
    root = write_image_folder(tmp_path)
    assert_streams_equal("image_folder", root, 8, 4, "train")
    port, _ = _streams("image_folder", root, 8, 4, "train")
    assert set(np.unique(next(port)["label"])) <= {0, 1}


def test_synthetic_attr_equal_jax():
    for split in ("train", "test"):
        port, ref = _streams("synthetic_attr", "", 8, 4, split)
        for i in range(3):
            assert_same_batch(next(port), next(ref), f"synthetic_attr {split} {i}")
    from pytorch_glow_tpu.data import synth_attrs as jattrs
    from pytorch_glow_tpu_torch.data import synth_attrs as tattrs

    images = next(port)["image"]
    np.testing.assert_array_equal(tattrs.measure_attributes(images),
                                  jattrs.measure_attributes(images))


def test_native_decoder_equals_jax_library(tmp_path):
    if not (tnl.available() and jnl.available()):
        pytest.skip(f"native decoder unavailable: {tnl.build_error() or jnl.build_error()}")
    write_image_folder(tmp_path)
    paths = sorted(str(p) for p in tmp_path.rglob("*.*"))
    np.testing.assert_array_equal(tnl.decode_batch(paths, 8), jnl.decode_batch(paths, 8))
    pool = tnl.DecodePool(8, threads=2)
    try:
        jobs = [pool.submit(paths[:5]), pool.submit(paths[5:])]
        got = np.concatenate([pool.wait(j) for j in jobs])
    finally:
        pool.close()
    np.testing.assert_array_equal(got, jnl.decode_batch(paths, 8))
    assert tnl.image_dims(paths[0]) == jnl.image_dims(paths[0])
    so = tnl._lib_path()
    assert so.is_file() and so.parent.parent == tnl._BUILD_DIR


def test_dispatch_order_and_fallback(tmp_path, cifar_dir, capsys):
    """An existing root no longer raises; a missing dataset falls back with
    the JAX line; loader="grain" needs the dataset on disk."""
    port, _ = _streams("cifar10", cifar_dir, 32, 4, "train", loader="auto")
    assert "label" in next(port)
    g = GlowConfig(image_shape=(32, 32, 3))
    t = TrainConfig(batch_size=4)
    tpipeline.make_dataset(DataConfig(name="cifar10", root=str(tmp_path)), g, t)
    assert f"dataset 'cifar10' not found under root='{tmp_path}'" in capsys.readouterr().out
    assert next(tpipeline.make_dataset(DataConfig(name="cifar10", root=cifar_dir,
                                                  loader="grain"), g, t))["image"].shape[0] == 4
    with pytest.raises(RuntimeError, match="loader='grain' requested but no grain source"):
        tpipeline.make_dataset(DataConfig(name="cifar10", root=str(tmp_path), loader="grain"),
                               g, t)


# ---------------------------------------------------------------------------
# The prefetcher
# ---------------------------------------------------------------------------


def _synthetic(seed=11):
    from pytorch_glow_tpu_torch.data.synthetic import synthetic_batches

    return synthetic_batches(2, (4, 4, 3), seed=seed)


def test_prefetch_state_accounts_for_the_queue():
    """The thread runs ahead; get_state is the consumed position, so a
    restore hands back exactly the batches not yet returned."""
    pf = tpipeline.DevicePrefetch(_synthetic(), "cpu", size=4)
    try:
        for _ in range(3):
            next(pf)
        time.sleep(0.3)  # let the thread fill the queue past the consumer
        assert pf._inner.get_state()["next_index"] > 3
        state = pf.get_state()
        assert state == {"next_index": 3}
        want = next(pf)
        pf2 = tpipeline.DevicePrefetch(_synthetic(), "cpu", size=4)
        pf2.set_state(state)
        got = next(pf2)
        pf2.close()
    finally:
        pf.close()
    assert isinstance(got["image"], torch.Tensor) and got["image"].dtype == torch.uint8
    assert torch.equal(got["image"], want["image"])
    ref = _synthetic()
    ref.set_state(state)
    np.testing.assert_array_equal(got["image"].numpy(), next(ref)["image"])


def test_prefetch_close_is_idempotent_and_restarts_at_the_consumed_position():
    pf = tpipeline.DevicePrefetch(_synthetic(), "cpu", size=3)
    firsts = [next(pf)["image"] for _ in range(2)]
    time.sleep(0.2)
    thread = pf._thread
    pf.close()
    pf.close()
    assert not thread.is_alive()
    assert pf.get_state() == {"next_index": 2}
    again = next(pf)["image"]  # a new thread, from the consumed position
    pf.close()
    ref = _synthetic()
    for i, x in enumerate([*firsts, again]):
        np.testing.assert_array_equal(x.numpy(), next(ref)["image"], err_msg=str(i))


def test_prefetch_reraises_worker_errors_with_their_type():
    def bad():
        yield {"image": np.zeros((2, 4, 4, 3), np.uint8)}
        raise ValueError("decode failed on record 7")

    pf = tpipeline.DevicePrefetch(bad(), "cpu", size=2)
    next(pf)
    for _ in range(2):
        with pytest.raises(ValueError, match="decode failed on record 7"):
            next(pf)
    pf.close()
    finite = tpipeline.DevicePrefetch(iter([{"image": np.ones((1, 2, 2, 3), np.uint8)}]), "cpu")
    next(finite)
    with pytest.raises(StopIteration):
        next(finite)
    finite.close()


def test_prefetch_rejects_an_unbounded_queue():
    with pytest.raises(ValueError, match="at least 1"):
        tpipeline.DevicePrefetch(_synthetic(), "cpu", size=0)


@pytest.mark.cuda
def test_prefetch_to_the_card_under_load():
    """Device batches equal their host batches byte for byte while the
    consumer's stream is busy and reallocates memory between batches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the prefetcher on one")
    from pytorch_glow_tpu_torch.data.synthetic import synthetic_batches

    pf = tpipeline.DevicePrefetch(synthetic_batches(64, (32, 32, 3), seed=3, kind="textured"),
                                   "cuda", size=2)
    ref = synthetic_batches(64, (32, 32, 3), seed=3, kind="textured")
    try:
        for i in range(20):
            got = next(pf)["image"]
            torch.cuda._sleep(2_000_000)
            torch.empty(got.numel(), dtype=torch.uint8, device="cuda").fill_(255)
            np.testing.assert_array_equal(got.cpu().numpy(), next(ref)["image"], err_msg=str(i))
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# The worker-process loader
# ---------------------------------------------------------------------------


def test_worker_loader_equals_the_indexed_path_and_resumes(cifar_dir):
    cfgs = (DataConfig(name="cifar10", root=cifar_dir), GlowConfig(image_shape=(32, 32, 3)),
            TrainConfig(batch_size=4, seed=2))
    ref = tpipeline.make_dataset(*cfgs)
    want = [next(ref) for _ in range(20)]  # two epochs and a bit
    workers = tpipeline.make_dataset(dataclasses.replace(cfgs[0], grain_workers=2), *cfgs[1:])
    assert isinstance(workers, WorkerBatches)
    try:
        for i in range(12):
            assert_same_batch(next(workers), want[i], f"worker batch {i}")
        assert workers.get_state() == {"next_index": 12}
        workers.set_state({"next_index": 16})
        for i in range(16, 20):
            assert_same_batch(next(workers), want[i], f"resumed worker batch {i}")
    finally:
        workers.close()
    workers.close()


# ---------------------------------------------------------------------------
# build and train from dataset files
# ---------------------------------------------------------------------------


def _cifar_profile(out, root, **train):
    glow = GlowConfig(image_shape=(32, 32, 3), hidden_channels=8, K=2, L=2,
                      compute_dtype="bfloat16", flowstep_impl="pallas")
    kw = dict(batch_size=4, scalar_log_gap=2, plot_gap=0, checkpoint_gap=2, eval_gap=0,
              swd_gap=0, step_timeout_s=0, ema_decay=0.99)
    kw.update(train)
    return Profile(name="d", glow=glow, train=TrainConfig(**kw),
                   data=DataConfig(name="cifar10", root=root), out_dir=str(out))


class _Direct:
    """The host stream handed to the trainer as tensors on the calling
    thread: the trainer's input without the prefetcher."""

    def __init__(self, host):
        self.host = host

    def __next__(self):
        return {k: torch.from_numpy(v) for k, v in next(self.host).items()}

    def get_state(self):
        return self.host.get_state()

    def close(self):
        pass


def test_trainer_with_and_without_the_prefetcher_is_bitwise_equal(tmp_path, cifar_dir):
    states = []
    for i, direct in enumerate((False, True)):
        p = _cifar_profile(tmp_path / str(i), cifar_dir, steps_per_call=2)
        built = build(p, device="cpu")
        if direct:
            host = tpipeline.make_dataset(p.data, p.glow, p.train)
            host.set_state(built.data.get_state())
            built.data.close()
            built.data = _Direct(host)
        train(built, num_steps=6, quiet=True)
        assert built.data.get_state() == {"next_index": 7}
        if not direct:
            assert built.data._thread is None  # the call closed its prefetcher
        states.append(built.state["model"].state_dict())
    for name, value in states[0].items():
        assert torch.equal(value, states[1][name]), name


def test_watchdog_closes_the_stream_before_it_exits(monkeypatch):
    from pytorch_glow_tpu_torch.train import trainer as ttrainer

    calls = []
    monkeypatch.setenv("GLOW_WEDGE_RESTART_BUDGET", "0")
    monkeypatch.setattr(ttrainer.os, "_exit", lambda code: calls.append(("exit", code)))
    pf = tpipeline.DevicePrefetch(_synthetic(), "cpu", size=2)
    next(pf)
    ttrainer._StepWatchdog(1.0, on_die=lambda: (calls.append("close"),
                                                pf.close(timeout=5.0)))._die()
    assert calls == ["close", ("exit", ttrainer.WEDGE_EXIT_CODE)] and pf._thread is None


def test_build_resumes_the_stream_and_replays_a_foreign_state(tmp_path, cifar_dir, capsys):
    p = _cifar_profile(tmp_path, cifar_dir)
    built = build(p, device="cpu")
    train(built, num_steps=4, quiet=True)
    ref = tpipeline.make_dataset(p.data, p.glow, p.train)
    ref.set_state({"next_index": 5})  # DDI's batch and four steps
    want = next(ref)
    resumed = build(p, device="cpu")
    assert resumed.resumed and resumed.start_step == 4
    assert resumed.data.get_state() == {"next_index": 5}
    np.testing.assert_array_equal(next(resumed.data)["image"].numpy(), want["image"])
    resumed.data.close()
    snap = tmp_path / "d" / "checkpoints" / "4.pt"
    blob = torch.load(snap, weights_only=True)
    blob["data_state"] = {"grain": "opaque"}
    torch.save(blob, snap)
    capsys.readouterr()
    replayed = build(p, device="cpu")
    assert "saved data state incompatible" in capsys.readouterr().out
    assert replayed.data.get_state() == {"next_index": 5}
    np.testing.assert_array_equal(next(replayed.data)["image"].numpy(), want["image"])
    replayed.data.close()


def test_infer_nll_scores_the_dataset_files(tmp_path, cifar_dir, capsys):
    from pytorch_glow_tpu_torch.cli import infer as infer_cli
    from pytorch_glow_tpu_torch.inference import Inferer
    from pytorch_glow_tpu_torch.models.glow import init_glow

    sets = ["--set", "glow.hidden_channels=8", "--set", "glow.K=1", "--set", "glow.L=2",
            "--set", "train.batch_size=4", "--set", "glow.flowstep_impl=xla"]
    infer_cli.main(["nll", "cifar10", "--cpu", "--data-root", cifar_dir, "--batches", "2",
                    "--out-dir", str(tmp_path), *sets])
    out = capsys.readouterr()
    assert "using synthetic data" not in out.out and "over 8 images" in out.out
    nll = float(out.out.split("nll: ")[1].split()[0])
    from pytorch_glow_tpu_torch.config import PRESETS

    prof = PRESETS["cifar10"]
    cfg = dataclasses.replace(prof.glow, hidden_channels=8, K=1, L=2, flowstep_impl="xla")
    inf = Inferer(init_glow(cfg, torch.Generator().manual_seed(prof.train.seed), "cpu"))
    data = tpipeline.make_dataset(DataConfig(name="cifar10", root=cifar_dir), cfg,
                                  dataclasses.replace(prof.train, batch_size=4))
    want = np.mean([float(inf.nll(next(data)["image"]).mean()) for _ in range(2)])
    np.testing.assert_allclose(nll, want, rtol=1e-4)
