"""The port's train and infer CLIs (`cli/train.py`, `cli/infer.py`) on the
CPU, in-process on a tiny profile made with `--set`, and its PNG writer
against Pillow."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from pytorch_glow_tpu_torch.cli import infer as infer_cli
from pytorch_glow_tpu_torch.cli import train as train_cli
from pytorch_glow_tpu_torch.ops import invconv_fused as icf
from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager
from pytorch_glow_tpu_torch.utils.image import make_grid, save_image_grid

TINY = ["--set", "glow.image_shape=[8,8,3]", "--set", "glow.hidden_channels=16",
        "--set", "glow.K=2", "--set", "glow.L=2", "--set", "train.batch_size=4",
        "--set", "train.steps_per_call=1", "--set", "train.eval_gap=0",
        "--set", "train.swd_gap=0", "--set", "train.step_timeout_s=0",
        "--set", "train.checkpoint_gap=1", "--set", "glow.flowstep_impl=xla",
        "--set", "glow.invconv_impl=pallas"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny cifar10-shaped run: 2 steps, then a second call to 3 that
    resumes from the step-2 snapshot."""
    out = str(tmp_path_factory.mktemp("cli"))
    args = ["cifar10", "--cpu", "--synthetic", "textured", "--out-dir", out, "--quiet", *TINY]
    first = train_cli.main([*args, "--steps", "2"])
    second = train_cli.main([*args, "--steps", "3"])
    return out, first, second


def _infer(out, *argv):
    return infer_cli.main([*argv, "cifar10", "--cpu", "--out-dir", out, *TINY])


def test_train_writes_snapshots_and_resumes(trained, capsys):
    out, first, second = trained
    assert first["final_step"] == 2 and second["final_step"] == 3
    assert first["checkpoint_saved"] and np.isfinite(second["loss"])
    assert CheckpointManager(f"{out}/cifar10/checkpoints").steps() == [1, 2, 3]
    train_cli.main(["cifar10", "--cpu", "--synthetic", "textured", "--out-dir", out, "--quiet",
                    *TINY, "--steps", "3"])
    assert "[train] resumed from step 3" in capsys.readouterr().out


def test_infer_sample_recon_nll(trained, tmp_path, capsys):
    out = trained[0]
    _infer(out, "sample", "-n", "4", "-o", str(tmp_path / "s.png"))
    assert Image.open(tmp_path / "s.png").size == (2 * 10 + 2, 2 * 10 + 2)
    _infer(out, "recon", "--synthetic", "textured", "-n", "3", "-o", str(tmp_path / "r.png"))
    assert np.asarray(Image.open(tmp_path / "r.png")).shape == (3 * 10 + 2, 2 * 10 + 2, 3)
    _infer(out, "nll", "--synthetic", "textured", "--batches", "2", "--ema")
    text = capsys.readouterr()
    assert "max |x - rec|" in text.out and "over 8 images" in text.out
    nll = float(text.out.split("nll: ")[1].split()[0])
    assert 0 < nll < 16
    assert "warning" not in text.err


def test_exact_warns_and_takes_no_kernel_path(tmp_path, monkeypatch, capsys):
    """--exact forces the f32 unfused path and invconv_impl=xla: the LU
    1x1 conv never reaches the kernel wrappers (their plain version on the
    CPU), where the profile's invconv_impl=pallas does.  No snapshot is
    needed for the routing: fresh parameters, with a warning."""
    calls = []
    real = icf.invconv_lu_forward
    monkeypatch.setattr(icf, "invconv_lu_forward", lambda *a: calls.append(1) or real(*a))
    out = str(tmp_path)
    _infer(out, "nll", "--synthetic", "textured", "--batches", "1")
    assert len(calls) == 4  # K * L steps, one batch
    calls.clear()
    _infer(out, "nll", "--synthetic", "textured", "--batches", "1", "--exact",
           "--set", "glow.compute_dtype=bfloat16")
    err = capsys.readouterr().err
    assert calls == [] and "no checkpoint found" in err
    assert "--exact overrides your --set 'glow.invconv_impl=pallas'" in err
    assert "glow.compute_dtype=float32" in err


def test_errors_exit_non_zero(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        _infer(str(tmp_path), "sample", "--best")
    assert "no checkpoint found" in str(e.value.code)
    # A best.json whose snapshot is gone, and no rolling snapshot: nothing
    # to load either.
    best = tmp_path / "run" / "cifar10" / "checkpoints-best" / "best.json"
    best.parent.mkdir(parents=True)
    best.write_text('{"step": 4, "metric": 3.0}')
    with pytest.raises(SystemExit) as e:
        _infer(str(tmp_path / "run"), "sample", "--best")
    assert "no checkpoint found" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        train_cli.main(["no-such-profile", "--cpu"])
    assert "neither a file nor a preset" in str(e.value.code)
    # nll --dequant-samples reports the discrete-NLL bound, which gaussian
    # dequantization cannot give.
    capsys.readouterr()
    _infer(str(tmp_path), "nll", "--synthetic", "textured", "--batches", "1",
           "--dequant-samples", "2")
    assert "over 4 images (elbo bound, 2 noise draws)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="only a valid discrete-NLL bound"):
        _infer(str(tmp_path), "nll", "--synthetic", "textured", "--batches", "1",
               "--dequant-samples", "2", "--set", "glow.dequant=gaussian")


@pytest.mark.parametrize("op,argv,message", [
    ("manipulate", ["--synthetic", "attr"], "--delta <file.npz> required"),
    ("delta", ["--synthetic", "textured"], "delta requires a dataset with attributes"),
    ("serve", [], "holds no manifest.json"),
    ("export", ["--batch-size", "0"], "--batch-size must be a positive int or 'dynamic'"),
    ("report", ["--best", "--synthetic", "attr"], "no checkpoint found"),
    ("interpolate", ["--best", "--synthetic", "attr"], "no checkpoint found"),
])
def test_new_subcommands_error_paths(tmp_path, op, argv, message):
    """Each subcommand the JAX CLI has beyond sample / recon / nll exits
    with its own error on a wrong call."""
    with pytest.raises(SystemExit) as e:
        if op == "serve":
            infer_cli.main(["serve", str(tmp_path), "--cpu"])
        else:
            _infer(str(tmp_path), op, *argv)
    assert message in str(e.value.code)
    if op == "export":
        with pytest.raises(SystemExit, match="exports for the device it runs on"):
            _infer(str(tmp_path), "export", "--platforms", "tpu")


@pytest.fixture
def one_thread():
    """One intra-op thread: these tiny ops spend more on waking threads
    than on their work (a 4x6x4x4 conv: 0.12 ms on one, 2.5-10 ms on 8)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_new_subcommands_run(trained, tmp_path, capsys, one_thread):
    """delta, manipulate, interpolate and report on the trained snapshot
    (synthetic attribute data), then export (fresh parameters, K=1) and
    serve an artifact."""
    out = trained[0]
    delta = str(tmp_path / "d.npz")
    _infer(out, "delta", "--synthetic", "attr", "--batches", "2", "-o", delta)
    assert np.load(delta, allow_pickle=True)["delta"].shape == (3, 2, 2, 24)
    _infer(out, "manipulate", "--synthetic", "attr", "--delta", delta, "--attr", "1",
           "--strength", "1.5", "-n", "3", "-o", str(tmp_path / "m.png"))
    assert np.asarray(Image.open(tmp_path / "m.png")).shape == (3 * 10 + 2, 2 * 10 + 2, 3)
    _infer(out, "interpolate", "--synthetic", "attr", "--steps", "4", "-o",
           str(tmp_path / "i.png"))
    assert Image.open(tmp_path / "i.png").size == (4 * 10 + 2, 10 + 2)
    rep = tmp_path / "rep"
    _infer(out, "report", "--synthetic", "attr", "--batches", "1", "--swd-images", "4",
           "-n", "4", "-o", str(rep))
    report = json.loads((rep / "report.json").read_text())
    assert report["step"] == 3 and report["manipulate"]["num_attributes"] == 3
    assert set(report["manipulate"]["detector_dscore"]) == {"bright", "red_tint",
                                                             "center_disk"}
    assert set(report["bits_dim"]) == {"noise_free_corner", "elbo_1draw", "iwae_8draw",
                                       "eval_images"}
    assert report["swd_x1e3"]["images_per_set"] == 4
    assert len(list(rep.glob("*.png"))) == 4 + 2 + 3  # ladder, recon, interp, 3 attributes
    art = str(tmp_path / "art")
    infer_cli.main(["export", "cifar10", "--cpu", "--out-dir", str(tmp_path / "fresh"), *TINY,
                    "--set", "glow.K=1", "--batch-size", "3", "-o", art])
    capsys.readouterr()
    infer_cli.main(["serve", art, "-n", "3", "-o", str(tmp_path / "s.png")])
    assert "3 samples @ T=0.7 from artifact" in capsys.readouterr().out
    assert Image.open(tmp_path / "s.png").size == (2 * 10 + 2, 2 * 10 + 2)


@pytest.mark.parametrize("shape", [(5, 7, 9, 3), (4, 6, 6, 1), (2, 3, 4, 4)])
def test_png_decodes_to_the_grid(tmp_path, shape):
    images = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "g.png"
    save_image_grid(str(path), images, ncol=3 if shape[0] > 3 else None)
    grid = make_grid(images, 3 if shape[0] > 3 else None)
    got = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got.reshape(grid.shape), grid)
