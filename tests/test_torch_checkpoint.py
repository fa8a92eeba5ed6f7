"""Snapshots (`utils/checkpoint.py`) and resume through `build` / `train` on
the CPU: the round-trip, the rolling window, a bitwise resume (as the JAX
package's `test_resume_is_bitwise_deterministic`), no save after a failure,
and an unknown `restore` refused."""

import dataclasses
import os

import pytest
import torch

from pytorch_glow_tpu_torch import DataConfig, GlowConfig, Profile, TrainConfig, build, train
from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager


def _profile(out_dir, **train_kw):
    glow = GlowConfig(image_shape=(8, 8, 3), hidden_channels=16, K=2, L=2,
                      compute_dtype="bfloat16", flowstep_impl="pallas")
    kw = dict(batch_size=4, scalar_log_gap=2, plot_gap=0, checkpoint_gap=2, ema_decay=0.99,
              keep_checkpoints=3)
    kw.update(train_kw)
    return Profile(name="ck", glow=glow, train=TrainConfig(**kw),
                   data=DataConfig(name="synthetic_textured"), out_dir=str(out_dir))


def _ckpt_dir(out_dir):
    return os.path.join(str(out_dir), "ck", "checkpoints")


def _assert_states_equal(a: dict, b: dict) -> None:
    assert a["step"] == b["step"]
    sb = b["model"].state_dict()
    for name, value in a["model"].state_dict().items():
        assert torch.equal(value, sb[name]), name
    assert sorted(a["opt_state"]) == sorted(b["opt_state"])
    for name, value in a["opt_state"].items():
        assert torch.equal(value, b["opt_state"][name]), name
    assert len(a["ema"]) == len(b["ema"])
    assert all(torch.equal(x, y) for x, y in zip(a["ema"], b["ema"]))


def test_save_and_restore_round_trip(tmp_path):
    built = build(_profile(tmp_path), device="cpu")
    train(built, num_steps=2, quiet=True)
    snap = CheckpointManager(_ckpt_dir(tmp_path)).restore("cpu")
    assert snap["step"] == 2 and snap["seed"] == 0
    assert snap["data_state"] == {"next_index": 3}  # DDI's batch, then two steps
    assert snap["profile"]["glow"]["K"] == 2 and snap["profile"]["name"] == "ck"
    restored = build(_profile(tmp_path), device="cpu")
    assert restored.resumed and restored.start_step == 2
    _assert_states_equal(built.state, restored.state)
    assert restored.data.get_state() == {"next_index": 3}


def test_only_keep_checkpoints_remain(tmp_path):
    built = build(_profile(tmp_path, checkpoint_gap=1, keep_checkpoints=2), device="cpu")
    train(built, num_steps=5, quiet=True)
    ckpt = CheckpointManager(_ckpt_dir(tmp_path))
    assert ckpt.steps() == [4, 5] and ckpt.latest_step() == 5
    assert sorted(os.listdir(_ckpt_dir(tmp_path))) == ["4.pt", "5.pt"]


@pytest.mark.parametrize("spc", [1, 2])
def test_resume_is_bitwise(tmp_path, spc):
    """4 steps straight against 2 steps, a rebuild that restores, 2 more."""
    straight = build(_profile(tmp_path / "a", steps_per_call=spc), device="cpu")
    train(straight, num_steps=4, quiet=True)
    first = build(_profile(tmp_path / "b", steps_per_call=spc), device="cpu")
    train(first, num_steps=2, quiet=True)
    resumed = build(_profile(tmp_path / "b", steps_per_call=spc), device="cpu")
    assert resumed.resumed and resumed.start_step == 2
    train(resumed, num_steps=4, quiet=True)
    _assert_states_equal(straight.state, resumed.state)


def test_no_save_after_a_failure(tmp_path):
    built = build(_profile(tmp_path, checkpoint_gap=2), device="cpu")
    built = dataclasses.replace(built, profile=built.profile.replace(
        train=dataclasses.replace(built.profile.train, plot_gap=4)))

    def failing_sample(*args):
        raise RuntimeError("sample failed")

    built.sample_fn = failing_sample
    with pytest.raises(RuntimeError, match="sample failed"):
        train(built, num_steps=6, quiet=True)
    # The rolling snapshots up to the failing boundary, which saves before
    # it fails, and no final one.
    assert CheckpointManager(_ckpt_dir(tmp_path)).steps() == [2, 4]
    assert built.state["step"] == 4


def test_unknown_restore_raises(tmp_path):
    with pytest.raises(ValueError, match="restore"):
        build(_profile(tmp_path), device="cpu", restore="newest")
    assert not os.path.exists(_ckpt_dir(tmp_path))
