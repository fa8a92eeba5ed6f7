"""The port's profile loader (`utils/profiles.py`) gives what the JAX
package's gives: the repository's profiles, the presets, `--set` overrides
and the reference lineage's format."""

import dataclasses
import glob
import json
import os

import pytest

from pytorch_glow_tpu.utils import profiles as jprof
from pytorch_glow_tpu_torch import PRESETS
from pytorch_glow_tpu_torch.utils import profiles as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILES = sorted(glob.glob(os.path.join(REPO, "profiles", "*.json")))

LINEAGE = {
    "Glow": {"image_shape": [3, 32, 32], "hidden_channels": 256, "K": 16, "L": 3,
             "flow_permutation": "invconv", "LU_decomposed": False, "learn_top": True},
    "Criterion": {"y_condition": "multi-classes", "other": 1},
    "Data": {"dataset": "cifar10", "dataset_root": "/data/cifar10"},
    "Optim": {"name": "adamax", "args": {"lr": 2e-4, "betas": [0.9, 0.99], "amsgrad": False},
              "Schedule": {"name": "noam_learning_rate_decay", "args": {"warmup_steps": 400}}},
    "Train": {"batch_size": 32, "num_batches": 1000, "max_grad_clip": None,
              "max_checkpoints": 5, "checkpoint_gap": 100},
    "Device": {"glow": ["cuda:0"]},
    "Dir": {"log_root": "results/lineage", "other": "x"},
}


def _as_dict(p):
    return dataclasses.asdict(p)


def test_every_profile_loads_as_in_jax():
    assert PROFILES
    for path in PROFILES:
        assert _as_dict(tprof.load_profile(path)) == _as_dict(jprof.load_profile(path)), path


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_survives_dict_round_trip(name, tmp_path):
    p = PRESETS[name]
    assert tprof.profile_from_dict(tprof.profile_to_dict(p)) == p
    path = str(tmp_path / "p.json")
    tprof.save_profile(path, p)
    assert tprof.load_profile(path) == p
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(jprof.profile_to_dict(p), default=list))


def test_preset_with_overrides_and_set():
    d = {"preset": "cifar10", "train": {"batch_size": 128}, "glow": {"image_shape": [16, 16, 3]}}
    ours, theirs = tprof.profile_from_dict(d), jprof.profile_from_dict(d)
    assert _as_dict(ours) == _as_dict(theirs)
    assert ours.glow.image_shape == (16, 16, 3) and ours.train.batch_size == 128
    sets = ["glow.K=4", "optim.lr=2e-4", "glow.image_shape=[64,64,3]", "data.name=image_folder",
            "out_dir=results/run2", "glow.invconv_impl=pallas", "glow.remat=true"]
    ours = tprof.apply_overrides(ours, sets)
    theirs = jprof.apply_overrides(theirs, sets)
    assert _as_dict(ours) == _as_dict(theirs)
    assert ours.glow.K == 4 and ours.glow.invconv_impl == "pallas" and ours.glow.remat is True
    assert ours.out_dir == "results/run2" and ours.glow.image_shape == (64, 64, 3)


@pytest.mark.parametrize("bad", ["glow.KK=4", "nosuch.key=1", "nosuch=1", "glow.K"])
def test_typo_raises(bad):
    with pytest.raises(KeyError):
        tprof.apply_overrides(PRESETS["cifar10"], [bad])
    with pytest.raises(KeyError):
        tprof.profile_from_dict({"glow": {"KK": 4}})
    with pytest.raises(KeyError):
        tprof.profile_from_dict({"globe": {}})


def test_lineage_profile_converts_as_in_jax(tmp_path, capsys):
    assert tprof.is_lineage_profile(LINEAGE) and not tprof.is_lineage_profile({"glow": {}})
    ours = tprof.convert_lineage_profile(LINEAGE, name="lin")
    assert "no equivalent for" in capsys.readouterr().out
    assert ours == jprof.convert_lineage_profile(LINEAGE, name="lin")
    path = tmp_path / "lineage.json"
    path.write_text(json.dumps(LINEAGE))
    got = tprof.load_profile(str(path))
    assert _as_dict(got) == _as_dict(jprof.load_profile(str(path)))
    assert got.name == "lineage" and got.glow.image_shape == (32, 32, 3)
    assert got.glow.lu_decomposed is False and got.train.keep_checkpoints == 5
