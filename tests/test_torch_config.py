"""The port's config is the JAX package's, field for field, and importing the
port pulls in no JAX."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from pytorch_glow_tpu import config as jax_config
from pytorch_glow_tpu_torch import config as torch_config

REPO = Path(__file__).resolve().parents[1]


def _as_dict(obj):
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("name", sorted(jax_config.PRESETS))
def test_presets_equal_field_for_field(name):
    assert sorted(torch_config.PRESETS) == sorted(jax_config.PRESETS)
    assert _as_dict(torch_config.PRESETS[name]) == _as_dict(jax_config.PRESETS[name])


@pytest.mark.parametrize("cls", ["GlowConfig", "OptimConfig", "TrainConfig",
                                 "DataConfig", "MeshConfig", "Profile"])
def test_dataclass_fields_and_defaults_match(cls):
    ours = [(f.name, f.default) for f in dataclasses.fields(getattr(torch_config, cls))]
    theirs = [(f.name, f.default) for f in dataclasses.fields(getattr(jax_config, cls))]
    assert ours == theirs


def test_latent_shapes_match():
    for name, prof in jax_config.PRESETS.items():
        assert torch_config.PRESETS[name].glow.latent_shapes() == prof.glow.latent_shapes()


def test_import_pulls_in_no_jax():
    code = (
        "import sys, pytorch_glow_tpu_torch, pytorch_glow_tpu_torch.utils.convert\n"
        "import pytorch_glow_tpu_torch.ops.flowstep\n"
        "import pytorch_glow_tpu_torch.train.builder, pytorch_glow_tpu_torch.cli.infer\n"
        "from pytorch_glow_tpu_torch.data import (celeba, folder, native_loader, pipeline,\n"
        "    synth_attrs, synthetic, tfrecord, workers)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'pytorch_glow_tpu.'))"
        " or m == 'pytorch_glow_tpu']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
