"""The benchmark's frozen counts against the port's own: a forward's
operations per image (pinned at 481.47 and 33.05 GFLOP) and the least
time of each chain call at every level of both configurations."""

import json
from pathlib import Path

import pytest

from flowbench import counts
from pytorch_glow_tpu_torch.ops import flowstep
from pytorch_glow_tpu_torch.utils.summary import forward_flops_per_image

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ["celebahq256", "celeba64"]
GFLOP = {"celebahq256": 481.47, "celeba64": 33.05}


def glow(name: str) -> dict:
    return json.loads((ROOT / "flowbench" / "configs" / f"{name}.json").read_text())["glow"]


def port_cfg(name: str):
    from flowbench.program import configs
    return configs(json.loads((ROOT / "flowbench" / "configs" / f"{name}.json").read_text()))[0]


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_flops_pinned_and_equal_to_the_port(name):
    ours = counts.forward_flops_per_image(glow(name))
    assert ours == forward_flops_per_image(port_cfg(name))
    assert round(ours / 1e9, 2) == GFLOP[name]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("kind", ["forward", "reverse", "backward"])
@pytest.mark.parametrize("batch", [64, 256, 512, 4096])
def test_bound_equal_to_the_port_at_every_level(name, kind, batch):
    g = glow(name)
    affine = g["flow_coupling"] == "affine"
    assert counts.latent_shapes(g) == port_cfg(name).latent_shapes()
    for h, w, c in counts.latent_shapes(g):
        args = (kind, batch, h, w, c, g["hidden_channels"], affine)
        assert counts.bound_ms(*args) == flowstep.bound_ms(*args)


def test_peaks_equal_to_the_port():
    assert (counts.PEAK_BF16, counts.PEAK_F32, counts.PEAK_BYTES) == (
        flowstep.PEAK_BF16, flowstep.PEAK_F32, flowstep.PEAK_BYTES)
