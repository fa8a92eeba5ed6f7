"""The port's attribute workflow (`Inferer.compute_attribute_delta`,
`manipulate`, `interpolate`, `interpolate_full`) against the JAX package's
`Inferer` on identical weights and images: the delta over "attr" (+-1) and
over class "label"s within atol 2e-4, `.npz` files either package writes
read by the other, a zero-strength edit bitwise decode(encode(x)), and the
full interpolation's endpoints within one bin of its inputs."""

import jax
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.config import GlowConfig as JaxGlowConfig
from pytorch_glow_tpu.inference import Inferer as JaxInferer
from pytorch_glow_tpu_torch import GlowConfig, Inferer
from test_torch_model import _port
from test_torch_serve import jax_params

SMALL = dict(image_shape=(8, 8, 3), hidden_channels=16, K=2, L=2, y_classes=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny ops spend more on waking threads
    than on their work (a 4x6x4x4 conv: 0.12 ms on one, 2.5-10 ms on 8)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = JaxGlowConfig(**SMALL), GlowConfig(**SMALL)
    params = jax_params(jcfg, seed=3)
    return JaxInferer(params, jcfg), Inferer(_port(params, tcfg))


def _batches(kind: str, n=2, b=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {"image": rng.integers(0, 256, (b, 8, 8, 3), dtype=np.uint8)}
        if kind == "attr":
            batch["attr"] = rng.choice(np.array([-1, 1]), (b, 3))
        else:
            batch["label"] = rng.integers(0, 4, (b,))
        out.append(batch)
    return out


@pytest.mark.parametrize("kind", ["attr", "label"])
def test_attribute_delta_matches_jax(pair, kind):
    jinf, tinf = pair
    batches = _batches(kind)
    want = jinf.compute_attribute_delta(iter(batches), num_batches=2)
    got = tinf.compute_attribute_delta(iter(batches + _batches(kind, seed=1)), num_batches=2)
    assert got.shape == want.shape == (3 if kind == "attr" else 4, 2, 2, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    if kind == "label":
        with pytest.raises(ValueError, match="num_classes"):
            tinf.compute_attribute_delta(iter(batches), num_classes=2)


def test_delta_npz_reads_across_packages(tmp_path):
    delta = np.random.default_rng(4).standard_normal((3, 2, 2, 24)).astype(np.float32)
    Inferer.save_attribute_delta(str(tmp_path / "port.npz"), torch.from_numpy(delta), ["a"])
    np.testing.assert_array_equal(JaxInferer.load_attribute_delta(str(tmp_path / "port.npz")),
                                  delta)
    JaxInferer.save_attribute_delta(str(tmp_path / "jax.npz"), delta, ["a", "b"])
    assert torch.equal(Inferer.load_attribute_delta(str(tmp_path / "jax.npz")),
                       torch.from_numpy(delta))


def test_manipulate_and_interpolate(pair):
    jinf, tinf = pair
    x = _batches("attr")[0]["image"]
    delta = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 2, 2, 24)).astype(
        np.float32))
    assert torch.equal(tinf.manipulate(x, delta, 1, 0.0), tinf.decode(tinf.encode(x)))
    z = tinf.encode(x)
    np.testing.assert_array_equal(
        tinf.apply_attribute_delta(z, delta, 2, 1.5).numpy(),
        np.asarray(jinf.apply_attribute_delta(z.numpy(), delta.numpy(), 2, 1.5)))
    moved = tinf.manipulate(x, delta, 2, 1.5)
    assert moved.shape == x.shape and not torch.equal(moved, tinf.decode(z))
    lerp = tinf.interpolate(x[0], x[1], steps=5)
    assert lerp.shape == (5, 8, 8, 3)
    assert torch.equal(lerp[0], tinf.decode(tinf.encode(x[:1]))[0])
    full = tinf.interpolate_full(x[0], x[1], steps=5)
    assert full.shape == (5, 8, 8, 3)
    for end, img in ((full[0], x[0]), (full[-1], x[1])):
        assert (end.int() - torch.from_numpy(img).int()).abs().max() <= 1
