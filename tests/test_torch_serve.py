"""The port's serving artifacts (`pytorch_glow_tpu_torch/serve.py`) on the
CPU: export -> save -> load -> serve reproduces the live port without its
model code (sample, encode and decode bitwise, nll and nll_elbo to rtol
1e-6, reconstruct within one bin), as tests/test_serve.py holds the JAX
package's; the port's live nll agrees with the JAX package's on the same
weights.  A kernel artifact (`keep_kernels=True`) exports the kernels as
their `torch.library` ops, which run their plain versions here."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.config import GlowConfig as JaxGlowConfig
from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu_torch import GlowConfig, Inferer, init_glow, serve
from test_torch_model import _port
from test_torch_parallel import _run

SMALL = dict(image_shape=(8, 8, 3), hidden_channels=16, K=1, L=2)
B = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny ops spend more on waking threads
    than on their work (a 4x6x4x4 conv: 0.12 ms on one, 2.5-10 ms on 8)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_params(jcfg, seed=0):
    """JAX init with every parameter outside the permutations perturbed (no
    flow is the identity; DDI's compile is spared), numpy leaves."""
    params = jglow.init_glow(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed + 2)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        if "perm" in jax.tree_util.keystr(path):
            return leaf
        return leaf + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = JaxGlowConfig(**SMALL), GlowConfig(**SMALL)
    params = jax_params(jcfg)
    return params, jcfg, _port(params, tcfg)


@pytest.fixture(scope="module")
def artifact(tiny, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("artifact"))
    return out, serve.export_artifact(tiny[2], None, out, batch_size=B)


@pytest.fixture(scope="module")
def served(artifact):
    return serve.load_artifact(artifact[0])


@pytest.fixture(scope="module")
def dynamic(tiny, tmp_path_factory):
    """A dynamic-batch artifact of two functions."""
    out = str(tmp_path_factory.mktemp("dynamic"))
    man = serve.export_artifact(tiny[2], None, out, batch_size="dynamic",
                                functions=("sample", "nll"))
    return out, man


def _images(n=B, seed=7):
    return np.random.default_rng(seed).integers(0, 256, (n, 8, 8, 3), dtype=np.uint8)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_manifest(artifact):
    out, manifest = artifact
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == manifest
    assert manifest["batch_size"] == B and manifest["device"] == "cpu"
    assert manifest["format_version"] == serve.FORMAT_VERSION
    assert manifest["torch_version"] == torch.__version__ and not manifest["keep_kernels"]
    assert manifest["glow_config"]["flowstep_impl"] == "xla"
    assert set(manifest["functions"]) == {
        "sample", "encode", "decode", "reconstruct", "nll", "nll_elbo"}
    for meta in manifest["functions"].values():
        assert os.path.getsize(os.path.join(out, meta["file"])) == meta["bytes"] > 0
        assert all("b" not in a["shape"] for a in meta["args"])
    kinds = [a["kind"] for a in manifest["functions"]["sample"]["args"]]
    assert kinds == ["input", "normal", "normal"]  # temperature, top, one split


def test_served_sample_bitwise_matches_live(tiny, served):
    m = served
    got = m.sample(seed=7, temperature=0.5)
    want = Inferer(tiny[2]).sample(B, 0.5, _gen(7))
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert not torch.equal(m.sample(seed=8, temperature=0.5), got)


def test_served_encode_decode_nll_match_live(tiny, served):
    m, live = served, Inferer(tiny[2])
    x = _images()
    z = m.encode(x)
    assert torch.equal(z, live.encode(x))
    assert torch.equal(m.decode(z, seed=3, temperature=0.5), live.decode(z, _gen(3), 0.5))
    np.testing.assert_allclose(m.nll(x), live.nll(x), rtol=1e-6)
    b1 = m.nll_elbo(x, seed=5)
    assert torch.equal(b1, m.nll_elbo(x, seed=5))
    np.testing.assert_allclose(b1, live.nll_bound(x, 1, "elbo", _gen(5)), rtol=1e-6)


def test_served_reconstruct_within_one_bin(served):
    x = _images()
    rec = served.reconstruct(x)
    assert (rec.int() - torch.from_numpy(x).int()).abs().max() <= 1


def test_live_and_served_nll_agree_with_jax(tiny, served):
    params, jcfg, model = tiny
    x = _images()
    want = np.asarray(jglow.log_prob(params, jglow.preprocess(jnp.asarray(x), jcfg), jcfg)["nll"])
    np.testing.assert_allclose(Inferer(model).nll(x), want, atol=2e-4)
    np.testing.assert_allclose(served.nll(x), want, atol=2e-4)


def test_y_conditional_entry_points(tmp_path):
    cfg = GlowConfig(**SMALL, y_condition=True, y_classes=5)
    model = init_glow(cfg, _gen(1), "cpu")
    with torch.no_grad():  # zero-init heads: perturb so labels shift the prior
        model.project_ycond.weight.normal_(0.0, 0.5, generator=_gen(2))
    with pytest.raises(ValueError, match="need labels"):
        serve.export_artifact(model, None, str(tmp_path / "bad"), B, ("sample",))
    out = str(tmp_path / "y")
    man = serve.export_artifact(model, None, out, B, ("sample_y", "nll_y"))
    assert set(man["functions"]) == {"sample_y", "nll_y"}
    m, live = serve.load_artifact(out), Inferer(model)
    a = m.sample(seed=0, temperature=0.6, labels=[0] * B)
    b = m.sample(seed=0, temperature=0.6, labels=[1] * B)
    assert a.shape == (B, 8, 8, 3) and not torch.equal(a, b)
    onehot = torch.nn.functional.one_hot(torch.tensor([1] * B), 5).float()
    assert torch.equal(b, live.sample(B, 0.6, _gen(0), onehot))
    x = _images()
    labels = torch.tensor([2, 0, 4, 1])
    np.testing.assert_allclose(m.nll(x, labels=labels),
                               live.nll(x, torch.nn.functional.one_hot(labels, 5).float()),
                               rtol=1e-6)


def test_function_subset_and_unknown_name(tiny, dynamic, tmp_path):
    out, man = dynamic
    assert list(man["functions"]) == ["sample", "nll"]
    m = serve.load_artifact(out)
    assert m.sample(seed=0).shape == (16, 8, 8, 3)  # a dynamic artifact's default batch
    with pytest.raises(KeyError, match="has: \\['nll', 'sample'\\]"):
        m.encode(_images(2))
    with pytest.raises(ValueError, match="nope"):
        serve.export_artifact(tiny[2], None, str(tmp_path), functions=("nope",))
    with pytest.raises(ValueError, match="batch_size"):
        serve.export_artifact(tiny[2], None, str(tmp_path), batch_size=0, functions=("nll",))


def test_dynamic_batch_artifact_serves_any_batch(tiny, dynamic):
    out, man = dynamic
    assert man["batch_size"] == "dynamic"
    assert man["functions"]["nll"]["args"][0]["shape"] == ["b", 8, 8, 3]
    m, live = serve.load_artifact(out), Inferer(tiny[2])
    for n in (1, 3, 8):
        got = m.sample(seed=1, temperature=0.7, n=n)
        assert got.shape == (n, 8, 8, 3) and torch.equal(got, live.sample(n, 0.7, _gen(1)))
        x = _images(n, seed=n)
        np.testing.assert_allclose(m.nll(x), live.nll(x), rtol=1e-6)


def test_newer_format_and_cuda_artifacts_refused(artifact, tmp_path, monkeypatch):
    out = str(tmp_path / "newer")
    os.makedirs(out)
    man = dict(artifact[1], format_version=serve.FORMAT_VERSION + 1)
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="newer"):
        serve.load_artifact(out)
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(dict(artifact[1], device="cuda"), f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.load_artifact(out)


def _targets(path: str) -> set[str]:
    return {str(n.target) for n in torch.export.load(path).graph.nodes
            if n.op == "call_function"}


@pytest.mark.parametrize("impl,ops", [
    ("fused", {"glow.flowstep_forward.default", "glow.flowstep_reverse.default"}),
    ("invconv", {"glow.invconv_lu_forward.default", "glow.invconv_mix.default"}),
])
def test_kernel_artifact_serves_the_kernels_ops(tmp_path, impl, ops):
    """keep_kernels exports the profile's kernels as their torch.library ops
    (plain versions on the CPU): the fused flow step (K1/K2) or the LU 1x1
    conv (K6a/K6b), served against the live model on the same path;
    reconstruct runs both directions."""
    kw = (dict(compute_dtype="bfloat16", flowstep_impl="pallas") if impl == "fused"
          else dict(invconv_impl="pallas"))
    cfg = GlowConfig(**SMALL, **kw)
    model = init_glow(cfg, _gen(3), "cpu")
    model.ddi_init(model.dequantize(model.preprocess(torch.from_numpy(_images(8, 1))), _gen(4)))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".f.4." in name:
                p.add_(0.01 * torch.randn(p.shape, generator=_gen(5)))
    out = str(tmp_path / impl)
    man = serve.export_artifact(model, None, out, B, ("reconstruct",), keep_kernels=True)
    assert man["keep_kernels"] and man["glow_config"] == {**man["glow_config"], **kw}
    assert ops <= _targets(os.path.join(out, "reconstruct.pt2"))
    x = _images()
    assert torch.equal(serve.load_artifact(out).reconstruct(x), Inferer(model).reconstruct(x))


@pytest.mark.parametrize("dequant", ["uniform", "variational"])
def test_explicit_noise_gives_the_live_draws(dequant):
    """Draws taken outside from a seeded generator, in the live order and
    shapes (`noise_shapes`, the dequantization draw of x's shape), give the
    live call's bits: what the served graphs take as inputs."""
    model = init_glow(GlowConfig(**SMALL, dequant=dequant), _gen(6), "cpu")
    x = model.preprocess(torch.from_numpy(_images()))
    gen = _gen(8)
    draws = [torch.randn(s, generator=gen) for s in model.noise_shapes(B)]
    with torch.no_grad():
        assert torch.equal(model.sample(B, 0.6, noise=draws), model.sample(B, 0.6, _gen(8)))
        z = model.encode(x)[0]
        gen = _gen(8)
        splits = [torch.randn(s, generator=gen) for s in model.noise_shapes(B)[1:]]
        assert torch.equal(model.decode(z, temperature=0.6, noise=splits),
                           model.decode(z, _gen(8), 0.6))
        gen = _gen(9)
        u = [torch.rand(x.shape, generator=gen) for _ in range(2)]
        got = model.nll_bound(x, None, 2, "iwae", noise=u)
        assert torch.equal(got, model.nll_bound(x, _gen(9), 2, "iwae"))
        assert torch.equal(model.log_prob(x, noise=u[0])["objective"],
                           model.log_prob(x, _gen(9))["objective"])


# -- SPMD serving (tests/test_serve.py:146-170, :191-197) ------------------------


def test_spmd_export_records_the_mesh_and_refuses_what_jax_refuses(tiny, tmp_path):
    """A mesh export records the mesh and per-argument specs (batch
    arguments over "data", scalars replicated); a dynamic batch, a mesh
    with no "data" axis and a batch that does not divide the data axis are
    refused, as JAX refuses them; a process with a world smaller than the
    mesh's device count refuses the artifact."""
    out = str(tmp_path / "spmd")
    man = serve.export_artifact(tiny[2], None, out, batch_size=B, functions=("sample", "nll"),
                                mesh={"data": 2})
    assert man["mesh"] == {"shape": [2], "axis_names": ["data"]}
    assert man["functions"]["sample"]["arg_specs"] == [[], ["data"], ["data"]]
    assert man["functions"]["nll"]["arg_specs"] == [["data"]]
    assert man["functions"]["nll"]["args"][0]["shape"] == [B, 8, 8, 3]  # the global batch
    with pytest.raises(ValueError, match="dynamic"):
        serve.export_artifact(tiny[2], None, str(tmp_path / "a"), batch_size="dynamic",
                              mesh={"data": 2})
    with pytest.raises(ValueError, match="no 'data' axis"):
        serve.export_artifact(tiny[2], None, str(tmp_path / "b"), batch_size=B,
                              mesh={"model": 2})
    with pytest.raises(ValueError, match="divide"):
        serve.export_artifact(tiny[2], None, str(tmp_path / "c"), batch_size=3,
                              functions=("sample",), mesh={"data": 2})
    with pytest.raises(ValueError, match="2 devices"):
        serve.load_artifact(out)


@pytest.mark.multiprocess
def test_spmd_artifact_served_by_two_ranks(tiny, artifact, served, tmp_path):
    """A data=2 artifact served by two gloo ranks, each on its half of the
    batch with the outputs gathered: every rank returns the whole batch,
    nll within rtol 1e-5 of the live JAX log_prob, encode and the sample
    (its draws made for the whole batch, then sliced) bitwise the
    one-device artifact's."""
    params, jcfg, model = tiny
    out = str(tmp_path / "spmd")
    serve.export_artifact(model, None, out, batch_size=B, functions=("sample", "nll", "encode"),
                          mesh={"data": 2})
    x = _images()
    ranks = _run("serve", {"path": out, "x": torch.from_numpy(x)}, 2, tmp_path)
    want = np.asarray(jglow.log_prob(params, jglow.preprocess(jnp.asarray(x), jcfg), jcfg)["nll"])
    for got in ranks:
        np.testing.assert_allclose(got["nll"].numpy(), want, rtol=1e-5)
        assert torch.equal(got["encode"], served.encode(x))
        assert torch.equal(got["sample"], served.sample(seed=7, temperature=0.5))
