"""Reference-lineage snapshots to and from the port (`utils/lineage.py`,
`scripts/torch_migrate.py`), against the JAX package's
`utils/torch_migrate.py`: a `.pth` the JAX package writes, imported into a
port checkpoint, scores within 2e-4 of JAX and loads in `cli.infer`; the
port's export reads back in JAX as the very parameters it came from."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.config import GlowConfig as JaxGlowConfig
from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu.utils import torch_migrate as jtm
from pytorch_glow_tpu_torch import GlowConfig, Inferer, init_glow
from pytorch_glow_tpu_torch.cli import infer as infer_cli
from pytorch_glow_tpu_torch.scripts import torch_migrate
from pytorch_glow_tpu_torch.utils import lineage
from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager
from pytorch_glow_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_serve import jax_params

GLOW = dict(image_shape=(8, 8, 3), hidden_channels=16, K=2, L=2)
SETS = ["--set", "glow.image_shape=[8,8,3]", "--set", "glow.hidden_channels=16",
        "--set", "glow.K=2", "--set", "glow.L=2", "--set", "train.batch_size=4",
        "--set", "glow.invconv_impl=xla"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tiny ops spend more on waking threads
    than on their work (a 4x6x4x4 conv: 0.12 ms on one, 2.5-10 ms on 8)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_side():
    jcfg = JaxGlowConfig(**GLOW)
    return jax_params(jcfg, seed=5), jcfg


def _restore(out: str, cfg: GlowConfig):
    snap = CheckpointManager(f"{out}/cifar10/checkpoints").restore("cpu")
    model = init_glow(cfg, device="cpu")
    model.load_state_dict(snap["model"])
    return snap, model


def test_jax_snapshot_imports_and_scores_as_jax(jax_side, tmp_path, capsys):
    params, jcfg = jax_side
    pth = str(tmp_path / "glow.pth")
    jtm.save_torch_snapshot(pth, params, jcfg, step=7)
    out = str(tmp_path / "run")
    torch_migrate.main(["import", pth, "cifar10", "--out-dir", out, "--keep-step", *SETS])
    snap, model = _restore(out, GlowConfig(**GLOW))
    assert snap["step"] == 7 and snap["ema"] is not None
    x = np.random.default_rng(1).integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)
    want = np.asarray(jglow.log_prob(params, jglow.preprocess(jnp.asarray(x), jcfg), jcfg)["nll"])
    np.testing.assert_allclose(Inferer(model).nll(x), want, atol=2e-4)
    capsys.readouterr()
    infer_cli.main(["nll", "cifar10", "--cpu", "--out-dir", out, "--synthetic", "textured",
                    "--batches", "1", *SETS])
    text = capsys.readouterr()
    assert "bits/dim over 4 images" in text.out and "no checkpoint" not in text.err


def test_port_export_reads_back_in_jax_bitwise(jax_side, tmp_path):
    params, jcfg = jax_side
    cfg = GlowConfig(**GLOW)
    model = init_glow(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), cfg))
    pth = str(tmp_path / "glow.pth")
    lineage.save_torch_snapshot(pth, lineage.export_state_dict(model.state_dict()), step=3)
    sd, step = jtm.load_torch_snapshot(pth)
    back = jtm.import_state_dict(sd, jcfg)
    assert step == 3
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_cli_export_and_import_round_trip(tmp_path):
    """`torch_migrate export` of a port checkpoint (with --ema), then
    `import` of that file into a fresh run, gives the same weights; a
    renamed, DataParallel-prefixed bare state_dict with an index-vector
    permutation imports too; a wrong depth is refused."""
    cfg = GlowConfig(**GLOW)
    src = str(tmp_path / "src")
    model = init_glow(cfg, torch.Generator().manual_seed(3), "cpu")
    lineage.save_torch_snapshot(str(tmp_path / "a.pth"),
                                lineage.export_state_dict(model.state_dict()))
    torch_migrate.main(["import", str(tmp_path / "a.pth"), "cifar10", "--out-dir", src, *SETS])
    out = str(tmp_path / "b.pth")
    torch_migrate.main(["export", "cifar10", "--out-dir", src, "--ema", "-o", out, *SETS])
    sd, _ = lineage.load_torch_snapshot(out)
    assert not any(k.startswith("vardeq.") for k in sd)
    for key, value in model.state_dict().items():
        assert torch.equal(sd[key], value), key
    renamed = {"module." + k.replace("flow.", "net.", 1): v for k, v in sd.items()
               if not k.endswith(("l_mask", "eye"))}
    for key in [k for k in renamed if k.endswith("invconv.p")]:
        renamed[key] = renamed[key].argmax(dim=1)
    torch.save(renamed, str(tmp_path / "c.pth"))
    dst = str(tmp_path / "dst")
    torch_migrate.main(["import", str(tmp_path / "c.pth"), "cifar10", "--out-dir", dst,
                        "--rename", "net.=flow.", *SETS])
    _, back = _restore(dst, cfg)
    for key, value in model.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key
    with pytest.raises(SystemExit, match="param-bearing flow layers"):
        torch_migrate.main(["import", out, "cifar10", "--out-dir", dst, *SETS,
                            "--set", "glow.K=3"])
