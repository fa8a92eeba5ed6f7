"""The port's multi-device training on the CPU: gloo ranks (one process
each, `tests/torch_parallel_worker.py`, which imports no JAX) against the
JAX package on the matching mesh of the 8 virtual CPU devices, and against
the port on one rank.

Weights go JAX -> port through `state_dict_from_jax`; images are numpy.
Each multi-rank case starts its ranks with a `file://` rendezvous under
`tmp_path` (no port is chosen) and reads back the numbers they wrote.
Bounds: those of `tests/test_sharding.py` and `tests/test_torch_train.py`
(f32 sums in another order: DDI atol 1e-5, the DP loss rtol 2e-4, three
train steps' loss rtol 2e-5, grad_norm rtol 1e-4, params and EMA atol
2e-5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.config import MeshConfig as JaxMeshConfig
from pytorch_glow_tpu.config import OptimConfig as JaxOptimConfig
from pytorch_glow_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu.parallel import mesh as jmesh
from pytorch_glow_tpu.train import optim as joptim
from pytorch_glow_tpu.train import step as jstep
from pytorch_glow_tpu.utils.tree import merge, partition
from pytorch_glow_tpu_torch import (
    DataConfig,
    GlowConfig,
    MeshConfig,
    OptimConfig,
    Profile,
    TrainConfig,
    build,
    make_optimizer,
    train,
)
from pytorch_glow_tpu_torch.data.pipeline import _process_rows, make_dataset
from pytorch_glow_tpu_torch.parallel import distributed as pd
from pytorch_glow_tpu_torch.parallel import mesh as tmesh
from pytorch_glow_tpu_torch.scripts import _smoke_common as sc
from pytorch_glow_tpu_torch.train import step as tstep
from pytorch_glow_tpu_torch.train.optim import make_schedule
from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager
from pytorch_glow_tpu_torch.utils.convert import state_dict_from_jax
from pytorch_glow_tpu_torch.utils.profiles import profile_to_dict
from test_torch_model import SMALL, _cfgs, _nontrivial_params, _port

WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
MESHES = {"dp": (2, 1), "dp_tp": (2, 2)}
OCFG = dict(schedule="constant", lr=1e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(task: str, inp: dict, world: int, tmp_path, tag: str = "") -> list[dict]:
    """Run `task` on `world` gloo ranks; each rank's output dict."""
    io = tmp_path / f"{task}{tag}"
    io.mkdir()
    torch.save(inp, io / "in.pt")
    sc.run_ranks([WORKER, task, str(io)], world, str(io / "store"), timeout=240)
    return [torch.load(io / f"out{r}.pt", weights_only=False) for r in range(world)]


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _jax_mesh(data: int, model: int, devices):
    return jmesh.make_mesh(JaxMeshConfig(data=data, model=model), devices[:data * model])


def _assert_sd_close(got: dict, want: dict, atol: float, rtol: float = 0.0, keys=None):
    for name in keys if keys is not None else want:
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(want[name]), atol=atol,
                                   rtol=rtol, err_msg=name)


def _images(n, shape=(8, 8, 3), seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *shape), dtype=np.uint8)


# ---------------------------------------------------------------------------
# Mesh, sharding rules, DDI and the DP loss
# ---------------------------------------------------------------------------


@pytest.mark.multiprocess
@pytest.mark.parametrize("layout", sorted(MESHES))
def test_ddi_and_loss_match_jax_mesh(eight_devices, tmp_path, layout):
    """DDI on each rank's rows with the global batch's statistics, against
    the JAX DDI on the batch sharded over the matching mesh (every
    parameter, atol 1e-5); then the per-image nll of the DDI'd model against
    the JAX sharded log_prob (rtol 2e-4).  Also the mesh's shape and
    coordinates, and the tensor-parallel shards' shapes."""
    data, model = MESHES[layout]
    jcfg, tcfg = _cfgs(dict(SMALL))
    params = jglow.init_glow(jax.random.key(0), jcfg)
    x = np.random.default_rng(2).uniform(size=(8, 8, 8, 3)).astype(np.float32)
    sd = _tensors(state_dict_from_jax(jax.tree.map(np.asarray, params), tcfg))
    outs = _run("ddi_loss", {"cfg": SMALL, "mesh": (data, model), "sd": sd,
                             "x": torch.from_numpy(x)}, data * model, tmp_path)

    mesh = _jax_mesh(data, model, eight_devices)
    p_sh = jglow.ddi_init(jmesh.shard_params(mesh, params),
                          jax.device_put(jnp.asarray(x), jmesh.batch_sharding(mesh)), jcfg)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(p_sh)), tcfg)
    nll = jglow.log_prob(p_sh, jax.device_put(jnp.asarray(x), jmesh.batch_sharding(mesh)), jcfg)
    for r, out in enumerate(outs):
        assert out["mesh"] == (data, model, r // model, r % model)
        _assert_sd_close(out["ddi"], want, atol=1e-5)
        np.testing.assert_allclose(out["nll"].numpy(), np.asarray(nll["nll"]), rtol=2e-4)
        if model == 1:
            assert out["shard_shapes"] == {}
        else:
            h = SMALL["hidden_channels"]
            shapes = out["shard_shapes"]
            assert len(shapes) == 4 * SMALL["K"] * SMALL["L"]
            for name, shape in shapes.items():
                if name.endswith("f.0.weight"):
                    assert shape[0] == h // model and shape[2:] == (3, 3), name
                elif name.endswith("f.2.weight"):
                    assert shape == (h, h // model, 1, 1)
                else:
                    assert shape == (1, h // model, 1, 1), name
    torch.testing.assert_close(outs[0]["ddi"], outs[-1]["ddi"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Train steps: DP and DP x TP against JAX's mesh steps; noise against one rank
# ---------------------------------------------------------------------------


def _jax_steps(jcfg, params, batches, mesh):
    """`make_train_step` on `mesh` from `params`: each step's metrics, the
    params and the EMA as port state dicts."""
    jtx = joptim.make_optimizer(JaxOptimConfig(**OCFG), JaxTrainConfig())
    trainable, frozen = partition(params)
    opt_state = jtx.init(trainable)
    ema = jax.tree.map(jnp.copy, trainable)
    jstate = {"step": jnp.zeros((), jnp.int32), "params": jmesh.shard_params(mesh, params),
              "opt_state": jax.device_put(opt_state, jmesh.param_shardings(mesh, opt_state)),
              "rng": jax.random.key(0),
              "ema": jax.device_put(ema, jmesh.param_shardings(mesh, ema))}
    jtrain = jstep.make_train_step(jcfg, jtx, 0.999, joptim.make_schedule(JaxOptimConfig(**OCFG)))
    metrics = []
    for batch in batches:
        jstate, jm = jtrain(jstate, jax.device_put(jnp.asarray(batch), jmesh.batch_sharding(mesh)))
        metrics.append({k: float(v) for k, v in jm.items()})
    jparams = jax.tree.map(np.asarray, jax.device_get(jstate["params"]))
    _, jfrozen = partition(jparams)
    tcfg = GlowConfig(**SMALL, dequant="none")
    return (metrics, state_dict_from_jax(jparams, tcfg),
            state_dict_from_jax(jax.tree.map(np.asarray, merge(jax.device_get(jstate["ema"]),
                                                                jfrozen)), tcfg))


@pytest.mark.multiprocess
@pytest.mark.parametrize("layout", sorted(MESHES))
def test_three_train_steps_match_jax_mesh(eight_devices, tmp_path, layout):
    """Three noise-free train steps (EMA on, constant lr 1e-3) on 2 gloo
    ranks (data=2) and 2x2 (data=2, model=2), against JAX `make_train_step`
    on the matching mesh from the same parameters: loss rtol 2e-5,
    grad_norm rtol 1e-4 (under TP the norm over every rank's shards),
    params and EMA atol 2e-5.  Every rank reports the same numbers."""
    data, model = MESHES[layout]
    kw = dict(SMALL, dequant="none")
    jcfg, _ = _cfgs(kw)
    params = _nontrivial_params(jcfg)
    batches = [_images(4, seed=10 + i) for i in range(3)]
    sd = _tensors(state_dict_from_jax(jax.tree.map(np.asarray, params), GlowConfig(**kw)))
    outs = _run("steps", {"cfg": kw, "mesh": (data, model), "sd": sd,
                          "batches": [torch.from_numpy(b) for b in batches],
                          "optim": OCFG, "train": dict(ema_decay=0.999)},
                data * model, tmp_path)
    jm, want_params, want_ema = _jax_steps(jcfg, params, batches,
                                           _jax_mesh(data, model, eight_devices))
    for out in outs:
        for got, want in zip(out["metrics"], jm):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
            np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-7)
        assert sorted(out["params"]) == sorted(want_params)
        _assert_sd_close(out["params"], want_params, atol=2e-5)
        _assert_sd_close(out["ema"], want_ema, atol=2e-5)
        assert out["metrics"] == outs[0]["metrics"]


@pytest.mark.multiprocess
@pytest.mark.parametrize("layout", sorted(MESHES))
def test_noisy_steps_on_ranks_equal_one_rank(tmp_path, layout):
    """With dequantization noise and flips on, N ranks draw the global
    batch's noise and keep their rows, so they compute what one rank does
    on the global batch: two steps' loss rtol 2e-5 and grad_norm rtol
    1e-4, params and EMA atol 2e-5, against the port on one rank."""
    data, model = MESHES[layout]
    jcfg, tcfg = _cfgs(dict(SMALL))
    params = _nontrivial_params(jcfg, seed=3)
    sd = _tensors(state_dict_from_jax(jax.tree.map(np.asarray, params), tcfg))
    batches = [_images(4, seed=20 + i) for i in range(2)]
    train_kw = dict(ema_decay=0.999, augment_flip=True, seed=5)
    outs = _run("steps", {"cfg": SMALL, "mesh": (data, model), "sd": sd,
                          "batches": [torch.from_numpy(b) for b in batches],
                          "optim": OCFG, "train": train_kw}, data * model, tmp_path)

    model_1 = _port(params, tcfg).train()
    tx = make_optimizer(OptimConfig(**OCFG), TrainConfig(**train_kw))
    state = tstep.init_state(model_1, tx, 0.999, seed=5)
    step_fn = tstep.make_train_step(tcfg, tx, 0.999, make_schedule(OptimConfig(**OCFG)), True)
    for batch, got in zip(batches, outs[0]["metrics"]):
        state, m = step_fn(state, torch.from_numpy(batch))
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=2e-5)
        np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=1e-4)
    _assert_sd_close(outs[0]["params"], {k: v.detach() for k, v in
                                         model_1.state_dict().items()}, atol=2e-5)
    _assert_sd_close(outs[0]["ema"], tstep.ema_params(state), atol=2e-5)


# ---------------------------------------------------------------------------
# Rows: model peers read the same rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["synthetic_textured", "cifar10"])
def test_model_peers_read_the_same_rows(tmp_path, source):
    """Under a (data=1, model=2) mesh both ranks sit at data coordinate 0,
    so both read the whole global batch: the streams take the mesh's data
    shard.  The old rule, rows by global rank and world size, hands the two
    model peers different rows, which a TP coupling net would mix: it fails
    here.  Under (data=2, model=1) the two data ranks' rows partition the
    batch."""
    from test_torch_data import write_cifar10

    root = str(tmp_path)
    if source == "cifar10":
        write_cifar10(root)
    cfgs = (DataConfig(name=source, root=root), GlowConfig(**SMALL),
            TrainConfig(batch_size=8, seed=1))
    whole = next(make_dataset(*cfgs))["image"]
    peers = []
    for rank in range(2):  # mesh (1, 2): rank = d * 2 + m, d = 0
        peers.append(next(make_dataset(*cfgs, shard=(rank // 2, 1)))["image"])
    np.testing.assert_array_equal(peers[0], peers[1])
    np.testing.assert_array_equal(peers[0], whole)
    old = [next(make_dataset(*cfgs, shard=(rank, 2)))["image"] for rank in range(2)]
    assert not np.array_equal(old[0], old[1])  # the old rule splits model peers
    data_ranks = [next(make_dataset(*cfgs, shard=(d, 2)))["image"] for d in range(2)]
    np.testing.assert_array_equal(np.concatenate(data_ranks), whole)
    with pytest.raises(ValueError, match="does not split"):
        make_dataset(*cfgs[:2], TrainConfig(batch_size=6), shard=(0, 4))


# ---------------------------------------------------------------------------
# Snapshots across meshes and per-rank stream positions
# ---------------------------------------------------------------------------


def _profile(out_dir, mesh=(-1, 1), num_steps=4, **train):
    return Profile(
        name="xmesh",
        glow=GlowConfig(**SMALL, flowstep_impl="pallas"),
        optim=OptimConfig(lr=1e-3, warmup_steps=10),
        train=TrainConfig(batch_size=8, num_steps=num_steps, scalar_log_gap=2, plot_gap=0,
                          checkpoint_gap=2, ema_decay=0.99, seed=0, **train),
        data=DataConfig(name="synthetic_textured"),
        mesh=MeshConfig(*mesh),
        out_dir=str(out_dir),
    )


@pytest.mark.multiprocess
def test_snapshots_restore_across_meshes(tmp_path):
    """A 2x2 run's snapshot (gathered, mesh-independent tensors) restores
    into one rank bit for bit, which trains on; that rank's snapshot
    restores onto 2 ranks (data=2), each resuming from its own saved
    stream position, and they train on with one loss.  The fused path
    (K1/K3's plain versions here) under the model axis: the gathered
    weights' gradient reaches each shard unscaled, so the 2x2 run's loss
    is the one-rank run's."""
    out = tmp_path / "runs"
    p22 = _profile(out, mesh=(2, 2))
    runs = _run("build_train", {"profile": profile_to_dict(p22), "num_steps": 4}, 4, tmp_path)
    assert [r["mesh"] for r in runs] == [(2, 2, d, m) for d in range(2) for m in range(2)]
    assert len({r["result"]["loss"] for r in runs}) == 1
    assert all(not r["resumed"] for r in runs)

    # 2x2 -> 1: bit for bit, then two more steps on one rank.
    built = build(_profile(out, num_steps=6), device="cpu")
    assert built.resumed and built.start_step == 4 and built.mesh is None
    for name, t in built.state["model"].state_dict().items():
        assert torch.equal(t, runs[0]["params"][name]), name
    snap = CheckpointManager(str(out / "xmesh" / "checkpoints")).restore("cpu")
    assert snap["opt_state"]["mu"].numel() == sum(p.numel() for _, p in
                                                  tstep.trainable(built.state["model"]))
    assert len(snap["data_states"]) == 4
    # The 2x2 run against one rank from the same start: the same losses.
    fresh = build(_profile(tmp_path / "one", num_steps=4), device="cpu")
    one = train(fresh, quiet=True)
    np.testing.assert_allclose(runs[0]["result"]["loss"], one["loss"], rtol=2e-5)
    result = train(built, quiet=True)
    assert result["final_step"] == 6

    # 1 -> 2, with each rank's own stream position.
    ckpt = CheckpointManager(str(out / "xmesh" / "checkpoints"))
    path = ckpt.path(6)
    snap = torch.load(path, weights_only=False)
    snap["data_states"] = [{"next_index": 11}, {"next_index": 13}]
    torch.save(snap, path)
    p2 = _profile(out, mesh=(2, 1), num_steps=8)
    runs2 = _run("build_train", {"profile": profile_to_dict(p2), "num_steps": 8,
                                 "async_save": True}, 2, tmp_path, tag="-two")
    assert all(r["resumed"] and r["start_step"] == 6 for r in runs2)
    # A background save on the mesh, restored on every rank.
    for r in runs2:
        got = r["async_restore"]
        assert got["step"] == 100 and len(got["data_states"]) == 2
        for name, t in runs2[0]["params"].items():
            assert torch.equal(got["model"][name], t), name
    assert [r["start_data_state"] for r in runs2] == snap["data_states"]
    assert len({r["result"]["loss"] for r in runs2}) == 1
    assert all(r["result"]["final_step"] == 8 for r in runs2)


# ---------------------------------------------------------------------------
# Start-up and the sharding helpers without a group
# ---------------------------------------------------------------------------


def test_multihost_env_and_no_fallback(monkeypatch):
    """torchrun's environment turns the collective path on, a world of one
    included; GLOW_TPU_MULTIHOST=off turns it off; outside it nothing
    initialises.  A CPU device with the nccl backend raises instead of
    falling back."""
    for k in ("WORLD_SIZE", "MASTER_ADDR", "GLOW_TPU_MULTIHOST"):
        monkeypatch.delenv(k, raising=False)
    assert not pd.multihost_env()
    assert pd.maybe_initialize("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert pd.multihost_env()
    with pytest.raises(ValueError, match="nccl"):
        pd.maybe_initialize("cpu", backend="nccl")
    monkeypatch.setenv("GLOW_TPU_MULTIHOST", "off")
    assert not pd.multihost_env()
    assert pd.world_size() == 1
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert pd.local_device(cpu=True) == torch.device("cpu")


def test_param_pspec_and_shard_rules():
    """The TP rules name the flow steps' conv1 (weight dim 0, its actnorm
    dim 1) and conv2 (weight dim 1); the variational dequantizer's nets,
    the priors and everything else stay replicated, as in the JAX rules.
    `shard_params` keeps the rank's contiguous block; `_process_rows`
    splits a batch into equal blocks."""
    model = _port(_nontrivial_params(_cfgs(dict(SMALL))[0]), GlowConfig(**SMALL))
    names = [n for n, _ in model.named_parameters()]
    sharded = {n: tmesh.param_pspec(n, True) for n in names if tmesh.param_pspec(n, True)
               is not None}
    assert len(sharded) == 4 * SMALL["K"] * SMALL["L"]
    assert all(tmesh.param_pspec(n, False) is None for n in names)
    assert tmesh.param_pspec("vardeq.steps.0.0.weight", True) is None
    assert tmesh.param_pspec("vardeq.ctx.conv1.weight", True) is None

    class FakeMesh:
        model, model_rank, tp = 2, 1, True

    sd = {n: p.detach() for n, p in model.named_parameters()}
    local = tmesh.shard_params(sd, FakeMesh())
    w = "flow.layers.1.f.0.weight"
    assert torch.equal(local[w], sd[w][8:])
    a = "flow.layers.1.f.0.actnorm.logs"
    assert torch.equal(local[a], sd[a][:, 8:])
    assert torch.equal(local["flow.layers.1.f.2.weight"], sd["flow.layers.1.f.2.weight"][:, 8:])
    assert torch.equal(local["flow.layers.1.f.4.weight"], sd["flow.layers.1.f.4.weight"])
    assert _process_rows(8, 1, 2) == (4, 8)
