"""Spatial sharding of the port on the CPU: image rows over the mesh's model
group (`parallel/spatial.py`), on gloo ranks (`tests/torch_parallel_worker.py`,
which imports no JAX) against the JAX package under `jax.set_mesh` with
`shard_spatial=True` on the 8 virtual CPU devices, and against the port on
one rank; and the slab form of the band chain's plain versions in one
process.

Bounds: JAX's own (`tests/test_sharding.py`): the nll rtol 2e-4,
three train steps' loss rtol 2e-5 and params and EMA rtol 2e-4, atol
2e-5; DDI atol 1e-5 (`tests/test_torch_parallel.py`); the f32 round trip
within 1e-5.  The fused path (the band chain's plain version on slabs)
against the port's unsharded fused path: the same bits for the images,
the nll within 1e-5 relative (the logdet's partials summed over ranks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.config import GlowConfig as JaxGlowConfig
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
)
from pytorch_glow_tpu_torch import PRESETS
from pytorch_glow_tpu_torch.models.glow import init_glow
from pytorch_glow_tpu_torch.ops import flowstep as tfs
from pytorch_glow_tpu_torch.parallel import spatial
from pytorch_glow_tpu_torch.utils.convert import state_dict_from_jax
from pytorch_glow_tpu_torch.utils.profiles import profile_to_dict
from test_torch_band import small_bands  # noqa: F401  (fixture)
from test_torch_flowstep import _z
from test_torch_flowstep_bwd import _assert_scaled_close, _cotangents, _noisy_step
from test_torch_model import _nontrivial_params
from test_torch_parallel import OCFG, _assert_sd_close, _images, _jax_mesh, _run, _tensors

SP = dict(image_shape=(16, 16, 3), hidden_channels=16, K=2, L=2, shard_spatial=True)
FUSED = dict(SP, hidden_channels=32, compute_dtype="bfloat16", flowstep_impl="pallas")
LAYOUTS = {"model2": (1, 2), "dp2_model2": (2, 2), "model4": (1, 4)}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_model(kw: dict, sd: dict):
    model = init_glow(GlowConfig(**kw), torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(sd)
    return model.eval()


def _sd(kw: dict, seed: int) -> dict:
    params = _nontrivial_params(JaxGlowConfig(**kw), seed)
    return params, _tensors(state_dict_from_jax(jax.tree.map(np.asarray, params),
                                                GlowConfig(**kw)))


# ---------------------------------------------------------------------------
# Which levels shard
# ---------------------------------------------------------------------------


def test_levels_shard_where_rows_divide_and_hold_the_halo():
    """celebahq256's six levels (128 .. 4 rows): all on slabs at model=2;
    at model=4 the deepest (one row a rank, less than the 2-row halo) runs
    whole; nothing without shard_spatial, on a mesh not made for it (TP),
    or with model=1."""
    cfg = PRESETS["celebahq256"].glow
    assert cfg.shard_spatial

    def mesh(model, spatial=True):
        return dataclasses.make_dataclass("M", ["model", "spatial"])(model, spatial)

    rows = [h for h, _, _ in cfg.latent_shapes()]
    assert [spatial.level_sharded(cfg, mesh(2), h) for h in rows] == [True] * 6
    assert [spatial.level_sharded(cfg, mesh(4), h) for h in rows] == [True] * 5 + [False]
    assert not any(spatial.level_sharded(cfg, mesh(1), h) for h in rows)
    assert not spatial.level_sharded(dataclasses.replace(cfg, shard_spatial=False), mesh(2), 128)
    assert not spatial.level_sharded(cfg, None, 128)
    assert not spatial.level_sharded(cfg, mesh(2, spatial=False), 128)


# ---------------------------------------------------------------------------
# The slab form of the band chain's plain versions, in one process
# ---------------------------------------------------------------------------

SHAPE = (5, 32, 32, 12)  # b, h, w, c; hidden 32 (test_torch_band's)


def _padded_slabs(z: torch.Tensor, n: int):
    """Each of n row slabs of z with HALO rows of each neighbour around it
    (zeros beyond the image), and its Slab."""
    h = z.shape[1]
    s, k = h // n, tfs.HALO
    zp = torch.nn.functional.pad(z, (0, 0, 0, 0, k, k))
    return [(zp[:, m * s:m * s + s + 2 * k].contiguous(), tfs.Slab(m * s, h)) for m in range(n)]


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("mode", ["affine", "additive"])
def test_slab_band_versions_match_the_whole_step(small_bands, mode, n):  # noqa: F811
    """n slabs (16 rows: two bands of 8, folded inside the slab; 8 rows: one
    band; 2 rows: one band shorter than its halo) of a 32-row batch: the
    slabs' rows concatenated equal `step_forward_ref`'s z bit for bit and
    the slab logdets sum to its logdet within 1e-6 relative; the same for
    the reverse; backward (at f32 coupling, as `test_torch_band` holds the
    band backward: at bf16 a rounding flips wherever the f32 sums before it
    run in another order), each padded slab's g_z with its halo rows sent
    on to their owners, and the slabs' weight grads summed, against
    `step_backward_ref` within 1e-5 of each output's largest magnitude."""
    affine = mode == "affine"
    step = _noisy_step(SHAPE[-1], mode)
    z = torch.from_numpy(_z(SHAPE))
    gzn, gld = (torch.from_numpy(a) for a in _cotangents(*SHAPE))
    slabs = _padded_slabs(z, n)
    s, k = SHAPE[1] // n, tfs.HALO
    with torch.no_grad():
        wf, wr = tfs.pack_weights(step, affine, False), tfs.pack_weights(step, affine, True)
        outs = [tfs.step_forward(wf, zp, affine, slab) for zp, slab in slabs]
        zw, ldw = tfs.step_forward_ref(wf, z, affine)
        assert torch.equal(torch.cat([o for o, _ in outs], dim=1), zw)
        np.testing.assert_allclose(sum(ld for _, ld in outs).numpy(), ldw.numpy(),
                                   rtol=1e-6, atol=1e-6 * float(ldw.abs().max()))
        back = [tfs.step_reverse(wr, zp, affine, slab) for zp, slab in _padded_slabs(zw, n)]
        assert torch.equal(torch.cat(back, dim=1), tfs.step_reverse_ref(wr, zw, affine))
        wf = tfs.pack_weights(step, affine, False, torch.float32)
        g_pad = torch.zeros(SHAPE[0], SHAPE[1] + 2 * k, *SHAPE[2:])
        grads = None
        for m, (zp, slab) in enumerate(slabs):
            g, part = tfs.step_backward(wf, zp, gzn[:, m * s:(m + 1) * s], gld, affine, slab)
            assert g.shape == zp.shape
            g_pad[:, m * s:m * s + s + 2 * k] += g
            grads = part if grads is None else [a + p for a, p in zip(grads, part)]
        gw, grads_w = tfs.step_backward_ref(wf, z, gzn, gld, affine, torch.float32)
    assert not g_pad[:, :k].any() and not g_pad[:, -k:].any()  # nothing beyond the image
    _assert_scaled_close(g_pad[:, k:-k].numpy(), gw.numpy(), 1e-5, what="g_z")
    for i, (a, r) in enumerate(zip(grads, grads_w)):
        _assert_scaled_close(a.numpy(), r.numpy(), 1e-5, what=f"weight grad {i}")


# ---------------------------------------------------------------------------
# The model on ranks against JAX under jax.set_mesh, and against one rank
# ---------------------------------------------------------------------------


def _expected_exchange(whole: torch.Tensor, cots: list[torch.Tensor], k: int, n: int):
    """Each rank's padded slab of `whole`, and the whole tensor's
    cotangent from the ranks' padded cotangents."""
    s = whole.shape[1] // n
    zp = torch.nn.functional.pad(whole, (0, 0, 0, 0, k, k))
    padded = [zp[:, m * s:m * s + s + 2 * k] for m in range(n)]
    grad = torch.zeros_like(zp)
    for m, cot in enumerate(cots):
        grad[:, m * s:m * s + s + 2 * k] += cot
    return padded, grad[:, k:-k]


@pytest.mark.multiprocess
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_spatial_model_matches_jax_mesh(eight_devices, tmp_path, layout):
    """On gloo ranks as (data, model), each rank on its data rows: DDI
    (atol 1e-5) and the DDI'd log_prob's nll (rtol 2e-4) against JAX's on
    the matching mesh under jax.set_mesh; decode(encode(x)) within 1e-5
    of x (f32); a sample from explicit noise and one from a generator
    against the port's unsharded model.  The fused path on slabs (bf16)
    against the port's unsharded fused path.  The halo exchange's forward
    and backward, 1 row of 1-row slabs and 2 rows of 2-row slabs, against
    slices of the whole tensor."""
    data, model = LAYOUTS[layout]
    world = data * model
    params, sd = _sd(SP, 0)
    _, fused_sd = _sd(FUSED, 4)
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(8, 16, 16, 3)).astype(np.float32)
    one = _port_model(dict(SP, shard_spatial=False), sd)
    noise = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in one.noise_shapes(8)]
    slab_x = torch.from_numpy(rng.standard_normal((2, 8, 3, 2)).astype(np.float32))
    exchange = [(1, 1), (2, 2)]
    outs = _run("spatial", {"cfg": SP, "sd": sd, "fused_cfg": FUSED, "fused_sd": fused_sd,
                            "x": torch.from_numpy(x), "noise": noise, "mesh": (data, model),
                            "spatial": True, "slab_x": slab_x, "exchange": exchange},
                world, tmp_path)

    jcfg = JaxGlowConfig(**SP)
    mesh = _jax_mesh(data, model, eight_devices)
    with jax.set_mesh(mesh):
        xs = jax.device_put(jnp.asarray(x), jmesh.batch_sharding(mesh))
        p_sh = jax.jit(lambda p, x: jglow.ddi_init(p, x, jcfg))(jmesh.shard_params(mesh, params), xs)
        nll = jax.jit(lambda p, x: jglow.log_prob(p, x, jcfg)["nll"])(p_sh, xs)
    want_ddi = state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(p_sh)), GlowConfig(**SP))

    one.load_state_dict(outs[0]["ddi"])
    fused_one = _port_model(dict(FUSED, shard_spatial=False), fused_sd)
    per = 8 // data
    with torch.no_grad():
        want = {"sample": one.sample(8, 0.7, noise=noise),
                "sample_gen": one.sample(per, 0.7, torch.Generator().manual_seed(5))}
        xt = torch.from_numpy(x)
        fused_want = {"nll": fused_one.log_prob(xt)["nll"], "recon": fused_one.reconstruct(xt),
                      "sample": fused_one.sample(8, 0.7, noise=noise),
                      "sample_gen": fused_one.sample(per, 0.7, torch.Generator().manual_seed(5))}
    sharded = [True, model == 2]  # 16x16, L=2: levels of 8 and 4 rows
    for r, out in enumerate(outs):
        assert out["mesh"] == (data, model, r // model, r % model)
        assert out["cfg"]["sharded"] == sharded and out["fused_cfg"]["sharded"] == sharded
        _assert_sd_close(out["ddi"], want_ddi, atol=1e-5)
        got = out["cfg"]
        np.testing.assert_allclose(got["nll"].numpy(), np.asarray(nll), rtol=2e-4)
        np.testing.assert_allclose(got["recon"].numpy(), x, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["sample"].numpy(), want["sample"].numpy(), atol=1e-5)
        for d in range(data):  # every data rank drew the same (local) sample
            np.testing.assert_allclose(got["sample_gen"][d * per:(d + 1) * per].numpy(),
                                       want["sample_gen"].numpy(), atol=1e-5)
        got = out["fused_cfg"]
        np.testing.assert_allclose(got["nll"].numpy(), fused_want["nll"].numpy(), rtol=1e-5)
        assert torch.equal(got["recon"], fused_want["recon"])
        assert torch.equal(got["sample"], fused_want["sample"])
        for d in range(data):
            assert torch.equal(got["sample_gen"][d * per:(d + 1) * per], fused_want["sample_gen"])
    for d in range(data):  # the exchange, within each model group
        group = outs[d * model:(d + 1) * model]
        for i, (k, rows) in enumerate(exchange):
            whole = slab_x[:, :rows * model]
            padded, grad = _expected_exchange(whole, [o["exchange"][i]["cot"] for o in group],
                                              k, model)
            for m, o in enumerate(group):
                assert torch.equal(o["exchange"][i]["padded"], padded[m])
                torch.testing.assert_close(o["exchange"][i]["grad"], grad, rtol=0, atol=1e-6)


def _jax_steps_sp(jcfg, params, batches, mesh):
    """`make_train_step` under jax.set_mesh(mesh) from `params` (TP and SP
    on one model axis): each step's metrics, the params and the EMA as
    port state dicts."""
    jtx = joptim.make_optimizer(JaxOptimConfig(**OCFG), JaxTrainConfig())
    trainable, _ = partition(params)
    with jax.set_mesh(mesh):
        opt_state = jtx.init(trainable)
        ema = jax.tree.map(jnp.copy, trainable)
        jstate = {"step": jnp.zeros((), jnp.int32), "params": jmesh.shard_params(mesh, params),
                  "opt_state": jax.device_put(opt_state, jmesh.param_shardings(mesh, opt_state)),
                  "rng": jax.random.key(0),
                  "ema": jax.device_put(ema, jmesh.param_shardings(mesh, ema))}
        jtrain = jstep.make_train_step(jcfg, jtx, 0.999,
                                       joptim.make_schedule(JaxOptimConfig(**OCFG)))
        metrics = []
        for batch in batches:
            jstate, jm = jtrain(jstate,
                                jax.device_put(jnp.asarray(batch), jmesh.batch_sharding(mesh)))
            metrics.append({k: float(v) for k, v in jm.items()})
    jparams = jax.tree.map(np.asarray, jax.device_get(jstate["params"]))
    _, jfrozen = partition(jparams)
    tcfg = GlowConfig(**{k: v for k, v in SP.items() if k != "hidden_channels"},
                      hidden_channels=64, dequant="none")
    ema_sd = merge(jax.tree.map(np.asarray, jax.device_get(jstate["ema"])), jfrozen)
    return (metrics, state_dict_from_jax(jparams, tcfg), state_dict_from_jax(ema_sd, tcfg))


@pytest.mark.multiprocess
def test_three_sharded_train_steps_match_jax_mesh(eight_devices, tmp_path):
    """Three noise-free train steps (EMA on, constant lr 1e-3) at hidden 64
    on 4 gloo ranks as (data=2, model=2) with the rows over the model
    group, against JAX's `make_train_step` under jax.set_mesh on the
    matching mesh with `shard_spatial`, where the coupling nets are
    tensor-parallel too: loss rtol 2e-5, grad_norm rtol 1e-4, params and
    EMA rtol 2e-4, atol 2e-5.  Every rank reports the same numbers."""
    kw = dict(SP, hidden_channels=64, dequant="none")
    params = _nontrivial_params(JaxGlowConfig(**kw))
    sd = _tensors(state_dict_from_jax(jax.tree.map(np.asarray, params), GlowConfig(**kw)))
    batches = [_images(4, (16, 16, 3), seed=30 + i) for i in range(3)]
    outs = _run("steps", {"cfg": kw, "mesh": (2, 2), "spatial": True, "sd": sd,
                          "batches": [torch.from_numpy(b) for b in batches],
                          "optim": OCFG, "train": dict(ema_decay=0.999)}, 4, tmp_path)
    jm, want_params, want_ema = _jax_steps_sp(JaxGlowConfig(**kw), params, batches,
                                              _jax_mesh(2, 2, eight_devices))
    for out in outs:
        assert out["shard_shapes"] == {}  # the coupling nets stay replicated
        for got, want in zip(out["metrics"], jm):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
        _assert_sd_close(out["params"], want_params, atol=2e-5, rtol=2e-4)
        _assert_sd_close(out["ema"], want_ema, atol=2e-5, rtol=2e-4)
        assert out["metrics"] == outs[0]["metrics"]


def _profile(out_dir, mesh=(-1, 1), num_steps=2):
    return Profile(
        name="sp",
        glow=GlowConfig(**FUSED),
        optim=OptimConfig(lr=1e-3, warmup_steps=10),
        train=TrainConfig(batch_size=4, num_steps=num_steps, scalar_log_gap=2, plot_gap=0,
                          checkpoint_gap=2, ema_decay=0.99, seed=0),
        data=DataConfig(name="synthetic_textured"),
        mesh=MeshConfig(*mesh),
        out_dir=str(out_dir),
    )


@pytest.mark.multiprocess
def test_sharded_snapshot_resumes_on_one_rank(tmp_path):
    """`build` and `train` of a shard_spatial profile on 2 gloo ranks as
    (data=1, model=2), through the fused path's slab form: one loss on both
    ranks, equal to the one-rank run's from the same start (rtol 2e-5), and
    a snapshot that one rank restores bit for bit."""
    out = tmp_path / "runs"
    runs = _run("build_train", {"profile": profile_to_dict(_profile(out, mesh=(1, 2))),
                                "num_steps": 2}, 2, tmp_path)
    assert [r["mesh"] for r in runs] == [(1, 2, 0, 0), (1, 2, 0, 1)]
    assert len({r["result"]["loss"] for r in runs}) == 1
    built = build(_profile(out), device="cpu")
    assert built.resumed and built.start_step == 2 and built.mesh is None
    for name, t in built.state["model"].state_dict().items():
        assert torch.equal(t, runs[0]["params"][name]), name
    from pytorch_glow_tpu_torch import train

    one = train(build(_profile(tmp_path / "one"), device="cpu"), quiet=True)
    np.testing.assert_allclose(runs[0]["result"]["loss"], one["loss"], rtol=2e-5)
