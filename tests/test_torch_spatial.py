"""Spatial sharding of the port on the CPU: image rows over the mesh's model
group (`parallel/spatial.py`), on gloo ranks (`tests/torch_parallel_worker.py`,
which imports no JAX) against the JAX package under `jax.set_mesh` with
`shard_spatial=True` on the 8 virtual CPU devices, and against the port on
one rank; and the slab form of the band chain's plain versions in one
process.

With model > 1 the coupling nets are tensor-parallel as well (JAX's
`param_pspec` on the same "model" axis): each rank holds hidden/n of
conv1's weight and actnorm and of conv2's weight, and of their optimizer
moments and EMA entries; the sharded levels' nets gather them.

Bounds: JAX's own (`tests/test_sharding.py`): the nll rtol 2e-4,
three train steps' loss rtol 2e-5, grad_norm rtol 1e-4 and params and
EMA rtol 2e-4, atol 2e-5; DDI atol 1e-5 (`tests/test_torch_parallel.py`);
the f32 round trip within 1e-5.  The fused path (the band chain's plain
version on slabs) against the port's unsharded fused path: the same bits
for the images, the nll within 1e-5 relative (the logdet's partials
summed over ranks).  Collectives against slices and sums of the whole
tensor within 1e-6 (f32 sums in another order).
"""

import dataclasses
import shutil

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
from pytorch_glow_tpu_torch.parallel import mesh as tmesh
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


def test_levels_shard_where_rows_divide():
    """celebahq256's six levels (128 .. 4 rows): all on slabs at model=2
    and at model=4 (the deepest one row a rank), as JAX's
    `_maybe_shard_spatial` shards every level whose rows divide the axis;
    at model=8 the 4-row level runs whole; nothing without shard_spatial,
    on a mesh not made for it, or with model=1."""
    cfg = PRESETS["celebahq256"].glow
    assert cfg.shard_spatial

    def mesh(model, spatial=True):
        return dataclasses.make_dataclass("M", ["model", "spatial"])(model, spatial)

    rows = [h for h, _, _ in cfg.latent_shapes()]
    assert rows == [128, 64, 32, 16, 8, 4]
    assert [spatial.level_sharded(cfg, mesh(2), h) for h in rows] == [True] * 6
    assert [spatial.level_sharded(cfg, mesh(4), h) for h in rows] == [True] * 6
    assert [spatial.level_sharded(cfg, mesh(8), h) for h in rows] == [True] * 5 + [False]
    assert not any(spatial.level_sharded(cfg, mesh(1), h) for h in rows)
    assert not spatial.level_sharded(dataclasses.replace(cfg, shard_spatial=False), mesh(2), 128)
    assert not spatial.level_sharded(cfg, None, 128)
    assert not spatial.level_sharded(cfg, mesh(2, spatial=False), 128)


def _assert_tp_shards(shapes: dict, kw: dict, model: int) -> None:
    """Each coupling net's conv1 weight and actnorm and conv2 weight hold
    hidden/model channels, and nothing else is sharded."""
    h = kw["hidden_channels"]
    assert len(shapes) == 4 * kw["K"] * kw["L"], sorted(shapes)
    for name, shape in shapes.items():
        if name.endswith("f.0.weight"):
            assert shape[0] == h // model and shape[2:] == (3, 3), name
        elif name.endswith("f.2.weight"):
            assert shape == (h, h // model, 1, 1), name
        else:
            assert name.endswith(("f.0.actnorm.bias", "f.0.actnorm.logs")), name
            assert shape == (1, h // model, 1, 1), name


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


@pytest.mark.parametrize("n", [2, 4, 16, 32])
@pytest.mark.parametrize("mode", ["affine", "additive"])
def test_slab_band_versions_match_the_whole_step(small_bands, mode, n):  # noqa: F811
    """n slabs (16 rows: two bands of 8, folded inside the slab; 8 rows: one
    band; 2 rows: one band as tall as its halo; 1 row: one band of R=1,
    its halo rows reaching two slabs away) of a 32-row batch: the
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
    """On gloo ranks as (data, model), each rank on its data rows and its
    hidden/model of the coupling nets (asserted): DDI
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
    sharded = [True, True]  # 16x16, L=2: levels of 8 and 4 rows (one row a rank at model=4)
    for r, out in enumerate(outs):
        assert out["mesh"] == (data, model, r // model, r % model)
        assert out["cfg"]["sharded"] == sharded and out["fused_cfg"]["sharded"] == sharded
        _assert_tp_shards(out["cfg"]["shard_shapes"], SP, model)
        _assert_tp_shards(out["fused_cfg"]["shard_shapes"], FUSED, model)
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


def _three_steps(eight_devices, tmp_path, data: int, model: int) -> None:
    """Three noise-free train steps (EMA on, constant lr 1e-3) at hidden 64
    on gloo ranks as (data, model) with the rows over the model group,
    against JAX's `make_train_step` under jax.set_mesh on the matching mesh
    with `shard_spatial`, where the coupling nets are tensor-parallel too:
    loss rtol 2e-5, grad_norm rtol 1e-4, params and EMA rtol 2e-4, atol
    2e-5.  Every rank reports the same numbers, holds hidden/model of each
    net's conv1 and conv2, and stores as many elements of each flat
    optimizer vector and of the EMA as of its trainables, a 1/model share
    of the sharded entries."""
    kw = dict(SP, hidden_channels=64, dequant="none")
    params = _nontrivial_params(JaxGlowConfig(**kw))
    sd = _tensors(state_dict_from_jax(jax.tree.map(np.asarray, params), GlowConfig(**kw)))
    batches = [_images(4, (16, 16, 3), seed=30 + i) for i in range(3)]
    outs = _run("steps", {"cfg": kw, "mesh": (data, model), "spatial": True, "sd": sd,
                          "batches": [torch.from_numpy(b) for b in batches],
                          "optim": OCFG, "train": dict(ema_decay=0.999)}, data * model, tmp_path)
    jm, want_params, want_ema = _jax_steps_sp(JaxGlowConfig(**kw), params, batches,
                                              _jax_mesh(data, model, eight_devices))
    one = init_glow(GlowConfig(**kw), torch.Generator().manual_seed(0), "cpu")
    total = sum(p.numel() for p in one.parameters() if p.requires_grad)
    tp = sum(p.numel() for n, p in one.named_parameters() if tmesh.param_pspec(n, True) is not None)
    for out in outs:
        _assert_tp_shards(out["shard_shapes"], kw, model)
        stored = out["stored"]
        assert stored["params"] == total - tp + tp // model
        assert set(stored.values()) == {stored["params"]}, stored
        for got, want in zip(out["metrics"], jm):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
        _assert_sd_close(out["params"], want_params, atol=2e-5, rtol=2e-4)
        _assert_sd_close(out["ema"], want_ema, atol=2e-5, rtol=2e-4)
        assert out["metrics"] == outs[0]["metrics"]


@pytest.mark.multiprocess
def test_three_sharded_train_steps_match_jax_mesh(eight_devices, tmp_path):
    """`_three_steps` on 4 gloo ranks as (data=2, model=2): slabs of 4 and
    2 rows."""
    _three_steps(eight_devices, tmp_path, 2, 2)


@pytest.mark.multiprocess
def test_three_tp_sp_train_steps_on_one_row_slabs_match_jax_mesh(eight_devices, tmp_path):
    """`_three_steps` on 4 gloo ranks as (data=1, model=4): slabs of 2 rows
    and, at the deeper level, of one row, whose fused-halo and unfused
    exchanges come from ranks beyond the neighbours; each net's gathered
    shards' gradients reduce-scattered over four ranks."""
    _three_steps(eight_devices, tmp_path, 1, 4)


@pytest.mark.multiprocess
def test_gathered_shard_backward_and_short_slab_exchange(tmp_path):
    """On 4 gloo ranks as (data=1, model=4): `gather_from_model` of two
    shards (sharded on dims 1 and 0) in one collective gives the whole
    tensors on every rank; its backward keeps this rank's slice of its own
    cotangents on a whole level, and of the four ranks' summed cotangents
    on a sharded level (a reduce-scatter).  The halo exchange of one-row
    slabs with 2 and 3 rows each side (ranks up to three away; zeros
    beyond the image), forward and backward, against slices of the whole
    tensor and the padded cotangents added at their rows."""
    rng = np.random.default_rng(7)
    full = [(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)), dim)
            for shape, dim in (((3, 8, 2), 1), ((8, 3), 0))]
    slab_x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 4, 3, 2))
                              .astype(np.float32))
    exchange = [(2, 1), (3, 1)]
    outs = _run("collectives", {"mesh": (1, 4), "full": full, "slab_x": slab_x,
                                "exchange": exchange}, 4, tmp_path)
    for i, (t, dim) in enumerate(full):
        total = sum(o["cots"][i] for o in outs)
        for m, o in enumerate(outs):
            assert o["mesh"] == (1, 4, 0, m)
            for key in ("whole", "partial"):
                assert torch.equal(o[key]["full"][i], t)
            torch.testing.assert_close(o["whole"]["grads"][i],
                                       o["cots"][i].narrow(dim, 2 * m, 2), rtol=0, atol=0)
            torch.testing.assert_close(o["partial"]["grads"][i], total.narrow(dim, 2 * m, 2),
                                       rtol=0, atol=1e-6)
    for i, (k, rows) in enumerate(exchange):
        padded, grad = _expected_exchange(slab_x[:, :rows * 4],
                                          [o["exchange"][i]["cot"] for o in outs], k, 4)
        for m, o in enumerate(outs):
            assert torch.equal(o["exchange"][i]["padded"], padded[m])
            torch.testing.assert_close(o["exchange"][i]["grad"], grad, rtol=0, atol=1e-6)


@pytest.mark.multiprocess
def test_tp_sp_ddi_matches_jax_mesh_with_a_whole_level(eight_devices, tmp_path):
    """DDI and the DDI'd nll of a 3-level model (rows 8, 4, 2) on 4 gloo
    ranks as (data=1, model=4): the two sharded levels' nets gathered
    (conv1's actnorm from the whole width's statistics, each rank keeping
    its slice), the 2-row level whole on every rank with its nets column /
    row parallel; against JAX's DDI and log_prob under jax.set_mesh with
    `shard_spatial` (atol 1e-5, rtol 2e-4), shards of hidden/4 asserted."""
    kw = dict(SP, L=3)
    params, sd = _sd(kw, 3)
    x = np.random.default_rng(9).uniform(size=(4, 16, 16, 3)).astype(np.float32)
    outs = _run("ddi_loss", {"cfg": kw, "mesh": (1, 4), "spatial": True, "sd": sd,
                             "x": torch.from_numpy(x)}, 4, tmp_path)
    jcfg = JaxGlowConfig(**kw)
    mesh = _jax_mesh(1, 4, eight_devices)
    with jax.set_mesh(mesh):
        xs = jax.device_put(jnp.asarray(x), jmesh.batch_sharding(mesh))
        p_sh = jax.jit(lambda p, x: jglow.ddi_init(p, x, jcfg))(jmesh.shard_params(mesh, params),
                                                                xs)
        nll = jax.jit(lambda p, x: jglow.log_prob(p, x, jcfg)["nll"])(p_sh, xs)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(p_sh)), GlowConfig(**kw))
    for out in outs:
        _assert_tp_shards(out["shard_shapes"], kw, 4)
        _assert_sd_close(out["ddi"], want, atol=1e-5)
        np.testing.assert_allclose(out["nll"].numpy(), np.asarray(nll), rtol=2e-4)
    torch.testing.assert_close(outs[0]["ddi"], outs[-1]["ddi"], rtol=0, atol=0)


@pytest.mark.multiprocess
def test_tp_sp_model_exports_whole_weights(tmp_path):
    """`export_artifact` of a model holding TP shards on row slabs, on 2
    gloo ranks as (data=1, model=2): each rank's artifact (the portable
    unfused path, no mesh) serves the nll of the one-rank model's artifact
    bit for bit."""
    from pytorch_glow_tpu_torch import serve

    _, sd = _sd(SP, 5)
    x = torch.from_numpy(np.random.default_rng(11).uniform(size=(4, 16, 16, 3))
                         .astype(np.float32))
    outs = _run("export", {"cfg": SP, "sd": sd, "mesh": (1, 2), "spatial": True,
                           "dir": str(tmp_path / "art"), "batch": 4, "functions": ["nll"]},
                2, tmp_path)
    one = tmp_path / "one"
    serve.export_artifact(_port_model(dict(SP, shard_spatial=False), sd), None, str(one), 4,
                          ("nll",))
    want = serve.load_artifact(str(one)).nll(x)
    for out in outs:
        assert out["holds_shards"]
        _assert_tp_shards(out["shard_shapes"], SP, 2)
        assert torch.equal(serve.load_artifact(out["dir"]).nll(x), want)


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
    (data=1, model=2), through the fused path's slab form with the coupling
    nets tensor-parallel: one loss on both ranks, equal to the one-rank
    run's from the same start (rtol 2e-5), and a snapshot that one rank
    restores bit for bit."""
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


@pytest.mark.multiprocess
def test_one_rank_snapshot_restores_onto_tp_sp(tmp_path):
    """A one-rank run's step-2 snapshot restored by `build` on 4 gloo ranks
    as (data=1, model=4) (TP and rows sharded, one-row slabs at the deeper
    level): the model, the optimizer's state and the EMA, gathered back,
    bitwise the snapshot's; then a step on the ranks and on one rank from
    that snapshot give the same loss (rtol 2e-5)."""
    from pytorch_glow_tpu_torch import train

    out = tmp_path / "runs"
    train(build(_profile(out), device="cpu"), quiet=True)
    snap = torch.load(out / "sp" / "checkpoints" / "2.pt", weights_only=False)
    shutil.copytree(out, tmp_path / "one")
    runs = _run("build_train", {"profile": profile_to_dict(_profile(out, mesh=(1, 4),
                                                                    num_steps=3)),
                                "num_steps": 3, "restored": True}, 4, tmp_path)
    one = train(build(_profile(tmp_path / "one", num_steps=3), device="cpu"), quiet=True)
    for r in runs:
        assert r["resumed"] and r["start_step"] == 2 and r["mesh"][:2] == (1, 4)
        got = r["restored"]
        for name, t in snap["model"].items():
            assert torch.equal(got["model"][name], t), name
        for k, v in snap["opt_state"].items():
            assert torch.equal(got["opt_state"][k], v), k
        assert all(torch.equal(a, b) for a, b in zip(got["ema"], snap["ema"]))
        np.testing.assert_allclose(r["result"]["loss"], one["loss"], rtol=2e-5)
