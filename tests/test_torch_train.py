"""The port's training path against the JAX package's: loss and grads,
the optimizer chain against optax, three train steps, the synthetic data,
and `build` -> `train` on the CPU.

Weights go JAX -> port through `state_dict_from_jax`, gradients the same
way (the conversion is linear); images and noise are numpy."""

import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_glow_tpu.config import DataConfig as JaxDataConfig
from pytorch_glow_tpu.config import GlowConfig as JaxGlowConfig
from pytorch_glow_tpu.config import OptimConfig as JaxOptimConfig
from pytorch_glow_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_glow_tpu.data import pipeline
from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu.ops import flowstep_pallas as fsp
from pytorch_glow_tpu.train import optim as joptim
from pytorch_glow_tpu.train import step as jstep
from pytorch_glow_tpu.utils.tree import merge, partition
from pytorch_glow_tpu_torch import (
    DataConfig,
    GlowConfig,
    OptimConfig,
    Profile,
    TrainConfig,
    build,
    make_optimizer,
    train,
)
from pytorch_glow_tpu_torch.data import pipeline as tpipeline
from pytorch_glow_tpu_torch.data import synthetic
from pytorch_glow_tpu_torch.ops import flowstep as tfs
from pytorch_glow_tpu_torch.train import step as tstep
from pytorch_glow_tpu_torch.train.optim import make_schedule
from pytorch_glow_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_model import PALLAS, SMALL, _cfgs, _nontrivial_params, _port


def _images(n, shape=(8, 8, 3), seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *shape), dtype=np.uint8)


def _grads_as_state_dict(grads, frozen, cfg):
    return state_dict_from_jax(jax.tree.map(np.asarray, merge(grads, frozen)), cfg)


def _assert_scaled_close(got, want, atol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1e-3, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("impl", ["xla", "pallas", "invconv"])
def test_loss_and_grads_match_jax(monkeypatch, impl):
    """`loss_fn` and its parameter grads against `jax.value_and_grad`, with
    explicit dequantisation noise; unfused at f32, fused at f32 coupling on
    both sides (the port's FusedStep and plain backward against the JAX
    custom VJP and interpreted kernels), and unfused with
    invconv_impl="pallas" (the 1x1 conv wrappers' plain version against
    the JAX K6 kernels' custom VJP).  Bounds: loss rtol 2e-5 and each grad
    within 1e-4 of its largest magnitude, f32 sums in another order
    through 8 flow steps and two priors."""
    if impl == "pallas":
        monkeypatch.setattr(fsp, "COUPLING_DTYPE", jnp.float32)
        monkeypatch.setattr(tfs, "COUPLING_DTYPE", torch.float32)
        fsp._partitioned.cache_clear()
        fsp._partitioned_bwd.cache_clear()
    jcfg, tcfg = _cfgs({"xla": dict(SMALL), "pallas": dict(PALLAS, hidden_channels=16),
                        "invconv": dict(SMALL, invconv_impl="pallas")}[impl])
    params = _nontrivial_params(jcfg)
    rng = np.random.default_rng(4)
    x = (_images(4).astype(np.float32) + rng.uniform(size=(4, 8, 8, 3))) / 256.0
    x = x.astype(np.float32)
    trainable, frozen = partition(params)
    (loss_j, metrics_j), grads_j = jax.value_and_grad(
        lambda tr: jglow.loss_fn(merge(tr, frozen), jnp.asarray(x), jcfg), has_aux=True)(trainable)
    want = _grads_as_state_dict(grads_j, frozen, tcfg)
    fsp._partitioned.cache_clear()
    fsp._partitioned_bwd.cache_clear()

    model = _port(params, tcfg)
    loss, metrics = model.loss_fn(torch.from_numpy(x))
    loss.backward()
    assert sorted(metrics) == sorted(metrics_j) == ["loss", "nll"]
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-5)
    for name, p in model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        _assert_scaled_close(got.numpy(), want[name], 1e-4, name)


OPT_CASES = [
    ("adam", "constant", 1), ("adam", "warmup", 2), ("adam", "noam", 1),
    ("adamax", "constant", 2), ("adamax", "warmup", 1), ("adamax", "noam", 1),
]


@pytest.mark.parametrize("name,schedule,accum", OPT_CASES)
def test_optimizer_matches_optax(name, schedule, accum):
    """The chain over 8 steps of grads: large ones trip the value clip and
    the global-norm clip; one with a NaN is skipped, leaving the inner
    state (count, moments, accumulator) alone.  f32 on both sides: rtol
    1e-5 on the parameters."""
    ocfg = dict(name=name, lr=1e-2, schedule=schedule, warmup_steps=3)
    tcfg = dict(grad_accum=accum, max_grad_clip=5.0, max_grad_norm=100.0,
                skip_nonfinite_updates=3)
    jtx = joptim.make_optimizer(JaxOptimConfig(**ocfg), JaxTrainConfig(**tcfg))
    ttx = make_optimizer(OptimConfig(**ocfg), TrainConfig(**tcfg))
    rng = np.random.default_rng(1)
    shapes = {"a": (20, 30), "b": (7,)}
    params = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
    ours = [torch.from_numpy(np.array(params[k])) for k in sorted(shapes)]
    jstate, tstate = jtx.init(params), ttx.init(ours)
    jupdate = jax.jit(jtx.update)
    accepted = applied = 0
    for i, scale in enumerate([1.0, 50.0, 1.0, np.nan, 0.1, 50.0, 1.0, 1.0]):
        grads = {k: (scale if np.isfinite(scale) else 1.0) * rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        if not np.isfinite(scale):
            grads["a"][3, 4] = np.nan
        before = [p.clone() for p in ours]
        count = int(tstate["count"])
        upd, jstate = jupdate({k: jnp.asarray(v) for k, v in grads.items()}, jstate, params)
        params = optax.apply_updates(params, upd)
        flat = ttx.flatten(ours, [torch.from_numpy(grads[k]) for k in sorted(shapes)])
        updates, tstate = ttx.update(flat, tstate)
        ttx.apply(ours, updates)
        for k, p in zip(sorted(shapes), ours):
            np.testing.assert_allclose(p.numpy(), np.asarray(params[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        assert int(tstate["notfinite_count"]) == int(jstate.notfinite_count)
        assert int(tstate["total_notfinite"]) == int(jstate.total_notfinite)
        if np.isfinite(scale):
            accepted += 1
            applied += accepted % accum == 0
        else:
            assert all(torch.equal(a, b) for a, b in zip(ours, before))
            assert int(tstate["count"]) == count
    assert int(tstate["count"]) == applied


def test_three_train_steps_match_jax():
    """Three steps of the port against `steplib.make_train_step` from the
    same parameters: no dequantisation noise, EMA on, constant lr 1e-3.
    Bounds: loss rtol 2e-5 and grad_norm rtol 1e-4 (f32 sums in another
    order); parameters and EMA atol 2e-5: Adam's first steps move every
    parameter by about lr whatever its grad's size, so agreement is the
    update's roundoff on top of the grads', far below one lr."""
    jcfg, tcfg = _cfgs(dict(SMALL, dequant="none"))
    params = _nontrivial_params(jcfg)
    ocfg = dict(schedule="constant", lr=1e-3)
    jtx = joptim.make_optimizer(JaxOptimConfig(**ocfg), JaxTrainConfig())
    trainable, frozen = partition(params)
    jstate = {"step": jnp.zeros((), jnp.int32), "params": params,
              "opt_state": jtx.init(trainable), "rng": jax.random.key(0),
              "ema": jax.tree.map(jnp.copy, trainable)}
    jtrain = jstep.make_train_step(jcfg, jtx, 0.999, joptim.make_schedule(JaxOptimConfig(**ocfg)))

    model = _port(params, tcfg)
    ttx = make_optimizer(OptimConfig(**ocfg), TrainConfig())
    tstate = tstep.init_state(model, ttx, 0.999)
    ttrain = tstep.make_train_step(tcfg, ttx, 0.999, make_schedule(OptimConfig(**ocfg)))
    for i in range(3):
        batch = _images(4, seed=10 + i)
        jstate, jm = jtrain(jstate, jnp.asarray(batch))
        tstate, tm = ttrain(tstate, torch.from_numpy(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    assert tstate["step"] == 3
    _, jfrozen = partition(jstate["params"])
    want_params = state_dict_from_jax(jax.tree.map(np.asarray, jstate["params"]), tcfg)
    want_ema = _grads_as_state_dict(jstate["ema"], jfrozen, tcfg)
    ema = tstep.ema_params(tstate)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name], atol=2e-5, err_msg=name)
        np.testing.assert_allclose(ema[name].numpy(), want_ema[name], atol=2e-5, err_msg=name)


@pytest.mark.parametrize("family", ["synthetic", "synthetic_smooth", "synthetic_textured"])
def test_synthetic_batches_equal_jax_pipeline(family):
    """Each family's batches, and `make_dataset`'s train and test splits
    (the test split on its own seed offset), byte for byte the JAX
    pipeline's."""
    kind = pipeline.SYNTHETIC_NAMES[family]
    assert synthetic.SYNTHETIC_NAMES[family] == kind
    for seed in (0, 7):
        ours = synthetic.synthetic_batches(4, (8, 8, 3), None, seed, kind)
        theirs = pipeline.synthetic_batches(4, (8, 8, 3), None, seed, kind)
        for index in (0, 5):
            ours.set_state({"next_index": index})
            theirs.set_state({"next_index": index})
            a, b = next(ours)["image"], next(theirs)["image"]
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b, err_msg=f"seed {seed} index {index}")
    glow = dict(image_shape=(8, 8, 3), hidden_channels=16, K=2, L=2)
    firsts = {}
    for split in ("train", "test"):
        ours = tpipeline.make_dataset(DataConfig(name=family), GlowConfig(**glow),
                                      TrainConfig(batch_size=4, seed=3), split=split)
        theirs = pipeline.make_dataset(JaxDataConfig(name=family), JaxGlowConfig(**glow),
                                       JaxTrainConfig(batch_size=4, seed=3), split=split)
        for index in range(2):
            a, b = next(ours)["image"], next(theirs)["image"]
            np.testing.assert_array_equal(a, b, err_msg=f"{split} batch {index}")
            firsts.setdefault(split, a)
    assert not np.array_equal(firsts["train"], firsts["test"])


def _profile(tmp_path, data="celeba", **train):
    glow = GlowConfig(image_shape=(8, 8, 3), hidden_channels=16, K=2, L=2,
                      compute_dtype="bfloat16", flowstep_impl="pallas")
    kw = dict(batch_size=4, scalar_log_gap=2, plot_gap=0, checkpoint_gap=0, ema_decay=0.99)
    kw.update(train)
    return Profile(name="t", glow=glow, train=TrainConfig(**kw), data=DataConfig(name=data),
                   out_dir=str(tmp_path))


def test_build_and_train_on_cpu(tmp_path, capsys):
    """The unchanged data name falls back to synthetic data with the JAX
    package's warning; a few fused steps give finite metrics and a CSV."""
    built = build(_profile(tmp_path), device="cpu")
    assert "dataset 'celeba' not found" in capsys.readouterr().out
    result = train(built, num_steps=4, quiet=True)
    assert result["final_step"] == 4 and result["checkpoint_saved"] is True
    assert {"loss", "nll", "grad_norm", "lr", "images_per_sec"} <= set(result)
    assert all(np.isfinite(result[k]) for k in ("loss", "nll", "grad_norm", "lr"))
    rows = (tmp_path / "t" / "metrics.csv").read_text().strip().splitlines()
    assert rows[0].startswith("step,") and len(rows) == 3
    # A second call continues from the state's step.
    assert train(built, num_steps=6, quiet=True)["final_step"] == 6


def test_steps_per_call_keeps_the_trajectory(tmp_path):
    states = []
    for spc in (1, 2):
        built = build(_profile(tmp_path / str(spc), data="synthetic_textured",
                               steps_per_call=spc), device="cpu")
        train(built, num_steps=4, quiet=True)
        states.append(built.state["model"].state_dict())
    for name, value in states[0].items():
        assert torch.equal(value, states[1][name]), name


def test_flips_are_deterministic_per_step(tmp_path):
    runs = []
    for i, flip in enumerate((True, True, False)):
        built = build(_profile(tmp_path / str(i), data="synthetic", augment_flip=flip),
                      device="cpu")
        train(built, num_steps=2, quiet=True)
        runs.append(built.state["model"].state_dict())
    assert all(torch.equal(v, runs[1][k]) for k, v in runs[0].items())
    assert not all(torch.equal(v, runs[2][k]) for k, v in runs[0].items())


# ---------------------------------------------------------------------------
# The step-liveness watchdog
# ---------------------------------------------------------------------------


def _watchdog(monkeypatch, timeout_s=0.2):
    from pytorch_glow_tpu_torch.train import trainer as ttrainer

    fired = threading.Event()
    wd = ttrainer._StepWatchdog(timeout_s, poll_s=0.01)
    monkeypatch.setattr(wd, "_die", fired.set)
    return wd, fired


def test_watchdog_fires_on_a_stalled_beat(monkeypatch, capsys):
    wd, fired = _watchdog(monkeypatch)
    wd.beat()
    wd.beat()  # arms
    assert fired.wait(5.0)
    assert "step-liveness watchdog" in capsys.readouterr().err
    wd.stop()


def test_watchdog_stays_quiet_while_beats_land(monkeypatch):
    wd, fired = _watchdog(monkeypatch)
    for _ in range(40):
        wd.beat()
        time.sleep(0.01)
    wd.stop()
    assert not fired.is_set()
    # One beat alone never arms it (the first call pays the kernel build).
    wd, fired = _watchdog(monkeypatch, timeout_s=0.05)
    wd.beat()
    assert not fired.wait(0.3)


@pytest.mark.parametrize("budget", ["0", "2"])
def test_watchdog_exits_17_or_reexecs_within_its_budget(monkeypatch, budget):
    from pytorch_glow_tpu_torch.train import trainer as ttrainer

    calls = []
    monkeypatch.setenv("GLOW_WEDGE_RESTART_BUDGET", budget)
    monkeypatch.setattr(ttrainer.os, "_exit", lambda code: calls.append(("exit", code)))
    monkeypatch.setattr(ttrainer.os, "execv", lambda exe, argv: calls.append(("execv", exe)))
    ttrainer._StepWatchdog(1.0)._die()
    if budget == "0":
        assert calls == [("exit", ttrainer.WEDGE_EXIT_CODE)] and ttrainer.WEDGE_EXIT_CODE == 17
    else:
        assert calls[0] == ("execv", sys.executable)
        assert os.environ["GLOW_WEDGE_RESTART_BUDGET"] == "1"


def test_step_timeout_runs_no_per_call_sync(tmp_path, monkeypatch):
    """With `step_timeout_s` set, the device syncs only after the first call
    (and at log boundaries, through the logged scalars), not per call; the
    watchdog beats once per loop iteration and once before the snapshot."""
    from pytorch_glow_tpu_torch.train import trainer as ttrainer

    syncs, beats = [], []
    monkeypatch.setattr(ttrainer, "_sync", lambda device: syncs.append(device))
    real_beat = ttrainer._StepWatchdog.beat
    monkeypatch.setattr(ttrainer._StepWatchdog, "beat",
                        lambda self: (beats.append(1), real_beat(self)))
    built = build(_profile(tmp_path, data="synthetic", step_timeout_s=1800), device="cpu")
    assert train(built, num_steps=6, quiet=True)["final_step"] == 6
    assert len(syncs) == 1 and len(beats) == 7
