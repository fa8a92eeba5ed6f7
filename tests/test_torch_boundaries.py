"""The trainer's boundaries in the port against the JAX package's: SWD, the
eval, sample and reconstruct functions, the model summary, best-snapshot
tracking, `build(restore="best")`, a trainer run through every gap, SIGTERM,
`--retries`, `infer --best`, TensorBoard, and the true-f32 pin.

Weights go JAX -> port through `state_dict_from_jax`; images and latents are
numpy.  Runs on the CPU at tiny shapes; the JAX fused path runs its kernels
in interpret mode, as the JAX package's own tests run them."""

import csv
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from pytorch_glow_tpu.models import glow as jglow
from pytorch_glow_tpu.train import step as jstep
from pytorch_glow_tpu.utils import summary as jsummary
from pytorch_glow_tpu.utils import swd as jswd
from pytorch_glow_tpu.utils.tree import partition
from pytorch_glow_tpu_torch import (
    DataConfig,
    GlowConfig,
    OptimConfig,
    Profile,
    TrainConfig,
    build,
    init_glow,
    make_optimizer,
    train,
)
from pytorch_glow_tpu_torch.cli import infer as infer_cli
from pytorch_glow_tpu_torch.cli import train as train_cli
from pytorch_glow_tpu_torch.scripts import run_summary
from pytorch_glow_tpu_torch.train import builder as tbuilder
from pytorch_glow_tpu_torch.train import step as tstep
from pytorch_glow_tpu_torch.train import trainer as ttrainer
from pytorch_glow_tpu_torch.utils import checkpoint as tcheckpoint
from pytorch_glow_tpu_torch.utils import summary as tsummary
from pytorch_glow_tpu_torch.utils import swd as tswd
from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager
from pytorch_glow_tpu_torch.utils.metrics import MetricLogger
from test_torch_model import PALLAS, SMALL, _cfgs, _nontrivial_params, _port

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"xla": dict(SMALL), "pallas": dict(PALLAS),
           "additive": dict(SMALL, flow_coupling="additive")}


def _images(n, shape=(8, 8, 3), seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *shape), dtype=np.uint8)


# ---------------------------------------------------------------------------
# The functions a boundary runs, against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,seed", [((6, 16, 16, 3), 0), ((4, 32, 32, 3), 7),
                                        ((5, 20, 24, 1), 3)])
def test_swd_equals_jax_bit_for_bit(shape, seed):
    rng = np.random.default_rng(seed)
    real = rng.integers(0, 256, shape, dtype=np.uint8)
    fake = rng.integers(0, 256, shape, dtype=np.uint8)
    kw = dict(seed=seed, patches_per_image=16, n_projections=32)
    assert tswd.sliced_wasserstein(real, fake, **kw) == jswd.sliced_wasserstein(real, fake, **kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_eval_step_n_matches_jax(name):
    """Mean held-out bits/dim over 3 stacked batches, within rtol 2e-4 (the
    port's f32 sums in another order; the fused path at bf16 coupling on
    both sides, JAX's kernel interpreted)."""
    jcfg, tcfg = _cfgs(CONFIGS[name])
    params = _nontrivial_params(jcfg)
    batches = np.stack([_images(4, seed=i) for i in range(3)])
    want = float(jstep.make_eval_step_n(jcfg)(params, jnp.asarray(batches))["nll"])
    got = tstep.make_eval_step_n(tcfg)(_port(params, tcfg), torch.from_numpy(batches))["nll"]
    np.testing.assert_allclose(float(got), want, rtol=2e-4)


@pytest.mark.parametrize("name", ["xla", "additive"])
def test_reconstruct_fn_matches_jax(name):
    """uint8 out, equal on both sides for inputs at bin centres, where the
    f32 round-trip's error (under 2e-4 of a unit, far under half a bin)
    cannot cross a bin edge.  A uint8 input sits on a bin's lower edge
    (preprocess maps k to k/256), so either side's last-bit error may
    floor it to k - 1: within 1 there."""
    jcfg, tcfg = _cfgs(CONFIGS[name])
    params = _nontrivial_params(jcfg, seed=3)
    model = _port(params, tcfg)
    x = _images(4, seed=5)
    centres = ((x.astype(np.float32) + 0.5) / 256).astype(np.float32)
    want = np.asarray(jstep.make_reconstruct_fn(jcfg)(params, jnp.asarray(centres)))
    got = tstep.make_reconstruct_fn(tcfg)(model, torch.from_numpy(centres)).numpy()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)
    want = np.asarray(jstep.make_reconstruct_fn(jcfg)(params, jnp.asarray(x)))
    got = tstep.make_reconstruct_fn(tcfg)(model, torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    assert int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()) <= 1
    assert int(np.abs(got.astype(np.int16) - x.astype(np.int16)).max()) <= 1


@pytest.mark.parametrize("name", ["xla", "additive"])
def test_sample_path_on_explicit_latents_matches_jax(name):
    """The sample path's decode and postprocess on the same latents (the two
    RNGs differ, so the draws are numpy's): uint8 within 1."""
    jcfg, tcfg = _cfgs(CONFIGS[name])
    params = _nontrivial_params(jcfg, seed=4)
    model = _port(params, tcfg)
    x = np.random.default_rng(8).uniform(size=(3, *jcfg.image_shape)).astype(np.float32)
    z, _, splits, _ = jglow.encode(params, jnp.asarray(x), jcfg)
    rng = np.random.default_rng(9)
    z = np.asarray(z) + 0.7 * rng.standard_normal(z.shape).astype(np.float32)
    splits = [np.asarray(s) + 0.7 * rng.standard_normal(s.shape).astype(np.float32)
              for s in splits]
    want = np.asarray(jglow.postprocess(
        jglow.decode(params, jnp.asarray(z), jcfg, z_splits=[jnp.asarray(s) for s in splits]),
        jcfg))
    with torch.no_grad():
        got = model.postprocess(model.decode(
            torch.from_numpy(z), z_splits=[torch.from_numpy(s) for s in splits])).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()) <= 1


def test_sample_fn_takes_its_generator_and_temperature():
    tcfg = GlowConfig(**SMALL)
    model = init_glow(tcfg, torch.Generator().manual_seed(0), "cpu")
    fn = tstep.make_sample_fn(tcfg, 3, 0.7)
    a = fn(model, tstep.step_generator(2, 10, "cpu"))
    b = fn(model, tstep.step_generator(2, 10, "cpu"), 0.7)
    c = fn(model, tstep.step_generator(2, 10, "cpu"), 0.0)
    assert a.dtype == torch.uint8 and a.shape == (3, 8, 8, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("kw", [dict(SMALL), dict(SMALL, flow_coupling="additive", K=3),
                                dict(SMALL, flow_permutation="shuffle")])
def test_summary_matches_jax(kw):
    """FLOPs exactly; the parameter count is the trainable one (the JAX
    tree also holds the LU's frozen permutation and signs)."""
    jcfg, tcfg = _cfgs(kw)
    params = jglow.init_glow(jax.random.key(0), jcfg)
    model = init_glow(tcfg, device="cpu")
    assert tsummary.forward_flops_per_image(tcfg) == jsummary.forward_flops_per_image(jcfg)
    assert tsummary.param_count(model) == jsummary.param_count(partition(params)[0])
    assert tsummary.summarize(model, tcfg).startswith("Glow K=")


def test_serving_config_and_eval_copy_share_keys():
    g = GlowConfig(**SMALL, compute_dtype="bfloat16", flowstep_impl="xla")
    assert tbuilder.serving_config(g, torch.device("cpu")) is g
    served = tbuilder.serving_config(g, torch.device("cuda"))
    assert served.flowstep_impl == "pallas" and served.compute_dtype == "bfloat16"
    assert tbuilder.serving_config(GlowConfig(**SMALL), torch.device("cuda")).flowstep_impl == "xla"
    a = init_glow(g, torch.Generator().manual_seed(0), "cpu")
    b = init_glow(served, torch.Generator().manual_seed(0), "cpu")
    assert list(a.state_dict()) == list(b.state_dict())
    b.load_state_dict(a.state_dict())


# ---------------------------------------------------------------------------
# Best-snapshot tracking
# ---------------------------------------------------------------------------


def _state(step):
    model = torch.nn.Linear(2, 2)
    torch.nn.init.constant_(model.weight, float(step))
    return {"step": step, "seed": 0, "model": model, "opt_state": {}}


def test_best_checkpoint_tracks_min_metric(tmp_path):
    """maybe_save_best keeps exactly the lowest-metric snapshot, persists
    across manager instances, and restore_best returns that state."""
    ckpt = CheckpointManager(str(tmp_path / "ck"), keep=2)
    assert ckpt.best_info() is None and ckpt.restore_best("cpu") is None
    assert ckpt.maybe_save_best(10, _state(10), 3.0, None, {})
    assert ckpt.maybe_save_best(20, _state(20), 2.5, {"next_index": 4}, {"name": "x"})
    assert not ckpt.maybe_save_best(30, _state(30), 2.8, None, {})
    assert not ckpt.maybe_save_best(31, _state(31), 2.5, None, {})  # ties keep the first
    assert ckpt.best_info() == {"step": 20, "metric": 2.5}
    ckpt.wait()  # the saves are asynchronous
    assert ckpt.best_info() == {"step": 20, "metric": 2.5}
    assert sorted(os.listdir(tmp_path / "ck-best")) == ["20.pt", "best.json"]

    ckpt2 = CheckpointManager(str(tmp_path / "ck"), keep=2)  # fresh instance
    assert ckpt2.best_info() == {"step": 20, "metric": 2.5}
    assert not ckpt2.maybe_save_best(40, _state(40), 2.6, None, {})
    restored = ckpt2.restore_best("cpu")
    assert restored["step"] == 20 and restored["data_state"] == {"next_index": 4}
    assert torch.equal(restored["model"]["weight"], torch.full((2, 2), 20.0))
    assert ckpt2.steps() == []  # the rolling directory is untouched


def test_restore_best_falls_back_when_sidecar_step_missing(tmp_path, capsys):
    """best.json naming a step that is not on disk restores the newest best
    file there, with a printed warning."""
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    assert ckpt.maybe_save_best(10, _state(10), 3.0, None, {})
    ckpt.wait()  # the save is asynchronous: let it land before the sidecar is edited
    (tmp_path / "ck-best" / "best.json").write_text(json.dumps({"step": 999, "metric": 2.0}))
    restored = ckpt.restore_best("cpu")
    assert restored is not None and restored["step"] == 10
    assert "names step 999, which is not on disk" in capsys.readouterr().out


def test_crash_before_best_json_leaves_the_old_pair(tmp_path, monkeypatch):
    """The new best's snapshot lands first, then best.json, then the old
    file goes: a crash between the first two leaves the old pair intact.
    The save is asynchronous, so the failure surfaces when the manager
    joins its writer (logged, on `last_best_error`), not at the call."""
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    assert ckpt.maybe_save_best(10, _state(10), 3.0, None, {})
    ckpt.wait()
    real = tcheckpoint._write_atomic

    def crash_on_json(path, write):
        if path.endswith("best.json"):
            raise OSError("disk full")
        real(path, write)

    monkeypatch.setattr(tcheckpoint, "_write_atomic", crash_on_json)
    assert ckpt.maybe_save_best(20, _state(20), 2.0, None, {})
    ckpt.wait()
    monkeypatch.undo()
    assert isinstance(ckpt.last_best_error, OSError)
    assert "disk full" in str(ckpt.last_best_error)
    assert ckpt.best_info() == {"step": 10, "metric": 3.0}
    assert ckpt.restore_best("cpu")["step"] == 10
    assert not [n for n in os.listdir(tmp_path / "ck-best") if n.endswith(".tmp")]
    assert ckpt.maybe_save_best(30, _state(30), 2.0, None, {})  # the next save cleans up
    ckpt.wait()
    assert sorted(os.listdir(tmp_path / "ck-best")) == ["30.pt", "best.json"]


# ---------------------------------------------------------------------------
# build / train through the boundaries
# ---------------------------------------------------------------------------


def _profile(tmp_path, name="b", **train_kw):
    glow = GlowConfig(image_shape=(8, 8, 3), hidden_channels=16, K=2, L=2,
                      compute_dtype="bfloat16", flowstep_impl="pallas")
    kw = dict(batch_size=4, scalar_log_gap=2, plot_gap=0, checkpoint_gap=0, ema_decay=0.99,
              num_sample_images=3, step_timeout_s=0)
    kw.update(train_kw)
    return Profile(name=name, glow=glow, train=TrainConfig(**kw),
                   data=DataConfig(name="synthetic_textured"), out_dir=str(tmp_path))


def test_eval_logs_raw_and_ema_nll_and_swd(tmp_path):
    """Every gap reached in one run: eval_nll (EMA) and eval_nll_raw (live)
    at every eval, recon_err_max_u8, best_eval_nll where it improved (and
    best.json at that step), swd_x1e3 > 0, sample and recon PNGs at every
    plot with the annealed temperature, and the profiler's trace."""
    p = _profile(tmp_path, plot_gap=2, eval_gap=2, eval_batches=2, swd_gap=4, swd_images=3,
                 profile_step=2, profile_num_steps=2, temperature_anneal_steps=4,
                 sample_temperature=0.8)
    built = build(p, device="cpu")
    temps = []
    sample_fn = built.sample_fn
    built.sample_fn = lambda model, gen, temp=None: (temps.append(temp), sample_fn(model, gen, temp))[1]
    result = train(built, num_steps=6, quiet=True)
    assert result["final_step"] == 6 and "preempted" not in result
    run = tmp_path / "b"
    with open(run / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    evals = [r for r in rows if r.get("eval_nll")]
    assert [int(r["step"]) for r in evals] == [2, 4, 6]
    for r in evals:
        assert np.isfinite(float(r["eval_nll"])) and np.isfinite(float(r["eval_nll_raw"]))
        assert 0 <= float(r["recon_err_max_u8"]) <= 255
    bests = [r for r in evals if r.get("best_eval_nll")]
    assert bests and bests[0]["step"] == "2"
    lowest = min(evals, key=lambda r: float(r["eval_nll"]))
    assert built.ckpt.best_info() == {"step": int(lowest["step"]),
                                      "metric": float(lowest["eval_nll"])}
    swds = [r for r in rows if r.get("swd_x1e3")]
    assert [int(r["step"]) for r in swds] == [4] and float(swds[0]["swd_x1e3"]) > 0
    # Each boundary's time and kernel launches (none on the CPU) in its row,
    # in the JAX order.
    timed = [(int(r["step"]), k[:-3]) for r in rows for k in ("plot_ms", "eval_ms", "swd_ms")
             if r.get(k)]
    assert timed == [(2, "plot"), (2, "eval"), (4, "plot"), (4, "eval"), (4, "swd"),
                     (6, "plot"), (6, "eval")]
    for r in rows:
        for kind in ("plot", "eval", "swd"):
            if r.get(f"{kind}_ms"):
                assert float(r[f"{kind}_ms"]) > 0 and float(r[f"{kind}_launches"]) == 0
    assert all(float(r["best_save_ms"]) >= 0 for r in evals)
    assert 0 < float(swds[0]["swd_host_ms"]) <= float(swds[0]["swd_ms"])
    summary = run_summary.summarize_run(rows, p.train.batch_size, p.train.scalar_log_gap)
    assert [(b["step"], b["kind"]) for b in summary["boundaries"]] == timed
    assert [b["swd_host_ms"] for b in summary["boundaries"] if b["kind"] == "swd"] == \
        [float(swds[0]["swd_host_ms"])]
    assert [e["step"] for e in summary["evals"]] == [2, 4, 4, 6]
    for kind in ("samples", "recon"):
        assert sorted(os.listdir(run / kind)) == [f"step_{s:08d}.png" for s in (2, 4, 6)]
    np.testing.assert_allclose(temps, [0.4, 0.8, 0.8])
    traces = os.listdir(run / "profile")
    assert traces == ["trace_step_00000002.json"]
    assert "traceEvents" in json.loads((run / "profile" / traces[0]).read_text())
    assert os.listdir(run / "tb")
    # The eval copy never replaced the live model.
    assert built.eval_model is not None and built.eval_model is not built.state["model"]


def test_eval_nll_is_the_ema_weights_on_the_test_split(tmp_path):
    """The first eval's eval_nll is the EMA weights' mean bits/dim on the
    first eval_batches test batches, outside the trainer."""
    from pytorch_glow_tpu_torch.data.pipeline import make_dataset

    p = _profile(tmp_path, eval_gap=2, eval_batches=2, checkpoint_gap=2)
    built = build(p, device="cpu")
    train(built, num_steps=2, quiet=True)
    with open(tmp_path / "b" / "metrics.csv") as f:
        logged = float([r for r in csv.DictReader(f) if r.get("eval_nll")][0]["eval_nll"])
    test = make_dataset(p.data, p.glow, p.train, split="test")
    model = init_glow(p.glow, device="cpu")
    model.load_state_dict(tstep.ema_params(built.state))
    with torch.no_grad():
        want = np.mean([float(model.log_prob(model.preprocess(
            torch.from_numpy(next(test)["image"])))["nll"].mean()) for _ in range(2)])
    np.testing.assert_allclose(logged, want, rtol=1e-6)


def test_build_restore_best(tmp_path, capsys):
    """No snapshot: a fresh start.  Snapshots but no best: the latest, said
    in a printed line and on `restored`.  After an eval: the best."""
    p = _profile(tmp_path)
    fresh = build(p, device="cpu", restore="best")
    assert fresh.restored is None and not fresh.resumed
    train(fresh, num_steps=2, quiet=True)
    capsys.readouterr()
    latest = build(p, device="cpu", restore="best")
    assert latest.restored == "latest" and latest.start_step == 2
    assert "no best snapshot recorded" in capsys.readouterr().out
    evaluated = build(_profile(tmp_path, eval_gap=2, eval_batches=1), device="cpu")
    train(evaluated, num_steps=4, quiet=True)
    best = build(p, device="cpu", restore="best")
    assert best.restored == "best" and best.start_step == evaluated.ckpt.best_info()["step"]
    assert build(p, device="cpu").start_step == 4
    with pytest.raises(ValueError, match="restore"):
        build(p, device="cpu", restore="newest")


def test_profiler_stops_when_the_loop_raises(tmp_path):
    p = _profile(tmp_path, profile_step=2, profile_num_steps=10)
    built = build(p, device="cpu")
    step_fn = built.train_step

    def failing(state, batch):
        if state["step"] >= 3:
            raise RuntimeError("boom")
        return step_fn(state, batch)

    built.train_step = failing
    with pytest.raises(RuntimeError, match="boom"):
        train(built, num_steps=6, quiet=True)
    assert os.listdir(tmp_path / "b" / "profile") == ["trace_step_00000002.json"]
    assert torch.profiler.profile is not None and built.ckpt.steps() == []


def test_profiler_failure_after_a_failure_keeps_the_original(tmp_path, monkeypatch, capsys):
    """A failure in the loop while the profiler runs, and a second failure
    in the profiler's own device sync (as after a device error): the loop's
    error propagates, the second is printed, and the logger still closes."""
    p = _profile(tmp_path, profile_step=2, profile_num_steps=10)
    built = build(p, device="cpu")
    step_fn = built.train_step
    failed = []

    def failing(state, batch):
        if state["step"] >= 3:
            failed.append(True)
            raise RuntimeError("boom")
        return step_fn(state, batch)

    def sync(device):
        if failed:
            raise RuntimeError("device lost")

    closed = []
    close = MetricLogger.close
    monkeypatch.setattr(ttrainer, "_sync", sync)
    monkeypatch.setattr(MetricLogger, "close", lambda self: (closed.append(True), close(self)))
    built.train_step = failing
    with pytest.raises(RuntimeError, match="boom"):
        train(built, num_steps=6, quiet=True)
    assert "profiler stop after a failure also failed: RuntimeError: device lost" in \
        capsys.readouterr().err
    assert closed == [True]
    assert not torch.autograd.profiler._is_profiler_enabled


def test_tensorboard_scalars_and_disabled_line(tmp_path, monkeypatch, capsys):
    logger = MetricLogger(str(tmp_path / "a"), 4, quiet=True)
    logger.scalars(1, {"loss": 1.5})
    logger.image(1, "grid", np.zeros((4, 4, 3), np.uint8))
    logger.close()
    assert os.listdir(tmp_path / "a" / "tb")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = MetricLogger(str(tmp_path / "b"), 4, quiet=True)
    logger.scalars(1, {"loss": 1.5})
    logger.close()
    assert capsys.readouterr().out.count("TensorBoard logging disabled") == 1
    assert not (tmp_path / "b" / "tb").exists()


# ---------------------------------------------------------------------------
# The CLIs: SIGTERM, --retries, infer --best
# ---------------------------------------------------------------------------

TINY = ["--set", "glow.image_shape=[8,8,3]", "--set", "glow.hidden_channels=16",
        "--set", "glow.K=2", "--set", "glow.L=2", "--set", "train.batch_size=4",
        "--set", "train.steps_per_call=1", "--set", "train.step_timeout_s=0",
        "--set", "train.swd_gap=0", "--set", "train.plot_gap=0"]


def test_train_sigterm_preempts_cleanly_and_resumes(tmp_path):
    """SIGTERM mid-run: the trainer stops at the next step boundary, writes
    a snapshot and exits 0 with {"preempted": true}; the same command with
    a few more steps resumes from that snapshot and completes."""
    out = str(tmp_path)
    prof_path = tmp_path / "p.json"
    # num_steps far beyond what the wait below allows: if the SIGTERM path
    # regresses, the run outlives the timeout and the test fails.
    prof_path.write_text(json.dumps({
        "name": "pre",
        "glow": {"image_shape": [8, 8, 3], "hidden_channels": 16, "K": 2, "L": 2},
        "train": {"batch_size": 4, "num_steps": 50000, "scalar_log_gap": 1, "plot_gap": 0,
                  "eval_gap": 0, "checkpoint_gap": 0, "step_timeout_s": 0},
        "data": {"name": "synthetic"},
    }))
    csv_path = tmp_path / "pre" / "metrics.csv"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_glow_tpu_torch.cli.train", str(prof_path), "--cpu",
         "--out-dir", out, "--quiet"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 240
        while time.time() < deadline:
            if csv_path.is_file() and len(csv_path.read_text().splitlines()) >= 2:
                break
            if proc.poll() is not None:
                raise AssertionError(f"train exited early: {proc.stderr.read()[-3000:]}")
            time.sleep(0.2)
        else:
            raise AssertionError("the step loop never became live")
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    result = json.loads(stdout.strip().splitlines()[-1])
    assert result["preempted"] is True
    stopped = result["final_step"]
    assert 0 < stopped < 50000
    assert CheckpointManager(str(tmp_path / "pre" / "checkpoints")).latest_step() == stopped
    again = train_cli.main([str(prof_path), "--cpu", "--out-dir", out, "--quiet",
                            "--steps", str(stopped + 2)])
    assert again["final_step"] == stopped + 2 and "preempted" not in again


def test_retries_resume_from_the_newest_snapshot(tmp_path, monkeypatch, capsys):
    """A train that fails once after its step-2 snapshot: with --retries 1
    the run rebuilds from step 2 and finishes; with --retries 0 the failure
    is raised."""
    real = ttrainer.train
    calls = []

    def flaky(built, num_steps=None, quiet=False):
        calls.append(built.start_step)
        if len(calls) == 1:
            real(built, num_steps=2, quiet=quiet)
            raise RuntimeError("boom")
        return real(built, num_steps=num_steps, quiet=quiet)

    monkeypatch.setattr(ttrainer, "train", flaky)
    args = ["cifar10", "--cpu", "--synthetic", "textured", "--quiet", "--steps", "4", *TINY,
            "--set", "train.eval_gap=0", "--set", "train.checkpoint_gap=0"]
    result = train_cli.main([*args, "--out-dir", str(tmp_path / "a"), "--retries", "1"])
    captured = capsys.readouterr()
    assert result["final_step"] == 4 and calls == [0, 2]
    assert "attempt 1 failed (RuntimeError: boom)" in captured.err
    assert "[train] resumed from step 2" in captured.out
    assert os.environ["GLOW_WEDGE_RESTART_BUDGET"] in ("0", "1")
    calls.clear()
    with pytest.raises(RuntimeError, match="boom"):
        train_cli.main([*args, "--out-dir", str(tmp_path / "b")])
    assert calls == [0]


def test_infer_best_loads_the_best_snapshot(tmp_path, capsys):
    """infer --best on a run with evals loads the best step with no
    warning; on a run without, the latest with a warning."""
    common = ["cifar10", "--cpu", "--synthetic", "textured", *TINY,
              "--set", "train.eval_batches=1", "--set", "train.checkpoint_gap=2"]
    evaluated = str(tmp_path / "e")
    train_cli.main([*common, "--out-dir", evaluated, "--quiet", "--steps", "4",
                    "--set", "train.eval_gap=2"])
    best = CheckpointManager(f"{evaluated}/cifar10/checkpoints").best_info()
    capsys.readouterr()
    infer_cli.main(["nll", *common, "--out-dir", evaluated, "--batches", "1", "--best", "--ema"])
    text = capsys.readouterr()
    assert f"loaded the best snapshot, step {best['step']}" in text.out
    assert "warning" not in text.err and "nll: " in text.out
    plain = str(tmp_path / "p")
    train_cli.main([*common, "--out-dir", plain, "--quiet", "--steps", "2",
                    "--set", "train.eval_gap=0"])
    capsys.readouterr()
    infer_cli.main(["sample", *common, "--out-dir", plain, "--best", "-n", "2",
                    "-o", str(tmp_path / "s.png")])
    text = capsys.readouterr()
    assert "loaded the latest snapshot, step 2" in text.out
    assert "no best snapshot recorded" in text.err and (tmp_path / "s.png").is_file()


# ---------------------------------------------------------------------------
# True f32
# ---------------------------------------------------------------------------


def _tf32():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


class _Record(TorchFunctionMode):
    """Each conv2d and matmul: its input dtype and the TF32 flags in effect
    (cuDNN's, cuBLAS's)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("conv2d", "matmul", "__matmul__"):
            self.calls.append((name, args[0].dtype, *_tf32()))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f32_convs_and_matmuls_run_in_true_f32(dtype, monkeypatch):
    """With TF32 switched on globally for cuDNN (PyTorch's default) and
    cuBLAS, every f32 conv and matmul of log_prob, sample and a train
    step's backward runs with both off; bf16 convs see the global flags;
    the flags come back afterwards."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    cfg = GlowConfig(**SMALL, compute_dtype=dtype)
    model = init_glow(cfg, torch.Generator().manual_seed(0), "cpu")
    grads = []
    real_grad = torch.autograd.grad
    monkeypatch.setattr(tstep.torch.autograd, "grad",
                        lambda *a, **k: (grads.append(_tf32()), real_grad(*a, **k))[1])
    x = torch.from_numpy(_images(2))
    with _Record() as rec, torch.no_grad():
        model.log_prob(model.preprocess(x))
        model.sample(2, 0.7, torch.Generator().manual_seed(0))
    f32 = [c for c in rec.calls if c[1] == torch.float32]
    assert {c[0] for c in f32} >= {"conv2d"} and any("matmul" in c[0] for c in f32)
    assert all(c[2:] == (False, False) for c in f32), f32
    bf16 = [c for c in rec.calls if c[1] == torch.bfloat16]
    assert bool(bf16) == (dtype == "bfloat16")
    assert all(c[2:] == (True, True) for c in bf16)
    tx = make_optimizer(OptimConfig(schedule="constant", lr=1e-3), TrainConfig())
    step = tstep.make_train_step(cfg, tx)
    step(tstep.init_state(model, tx), x)
    assert grads == [(False, False)]
    assert _tf32() == (True, True)


def test_true_f32_pin_holds_until_the_last_thread_leaves(monkeypatch):
    """Two threads' overlapping blocks: the first to leave does not switch
    TF32 back on under the second; the last to leave does."""
    import threading

    from pytorch_glow_tpu_torch.ops.math import true_f32

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    entered, first_left = threading.Event(), threading.Event()
    seen = []

    def second():
        with true_f32():
            entered.set()
            first_left.wait(10)
            seen.append(_tf32())

    thread = threading.Thread(target=second)
    with true_f32():
        thread.start()
        assert entered.wait(10)
    first_left.set()
    thread.join(10)
    assert seen == [(False, False)]
    assert _tf32() == (True, True)


def test_bf16_round_trip_drift_is_the_reference_s_too():
    """After training, the bf16 coupling's round-trip leaves the uint8 bin
    in the JAX package as in the port.  The JAX package's train step trains
    a 16x16x3 model (K=8, L=2, hidden 64, bf16 coupling) for 100 steps on
    synthetic textured batches; on its weights and 64 test images, JAX's
    reconstruct and the port's at bf16 coupling each miss some image by
    more than one bin, and at f32 coupling both round-trip every image
    within one."""
    from pytorch_glow_tpu.config import GlowConfig as JGlowConfig
    from pytorch_glow_tpu.config import OptimConfig as JOptimConfig
    from pytorch_glow_tpu.config import TrainConfig as JTrainConfig
    from pytorch_glow_tpu.train import optim as joptim
    from pytorch_glow_tpu_torch.data.pipeline import make_dataset
    from pytorch_glow_tpu_torch.utils.convert import state_dict_from_jax

    glow = dict(image_shape=(16, 16, 3), hidden_channels=64, K=8, L=2,
                compute_dtype="bfloat16", flowstep_impl="xla")
    jcfg, tcfg = JGlowConfig(**glow), GlowConfig(**glow)
    ocfg = JOptimConfig(lr=2e-3, warmup_steps=20)
    tx = joptim.make_optimizer(ocfg, JTrainConfig(batch_size=16))
    state = jstep.init_state(jax.random.key(0), jcfg, tx)
    data = make_dataset(DataConfig(name="synthetic_textured"), tcfg, TrainConfig(batch_size=16))
    x = jglow.preprocess(jnp.asarray(next(data)["image"]), jcfg)
    state["params"] = jglow.ddi_init(state["params"], jglow.dequantize(jax.random.key(1), x, jcfg),
                                     jcfg)
    step = jstep.make_train_step(jcfg, tx, schedule=joptim.make_schedule(ocfg))
    for _ in range(100):
        state, _ = step(state, jnp.asarray(next(data)["image"]))
    params = state["params"]
    x = next(make_dataset(DataConfig(name="synthetic_textured"), tcfg,
                          TrainConfig(batch_size=64), split="test"))["image"]

    def per_image(rec):
        return np.abs(x.astype(np.int16) - np.asarray(rec).astype(np.int16)).reshape(64, -1).max(1)

    err = {}
    for dtype in ("bfloat16", "float32"):
        err["jax", dtype] = per_image(jstep.make_reconstruct_fn(
            JGlowConfig(**dict(glow, compute_dtype=dtype)))(params, x))
        cfg = GlowConfig(**dict(glow, compute_dtype=dtype))
        model = init_glow(cfg, device="cpu")
        model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), cfg))
        err["port", dtype] = per_image(tstep.make_reconstruct_fn(cfg)(model, torch.from_numpy(x)))
    report = {" ".join(k): (int(v.max()), int((v > 1).sum())) for k, v in err.items()}
    print("max uint8 error, images beyond one bin:", report)
    assert err["jax", "bfloat16"].max() > 1 and err["port", "bfloat16"].max() > 1, report
    assert err["jax", "float32"].max() <= 1 and err["port", "float32"].max() <= 1, report
