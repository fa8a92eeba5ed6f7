"""The port's timing tools `perf_fused_levels`, `perf_breakdown` and
`bench_train` (`pytorch_glow_tpu_torch/scripts/`) against the JAX scripts
of the same names, on the CPU at a tiny size: the levels and op counts,
the timed components on weights bridged from JAX, and the train-step
A/B's first loss and keys.  The JAX scripts' own expressions (the op
count, the JSON keys) are read from their source, so the port is held to
what the JAX script computes.  Last, the train CLI's exit code with its
watchdog thread busy at exit (the trainer joins it)."""

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_glow_tpu.config import PRESETS as JAX_PRESETS
from pytorch_glow_tpu.config import OptimConfig as JaxOptimConfig
from pytorch_glow_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_glow_tpu.models import layers as jlayers
from pytorch_glow_tpu.ops import invconv_xla as jic
from pytorch_glow_tpu.train import optim as joptim
from pytorch_glow_tpu.train import step as jstep
from pytorch_glow_tpu.utils.tree import partition
from pytorch_glow_tpu_torch import OptimConfig, Profile, TrainConfig
from pytorch_glow_tpu_torch.config import PRESETS
from pytorch_glow_tpu_torch.ops import flowstep as tfs
from pytorch_glow_tpu_torch.scripts import bench_train, perf_breakdown, perf_fused_levels, step_bits
from pytorch_glow_tpu_torch.train import step as tstep
from pytorch_glow_tpu_torch.train.optim import make_optimizer
from test_torch_model import SMALL, _cfgs, _nontrivial_params, _port

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--set", "glow.hidden_channels=8", "--set", "glow.K=2", "--set", "glow.L=2",
        "--set", "glow.compute_dtype=float32"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_script(name: str) -> ast.Module:
    return ast.parse((REPO / "scripts" / f"{name}.py").read_text())


def _jax_flops():
    """The JAX perf_fused_levels script's `flops = ...` expression, compiled."""
    for node in ast.walk(_jax_script("perf_fused_levels")):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "flops"):
            return compile(ast.Expression(node.value), "perf_fused_levels.py", "eval")
    raise AssertionError("no flops expression in scripts/perf_fused_levels.py")


def _jax_bench_keys() -> set:
    """The keys of the dict that the JAX bench_train script's `run` returns."""
    run = next(n for n in ast.walk(_jax_script("bench_train"))
               if isinstance(n, ast.FunctionDef) and n.name == "run")
    ret = next(n for n in ast.walk(run) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_levels_and_op_counts_are_the_jax_script_s(preset):
    """Per level of every preset: the port's levels are JAX's
    `cfg.latent_shapes()`, and `jax_ops` is the JAX script's `flops` at the
    preset's batch, exactly."""
    jcfg, tcfg = JAX_PRESETS[preset].glow, PRESETS[preset].glow
    assert tcfg.latent_shapes() == jcfg.latent_shapes()
    flops = _jax_flops()
    batch, hidden, mode = PRESETS[preset].train.batch_size, jcfg.hidden_channels, jcfg.flow_coupling
    for lh, lw, lc in jcfg.latent_shapes():
        ch = lc // 2
        want = eval(flops, {}, dict(batch=batch, lh=lh, lw=lw, lc=lc, hidden=hidden, ch=ch,
                                    cout=lc if mode == "affine" else ch))
        got = perf_fused_levels.jax_ops(batch, lh, lw, lc, hidden, mode == "affine")
        assert got == want, (preset, (lh, lw, lc))


def test_perf_fused_levels_runs_on_the_cpu(capsys):
    """A `--cpu` run at a tiny profile: one line per level, with the three
    directions' times, tilings, bounds and library times, then the
    K-weighted totals."""
    out = perf_fused_levels.main(["cifar10", "--cpu", *TINY, "--batch", "2", "--n1", "1",
                                  "--n2", "2"])
    text = capsys.readouterr().out
    jcfg = dataclasses.replace(JAX_PRESETS["cifar10"].glow, hidden_channels=8, K=2, L=2,
                               compute_dtype="float32")
    assert [tuple(r["shape"]) for r in out["levels"]] == list(jcfg.latent_shapes())
    for li, row in enumerate(out["levels"]):
        assert f"level {li} (" in text
        for d in perf_fused_levels.DIRECTIONS:
            assert row[d]["ms"] > 0 and row[d]["tiling"] == "whole"
            assert row[d]["bound_ms"] > 0 and row[d]["bound_by"] in ("bytes", "operations")
            assert row[d]["library_ms"] > 0
    assert "K-weighted:" in text and "implied img/s:" in text
    assert out["card"] == "cpu" and set(out["totals"]) == set(perf_fused_levels.DIRECTIONS)


def test_perf_fused_levels_split_needs_the_card():
    """`--split` reads torch.profiler's device times: on the CPU it refuses
    rather than print host numbers under a device name."""
    with pytest.raises(ValueError, match="needs the card"):
        perf_fused_levels.main(["--split", "--cpu"])


def test_step_bits_saves_and_compares_outputs(tmp_path, monkeypatch, capsys):
    """`step_bits` on the plain versions at two tiny cases: one run's file
    against itself is bitwise equal everywhere; a changed output is named
    with its difference."""
    monkeypatch.setattr(step_bits, "CASES", [(2, 4, 4, 12, "affine"), (1, 2, 2, 24, "additive")])
    monkeypatch.setattr(step_bits.FlowStep, "__init__", _small_flowstep_init(step_bits.FlowStep))
    a, b = tmp_path / "a.pt", tmp_path / "b.pt"
    out = step_bits.main(["save", str(a), "--cpu"])
    assert len(out) == 2 * (4 + 12) and all(torch.isfinite(t).all() for t in out.values())
    step_bits.main(["save", str(b), "--cpu"])
    assert step_bits.main(["compare", str(a), str(b)]) == {"outputs": 32, "bitwise": 32,
                                                            "differ": []}
    changed = torch.load(b)
    changed["2x4x4x12 affine forward logdet"] += 1e-3
    torch.save(changed, b)
    line = step_bits.main(["compare", str(a), str(b)])
    assert line["differ"] == ["2x4x4x12 affine forward logdet"] and line["bitwise"] == 31
    assert "2x4x4x12 affine forward logdet: max |diff|" in capsys.readouterr().out


def _small_flowstep_init(cls):
    """FlowStep.__init__ with hidden 8 in place of the script's 512."""
    init = cls.__init__

    def small(self, c, hidden, *args, **kwargs):
        init(self, c, 8, *args, **kwargs)

    return small


def _jax_component(name: str, sp, z, b: int, mode: str, precision: str):
    if name == "coupling":
        out, ld, _ = jlayers.coupling_forward(sp["coupling"], z, jnp.zeros((b,)), mode,
                                              compute_dtype=jnp.float32)
        return out, ld
    if name == "coup_rev":
        return jlayers.coupling_reverse(sp["coupling"], z, mode, compute_dtype=jnp.float32)
    if name in ("invconv", "invconv_rev"):
        lu = sp["perm"]["lu"]
        w = jic.lu_assemble(lu) if name == "invconv" else jic.lu_inverse(lu)
        return jic.mix_channels(z, w, jic.PRECISIONS[precision])
    return jlayers.actnorm_forward(sp["actnorm"], z, None)[0]


@pytest.mark.parametrize("name,invconv_impl", [
    *((c, "xla") for c in perf_breakdown.COMPONENTS),
    ("invconv", "pallas"), ("invconv_rev", "pallas")])
def test_breakdown_components_match_jax(name, invconv_impl):
    """Each component `perf_breakdown` times, on weights bridged from JAX
    at f32 coupling, against the JAX function the JAX script times on the
    same z (each level's step 0; the LU mix also through the 1x1 conv
    kernels' plain version): within 1e-5."""
    kw = dict(SMALL, invconv_impl=invconv_impl, invconv_precision="high")
    jcfg, tcfg = _cfgs(kw)
    params = _nontrivial_params(jcfg)
    model = _port(params, tcfg)
    b = 3
    for li, (lh, lw, lc) in enumerate(jcfg.latent_shapes()):
        z = np.random.default_rng(li).standard_normal((b, lh, lw, lc)).astype(np.float32)
        sp = jax.tree.map(lambda a: a[0], params["levels"][li]["steps"])
        want = _jax_component(name, sp, jnp.asarray(z), b, jcfg.flow_coupling,
                              jcfg.invconv_precision)
        with torch.no_grad():
            got = perf_breakdown.components(model._levels[li][0][0], b)[name](
                torch.from_numpy(z))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} level {li}")


def test_perf_breakdown_runs_on_the_cpu(capsys):
    """A `--cpu` run at a tiny celeba64: the full paths, one line per level
    with the five components, the sums against the full paths, and level
    0's three convs; host and stream times, the device's own time not
    measured on the CPU."""
    out = perf_breakdown.main(["--cpu", "--batch", "2", "--n1", "1", "--n2", "2",
                               "--full-n1", "1", "--full-n2", "2", "--set",
                               "glow.image_shape=[16,16,3]", "--set", "glow.hidden_channels=8",
                               "--set", "glow.K=1", "--set", "glow.compute_dtype=float32"])
    text = capsys.readouterr().out
    assert set(out["full"]) == {"forward", "sample", "recon"}
    assert len(out["levels"]) == PRESETS["celeba64"].glow.L
    assert set(out["conv"]) == {"conv1", "conv2", "conv3"}
    for t in [*out["full"].values(), *out["conv"].values(),
              *(row[k] for row in out["levels"] for k in perf_breakdown.COMPONENTS)]:
        assert np.isfinite(t["device_ms"]) and np.isfinite(t["host_ms"]) and t["busy_ms"] is None
    assert "component sum: fwd" in text and "level-0 coupling internals" in text


def _tiny_profile(impl: str) -> Profile:
    prof = PRESETS["cifar10"]
    glow = dict(SMALL, dequant="none", flowstep_impl=impl)
    return prof.replace(glow=type(prof.glow)(**glow), optim=OptimConfig(lr=1e-3),
                        train=TrainConfig(batch_size=4))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bench_train_first_loss_matches_jax(monkeypatch, impl):
    """`bench_train.run` from weights bridged from JAX, on the same uint8
    batches: the first call's loss (its last step's, 2 steps a call,
    noam-free Adam, no dequantization noise on either side) against the
    JAX `make_train_step_n`'s at f32 (the fused arm at f32 coupling),
    within 2e-4, the repo's objective tolerance."""
    monkeypatch.setattr(tfs, "COUPLING_DTYPE", torch.float32)
    spc = 2
    prof = _tiny_profile(impl)
    jcfg, tcfg = _cfgs(dict(SMALL, dequant="none"))
    params = _nontrivial_params(jcfg)
    batches = np.random.default_rng(3).integers(0, 256, (spc, 4, *jcfg.image_shape),
                                                dtype=np.uint8)
    model = _port(params, bench_train.impl_cfg(prof, impl)).train()
    state = tstep.init_state(model, make_optimizer(prof.optim, prof.train))
    jtx = joptim.make_optimizer(JaxOptimConfig(lr=1e-3), JaxTrainConfig(batch_size=4))
    trainable, _ = partition(params)
    jstate = {"step": jnp.zeros((), jnp.int32), "params": params,
              "opt_state": jtx.init(trainable), "rng": jax.random.key(0)}
    # The JAX step donates the state, params included: bridged above.
    _, jm = jstep.make_train_step_n(jcfg, jtx, spc)(jstate, jnp.asarray(batches))
    row = bench_train.run(prof, impl, spc, batch=4, device="cpu", state=state,
                          batches=torch.from_numpy(batches), n=(1, 2))
    np.testing.assert_allclose(row["loss0"], float(jm["loss"]), rtol=2e-4, atol=2e-4)
    assert set(row) == _jax_bench_keys()


def test_bench_train_prints_both_impls_with_jax_s_keys(monkeypatch, capsys):
    """`main` at a tiny profile on the CPU: one JSON line per impl, fused
    then unfused, with the JAX script's keys, positive wall times and
    finite numbers (a CPU's two-N difference under other load can come
    out negative: the card's are held positive by `chip_smoke.py`)."""
    monkeypatch.setenv("AB_SPC", "2")
    rows = bench_train.main(["cifar10", "--cpu", *TINY, "--set", "glow.image_shape=[8,8,3]",
                             "--set", "train.batch_size=2"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines == rows and [r["impl"] for r in rows] == ["pallas", "xla"]
    for r in rows:
        assert set(r) == _jax_bench_keys()
        assert r["compile_s"] > 0 and all(t > 0 for t in r["raw_wall_s"])
        assert all(np.isfinite(r[k]) for k in ("ms_per_step", "train_images_per_sec", "loss0",
                                               "loss", "grad_norm"))


# The step-liveness watchdog's thread, slowed so that it is still inside a
# torch op (which releases the GIL) when the interpreter finalizes: before
# the trainer joined it, such a thread was ended by the finalizing
# interpreter from inside a C++ destructor and the process aborted with
# "terminate called without an active exception" (exit code 134) after
# printing its result, about one run in four.
_LINGERING_WATCHDOG = r"""
import sys
import torch
sys.modules["torch.utils.tensorboard"] = None
from pytorch_glow_tpu_torch.train import trainer

def _watch(self):
    self._stop.wait()
    x = torch.randn(512, 512)
    for _ in range(100):
        x = torch.tanh(x @ x)

trainer._StepWatchdog._watch = _watch
from pytorch_glow_tpu_torch.cli.train import main
main(sys.argv[1:])
"""


@pytest.mark.multiprocess
def test_train_cli_exits_0_with_its_watchdog_thread_busy_at_exit(tmp_path):
    """A one-process `cli.train --cpu` whose watchdog thread is busy in
    torch ops when the run ends: the trainer joins the thread, so the
    process prints its result line and exits 0."""
    argv = ["cifar10", "--cpu", "--synthetic", "textured", "--steps", "2",
            "--out-dir", str(tmp_path), *TINY, "--set", "glow.image_shape=[8,8,3]",
            "--set", "train.batch_size=2", "--set", "train.steps_per_call=1",
            "--set", "train.step_timeout_s=600"]
    proc = subprocess.run([sys.executable, "-c", _LINGERING_WATCHDOG, *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    assert result["final_step"] == 2 and result["checkpoint_saved"]
