"""The port's tools (`pytorch_glow_tpu_torch/scripts/`) on the CPU at a tiny
size: `memory_report`, `lr_probe`, `vardeq_ab`, `vardeq_overhead_ab` and
`dress_rehearsal`, the counterparts of `scripts/memory_report.py` and the
others (`tests/test_memory_report.py`, `tests/test_dress_rehearsal.py`
hold the JAX ones).  Each prints the JAX script's JSON line, its keys
where they mean the same; a forced blow-up gives `lr_probe` an onset."""

import json
import os
import subprocess
import sys

import pytest
import torch

from pytorch_glow_tpu_torch.scripts import (
    dress_rehearsal,
    lr_probe,
    memory_report,
    vardeq_ab,
    vardeq_overhead_ab,
)

TINY = ["--set", "glow.image_shape=[8,8,3]", "--set", "glow.hidden_channels=8",
        "--set", "glow.K=2", "--set", "glow.L=2", "--set", "train.step_timeout_s=0"]


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One intra-op thread, and no TensorBoard (its import pulls in
    TensorFlow where that is installed): the trainer logs without it."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _last_json(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def test_memory_report_on_the_cpu_reports_what_the_host_knows(capsys):
    r = memory_report.main(["cifar10", "--batch-size", "4", "--cpu", *TINY])
    assert _last_json(capsys.readouterr().out) == r
    assert r["platform"] == "cpu" and r["train_batch"] == 4
    assert r["param_bytes"] > 0 and r["ema_bytes"] == r["param_bytes"]
    assert r["opt_state_bytes"] >= 2 * r["param_bytes"]  # mu and nu
    assert r["train"] is None and r["train_fits"] is None and "nothing measured" in r["note"]


def test_memory_report_peak_sites_replay_the_trace():
    """The sites live at the trace's peak, largest first, named by the
    port's frame nearest the allocation."""
    port = os.sep + os.path.join("x", "pytorch_glow_tpu_torch", "ops", "flowstep.py")

    def alloc(addr, size, line):
        return {"action": "alloc", "addr": addr, "size": size,
                "frames": [{"filename": "/lib/torch.py", "line": 1, "name": "f"},
                           {"filename": port, "line": line, "name": "step"}]}

    trace = [alloc(1, 100, 10), alloc(2, 300, 20), {"action": "free_completed", "addr": 1},
             alloc(3, 50, 10), alloc(4, 400, 30), {"action": "free_completed", "addr": 4},
             alloc(5, 10, 40)]
    sites = memory_report.peak_sites({"device_traces": [trace]}, 0, 2)
    assert sites == [{"site": "ops/flowstep.py:30:step", "bytes": 400, "allocations": 1},
                     {"site": "ops/flowstep.py:20:step", "bytes": 300, "allocations": 1}]


@pytest.mark.parametrize("blow_up", [True, False])
def test_lr_probe_finds_the_onset_of_a_forced_blow_up(capsys, blow_up):
    """A ramp to lr 1e3 diverges: an onset with its lr and step, the
    recommended peak half of it; a ramp within 1e-5 .. 1e-4 stays clean."""
    ramp = ["--lr0", "1e-3", "--lr1", "1e3"] if blow_up else ["--lr0", "1e-5", "--lr1", "1e-4"]
    r = lr_probe.main(["cifar10", "--cpu", "--batch-size", "4", *ramp, "--steps", "40",
                       "--spc", "2", "--min-steps", "4", "--window", "3", "--quiet", *TINY])
    assert _last_json(capsys.readouterr().out) == r
    assert set(r) >= {"onset_step", "onset_lr", "max_stable_lr", "recommended_peak", "clean"}
    if blow_up:
        assert not r["clean"] and 1e-3 < r["onset_lr"] < 1e3 and 0 < r["onset_step"] <= 40
        assert r["recommended_peak"] == pytest.approx(r["onset_lr"] / 2)
        assert r["max_stable_lr"] < r["onset_lr"]
    else:
        assert r["clean"] and r["onset_lr"] is None and r["recommended_peak"] is None


def test_lr_probe_ramp_schedule():
    sched = lr_probe.ramp_schedule(1e-4, 1e-2, 10, 20)
    got = [float(sched(torch.tensor(s))) for s in (0, 10, 20, 30, 50)]
    assert got == pytest.approx([1e-4, 1e-4, 1e-3, 1e-2, 1e-2], rel=1e-5)


def test_vardeq_ab_scores_both_arms(capsys):
    r = vardeq_ab.main(["--cpu", "--steps", "2", "--size", "8", "--width", "8", "--K", "2",
                        "--batch-size", "4", "--eval-batches", "2", "--iwae-samples", "2",
                        "--vardeq-steps", "1", "--vardeq-width", "8"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln.get("dequant") for ln in lines[:2]] == ["uniform", "variational"]
    for arm in r["arms"].values():
        assert arm["steps"] == 2 and arm["eval_images"] == 8
        # The IWAE bound is at most the ELBO of its own draws' mean, both finite.
        assert 0 < arm["iwae2_bits_dim"] < 9 and 0 < arm["elbo_bits_dim"] < 9
    assert set(r["summary"]) >= {"delta_elbo_bits_dim", "delta_iwae2_bits_dim"}


def test_vardeq_overhead_ab_times_both_arms(capsys):
    r = vardeq_overhead_ab.main(["--cpu", "--batch-size", "2", "--spc", "1", *TINY,
                                 "--set", "glow.vardeq_width=8", "--set", "glow.vardeq_steps=1"])
    assert _last_json(capsys.readouterr().out) == {"overhead_pct": r["overhead_pct"]}
    for arm in ("uniform", "variational"):
        assert r[arm]["dequant"] == arm and r[arm]["train_images_per_sec"] > 0
        assert r[arm]["ms_per_step"] > 0 and len(r[arm]["raw_wall_s"]) == 2


def test_dress_rehearsal_stage_times_and_failure(capsys):
    """A stage that runs records its seconds; a stage that fails exits 2
    with its stderr and records none."""
    secs: dict = {}
    assert dress_rehearsal.run("ok", ["platform"], secs).strip()  # `python -m platform`
    assert list(secs) == ["ok"] and secs["ok"] >= 0
    with pytest.raises(SystemExit) as e:
        dress_rehearsal.run("bad", ["no_such_module_of_the_port"], secs)
    err = capsys.readouterr().err
    assert e.value.code == 2 and "stage 'bad' FAILED rc=1" in err and "No module named" in err
    assert list(secs) == ["ok"]


@pytest.mark.slow
@pytest.mark.multiprocess
def test_dress_rehearsal_chain(tmp_path):
    """prepare -> train (worker processes over TFRecord shards) -> resume ->
    report --best -> export -> serve, each a fresh subprocess of the port's
    CLIs.  TensorBoard is made unimportable in the stages (a package that
    raises ImportError first on their path), as in the in-process tests.
    Marked slow: ten Python processes, about a minute alone on the CPU."""
    stub = tmp_path / "no_tensorboard" / "tensorboard"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text('raise ImportError("left out of the test")\n')
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (dress_rehearsal.REPO, str(stub.parent), os.environ.get("PYTHONPATH", ""))
        if p), "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-u", "-m", "pytorch_glow_tpu_torch.scripts."
                        "dress_rehearsal", "--cpu", "--steps", "2"],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=dress_rehearsal.REPO)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    out = _last_json(r.stdout)
    assert out["dress_rehearsal"] == "OK" and out["best"]["step"] == 2
    assert out["best"]["metric"] < 8.1 and 0.0 < out["report_bits_dim_elbo"] < 8.1
    assert out["served_png_bytes"] > 0 and len(out["fixtures"]) == 4
    assert list(out["stage_s"]) == ["prepare", "train", "resume", "report", "export", "serve"]
