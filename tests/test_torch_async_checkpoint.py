"""The port's asynchronous snapshots (`utils/checkpoint.py`) on the CPU:
`save` and `maybe_save_best` return before the file is written and capture
the state as it was at the call; `wait()` / `close()` drain; a failed best
write rolls its pending marker back (the counterpart of the JAX package's
`test_best_save_failure_rolls_back_pending`); a failed rolling write
raises at the next call; `best.json` never moves back; a failing train
call under `--retries` resumes from the newest snapshot written before
the failure; and the stall tool (`scripts/ckpt_stall_ab.py`)."""

import csv
import json
import os
import threading

import pytest
import torch

from pytorch_glow_tpu_torch import GlowConfig, OptimConfig, TrainConfig, init_glow, make_optimizer
from pytorch_glow_tpu_torch.cli import train as train_cli
from pytorch_glow_tpu_torch.scripts import run_summary
from pytorch_glow_tpu_torch.train import step as tstep
from pytorch_glow_tpu_torch.train import trainer as ttrainer
from pytorch_glow_tpu_torch.utils import checkpoint as tcheckpoint
from pytorch_glow_tpu_torch.utils import metrics as tmetrics
from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(step):
    model = torch.nn.Linear(2, 2)
    torch.nn.init.constant_(model.weight, float(step))
    return {"step": step, "seed": 0, "model": model, "opt_state": {}}


def _trainer(ema_decay=0.99):
    """A tiny Glow's train state after one step, and its train step."""
    cfg = GlowConfig(image_shape=(8, 8, 3), hidden_channels=8, K=2, L=2)
    tcfg = TrainConfig(batch_size=4, ema_decay=ema_decay)
    tx = make_optimizer(OptimConfig(), tcfg)
    model = init_glow(cfg, torch.Generator().manual_seed(0), "cpu")
    state = tstep.init_state(model, tx, ema_decay)
    step_fn = tstep.make_train_step(cfg, tx, ema_decay)
    gen = torch.Generator().manual_seed(1)
    batches = [torch.randint(0, 256, (4, 8, 8, 3), generator=gen, dtype=torch.uint8)
               for _ in range(3)]
    state, _ = step_fn(state, batches[0])
    return state, step_fn, batches[1:]


def _tensors(snapshot: dict) -> dict:
    """Every tensor of a snapshot (or a train state) by its path."""
    out = {}

    def walk(value, path):
        if isinstance(value, torch.nn.Module):
            value = value.state_dict()
        if isinstance(value, torch.Tensor):
            out[path] = value.detach().clone()
        elif isinstance(value, dict):
            for k, v in value.items():
                walk(v, (*path, k))
        elif isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                walk(v, (*path, i))

    walk({k: snapshot[k] for k in ("model", "opt_state", "ema")}, ())
    return out


def _assert_bitwise(got: dict, want: dict) -> None:
    assert sorted(got, key=str) == sorted(want, key=str)
    for path, value in want.items():
        assert got[path].dtype == value.dtype and torch.equal(got[path], value), path


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_best_save_failure_rolls_back_pending(tmp_path, monkeypatch):
    """A failed background best save does not poison the tracker: the
    pending marker is rolled back (so a later metric still saves, a worse
    one than the failed save's included), the error is on
    `last_best_error`, a later healthy save commits, and the finished
    writer threads are pruned."""
    ckpt = CheckpointManager(str(tmp_path / "ck"), keep=2)
    real = tcheckpoint._write_atomic

    def flaky(path, write):
        if threading.current_thread() is threading.main_thread():
            return real(path, write)
        raise RuntimeError("simulated disk-full during best save")

    monkeypatch.setattr(tcheckpoint, "_write_atomic", flaky)
    assert ckpt.maybe_save_best(10, _state(10), 3.0, None, {})
    ckpt._join_best()  # the writer fails here
    monkeypatch.undo()
    assert ckpt.last_best_error is not None
    assert "simulated disk-full" in str(ckpt.last_best_error)
    assert ckpt._best_pending is None  # rolled back, not masking
    # best.json was never written, and the failure is not sticky: a worse
    # metric than the failed save's is accepted now.
    assert ckpt.maybe_save_best(20, _state(20), 3.5, None, {})
    ckpt._join_best()
    assert ckpt.best_info() == {"step": 20, "metric": 3.5}
    restored = ckpt.restore_best("cpu")
    assert restored["step"] == 20
    assert not ckpt._best_threads  # finished writer threads are pruned
    ckpt.close()


def test_save_returns_before_the_write_and_captures_the_state(tmp_path, monkeypatch):
    """`save` and `maybe_save_best` return while the write is blocked, and
    `best_info` shows the pending best; train steps then update the state
    in place (and the caller edits its data_state), and once released the
    files hold the state as it was at the calls, tensor by tensor."""
    state, step_fn, batches = _trainer()
    want = _tensors(state)
    gate, entered = threading.Event(), threading.Semaphore(0)
    real_save = torch.save

    def blocked_save(obj, f, *args, **kwargs):
        if threading.current_thread() is not threading.main_thread():
            entered.release()
            assert gate.wait(30), "the test never released the write"
        return real_save(obj, f, *args, **kwargs)

    monkeypatch.setattr(torch, "save", blocked_save)
    ckpt = CheckpointManager(str(tmp_path / "ck"), keep=2)
    data_state = {"next_index": 5}
    ckpt.save(1, state, data_state, {"name": "async"})
    assert ckpt.maybe_save_best(1, state, 2.5, data_state, {"name": "async"})
    assert entered.acquire(timeout=30) and entered.acquire(timeout=30)
    assert ckpt.best_info() == {"step": 1, "metric": 2.5}  # pending, not on disk yet
    assert ckpt.steps() == [] and not os.path.exists(ckpt.best_directory + "/best.json")
    for batch in batches:
        state, _ = step_fn(state, batch)
    data_state["next_index"] = 99
    moved = _tensors(state)
    assert any(not torch.equal(moved[p], want[p]) for p in want)  # the steps changed it
    gate.set()
    ckpt.wait()
    monkeypatch.undo()
    for path in (ckpt.path(1), os.path.join(ckpt.best_directory, "1.pt")):
        snap = _load(path)
        assert snap["step"] == 1 and snap["data_state"] == {"next_index": 5}
        _assert_bitwise(_tensors(snap), want)
    assert ckpt.best_info() == {"step": 1, "metric": 2.5}
    ckpt.close()


@pytest.mark.parametrize("next_call", ["save", "wait", "close"])
def test_failed_rolling_write_raises_at_the_next_call(tmp_path, monkeypatch, next_call):
    """A rolling write that fails in the background raises, naming its
    step, at the next `save`, `wait` or `close`; it is raised once, and
    the next save writes."""
    ckpt = CheckpointManager(str(tmp_path / "ck"))

    def full(path, write):
        raise OSError("no space left on device")

    monkeypatch.setattr(tcheckpoint, "_write_atomic", full)
    ckpt.save(3, _state(3), None, {})
    ckpt._rolling.join()
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="snapshot 3") as raised:
        if next_call == "save":
            ckpt.save(4, _state(4), None, {})
        else:
            getattr(ckpt, next_call)()
    assert isinstance(raised.value.__cause__, OSError)
    ckpt.save(5, _state(5), None, {}, wait=True)
    assert ckpt.steps() == [5]
    ckpt.close()


def test_out_of_order_commit_does_not_move_best_json_back(tmp_path, monkeypatch):
    """A best write that lands after a better one (another manager on the
    same directory) leaves best.json at the better metric and removes its
    own file."""
    first = CheckpointManager(str(tmp_path / "ck"))
    gate = threading.Event()
    real_save = torch.save

    def slow_step_10(obj, f, *args, **kwargs):
        if isinstance(obj, dict) and obj.get("step") == 10:
            assert gate.wait(30), "the test never released the write"
        return real_save(obj, f, *args, **kwargs)

    monkeypatch.setattr(torch, "save", slow_step_10)
    assert first.maybe_save_best(10, _state(10), 3.0, None, {})
    second = CheckpointManager(str(tmp_path / "ck"))
    assert second.maybe_save_best(20, _state(20), 2.0, None, {})
    second.wait()
    gate.set()
    first.wait()
    monkeypatch.undo()
    assert first.last_best_error is None
    assert first.best_info() == second.best_info() == {"step": 20, "metric": 2.0}
    names = sorted(os.listdir(tmp_path / "ck-best"))
    assert names == ["20.pt", "best.json"], names
    assert first.restore_best("cpu")["step"] == 20


def test_failing_call_under_retries_resumes_from_the_newest_snapshot(tmp_path, monkeypatch,
                                                                      capsys):
    """A train call that fails at the plot boundary of step 2, while the
    step-2 snapshot is still being written: the failure drains the write,
    so `--retries 1` resumes from step 2, not from step 1."""
    real_save = torch.save

    def slow_step_2(obj, f, *args, **kwargs):
        if isinstance(obj, dict) and obj.get("step") == 2:
            threading.Event().wait(0.5)
        return real_save(obj, f, *args, **kwargs)

    real_plot, plots = ttrainer._plot, []

    def failing_plot(*args):
        plots.append(1)
        if len(plots) == 1:
            raise RuntimeError("plot failed")
        return real_plot(*args)

    monkeypatch.setattr(torch, "save", slow_step_2)
    monkeypatch.setattr(ttrainer, "_plot", failing_plot)
    # No TensorBoard: importing it takes seconds, and no assertion reads it.
    monkeypatch.setattr(tmetrics.TBWriter, "__init__",
                        lambda self, logdir: setattr(self, "_writer", None))
    args = ["cifar10", "--cpu", "--synthetic", "textured", "--quiet", "--steps", "3",
            "--out-dir", str(tmp_path), "--retries", "1",
            "--set", "glow.image_shape=[8,8,3]", "--set", "glow.hidden_channels=8",
            "--set", "glow.K=1", "--set", "glow.L=2", "--set", "train.batch_size=2",
            "--set", "train.steps_per_call=1", "--set", "train.step_timeout_s=0",
            "--set", "train.eval_gap=0", "--set", "train.swd_gap=0",
            "--set", "train.plot_gap=2", "--set", "train.checkpoint_gap=1",
            "--set", "train.num_sample_images=2"]
    result = train_cli.main(args)
    captured = capsys.readouterr()
    assert "attempt 1 failed (RuntimeError: plot failed)" in captured.err
    assert "[train] resumed from step 2" in captured.out
    assert result["final_step"] == 3
    assert CheckpointManager(str(tmp_path / "cifar10" / "checkpoints")).steps() == [1, 2, 3]
    # Each rolling save logged what it held up the loop; run_summary reads it.
    with open(tmp_path / "cifar10" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    saves = run_summary.summarize_run(rows, 2, 50)["saves"]
    assert [s["step"] for s in saves] == [1, 2, 3] and all(s["save_ms"] > 0 for s in saves)


def test_async_and_waited_saves_write_the_same_tensors(tmp_path):
    """The background write and `save(..., wait=True)` write the same
    snapshot, bitwise, and it is the state's; a second save into the same
    directory reuses the host buffers and the pickled tensor entries."""
    state, step_fn, batches = _trainer()
    want = _tensors(state)
    background = CheckpointManager(str(tmp_path / "a"))
    waited = CheckpointManager(str(tmp_path / "b"))
    background.save(1, state, {"next_index": 2}, {"name": "x"})
    waited.save(1, state, {"next_index": 2}, {"name": "x"}, wait=True)
    assert waited.steps() == [1]
    background.wait()
    a, b = _load(background.path(1)), _load(waited.path(1))
    _assert_bitwise(_tensors(a), want)
    _assert_bitwise(_tensors(b), want)
    assert {k: v for k, v in a.items() if k not in ("model", "opt_state", "ema")} == \
        {k: v for k, v in b.items() if k not in ("model", "opt_state", "ema")}
    def buffers():
        flats = background._staging[background.directory]["flats"]
        return {dtype: t.data_ptr() for dtype, t in flats.items()}

    first = buffers()
    state, _ = step_fn(state, batches[0])
    background.save(2, state, {"next_index": 3}, {"name": "x"})
    background.wait()
    assert first and buffers() == first
    assert background.steps() == [1, 2]
    # The second write reuses the tensor entries' pickled bytes, with this
    # save's step, stream position and profile beside them.
    second = _load(background.path(2))
    assert second["step"] == 2 and second["data_state"] == {"next_index": 3}
    assert second["profile"] == {"name": "x"} and second["seed"] == state["seed"]
    _assert_bitwise(_tensors(second), _tensors(state))
    # A written snapshot's tensors view one storage a dtype; a restored
    # one's own theirs.
    restored = background.restore("cpu")
    assert restored["step"] == 2
    for t in [*restored["model"].values(), *restored["opt_state"].values(), *restored["ema"]]:
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    logs = _load(background.path(2))["model"]["flow.layers.1.actnorm.logs"]
    assert logs.untyped_storage().nbytes() > logs.numel() * logs.element_size()
    background.close()
    assert background._staging == {}  # close frees them


def test_ckpt_stall_ab_prints_the_jax_tool_keys(capsys):
    """The stall tool on the CPU at a tiny size: the JAX tool's keys and
    the synchronous yardstick, every time positive, its line last."""
    from pytorch_glow_tpu_torch.scripts import ckpt_stall_ab

    r = ckpt_stall_ab.main(["cifar10", "--cpu", "--reps", "2", "--imgs-per-sec", "100",
                            "--set", "glow.hidden_channels=8", "--set", "glow.K=1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# card: cpu" and json.loads(out[-1]) == r
    for key in ("save_return_s", "drain_s", "sync_save_s", "best_save_return_s",
                "best_save_total_s", "stall_pct"):
        assert r[key] > 0, key
    assert r["best_save_total_s"] >= r["best_save_return_s"] and len(r["reps"]) == 2
    assert r["state_mb"] == r["state_bytes"] / 1e6 > 0 and r["platform"] == "cpu"
