"""The port's spans (`utils/spans.py`): nothing recorded outside a
torch.profiler session; inside one, the train step's, sampling's and the
prefetcher's spans as a tree on the profiler's clock; the trainer's
profile trace carrying them.  Tiny fused models on the CPU, seconds."""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pytorch_glow_tpu_torch import GlowConfig, OptimConfig, TrainConfig
from pytorch_glow_tpu_torch.data.pipeline import DevicePrefetch
from pytorch_glow_tpu_torch.models.glow import init_glow
from pytorch_glow_tpu_torch.train import step as steplib
from pytorch_glow_tpu_torch.train import trainer
from pytorch_glow_tpu_torch.train.optim import make_optimizer, make_schedule
from pytorch_glow_tpu_torch.utils import spans

CFG = GlowConfig(image_shape=(8, 8, 3), hidden_channels=16, K=2, L=2,
                 compute_dtype="bfloat16", flowstep_impl="pallas")


@pytest.fixture(autouse=True)
def fresh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.clear()
    yield
    spans.clear()
    torch.set_num_threads(threads)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _batches(n=4):
    rng = np.random.default_rng(0)
    while True:
        yield {"image": rng.integers(0, 256, (n, *CFG.image_shape), dtype=np.uint8)}


def _train_setup():
    torch.manual_seed(0)
    model = init_glow(CFG, torch.Generator().manual_seed(0), "cpu")
    model.ddi_init(model.preprocess(torch.from_numpy(next(_batches())["image"])))
    tcfg = TrainConfig(batch_size=4, ema_decay=0.99)
    tx = make_optimizer(OptimConfig(), tcfg)
    state = steplib.init_state(model, tx, tcfg.ema_decay, seed=3)
    step = steplib.make_train_step(CFG, tx, tcfg.ema_decay, make_schedule(OptimConfig()))
    return state, step, DevicePrefetch(_batches(), "cpu", 2)


def _one_step(state, step, data):
    return step(state, next(data)["image"])


def test_no_profiler_no_records():
    assert spans.span("x") is spans.NO_SPAN and spans.span("y", a=1) is spans.NO_SPAN
    state, step, data = _train_setup()
    try:
        _one_step(state, step, data)
    finally:
        data.close()
    assert spans.recorded() == [] and spans.dropped() == 0


def test_train_step_records_its_tree_under_one_call():
    state, step, data = _train_setup()
    try:
        with _cpu_profile():
            _one_step(state, step, data)
    finally:
        data.close()
    recs = spans.recorded()
    by_id = {r.id: r for r in recs}
    names = [r.name for r in recs]
    kl = CFG.K * CFG.L
    assert names.count("chain.forward") == kl and names.count("chain.backward") == kl
    assert names.count("glow.level") == CFG.L
    for n in ("data.wait", "train.step", "train.forward", "train.backward", "train.optimizer",
              "train.ema"):
        assert names.count(n) == 1, n
    wait = next(r for r in recs if r.name == "data.wait")
    assert wait.parent is None and wait.depth == 0 and isinstance(wait.attrs["starved"], bool)
    root = next(r for r in recs if r.name == "train.step")
    assert root.parent is None and root.depth == 0 and root.attrs == {"step": 0}
    step_spans = [r for r in recs if r is not wait]
    assert {r.call for r in step_spans} == {root.id}
    parent = {r.name: by_id[r.parent].name for r in step_spans if r.parent is not None}
    assert parent == {"train.forward": "train.step", "train.backward": "train.step",
                      "train.optimizer": "train.step", "train.ema": "train.step",
                      "glow.level": "train.forward", "chain.forward": "glow.level",
                      "chain.backward": "train.backward"}
    for r in step_spans:
        assert r.depth == (0 if r.parent is None else by_id[r.parent].depth + 1)
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
    levels = [r.attrs for r in recs if r.name == "glow.level"]
    assert levels == [{"level": i, "direction": "encode"} for i in range(CFG.L)]
    assert {r.attrs["route"] for r in recs if r.name.startswith("chain.")} == {"whole"}


def test_sample_records_levels_and_reverse_chains():
    model = init_glow(CFG, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad(), _cpu_profile():
        model.sample(2, 0.7, torch.Generator().manual_seed(1))
    recs = spans.recorded()
    by_id = {r.id: r for r in recs}
    root = next(r for r in recs if r.name == "glow.sample")
    assert root.depth == 0 and root.attrs == {"n": 2}
    levels = [r for r in recs if r.name == "glow.level"]
    chains = [r for r in recs if r.name == "chain.reverse"]
    assert [r.attrs["level"] for r in levels] == list(range(CFG.L - 1, -1, -1))
    assert {r.attrs["direction"] for r in levels} == {"decode"}
    assert {by_id[r.parent].name for r in levels} == {"glow.sample"}
    assert len(chains) == CFG.K * CFG.L
    assert {by_id[r.parent].name for r in chains} == {"glow.level"}
    assert len(recs) == 1 + CFG.L + CFG.K * CFG.L


def test_a_span_opened_on_another_thread_joins_the_open_call():
    with _cpu_profile():
        with spans.span("root"), spans.span("inner"):
            t = threading.Thread(target=lambda: spans.span("worker").__enter__().__exit__())
            t.start()
            t.join()
        with spans.span("later"):
            pass
    recs = {r.name: r for r in spans.recorded()}
    assert recs["worker"].parent == recs["inner"].id and recs["worker"].depth == 2
    assert recs["worker"].call == recs["root"].id and recs["worker"].tid != recs["root"].tid
    assert recs["later"].parent is None and recs["later"].call == recs["later"].id


def test_threads_recording_at_once_lose_no_record(monkeypatch):
    """More threads than cores, switching often: every span is kept or
    counted as dropped past the cap, and every thread's stack unwinds."""
    monkeypatch.setattr(spans, "CAP", 1000)
    threads, each = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            def work():
                for _ in range(each // 2):
                    with spans.span("a"), spans.span("b"):
                        pass
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert len(spans.recorded()) == 1000 and spans.dropped() == threads * each - 1000
    assert spans._root_stack is None


def test_profiler_events_lie_inside_their_span():
    """The spans' clock is the profiler's: an event recorded inside a span
    starts and ends within it."""
    with _cpu_profile() as prof:
        for i in range(3):
            with spans.span(f"outer{i}"):
                with record_function(f"marker{i}"):
                    torch.ones(64).sum()
    recs = {r.name: r for r in spans.recorded()}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for i in range(3):
        ev, sp = events[f"marker{i}"], recs[f"outer{i}"]
        assert sp.start_ns <= ev.start_ns() <= ev.start_ns() + ev.duration_ns() <= sp.end_ns


@pytest.mark.cuda
def test_span_brackets_its_kernel_in_a_cuda_only_session():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(2048, 2048, device="cuda")
    (x @ x).sum().item()  # warm up the library
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with spans.span("kernel") as sp:
            assert isinstance(sp, spans.Span)
            y = x @ x
            torch.cuda.synchronize()
    del y
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0]
    assert kernels
    for e in kernels:
        assert sp.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= sp.end_ns, \
            (sp, e.name(), e.start_ns(), e.duration_ns())


def test_profile_trace_holds_the_train_steps_spans(tmp_path):
    state, step, data = _train_setup()
    prof = trainer._Profiler(str(tmp_path), torch.device("cpu"))
    try:
        prof.start(1)
        state, _ = _one_step(state, step, data)
        _one_step(state, step, data)
        prof.stop()
    finally:
        data.close()
    events = json.loads((tmp_path / "trace_step_00000001.json").read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "span"]
    steps = [e for e in ours if e["name"] == "train.step"]
    assert [e["args"]["step"] for e in steps] == [0, 1]
    assert all(e["ph"] == "X" and e["dur"] > 0 for e in ours)
    assert len(ours) == len(spans.recorded())
    # On the profiler's own time axis: the step's aten operations lie inside it.
    first = steps[0]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["tid"] == first["tid"]
           and first["ts"] <= e["ts"] <= first["ts"] + first["dur"]]
    assert ops
