"""The benchmark's split of the traced window's idle gaps by the program's
spans (`flowbench/spans.py`), on synthetic busy intervals and spans."""

from types import SimpleNamespace

import pytest

from flowbench import spans as fbspans
from flowbench.trace import Trace
from pytorch_glow_tpu_torch.utils import spans as pspans

_ids = iter(range(1, 10**6))


def _rec(name, start, end, depth, **attrs):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end, depth=depth, id=next(_ids),
                           attrs=attrs)


def _owned(records, idle):
    owned, none = fbspans.attribute(records, idle)
    return {r.name: ns for r, ns in zip(records, owned)}, none


def test_nested_spans_take_their_self_time():
    records = [_rec("train.step", 0, 100, 0), _rec("train.forward", 20, 60, 1)]
    owned, none = _owned(records, [(10, 70)])
    assert owned == {"train.step": 20, "train.forward": 40} and none == 0


def test_a_deeper_span_on_another_thread_owns_the_gap():
    """The autograd engine's chain span (depth 2, its parent on the main
    thread) owns the gap over it; the rest of the gap is the backward's."""
    records = [_rec("train.step", 0, 100, 0), _rec("train.backward", 10, 90, 1),
               _rec("chain.backward", 30, 50, 2)]
    owned, none = _owned(records, [(20, 60)])
    assert owned == {"train.step": 0, "train.backward": 20, "chain.backward": 20}
    assert none == 0


def test_equal_depth_goes_to_the_span_opened_last():
    records = [_rec("a", 0, 100, 1), _rec("b", 40, 100, 1)]
    owned, _ = _owned(records, [(30, 60)])
    assert owned == {"a": 10, "b": 20}


def test_a_gap_splits_between_two_spans_and_the_harness():
    records = [_rec("data.wait", 0, 50, 0), _rec("train.step", 50, 100, 0)]
    owned, none = _owned(records, [(40, 60), (100, 130), (200, 250)])
    assert owned == {"data.wait": 10, "train.step": 10} and none == 30 + 50


def test_gaps_lie_between_busy_intervals_only():
    assert fbspans.gaps([(0, 10), (10, 20), (25, 30), (40, 50)]) == [(20, 25), (30, 40)]


def test_layer_shares_and_the_unattributed_share_sum_to_the_gaps(monkeypatch):
    # Busy 0-100, 150-300, 320-500, 600-1000 ns: gaps 100-150, 300-320, 500-600.
    ops = [("k", 0, 100), ("k", 150, 300), ("k", 320, 500), ("k", 600, 1000)]
    records = [
        _rec("data.wait", 90, 160, 0, starved=True),
        _rec("train.step", 160, 700, 0, step=0),
        _rec("train.backward", 290, 330, 1),
        _rec("chain.backward", 305, 315, 2, route="band"),
        _rec("train.optimizer", 510, 560, 1),
        _rec("train.step", 2000, 2100, 0),  # after the window's end: not counted
    ]
    monkeypatch.setattr(pspans, "recorded", lambda: records)
    rec = {"trace": Trace(ops=ops), "window_s": 1000e-9, "calls": 1}
    out = fbspans.split(rec)
    # data.wait 100-150; backward 300-305, 315-320; chain 305-315; optimizer
    # 510-560; train.step 500-510, 560-600; nothing unattributed.
    assert out.layers == pytest.approx({"data": 5.0, "wrapper": 2.0, "optimizer": 5.0,
                                        "glue": 5.0})
    assert out.unattributed == 0 and out.gaps == pytest.approx(17.0)
    assert sum(out.layers.values()) + out.unattributed == pytest.approx(out.gaps)
    assert fbspans.share(rec, "data") == pytest.approx(5.0)
    assert fbspans.share(rec, "optimizer") == pytest.approx(5.0)
    # A window whose spans leave a gap uncovered.
    rec2 = {"trace": Trace(ops=ops), "window_s": 1000e-9, "calls": 1}
    monkeypatch.setattr(pspans, "recorded", lambda: records[:1])
    out2 = fbspans.split(rec2)
    assert out2.layers == pytest.approx({"data": 5.0})
    assert out2.unattributed == pytest.approx(12.0)
    assert sum(out2.layers.values()) + out2.unattributed == pytest.approx(out2.gaps)


def test_no_spans_no_reading(monkeypatch):
    ops = [("k", 0, 100), ("k", 150, 300)]
    monkeypatch.setattr(pspans, "recorded", lambda: [])
    assert fbspans.share({"trace": Trace(ops=ops), "window_s": 1e-6, "calls": 1}, "data") is None
    assert fbspans.share({"trace": None, "window_s": 1.0, "calls": 1}, "data") is None
