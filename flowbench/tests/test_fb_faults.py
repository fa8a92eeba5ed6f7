"""Whole runs of each cell on the CPU at a tiny size, the look for a card
skipped: sound, `correct` is true; with each fault the cell can have
planted in the program underneath (the kind's `FAULTS`), or with the
control (the reference in scaled float8 in the program's place), it is
false against the cell's own limits."""

import importlib

import pytest
import torch

from flowbench import run
from flowbench.reference import glow as ref

torch.set_num_threads(1)

BENCH = run.load_json("BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(workload: str) -> run.Ctx:
    ctx = run.context(BENCH, workload, 2**33 + 17, 0.3, False, "cpu")
    ctx.config["glow"].update(image_shape=[32, 32, 3], hidden_channels=32, K=6, L=3)
    ctx.traffic.update(batch=4, reference_rows=2)
    if "images" in ctx.traffic:
        ctx.traffic["images"] = dict(ctx.traffic["images"], pool=3)
    return ctx


def limits(workload: str) -> dict:
    return run.load_json(f"flowbench/limits/{workload}.json")


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    line = run.run_cell(BENCH, tiny(workload), limits(workload))
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"


def kind_of(workload: str):
    traffic = next(c for c in BENCH["workloads"] if c["name"] == workload)["traffic"]
    return importlib.import_module(
        f"flowbench.kinds.{run.load_json(f'flowbench/traffic/{traffic}.json')['kind']}")


FAULTY = [(w, f) for w in CELLS for f in kind_of(w).FAULTS]


@pytest.mark.parametrize("workload,fault", FAULTY)
def test_planted_fault_is_not_correct(workload, fault):
    ctx = tiny(workload)
    with kind_of(workload).FAULTS[fault]():
        line = run.run_cell(BENCH, ctx, limits(workload))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference in scaled float8 e4m3 put in the program's place."""
    ctx = tiny(workload)
    kind = importlib.import_module(f"flowbench.kinds.{ctx.traffic['kind']}")
    cell = kind.Cell(ctx)
    run.window(cell, ctx)
    answers, _ = cell.close()
    theirs = kind.reference(ctx, answers)
    ok, checks = run.judge(kind.compare(kind.reference(ctx, answers, quant=ref.fp8), theirs),
                           limits(workload))
    assert not ok, checks
