"""On the card: each cell once, a short window, through the command the
benchmark runs, `correct` true and the metrics present.  Skips without a
CUDA card; run on the card with `python -m pytest flowbench/tests -m cuda`."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = next(w for w in BENCH["workloads"] if w["name"] == workload)
    if torch.cuda.device_count() < cell["chips"]:
        pytest.skip(f"needs {cell['chips']} CUDA cards")
    out = subprocess.run([sys.executable, "-m", "flowbench.run", "--workload", workload,
                          "--seed", "5", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert "setup_s" in line["metrics"] and line["device"]["platform"] == "gpu"
