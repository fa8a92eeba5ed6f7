"""BENCHMARK.json against the harness: names and units in the allowed
characters, every per-layer metric listing its cells and each of them
reporting the end-to-end metric it moves, every name resolving to its
file, every configuration naming its source and running whole, and no
JAX and no JAX package in a process that has imported the harness."""

import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", CELLS)


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in METRICS] + list(CELLS) + [c["name"] for c in BENCH["configs"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    for name in names:
        assert NAME.fullmatch(name), name
    for m in METRICS:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in METRICS}) == len(METRICS)


def test_per_layer_metrics_list_their_cells_which_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if reports(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(reports(m, cell) for m in BENCH["per_layer"]), cell


def test_names_resolve_to_their_files():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["published"] and cfg["assumed"]
    for w in BENCH["workloads"]:
        traffic = json.loads((ROOT / "flowbench" / "traffic" / f"{w['traffic']}.json").read_text())
        kind = importlib.import_module(f"flowbench.kinds.{traffic['kind']}")
        assert hasattr(kind, "Cell") and hasattr(kind, "reference") and hasattr(kind, "compare")
        assert json.loads((ROOT / "flowbench" / "limits" / f"{w['name']}.json").read_text())
    for m in METRICS:
        assert hasattr(importlib.import_module(f"flowbench.metrics.{m['name'].split('.')[0]}"),
                       "read")


def test_configurations_run_at_their_published_widths():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        pub, glow = cfg["published"], cfg["glow"]
        assert list(pub["image_shape"]) == glow["image_shape"]
        assert pub["hidden_channels"] == glow["hidden_channels"]
        assert pub["steps_per_level_K"] == glow["K"]
        assert pub["n_bits_x"] == glow["n_bits_x"]


def test_no_jax_after_importing_the_harness():
    code = ("import sys, pkgutil, importlib, flowbench.run, flowbench.control\n"
            "import flowbench.kinds, flowbench.metrics\n"
            "for pkg in (flowbench.kinds, flowbench.metrics):\n"
            "    for m in pkgutil.iter_modules(pkg.__path__):\n"
            "        importlib.import_module(pkg.__name__ + '.' + m.name)\n"
            "bad = {'jax', 'jaxlib', 'flax', 'pytorch_glow_tpu'}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("module", ["flowbench.reference.glow", "flowbench.reference.optim"])
def test_reference_imports_nothing_of_the_program(module):
    code = (f"import sys, {module}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('pytorch_glow')"
            " or m.split('.')[0] in ('jax', 'flax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
