"""The port's multi-rank drills on the CPU (gloo), as the JAX package's
`tests/test_sharding.py` runs its jax.distributed smokes: each drill is a
module of `pytorch_glow_tpu_torch/scripts/` that starts its own ranks
(`file://` rendezvous, no port) and prints one JSON line."""

import json
import subprocess
import sys

import pytest

from pytorch_glow_tpu_torch.scripts import _smoke_common as sc


def _drill(module: str, *args: str) -> dict:
    proc = subprocess.run([sys.executable, "-m", f"pytorch_glow_tpu_torch.scripts.{module}",
                           *args], capture_output=True, text=True, timeout=300, cwd=sc.REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if module in ln][-1]
    out = json.loads(line)
    assert out[module] == "OK", out
    return out


@pytest.mark.multiprocess
@pytest.mark.parametrize("nprocs,model", [(2, 1), (4, 2)])
def test_multihost_smoke(nprocs, model):
    """Every rank logs one global loss; the snapshot every rank took part
    in is resumed by a second build on every rank (2 ranks data=2, and 4
    ranks data=2 x model=2)."""
    out = _drill("multihost_smoke", "--nprocs", str(nprocs), "--model", str(model))
    assert len(out["procs"]) == nprocs
    assert all(p["mesh"] == {"data": nprocs // model, "model": model} for p in out["procs"])


@pytest.mark.multiprocess
def test_preemption_collective_stop():
    """A SIGTERM to one of two ranks stops both at the same step with a
    snapshot; a second wave resumes from it to its end."""
    out = _drill("multihost_preempt_smoke")
    assert all(p["preempted"] for p in out["procs"])
    assert len({p["final_step"] for p in out["procs"]}) == 1 and out["snapshot"]
    assert all(p["final_step"] == out["resumed_to"] for p in out["resume"])


@pytest.mark.multiprocess
def test_tfrecord_rows_partition_an_epoch():
    """Two data ranks read disjoint TFRecord rows that together make the
    epoch, resume from a saved position, and train with one loss."""
    out = _drill("multihost_tfrecord_smoke")
    assert out["per_proc_records"] == [40, 40]
    assert len(set(out["losses"])) == 1


@pytest.mark.multiprocess
def test_dryrun_multichip_four_ranks():
    """`graft_entry.dryrun_multichip(4)`: one real train step on a 2x2
    (DP x TP) mesh of gloo ranks, one finite loss on every rank."""
    from pytorch_glow_tpu_torch import graft_entry

    line = graft_entry.dryrun_multichip(4)
    assert line["mesh"] == {"data": 2, "model": 2} and line["step"] == 1
