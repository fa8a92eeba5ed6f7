"""Process plumbing shared by the multi-rank drills and tests on the CPU.

Counterpart of `scripts/_smoke_common.py`.  A drill's parent starts one
process per rank (`spawn_ranks`), each of which joins a gloo process group
through a file under a directory of the parent's (`init_gloo`: a
`file://` rendezvous, so no port is chosen and concurrent drills never
collide), runs on one intra-op thread, and cannot outlive its parent or a
wall-clock bound (`install_child_watchdog`).  `communicate_all` never
leaves a child running when a collect times out or raises.
"""

from __future__ import annotations

import ctypes
import os
import signal
import subprocess
import sys
import threading
import time

# Exit code a child uses when its watchdog fires.
WATCHDOG_EXIT = 40
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def install_child_watchdog(max_seconds: int = 600) -> None:
    """Die with the parent (PR_SET_PDEATHSIG, and a thread that polls the
    parent pid) or after `max_seconds` (SIGALRM, whose default action ends
    the process even inside a blocked collective)."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, int(signal.SIGKILL), 0, 0, 0)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):  # not Linux
        pass
    signal.alarm(int(max_seconds))
    parent = os.getppid()
    if parent == 1:
        os._exit(WATCHDOG_EXIT)

    def watch():
        while True:
            if os.getppid() != parent:
                os._exit(WATCHDOG_EXIT)
            time.sleep(1.0)

    threading.Thread(target=watch, daemon=True, name="orphan-watchdog").start()


def init_gloo(rank: int, world: int, store_dir: str) -> None:
    """Join the drill's gloo group (rendezvous file under `store_dir`) on
    one intra-op thread.  TensorBoard is made unimportable first, so the
    trainer's metric logger runs without it: where TensorFlow is installed
    its import costs rank 0 about 17 s of a drill that checks collectives."""
    import torch
    import torch.distributed as dist

    sys.modules["torch.utils.tensorboard"] = None

    torch.set_num_threads(1)
    store = os.path.join(os.path.abspath(store_dir), "rendezvous")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)


def spawn_ranks(argv, world: int, store_dir: str, env: dict | None = None):
    """Start `world` processes `python <argv...> --rank r --world n --store
    store_dir`, with the repository on the path; returns the Popen list."""
    os.makedirs(store_dir, exist_ok=True)
    child_env = {**os.environ, **(env or {})}
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, child_env.get("PYTHONPATH", "")) if p)
    child_env.setdefault("OMP_NUM_THREADS", "1")
    return [subprocess.Popen([sys.executable, *argv, "--rank", str(r), "--world", str(world),
                              "--store", store_dir],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=child_env)
            for r in range(world)]


def communicate_all(procs, timeout: float = 300.0):
    """[(returncode, stdout, stderr)] of every proc, under one deadline; on
    a timeout or error every proc still running is killed and reaped first."""
    results = []
    try:
        deadline = time.monotonic() + timeout
        for pr in procs:
            out, err = pr.communicate(timeout=max(1.0, deadline - time.monotonic()))
            results.append((pr.returncode, out, err))
        return results
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
        for pr in procs:
            try:
                pr.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


def run_ranks(argv, world: int, store_dir: str, timeout: float = 300.0,
              env: dict | None = None) -> list[str]:
    """Run a drill's ranks to the end; raise with their stderr unless every
    one exits 0; return their stdouts."""
    results = communicate_all(spawn_ranks(argv, world, store_dir, env), timeout)
    bad = [(r, rc, err) for r, (rc, _, err) in enumerate(results) if rc != 0]
    if bad:
        raise RuntimeError("\n".join(f"[rank {r}] rc={rc}\n{err[-3000:]}" for r, rc, err in bad))
    return [out for _, out, _ in results]


def rank_args(argv=None):
    """The --rank / --world / --store flags a child takes (plus the rest)."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--store", required=True)
    return p.parse_known_args(argv)
