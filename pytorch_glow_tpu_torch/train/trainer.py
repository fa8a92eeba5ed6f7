"""Trainer: the step loop with scalar logs, snapshots and the
non-finite-loss guard.

Counterpart of `pytorch_glow_tpu/train/trainer.py` `train`: calls of
`steps_per_call` steps from the state's step (a second call on the same
`Built`, or a build that resumed from a snapshot, continues where the last
stopped), the images/sec window restarted after the first call, scalars
every `scalar_log_gap` steps (CSV under out_dir/name and stdout), a
rolling snapshot every `checkpoint_gap` steps and a final one when the
call ends without a failure (`utils/checkpoint.py`; none after a failure,
so a bad state never rotates out the last good snapshot), the guard
that stops on persistent non-finite losses, and the step-liveness
watchdog (`_StepWatchdog`, armed by `step_timeout_s`).  The device syncs
only after the first call, at log boundaries and at snapshots.

Not ported yet, each raising NotImplementedError when first reached (not
at build time, so a few steps of any preset run): sample/recon grids
(`plot_gap`), held-out eval (`eval_gap`), SWD (`swd_gap`), the profiler
(`profile_step`) and graceful preemption (SIGTERM).
"""

from __future__ import annotations

import math
import os
import signal
import sys
import threading
import time

import torch

from pytorch_glow_tpu_torch.train.builder import Built
from pytorch_glow_tpu_torch.utils.metrics import MetricLogger
from pytorch_glow_tpu_torch.utils.profiles import profile_to_dict


def _not_ported(what: str, step: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (reached at step {step})")


def _on_sigterm(signum, frame):
    raise NotImplementedError("graceful preemption on SIGTERM is not ported yet")


WEDGE_EXIT_CODE = 17  # distinct from crash codes, so a supervisor can tell
_WEDGE_BUDGET_ENV = "GLOW_WEDGE_RESTART_BUDGET"


class _StepWatchdog:
    """Liveness watchdog for a wedged device call, a copy of the JAX
    trainer's `_StepWatchdog`.

    A call stuck inside the driver never returns to Python, so nothing in
    the loop can notice it; the recovery unit is the process.  `beat()` is
    called once per loop iteration, and the watchdog thread arms at the
    second beat (the first iteration pays the kernel build).  If no beat
    lands for `timeout_s`, it writes a diagnostic to stderr and re-execs
    the process while GLOW_WEDGE_RESTART_BUDGET is above 0 (decrementing
    it; the new run resumes from the newest snapshot), else exits with
    WEDGE_EXIT_CODE.  The port trains in one process, so the re-exec is
    always allowed."""

    def __init__(self, timeout_s: float, poll_s: float | None = None):
        self.timeout_s = timeout_s
        self.poll_s = poll_s if poll_s is not None else min(10.0, max(0.5, timeout_s / 10))
        self._last = time.monotonic()
        self._beats = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self) -> None:
        self._beats += 1
        self._last = time.monotonic()
        if self._beats == 2 and self._thread is None:
            self._thread = threading.Thread(target=self._watch, daemon=True,
                                            name="glow-step-watchdog")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            stale = time.monotonic() - self._last
            if stale > self.timeout_s:
                sys.stderr.write(
                    f"[train] step-liveness watchdog: no progress for {stale:.0f}s "
                    f"(> {self.timeout_s:.0f}s) after {self._beats} loop beats; device call "
                    f"presumed wedged, abandoning this process (the newest snapshot is the "
                    f"resume point)\n")
                sys.stderr.flush()
                self._die()
                return

    def _die(self) -> None:
        budget = int(os.environ.get(_WEDGE_BUDGET_ENV, "0") or 0)
        if budget > 0:
            os.environ[_WEDGE_BUDGET_ENV] = str(budget - 1)
            sys.stderr.write(f"[train] watchdog re-exec ({budget - 1} restart(s) left): "
                             f"{sys.executable} {' '.join(sys.argv)}\n")
            sys.stderr.flush()
            os.execv(sys.executable, [sys.executable] + sys.argv)
        os._exit(WEDGE_EXIT_CODE)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _save(built: Built, state: dict, step: int) -> None:
    built.ckpt.save(step, state, built.data.get_state(), profile_to_dict(built.profile))


def train(built: Built, num_steps: int | None = None, quiet: bool = False) -> dict:
    p = built.profile
    t = p.train
    num_steps = num_steps if num_steps is not None else t.num_steps
    logger = MetricLogger(os.path.join(p.out_dir, p.name), t.batch_size, quiet=quiet)
    state = built.state
    step = first_step = state["step"]
    spc = t.steps_per_call
    last_metrics: dict = {}
    nonfinite_logs = 0
    t_start = time.perf_counter()

    in_main = threading.current_thread() is threading.main_thread()
    prev_handler = signal.signal(signal.SIGTERM, _on_sigterm) if in_main else None
    watchdog = _StepWatchdog(t.step_timeout_s) if t.step_timeout_s else None
    try:
        while step < num_steps:
            if watchdog is not None:
                watchdog.beat()
            if t.profile_step and step == t.profile_step:
                raise _not_ported("the profiler (profile_step)", step)
            images = [torch.from_numpy(next(built.data)["image"]) for _ in range(spc)]
            batch = torch.stack(images) if spc > 1 else images[0]
            state, metrics = built.train_step(state, batch.to(built.device))
            step += spc
            if step == first_step + spc:
                # The first call pays the kernel build and warm-up; its images
                # are not counted either.
                _sync(built.device)
                logger.throughput.reset_clock()
            else:
                logger.throughput.update(spc)

            if step % t.scalar_log_gap == 0 or step == num_steps:
                host = {k: float(v) for k, v in metrics.items()}
                host["images_per_sec"] = logger.throughput.rate_and_reset()
                logger.scalars(step, host)
                last_metrics = host
                if not math.isfinite(host["loss"]):
                    # With skip_nonfinite_updates the optimizer drops bad
                    # steps, so only persistent non-finite logs stop the run.
                    nonfinite_logs += 1
                    limit = 3 if t.skip_nonfinite_updates else 1
                    if nonfinite_logs >= limit:
                        raise FloatingPointError(
                            f"non-finite loss at step {step} "
                            f"({nonfinite_logs} consecutive logs): {host}")
                else:
                    nonfinite_logs = 0
            # The snapshot comes before the boundary's other work, so a
            # failure there keeps it.
            if t.checkpoint_gap and step % t.checkpoint_gap == 0:
                _save(built, state, step)
            for gap_name, what in (("plot_gap", "sample/recon grids"),
                                   ("eval_gap", "held-out eval"), ("swd_gap", "SWD")):
                gap = getattr(t, gap_name)
                if gap and step % gap == 0:
                    raise _not_ported(f"{what} ({gap_name}={gap})", step)
    except BaseException:
        if watchdog is not None:
            watchdog.stop()  # no snapshot follows a failure
        raise
    finally:
        built.state = state  # the model was updated in place either way
        if in_main:
            signal.signal(signal.SIGTERM, prev_handler or signal.SIG_DFL)
    if watchdog is not None:
        # The final snapshot may block on the device, so the thread keeps
        # watching it; one last beat first, so that a clean exit does not
        # trip it.
        watchdog.beat()
    try:
        _save(built, state, step)  # only after a call that did not fail
    finally:
        if watchdog is not None:
            watchdog.stop()  # teardown done; do not police the caller

    return {"final_step": step, "wall_s": time.perf_counter() - t_start,
            "checkpoint_saved": True, **last_metrics}
