"""Trainer: the step loop with scalar logs, snapshots, the boundaries'
eval, grids and SWD, and the non-finite-loss guard.

Counterpart of `pytorch_glow_tpu/train/trainer.py` `train`: calls of
`steps_per_call` steps from the state's step (a second call on the same
`Built`, or a build that resumed from a snapshot, continues where the last
stopped), each on device batches from `build`'s prefetcher (stacked on
the device for `steps_per_call > 1`), which every exit of the call closes
(a later call starts it again where this one stopped), the images/sec
window restarted after the first call, scalars every `scalar_log_gap`
steps (CSV and TensorBoard under out_dir/name, and stdout), a rolling
snapshot every `checkpoint_gap` steps and a final one
when the call ends without a failure (`utils/checkpoint.py`; none after a
failure, so a bad state never rotates out the last good snapshot), the
guard that stops on persistent non-finite losses, and the step-liveness
watchdog (`_StepWatchdog`, armed by `step_timeout_s`).  The device syncs
only after the first call, at log boundaries, snapshots and the
boundaries below.

Snapshots are written as the JAX trainer writes them: the rolling one and
the eval's best one return once the state is captured (a copy into host
buffers on the stream) and are written by the manager's writer thread
while the loop goes on; the final one waits for its file, and then
`ckpt.wait()` drains the best saves, so a clean return or a SIGTERM stop
leaves its snapshots on disk.  A failed call takes no new snapshot but
drains the writes in flight before the failure propagates, so a retry
resumes from the newest one.  The watchdog never waits for a write: its
re-exec abandons the write in flight, whose temporary file never replaces
a snapshot.

After the rolling snapshot of a step, in the JAX order, each on the eval
copy of the model (`Built.serving`):

* `plot_gap`: `num_sample_images` samples from the EMA weights at
  `sample_temperature` (annealed over `temperature_anneal_steps`) to
  samples/step_%08d.png, and the reconstruction of the last batch's first
  images with the live weights to recon/step_%08d.png;
* `eval_gap`: `eval_batches` test batches, `eval_nll` with the EMA weights
  and, with an EMA, `eval_nll_raw` with the live ones; `recon_err_max_u8`
  over the first eval batch's first images; a new best snapshot when
  `eval_nll` improves (`best_eval_nll` logged);
* `swd_gap`: `swd_x1e3`, the sliced Wasserstein distance between the
  training batch and T=1.0 samples from the EMA weights (numpy, on the
  host).

A y-conditional profile's labels (`builder.labels_to_onehot`) go with
their batches: into the train steps (stacked for `steps_per_call > 1`),
the eval batches, and, from the last batch of the call, the plot's
samples (its first `num_sample_images`) and the SWD's (its first
`swd_images`), as the JAX trainer passes them.  The class loss
`loss_class` and, under variational dequantization, `vardeq_logq_bits`
are logged with the other scalars.

Each boundary logs its wall time, `plot_ms` / `eval_ms` / `swd_ms` (the
device synced before it; each ends on a host read), and the flow-step
kernel launches it made, `plot_launches` / `eval_launches` /
`swd_launches` (0 on the CPU, where no kernel runs); the host parts apart
as `swd_host_ms` (the numpy SWD) and `best_save_ms` (what the loop waits
for of the eval's best-snapshot check and save: the decision, the capture
and its copy, not the write).  A rolling snapshot logs `save_ms`, the same
for its save (the device synced before it).

`profile_step` traces `profile_num_steps` steps with `torch.profiler` (CPU,
and CUDA on the card) into out_dir/name/profile/, the program's spans
beside its operations.  A SIGTERM stops the loop at the next step
boundary; the final snapshot is written and the result says
`"preempted": True` (rerun the same command to resume).

On a mesh (`Built.mesh`, several ranks): every rank runs the loop and every
boundary, on its rows, and rank 0 alone writes metrics.csv, TensorBoard,
the PNGs, the SWD and the profiler trace.  The SIGTERM flag is
MAX-all-reduced at `scalar_log_gap` boundaries, the same step numbers on
every rank, so all ranks stop at one step (a one-sided stop would leave
the others blocked in the next collective).  The eval metrics are global:
`eval_nll` the data-group mean, `recon_err_max_u8` its maximum.  The
eval copy and the snapshots take gathered (full) weights.  The watchdog
never re-execs a multi-rank run: it exits with WEDGE_EXIT_CODE, and the
launcher owns the restart.
"""

from __future__ import annotations

import itertools
import math
import os
import signal
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from pytorch_glow_tpu_torch.ops import flowstep
from pytorch_glow_tpu_torch.parallel import distributed as pd
from pytorch_glow_tpu_torch.parallel.mesh import gather_params
from pytorch_glow_tpu_torch.train import step as steplib
from pytorch_glow_tpu_torch.train.builder import Built, labels_to_onehot
from pytorch_glow_tpu_torch.utils import spans
from pytorch_glow_tpu_torch.utils.image import save_image_grid
from pytorch_glow_tpu_torch.utils.metrics import MetricLogger
from pytorch_glow_tpu_torch.utils.profiles import profile_to_dict
from pytorch_glow_tpu_torch.utils.summary import summarize
from pytorch_glow_tpu_torch.utils.swd import sliced_wasserstein


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
    WEDGE_EXIT_CODE.  A multi-rank run always exits: a one-sided re-exec
    would leave its peers in a collective the new process never joins."""

    def __init__(self, timeout_s: float, poll_s: float | None = None, on_die=None):
        self.timeout_s = timeout_s
        self.on_die = on_die  # called before the re-exec or exit
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
        """Stop the thread and wait for it to end.  A daemon thread still
        running when the interpreter finalizes is ended from inside
        whatever torch op it is in, which aborts the process ("terminate
        called without an active exception", exit code 134) after the
        run's result."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

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
        if self.on_die is not None:
            try:
                self.on_die()
            except Exception as e:  # the re-exec must happen all the same
                sys.stderr.write(f"[train] watchdog cleanup failed: {type(e).__name__}: {e}\n")
        budget = int(os.environ.get(_WEDGE_BUDGET_ENV, "0") or 0)
        if budget > 0 and pd.world_size() == 1:
            os.environ[_WEDGE_BUDGET_ENV] = str(budget - 1)
            sys.stderr.write(f"[train] watchdog re-exec ({budget - 1} restart(s) left): "
                             f"{sys.executable} {' '.join(sys.argv)}\n")
            sys.stderr.flush()
            os.execv(sys.executable, [sys.executable] + sys.argv)
        os._exit(WEDGE_EXIT_CODE)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _save(built: Built, state: dict, step: int, wait: bool = False) -> None:
    built.ckpt.save(step, state, built.data.get_state(), profile_to_dict(built.profile),
                    wait=wait)


def _timed_save(built: Built, state: dict, step: int) -> dict:
    """The rolling snapshot, and `save_ms`: the wall time the loop spends
    on it, the capture's copy included."""
    _sync(built.device)
    t0 = time.perf_counter()
    _save(built, state, step)
    _sync(built.device)
    return {"save_ms": 1e3 * (time.perf_counter() - t0)}


def _writer(built: Built) -> bool:
    """Whether this rank writes the run's files (rank 0, or a lone process)."""
    return built.mesh is None or dist.get_rank() == 0


def _serving(built: Built, sd: dict):
    """The eval copy holding the full tensors of the (sharded) `sd`."""
    return built.serving(gather_params(sd, built.mesh))


def _preempt_stop(built: Built, preempt: dict, step: int, log_gap: int) -> bool:
    """True when the loop should stop for a delivered SIGTERM; on a mesh the
    decision is collective, taken at `log_gap` boundaries."""
    if built.mesh is None:
        return preempt["sig"] is not None
    if log_gap and step % log_gap:
        return False
    flag = torch.tensor([int(preempt["sig"] is not None)], dtype=torch.int32,
                        device=pd.comm_device())
    pd.all_reduce_(flag, None, dist.ReduceOp.MAX)
    return bool(flag.item())


class _Profiler:
    """torch.profiler from `start(step)` to `stop()`, a Chrome trace of it
    written to `out_dir` at the stop, with the program's spans of the
    window (`utils/spans.py`: the step's phases, levels and flow-step
    chains) on their threads beside the operations and kernels.  It writes
    whatever it recorded: an empty trace never fails the run."""

    def __init__(self, out_dir: str, device: torch.device):
        self.out_dir, self.device = out_dir, device
        self._prof = None
        self._since_ns = 0
        self.path: str | None = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self, step: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._since_ns = time.time_ns()
        self._prof.start()
        self.path = os.path.join(self.out_dir, f"trace_step_{step:08d}.json")

    def stop(self) -> None:
        prof, self._prof = self._prof, None
        try:
            _sync(self.device)
        finally:
            prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        prof.export_chrome_trace(self.path)
        spans.add_to_chrome_trace(self.path, self._since_ns)


def _boundary(kind: str, fn, built: Built, *args) -> dict:
    """`fn(built, *args)`'s metrics with the boundary's wall ms and its
    flow-step kernel launches."""
    _sync(built.device)
    before = sum(flowstep.launches.values())
    t0 = time.perf_counter()
    out = fn(built, *args)
    return {**out, f"{kind}_ms": 1e3 * (time.perf_counter() - t0),
            f"{kind}_launches": sum(flowstep.launches.values()) - before}


def _labels(y: torch.Tensor | None, n: int | None = None) -> dict:
    """The labels keyword of a step or sample call on a y-conditional
    profile (their first `n` rows); none on an unconditional one."""
    return {} if y is None else {"y_onehot": y[:n]}


def _plot(built: Built, state: dict, step: int, images: np.ndarray, y, out_dir: str) -> dict:
    t = built.profile.train
    temp = t.sample_temperature
    if t.temperature_anneal_steps:
        temp *= min(1.0, step / t.temperature_anneal_steps)
    gen = steplib.step_generator(t.seed + 2, step, built.device)
    samples = built.sample_fn(_serving(built, steplib.ema_params(state)), gen, temp,
                              **_labels(y, t.num_sample_images)).cpu().numpy()
    live = _serving(built, state["model"].state_dict())
    recon = built.reconstruct_fn(live, torch.from_numpy(images[: t.num_sample_images]))
    recon = recon.cpu().numpy()
    if _writer(built):
        save_image_grid(os.path.join(out_dir, "samples", f"step_{step:08d}.png"), samples)
        save_image_grid(os.path.join(out_dir, "recon", f"step_{step:08d}.png"), recon)
    return {}


def _eval(built: Built, state: dict, step: int) -> dict:
    t = built.profile.train
    group = list(itertools.islice(built.eval_data, t.eval_batches))
    if not group:
        return {}
    batches = [b["image"] for b in group]
    stacked = torch.from_numpy(np.stack(batches)).to(built.device)
    ys = [labels_to_onehot(b, built.profile) for b in group]
    y = None if ys[0] is None else torch.stack(ys)
    ev = {"eval_nll": float(built.eval_step_n(_serving(built, steplib.ema_params(state)),
                                              stacked, **_labels(y))["nll"])}
    live = _serving(built, state["model"].state_dict())
    if "ema" in state:
        # The live weights on the same batches: every EMA run carries its
        # own control.
        ev["eval_nll_raw"] = float(built.eval_step_n(live, stacked, **_labels(y))["nll"])
    # Round-trip drift: decode(encode(x)) against x in uint8.
    xb = batches[0][: t.num_sample_images]
    rec = built.reconstruct_fn(live, torch.from_numpy(xb)).cpu().numpy()
    err = float(np.abs(xb.astype(np.int16) - rec.astype(np.int16)).max())
    if built.mesh is not None:
        err_t = torch.tensor([err], device=pd.comm_device())
        err = float(pd.all_reduce_(err_t, built.mesh.data_group, dist.ReduceOp.MAX).item())
    ev["recon_err_max_u8"] = err
    t0 = time.perf_counter()
    if math.isfinite(ev["eval_nll"]) and built.ckpt.maybe_save_best(
            step, state, ev["eval_nll"], built.data.get_state(), profile_to_dict(built.profile)):
        ev["best_eval_nll"] = ev["eval_nll"]
        _sync(built.device)  # the capture's copy
    ev["best_save_ms"] = 1e3 * (time.perf_counter() - t0)
    return ev


def _swd(built: Built, state: dict, step: int, images: np.ndarray, y) -> dict:
    t = built.profile.train
    n = min(t.swd_images, images.shape[0])  # this rank's rows
    gen = steplib.step_generator(t.seed + 3, step, built.device)
    fake = built.swd_sample_fn(_serving(built, steplib.ema_params(state)), gen,
                               **_labels(y, n)).cpu().numpy()
    if not _writer(built):
        return {}
    t0 = time.perf_counter()
    swd = sliced_wasserstein(images[:n], fake, seed=t.seed)["swd_avg"]
    return {"swd_x1e3": swd, "swd_host_ms": 1e3 * (time.perf_counter() - t0)}


def train(built: Built, num_steps: int | None = None, quiet: bool = False) -> dict:
    p = built.profile
    t = p.train
    num_steps = num_steps if num_steps is not None else t.num_steps
    out_dir = os.path.join(p.out_dir, p.name)
    writer = _writer(built)
    logger = MetricLogger(out_dir, t.batch_size, quiet=quiet, write=writer)
    state = built.state
    if not quiet and writer:
        print(f"[train] {summarize(state['model'], p.glow)}", flush=True)
    step = first_step = state["step"]
    spc = t.steps_per_call
    last_metrics: dict = {}
    nonfinite_logs = 0
    t_start = time.perf_counter()
    profiler = _Profiler(os.path.join(out_dir, "profile"), built.device)

    # Graceful preemption: a SIGTERM sets the flag, and the loop stops at
    # the next step boundary.  Handlers can only be installed from the main
    # thread; elsewhere preemption stays off.
    preempt: dict = {"sig": None}
    stopped_early = False
    in_main = threading.current_thread() is threading.main_thread()
    prev_handler = (signal.signal(signal.SIGTERM,
                                  lambda signum, frame: preempt.__setitem__("sig", signum))
                    if in_main else None)
    # The prefetcher's thread may be stuck behind a wedged device: wait for
    # it a few seconds at most before the re-exec.
    watchdog = (_StepWatchdog(t.step_timeout_s, on_die=lambda: built.data.close(timeout=5.0))
                if t.step_timeout_s else None)
    try:
        while step < num_steps:
            if watchdog is not None:
                watchdog.beat()
            if _preempt_stop(built, preempt, step, t.scalar_log_gap):
                stopped_early = True
                if not quiet:
                    print(f"[train] SIGTERM: stopping at step {step} (snapshot will be written)",
                          flush=True)
                break
            if (t.profile_step and step == t.profile_step and not profiler.active
                    and writer):
                profiler.start(step)
            group = [next(built.data) for _ in range(spc)]
            images = [b["image"] for b in group]
            ys = [labels_to_onehot(b, p) for b in group]
            y = ys[-1]  # the last micro-batch's, with its images below
            if spc > 1:
                y_stack = None if y is None else torch.stack(ys)
                state, metrics = built.train_step(state, torch.stack(images), **_labels(y_stack))
            else:
                state, metrics = built.train_step(state, images[0], **_labels(y))
            step += spc
            if step == first_step + spc:
                # The first call pays the kernel build and warm-up; its images
                # are not counted either.
                _sync(built.device)
                logger.throughput.reset_clock()
            else:
                logger.throughput.update(spc)
            if profiler.active and step >= t.profile_step + t.profile_num_steps:
                profiler.stop()

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
                logger.scalars(step, _timed_save(built, state, step))
            # The last micro-batch feeds the grids and SWD.
            plot = t.plot_gap and step % t.plot_gap == 0
            swd = t.swd_gap and step % t.swd_gap == 0
            last = images[-1].cpu().numpy() if plot or swd else None
            if plot:
                logger.scalars(step, _boundary("plot", _plot, built, state, step, last, y,
                                               out_dir))
            if t.eval_gap and step % t.eval_gap == 0 and built.eval_data is not None:
                logger.scalars(step, _boundary("eval", _eval, built, state, step))
            if swd:
                logger.scalars(step, _boundary("swd", _swd, built, state, step, last, y))
    except BaseException:
        # No snapshot follows a failure, but the writes in flight land
        # before it propagates (a retry resumes from the newest), still
        # under the watchdog; no barrier, as the other ranks may not come.
        try:
            built.ckpt.wait(barrier=False)
        except Exception as e:
            print(f"[train] a snapshot write in flight also failed: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
        if watchdog is not None:
            watchdog.stop()
        if profiler.active:
            # After a device error the profiler's sync raises again: report
            # that, and let the original failure propagate.
            try:
                profiler.stop()
            except Exception as e:
                print(f"[train] profiler stop after a failure also failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
        raise
    finally:
        built.state = state  # the model was updated in place either way
        built.data.close()
        if in_main:
            signal.signal(signal.SIGTERM, prev_handler or signal.SIG_DFL)
        try:
            if profiler.active:
                profiler.stop()
        finally:
            logger.close()
    if watchdog is not None:
        # The final snapshot may block on the device, so the thread keeps
        # watching it; one last beat first, so that a clean exit does not
        # trip it.
        watchdog.beat()
    try:
        _save(built, state, step, wait=True)  # only after a call that did not fail
        built.ckpt.wait()  # the best saves in flight
    finally:
        if watchdog is not None:
            watchdog.stop()  # teardown done; do not police the caller

    result = {"final_step": step, "wall_s": time.perf_counter() - t_start,
              "checkpoint_saved": True, **last_metrics}
    if stopped_early:
        result["preempted"] = True
    return result
