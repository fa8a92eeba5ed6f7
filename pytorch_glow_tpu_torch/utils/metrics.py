"""Metrics: CSV scalars, TensorBoard, an images/sec meter, and the logger
over them.

Counterpart of `pytorch_glow_tpu/utils/metrics.py` (`CsvWriter`,
`TBWriter`, `Throughput`, `MetricLogger`).  The TensorBoard writer is
`torch.utils.tensorboard.SummaryWriter` (the JAX package's goes through
`tf.summary`), under <out_dir>/<name>/tb; where `tensorboard` is not
importable it is disabled, as there, with one printed line that says so.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any

import numpy as np


class CsvWriter:
    """CSV scalars with a growable schema: rows append in O(1); only a
    late-appearing metric extending the header triggers a one-off rewrite
    of the file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._fields: list[str] = []
        self._rows: list[dict] = []
        if os.path.isfile(path):
            with open(path, newline="") as f:
                reader = csv.DictReader(f)
                self._fields = list(reader.fieldnames or [])
                self._rows = list(reader)

    def _rewrite(self) -> None:
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields, restval="")
            w.writeheader()
            w.writerows(self._rows)

    def scalars(self, step: int, values: dict[str, float]) -> None:
        row = {"step": step, **{k: float(v) for k, v in values.items()}}
        grew = False
        for k in row:
            if k not in self._fields:
                self._fields.append(k)
                grew = True
        self._rows.append(row)
        if grew or not os.path.isfile(self.path):
            self._rewrite()
        else:
            with open(self.path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fields, restval="").writerow(row)


class TBWriter:
    def __init__(self, logdir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            print(f"[metrics] TensorBoard logging disabled: {e}", flush=True)
            return
        self._writer = SummaryWriter(logdir)

    def scalars(self, step: int, values: dict[str, float]) -> None:
        if self._writer is None:
            return
        for k, v in values.items():
            self._writer.add_scalar(k, float(v), global_step=step)

    def image(self, step: int, tag: str, image: np.ndarray) -> None:
        """One (H, W, C) uint8 image."""
        if self._writer is not None:
            self._writer.add_image(tag, image, global_step=step, dataformats="HWC")

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class Throughput:
    """images/sec meter over a window of steps."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._t0 = time.perf_counter()
        self._steps = 0

    def update(self, n_steps: int = 1) -> None:
        self._steps += n_steps

    def reset_clock(self) -> None:
        """Restart the window (drops the first call's warm-up)."""
        self._t0 = time.perf_counter()
        self._steps = 0

    def rate_and_reset(self) -> float:
        t1 = time.perf_counter()
        rate = self._steps * self.batch_size / max(1e-9, t1 - self._t0)
        self._t0, self._steps = t1, 0
        return rate


class MetricLogger:
    """CSV, TensorBoard and stdout scalars.  With `write=False` (a
    multi-rank run's other ranks) it writes and prints nothing; its
    throughput meter still runs."""

    def __init__(self, out_dir: str, batch_size: int, quiet: bool = False, write: bool = True):
        self.write = write
        self.csv = CsvWriter(os.path.join(out_dir, "metrics.csv")) if write else None
        self.tb = TBWriter(os.path.join(out_dir, "tb")) if write else None
        self.throughput = Throughput(batch_size)
        self.quiet = quiet or not write

    def scalars(self, step: int, values: dict[str, Any]) -> None:
        if not self.write:
            return
        vals = {k: float(v) for k, v in values.items()}
        self.csv.scalars(step, vals)
        self.tb.scalars(step, vals)
        if not self.quiet:
            msg = " ".join(f"{k}={v:.4g}" for k, v in vals.items())
            print(f"[step {step}] {msg}", flush=True)

    def image(self, step: int, tag: str, image: np.ndarray) -> None:
        if self.write:
            self.tb.image(step, tag, image)

    def close(self) -> None:
        if self.write:
            self.tb.close()
