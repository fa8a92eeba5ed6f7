"""optimizer_idle_pct.<mode>: the share of the traced window in which the
card sat idle while the host ran the optimizer and the EMA: the
program's `train.optimizer` (flatten, clip, Adam, apply, the schedule)
and `train.ema` spans (`flowbench/spans.py` splits the idle gaps).  No
spans in the window: nothing is read."""

from flowbench.spans import share


def read(rec: dict, name: str) -> float | None:
    return share(rec, "optimizer")
