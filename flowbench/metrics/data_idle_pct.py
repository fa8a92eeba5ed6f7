"""data_idle_pct.<mode>: the share of the traced window in which the card
sat idle while the host waited in the data layer, for the prefetcher's
next batch (the program's `data.wait` spans; `flowbench/spans.py` splits
the idle gaps).  No spans in the window: nothing is read."""

from flowbench.spans import share


def read(rec: dict, name: str) -> float | None:
    return share(rec, "data")
