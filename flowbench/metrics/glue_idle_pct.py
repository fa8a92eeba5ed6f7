"""glue_idle_pct.<mode>: the share of the traced window in which the card
sat idle while the host ran the model's glue: the self time of the
program's `train.step`, `train.forward`, `glow.sample` and `glow.level`
spans (input prep, flips, generators, metrics, squeezes, splits and
priors; `flowbench/spans.py` splits the idle gaps).  No spans in the
window: nothing is read."""

from flowbench.spans import share


def read(rec: dict, name: str) -> float | None:
    return share(rec, "glue")
