"""wrapper_idle_pct.<mode>: the share of the traced window in which the
card sat idle while the host was in the flow-step wrappers and autograd:
the program's `chain.forward`, `chain.reverse` and `chain.backward` spans
(weight packing, the autograd Functions, the launches) and the self time
of `train.backward` (the autograd engine's other nodes;
`flowbench/spans.py` splits the idle gaps).  No spans in the window:
nothing is read."""

from flowbench.spans import share


def read(rec: dict, name: str) -> float | None:
    return share(rec, "wrapper")
