"""flowstep_roofline.<mode>: the flow-step chains' share of their roofline
over the traced window: the least time of the window's chain calls,
counted from the model's shapes and steps (`flowbench.counts`), over the
device time of the chains' kernels in the trace, named in
`flowstep_roofline.json`.  The device time no name matched is printed.
No chain kernel in the trace: nothing is read."""

import json
import sys
from pathlib import Path

from flowbench.counts import call_bound_ms

KERNELS = set(json.loads((Path(__file__).with_suffix(".json")).read_text())["kernels"])


def read(rec: dict, name: str) -> float | None:
    tr = rec["trace"]
    if tr is None:
        return None
    chain_s = tr.device_s(KERNELS)
    print(f"{name}: chain kernels {chain_s!r} s, other device operations "
          f"{tr.device_s() - chain_s!r} s", file=sys.stderr)
    if chain_s <= 0:
        return None
    bound_s = 1e-3 * call_bound_ms(rec["glow"], rec["batch"], rec["chains"]) * rec["calls"]
    return 100.0 * bound_s / chain_s
