"""The traced window's idle time split by the program's layer that left
the card waiting, read from the program's spans
(`pytorch_glow_tpu_torch.utils.spans`, recorded while the window's
profiler runs, on the clock of the profiler's events).

The window's spans are those that started within its seconds, which end
where its last device operation ends.  Each idle gap between two of the
window's busy intervals (`Trace.busy`) is cut at the spans' boundaries;
each piece goes to the deepest span open over it on any thread, the one
opened last where two are as deep: exact self time.  A span's piece
counts for its layer (`LAYERS`); a piece under no span is the harness's
own time between calls, unattributed.  The window's head and tail are no
gap, so the layers and the unattributed share add up to the gaps' total,
a little under `idle_pct`.  A program without the spans module, or a
window in which it recorded nothing, reads nothing.
"""

from __future__ import annotations

import sys
from collections import Counter, defaultdict
from dataclasses import dataclass

# The layer of each span the program records (PERF.md §3).
LAYERS = {
    "data.wait": "data",
    "train.step": "glue", "train.forward": "glue", "glow.sample": "glue", "glow.level": "glue",
    "train.backward": "wrapper", "chain.forward": "wrapper", "chain.reverse": "wrapper",
    "chain.backward": "wrapper",
    "train.optimizer": "optimizer", "train.ema": "optimizer",
}
OTHER = "other"  # a span this table does not name yet


def gaps(busy: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The idle intervals between consecutive busy ones."""
    return [(a, b) for (_, a), (b, _) in zip(busy, busy[1:]) if b > a]


def attribute(records, idle: list[tuple[int, int]]) -> tuple[list[int], int]:
    """(ns of the idle intervals owned by each record, in order; ns under
    none).  Records carry `start_ns`, `end_ns`, `depth` and `id`; the
    owner of a piece is the deepest record open over it, the one opened
    last among equals."""
    events = []
    for i, r in enumerate(records):
        if r.end_ns > r.start_ns:
            events += [(r.start_ns, 1, i), (r.end_ns, -1, i)]
    for a, b in idle:
        events += [(a, 1, -1), (b, -1, -1)]
    events.sort(key=lambda e: e[0])
    owned, none = [0] * len(records), 0
    open_: set[int] = set()
    in_gap, prev = 0, None
    for t, step, i in events:
        if in_gap and t > prev:
            if open_:
                owner = max(open_, key=lambda j: (records[j].depth, records[j].start_ns,
                                                  records[j].id))
                owned[owner] += t - prev
            else:
                none += t - prev
        prev = t
        if i < 0:
            in_gap += step
        elif step > 0:
            open_.add(i)
        else:
            open_.discard(i)
    return owned, none


def window_records(records, busy: list[tuple[int, int]], window_s: float) -> list:
    """The records whose span started within the window: its seconds back
    from the end of its last device operation."""
    end = busy[-1][1]
    start = end - int(window_s * 1e9)
    return [r for r in records if start <= r.start_ns <= end]


@dataclass
class Split:
    """A traced window's idle gaps in % of the window: by layer, under no
    span, and their total."""

    layers: dict[str, float]
    unattributed: float
    gaps: float


def split(rec: dict) -> Split | None:
    """The run's traced window split, or None where the program recorded no
    span in it.  Worked out once a run (kept in `rec` for the other
    readers) and printed then, to standard error, with the chain spans a
    call by route, the idle microseconds per chain launch and the
    prefetcher's starved waits."""
    if "spans_split" in rec:
        return rec["spans_split"]
    rec["spans_split"] = None
    tr = rec["trace"]
    if tr is None or not tr.ops:
        return None
    try:
        from pytorch_glow_tpu_torch.utils import spans
    except ImportError:
        return None
    busy = tr.busy
    records = window_records(spans.recorded(), busy, rec["window_s"])
    if not records:
        return None
    idle = gaps(busy)
    owned, none = attribute(records, idle)
    scale = 100.0 / (rec["window_s"] * 1e9)
    layers: dict[str, float] = defaultdict(float)
    for r, ns in zip(records, owned):
        layers[LAYERS.get(r.name, OTHER)] += ns * scale
    out = Split(dict(layers), none * scale, sum(b - a for a, b in idle) * scale)
    rec["spans_split"] = out
    _report(rec, records, owned, out, spans.dropped())
    return out


def _report(rec: dict, records, owned: list[int], out: Split, dropped: int) -> None:
    idle_pct = 100.0 * (1.0 - rec["trace"].busy_s() / rec["window_s"])
    print(f"spans: {len(records)} in the window ({dropped} dropped); gaps {out.gaps!r} % of "
          f"the window against idle_pct {idle_pct!r} %; unattributed {out.unattributed!r} %; "
          f"by layer {out.layers!r}", file=sys.stderr)
    count, idle_ns = Counter(), Counter()
    for r, ns in zip(records, owned):
        if r.name.startswith("chain."):
            key = f"{r.name}/{r.attrs.get('route', '?')}"
            count[key] += 1
            idle_ns[key] += ns
    per_call = {k: n / rec["calls"] for k, n in sorted(count.items())}
    per_launch = {k: idle_ns[k] / 1e3 / n for k, n in sorted(count.items())}
    print(f"spans: chain spans a call by route {per_call!r}; idle us per launch "
          f"{per_launch!r}", file=sys.stderr)
    waits = [r for r in records if r.name == "data.wait"]
    if waits:
        starved = sum(bool(r.attrs.get("starved")) for r in waits)
        print(f"spans: data.wait {len(waits)}, starved {starved}", file=sys.stderr)


def share(rec: dict, layer: str) -> float | None:
    """The layer's idle share of the run's traced window (0 where the
    window recorded spans but none of the layer's owned a gap)."""
    out = split(rec)
    return None if out is None else out.layers.get(layer, 0.0)
