"""The traced window: torch.profiler over it, read into the device's
operations, its busy time and the host's activity in its idle gaps.

The measured window records the card's activity alone (`profiler(device)`),
so that its rate, busy time and idle share stay close to an untraced
run's; recording every host operation as well slowed a host-paced call by
35-60 %.  The host's events that name the idle gaps come from a short
profile of both after the window (`profiler(device, host=True)`).

The profile stays in memory and is read through the profiler's raw events
(no chrome trace is written).  A device operation is any event the
profiler puts on the card: kernels, copies and sets.  Busy time is the
union of their intervals; an idle gap lies between two busy intervals, and
is named after the host event that overlaps it most (the shortest, where
several overlap it wholly).
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def profiler(device, host: bool = False) -> profile:
    """The card's activity; with `host`, the host's operations too (on the
    CPU, which has no card, the host's alone)."""
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        acts.append(ProfilerActivity.CPU)
    return profile(activities=acts)


def short_name(name: str) -> str:
    """A kernel's name without its template and call arguments, its return
    type or anonymous namespaces: "sm90::gemm_kernel", "mix_tile_kernel"."""
    name = name.replace("(anonymous namespace)::", "")
    while True:
        stripped = re.sub(r"<[^<>]*>", "", name)
        if stripped == name:
            break
        name = stripped
    name = name.split("(", 1)[0].strip()
    return name.split(" ")[-1] if name.startswith("void ") else name


@dataclass
class Trace:
    ops: list[tuple[str, int, int]] = field(default_factory=list)  # (short name, start, end) ns
    host: list[tuple[str, int, int]] = field(default_factory=list)

    @property
    def busy(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, in order."""
        out: list[list[int]] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def device_s(self, names: set[str] | None = None) -> float:
        """Summed device time of the operations (of those named)."""
        return sum(e - s for n, s, e in self.ops if names is None or n in names) / 1e9

    def top_ops(self, n: int = 10) -> list[list]:
        by = defaultdict(int)
        for name, s, e in self.ops:
            by[name] += e - s
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, longest: int = 200) -> list[list]:
        """The idle seconds of the `longest` gaps between busy intervals,
        summed by what the host was doing over each gap, the largest n."""
        busy = self.busy
        if len(busy) < 2 or not self.host:
            return []
        hs = np.array([s for _, s, _ in self.host], dtype=np.int64)
        he = np.array([e for _, _, e in self.host], dtype=np.int64)
        gaps = sorted(((b - a, a, b) for (_, a), (b, _) in zip(busy, busy[1:]) if b > a),
                      reverse=True)[:longest]
        by = defaultdict(int)
        for _, a, b in gaps:
            overlap = np.minimum(he, b) - np.maximum(hs, a)
            best = overlap.max(initial=0)
            if best <= 0:
                by["(no host event)"] += b - a
                continue
            cand = np.flatnonzero(overlap == best)
            pick = cand[np.argmin((he - hs)[cand])]
            by[self.host[pick][0]] += b - a
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def read(prof: profile) -> Trace:
    out = Trace()
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            out.ops.append((short_name(ev.name()), s, e))
        elif e > s:
            out.host.append((ev.name(), s, e))
    return out
