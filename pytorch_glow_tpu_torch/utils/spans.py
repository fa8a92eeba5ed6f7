"""Spans: named host intervals of the program, recorded only while a
torch.profiler session runs, on the clock its events carry.

    with spans.span("train.step", step=7):
        ...

Outside a profiler session (and while `torch.compiler.is_compiling()`)
`span` returns one shared no-op object: no clock read, nothing kept; its
cost is one flag read and a method call.  Inside one, each span becomes a
`Span` record in one process-wide list, kept in the order spans close:
its name, `start_ns` and `end_ns` from `time.time_ns()` (the Unix-epoch
nanoseconds torch.profiler stamps its host and device events with), the
native thread id, its `parent` span's id, its `depth` (a root's is 0), its
`call` (the id of the root span of the call it belongs to) and its
`attrs`.  A span opened on a thread with no open span of its own, while a
call's root is open on another thread (the autograd engine's thread
during `torch.autograd.grad`), takes the innermost open span of that
thread as its parent and joins its call; otherwise it is a root.  The list
keeps `CAP` records at most and counts the ones it drops.

`annotate(**attrs)` adds attributes to the innermost open span of the
calling thread, so that the code which decides a value (the flow-step
wrappers' whole / band / slab route, the prefetcher's empty queue)
records it on the span around it.

Readers: the trainer's `profile_step` trace (`train/trainer._Profiler`)
and the benchmark's per-layer idle shares (`flowbench/spans.py`).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _profiler

CAP = 2**20  # records kept at most

_records: list["Span"] = []
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()  # over _root_stack, and the cap check with its append
_root_stack: "_Stack | None" = None  # the open spans of the thread whose root is open


class _Stack(list):
    """A thread's open spans, innermost last, and its native id."""

    __slots__ = ("tid",)


def _stack() -> _Stack:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = stack = _Stack()
        stack.tid = threading.get_native_id()
        return stack


class Span:
    """One recorded span; the context manager that records it."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "tid", "id", "parent", "depth", "call",
                 "_stack")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "Span":
        global _root_stack
        self._stack = stack = _stack()
        self.tid, self.id = stack.tid, next(_ids)
        parent = stack[-1] if stack else None
        if parent is None:
            with _lock:
                if _root_stack:  # another thread's open call
                    parent = _root_stack[-1]
                else:
                    _root_stack = stack
        if parent is None:
            self.parent, self.depth, self.call = None, 0, self.id
        else:
            self.parent, self.depth, self.call = parent.id, parent.depth + 1, parent.call
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _root_stack, _dropped
        self.end_ns = time.time_ns()
        stack, self._stack = self._stack, None
        stack.pop()
        with _lock:
            if self.parent is None and _root_stack is stack:
                _root_stack = None
            if len(_records) < CAP:
                _records.append(self)
            else:
                _dropped += 1

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start_ns}-{self.end_ns}, depth={self.depth}, "
                f"call={self.call}, {self.attrs})")


class _NoSpan:
    """The shared no-op span outside a profiler session."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A context manager over one named interval; it records only inside a
    torch.profiler session (see the module's docstring)."""
    if not _profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return NO_SPAN
    return Span(name, attrs)


def annotate(**attrs) -> None:
    """Adds `attrs` to the calling thread's innermost open span, if any."""
    if not _profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return
    stack = _stack()
    if stack:
        stack[-1].attrs.update(attrs)


def recorded() -> list[Span]:
    """The records so far, in the order their spans closed."""
    return list(_records)


def dropped() -> int:
    """The records not kept since the last `clear`: the list was full."""
    return _dropped


def clear() -> None:
    global _dropped
    _records.clear()
    _dropped = 0


def add_to_chrome_trace(path: str, since_ns: int) -> None:
    """Appends the records that started at `since_ns` or later to the
    Chrome trace torch.profiler wrote at `path`, as complete events on
    their threads (category "span"; times in microseconds after the
    trace's `baseTimeNanoseconds`)."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    added = [{"ph": "X", "cat": "span", "name": r.name, "pid": pid, "tid": r.tid,
              "ts": (r.start_ns - base) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
              "args": {**r.attrs, "depth": r.depth, "call": r.call}}
             for r in recorded() if r.start_ns >= since_ns]
    trace.setdefault("traceEvents", []).extend(added)
    with open(path, "w") as f:
        json.dump(trace, f)
