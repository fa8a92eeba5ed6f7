"""What planting a fault in the program under test takes: a context
manager that patches one of the program's functions for a block.  Each
kind of cell names the faults it can have in its own `FAULTS`
(`flowbench/kinds/<kind>.py`: fault name -> a function that returns the
context manager); `flowbench.control` and `flowbench/tests/test_fb_faults.py`
read them from there, and the benchmark's own runs never plant one.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(owner, name: str, make):
    """owner.name replaced by make(original) inside the block."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def first_is_second(original):
    """A method whose answer for the first image is the second's, altered
    where it is produced."""
    def call(self, *args, **kwargs):
        out = original(self, *args, **kwargs).clone()
        out[0] = out[1]
        return out
    return call
