"""Wall-clock phase timing (the reference's entire profiling subsystem is the
`withMeasureTime` template, groth16/misc.nim:17-26; this is its context-
manager analog, plus a collector used by the prover's per-phase timings)."""

from __future__ import annotations

import time
from contextlib import contextmanager


@contextmanager
def measure_time(do_print: bool, text: str, sink: dict | None = None, key: str | None = None):
    """`with measure_time(True, "computing pi_A (G1 MSM)"): ...` prints
    "<text> took N.NNNN seconds" (same message shape as misc.nim:24-25)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[key or text] = dt
    if do_print:
        print(f"{text} took {dt:.4f} seconds")


def floor_log2(n: int) -> int:
    """Reference misc.nim:35-40."""
    assert n > 0
    return n.bit_length() - 1


def ceiling_log2(n: int) -> int:
    """Reference misc.nim:42-47."""
    assert n > 0
    return (n - 1).bit_length()
