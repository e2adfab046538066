"""The port's tracer: spans on the profiler's clock, counters, and the
phases of a proof's core (device seconds on the card, host seconds on the
CPU).

    with span("load", sink, "load_s"):        # sink["load_s"] = seconds
        ...

A span always writes its duration (host seconds) into `sink[key]` when a
sink is given; that is how the prover's `timings` are filled.  While
tracing is on, a span also appends a `Record` to the recorder: its name,
start and end on the `time.time_ns()` clock, which is the clock of the
profiler's events, the index of the span open around it on the same
thread, and the proof id that the root span `proof()` gives every span
inside it; while a profiler records, it also opens
`torch.profiler.record_function(name)` around that, so that the trace
names it (with no profiler to receive it, a record_function would cost
about 13 us a span and tell no one).  Spans of a zkey's set-up pass
`always=True`: they are recorded whether tracing is on or not (once a
zkey, microseconds against seconds).

Tracing is on while a torch profiler records, or between `enable()` and
`disable()`.  The program never starts a profiler session itself.  Off, a
span without a sink costs one check and a shared null context, and
records nothing.

The recorder, the phases (`record_phases`), the side branch's
device seconds (`record_side_chains`) and the counters (`count`) live at
module level, bounded, so that they outlive the zkey whose proofs filled
them; `records()`, `phases()`, `side_chains()` and `counters()` read them.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import NamedTuple

import torch

# the phases of a proof's core, in the order `prove_core_device` runs them
PHASES = ("spmv", "quotient", "msm_a1", "msm_b1", "msm_b2", "msm_h1", "msm_c1", "algebra",
          "affine")
LIMIT = 65536          # records (and proofs' phases) the recorder keeps, the newest


class Record(NamedTuple):
    index: int                  # the span's number in this process, in order of start
    name: str
    start_ns: int               # time.time_ns(), the profiler's clock
    end_ns: int
    parent: int | None          # index of the span open around it on its thread
    proof: int | None           # the id `proof()` gave the proof it belongs to


_records: deque = deque(maxlen=LIMIT)
_phases: deque = deque(maxlen=LIMIT)     # (proof id, {phase: device seconds})
_side: deque = deque(maxlen=LIMIT)       # (proof id, side branch device seconds)
_counters: dict = {}
_counters_lock = threading.Lock()
_index = itertools.count()
_proof_ids = itertools.count(1)
_local = threading.local()
_enabled = False
_NULL = nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def enable() -> None:
    """Trace from now on, with no profiler session (the CLI's `-t`)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def on() -> bool:
    """Whether spans are traced: after `enable()`, or while a torch
    profiler records."""
    return _enabled or _profiling()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    """A recorded span (see the module's docstring)."""

    __slots__ = ("name", "sink", "key", "new_proof", "scope", "index", "parent", "proof",
                 "start_ns", "t0")

    def __init__(self, name: str, sink, key, new_proof: bool = False):
        self.name, self.sink, self.key, self.new_proof = name, sink, key, new_proof

    def __enter__(self):
        self.scope = torch.profiler.record_function(self.name) if _profiling() else None
        if self.scope is not None:
            self.scope.__enter__()
        st = _stack()
        outer = st[-1] if st else None
        self.parent = outer.index if outer is not None else None
        self.proof = next(_proof_ids) if self.new_proof else (outer.proof if outer else None)
        self.index = next(_index)
        st.append(self)
        self.t0 = time.perf_counter()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        dt = time.perf_counter() - self.t0
        _stack().pop()
        if self.scope is not None:
            self.scope.__exit__(*exc)
        _records.append(Record(self.index, self.name, self.start_ns, end_ns, self.parent,
                               self.proof))
        if self.sink is not None:
            self.sink[self.key] = dt
        return False


class _Timer:
    """An untraced span with a sink: its duration and nothing else."""

    __slots__ = ("sink", "key", "t0")

    def __init__(self, sink: dict, key: str):
        self.sink, self.key = sink, key

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sink[self.key] = time.perf_counter() - self.t0
        return False


def span(name: str, sink: dict | None = None, key: str | None = None, always: bool = False):
    """A context manager around one step named `name`: its host seconds go
    to `sink[key or name]` where a sink is given; recorded while tracing is
    on, and always with `always=True`; a record_function while a profiler
    records."""
    if always or on():
        return _Span(name, sink, key or name)
    if sink is not None:
        return _Timer(sink, key or name)
    return _NULL


def proof():
    """The root span `proof` of one proof, while tracing is on: every span
    opened inside it on this thread carries the new proof id it draws."""
    return _Span("proof", None, None, new_proof=True) if on() else _NULL


def current_proof() -> int | None:
    """The proof id of the innermost span open on this thread."""
    st = _stack()
    return st[-1].proof if st else None


def record_phases(seconds: dict) -> None:
    """Keep one proof's phases ({phase: seconds}) under the id of
    the proof open on this thread."""
    _phases.append((current_proof(), dict(seconds)))


def record_side_chains(seconds: float) -> None:
    """Keep one fused proof's side-branch device seconds (its MSMs' Horner
    chains, `msm.SideChains`: from before the first launch to after the
    last) under the id of the proof open on this thread, apart from the
    phases of PHASES, which the side branch overlaps."""
    _side.append((current_proof(), seconds))


def count(name: str, value) -> None:
    """Add `value` to the counter `name`, which starts at 0."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + value


def peak(name: str, value) -> None:
    """Keep the larger of the counter `name` and `value`."""
    with _counters_lock:
        _counters[name] = max(_counters.get(name, value), value)


def records() -> list:
    """The recorder's Records, oldest first (at most LIMIT)."""
    return list(_records)


def phases() -> list:
    """[(proof id, {phase: seconds})] of the traced proofs (device
    seconds on the card, host seconds on the CPU), oldest first (at most
    LIMIT)."""
    return list(_phases)


def side_chains() -> list:
    """[(proof id, side branch device seconds)] of the traced fused
    proofs, oldest first (at most LIMIT)."""
    return list(_side)


def counters() -> dict:
    with _counters_lock:
        return dict(_counters)


def clear() -> None:
    """Empty the recorder, the phases, the side branch's seconds and the
    counters."""
    _records.clear()
    _phases.clear()
    _side.clear()
    with _counters_lock:
        _counters.clear()
