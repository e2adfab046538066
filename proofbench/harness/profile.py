"""A traced stretch of proofs, reduced to what the per-layer metrics read.

The stretch runs under torch.profiler (CPU and CUDA activity) in one
session of its own, every proof inside the benchmark's span `request` and
the program's steps inside the spans of `port.spans`.  It starts at the
first request's start and ends at the last one's return, so the host's
work between replays counts.  From the trace:

    busy_s      the union of every device operation (kernel, copy, memset)
                inside the stretch
    window_s    the stretch's length
    ops         {device operation name: [count, seconds]} inside it
    gaps        the stretch's idle intervals, each named by the innermost
                benchmark span open at its middle ("host" where none is)
"""

from __future__ import annotations

from dataclasses import dataclass, field

SPANS = ("request", "load", "copy_back", "replay", "proof_points")


@dataclass
class Trace:
    proofs: int
    window_s: float
    busy_s: float
    ops: dict = field(default_factory=dict)
    gaps: list = field(default_factory=list)         # [(name, seconds)], longest first
    witnesses: list = field(default_factory=list)    # pool index of each traced proof


def union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name: str) -> str:
    """A kernel's own name, without its signature and template arguments."""
    bare = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return bare.split("(")[0].split("<")[0].strip()[:80] or name[:80]


def reduce(device_events, span_events, proofs: int) -> Trace:
    """device_events: [(name, start_us, end_us)]; span_events: [(name,
    start_us, end_us)] of the benchmark's spans."""
    reqs = [(s, e) for n, s, e in span_events if n == "request"]
    if not reqs or not device_events:
        return Trace(proofs=proofs, window_s=0.0, busy_s=0.0)
    t0, t1 = min(s for s, _ in reqs), max(e for _, e in reqs)
    inside = [(n, max(s, t0), min(e, t1)) for n, s, e in device_events if e > t0 and s < t1]
    ops: dict = {}
    for n, s, e in inside:
        rec = ops.setdefault(short_name(n), [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) / 1e6
    busy = union((s, e) for _, s, e in inside)
    gaps, prev = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            mid = (prev + s) / 2
            # the innermost span: the latest to start, of those the first to end
            open_ = [(ss, -ee, n) for n, ss, ee in span_events if ss <= mid <= ee]
            gaps.append((max(open_)[2] if open_ else "host", (s - prev) / 1e6))
        prev = max(prev, e)
    gaps.sort(key=lambda g: -g[1])
    return Trace(proofs=proofs, window_s=(t1 - t0) / 1e6,
                 busy_s=sum(e - s for s, e in busy) / 1e6, ops=ops, gaps=gaps)


def profiled(run_proofs, proofs: int) -> Trace:
    """Run `run_proofs()` (which makes `proofs` proofs, each in a `request`
    span) under the profiler and reduce its trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        witnesses = run_proofs()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    dev, spans = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # a span's range on the device's timeline is no operation of the card
            if e.name not in SPANS and not getattr(e, "is_user_annotation", False):
                dev.append((e.name, tr.start, tr.end))
        elif e.name in SPANS:
            spans.append((e.name, tr.start, tr.end))
    trace = reduce(dev, spans, proofs)
    trace.witnesses = list(witnesses)
    return trace
