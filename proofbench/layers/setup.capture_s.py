"""Set-up: the program's span `capture` (the spec points and delta's window
tables, the warm-up run and the capture of the proof's CUDA graph),
seconds, recorded always."""

from proofbench.harness import port


def read(ctx):
    tracer = getattr(port.G, "tracer", None)
    spans = [r for r in tracer.records() if r.name == "capture"] if tracer is not None else []
    if not spans:
        return None
    return sum(r.end_ns - r.start_ns for r in spans) / 1e9
