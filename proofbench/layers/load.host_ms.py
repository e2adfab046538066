"""Entry: the host's time a traced proof in the program's span `load`: the
witness and masks into the graph's pinned buffers (`load.stage`) and
their two copies queued (`load.enqueue`), while the card waits for the
proof's graph; milliseconds, the mean over the traced proofs."""

from proofbench.harness import port


def read(ctx):
    tracer = getattr(port.G, "tracer", None)
    spans = [r for r in tracer.records() if r.name == "load" and r.proof is not None] \
        if tracer is not None else []
    if not spans:
        return None
    return sum(r.end_ns - r.start_ns for r in spans) / len(spans) / 1e6
