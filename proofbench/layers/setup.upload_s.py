"""Set-up: the program's span `upload` (the zkey's proof inputs to the card
at its first proof, up to a synchronization), seconds, recorded always."""

from proofbench.harness import port


def read(ctx):
    tracer = getattr(port.G, "tracer", None)
    spans = [r for r in tracer.records() if r.name == "upload"] if tracer is not None else []
    if not spans:
        return None
    return sum(r.end_ns - r.start_ns for r in spans) / 1e9
