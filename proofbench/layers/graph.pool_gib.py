"""Device: the program's counter `graph.pool_bytes`, the device memory the
capture of the proof's CUDA graph reserved (its private pool, which holds
one proof's intermediates for as long as the graph lives), GiB."""

from proofbench.harness import port


def read(ctx):
    tracer = getattr(port.G, "tracer", None)
    value = tracer.counters().get("graph.pool_bytes") if tracer is not None else None
    return None if value is None else value / 2**30
