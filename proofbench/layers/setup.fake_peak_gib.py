"""Set-up: the program's counter `fake_setup.peak_bytes`, the device memory
reserved at the fake setup's peak (`torch.cuda.max_memory_reserved` at its
end), GiB."""

from proofbench.harness import port


def read(ctx):
    tracer = getattr(port.G, "tracer", None)
    value = tracer.counters().get("fake_setup.peak_bytes") if tracer is not None else None
    return None if value is None else value / 2**30
