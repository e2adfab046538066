"""MSMs and the spec-point algebra: the device time a traced proof of the
H1 MSM over the quotient's scalars, from the program's timing events
inside its graph (the tracer's phase `msm_h1`), milliseconds; the mean
over the traced proofs."""

from proofbench.harness import port

PHASES = ("msm_h1",)


def read(ctx):
    tracer = getattr(port.G, "tracer", None)
    rows = [ph for _, ph in tracer.phases()] if tracer is not None else []
    if not rows:
        return None
    return 1e3 * sum(ph[p] for ph in rows for p in PHASES) / len(rows)
