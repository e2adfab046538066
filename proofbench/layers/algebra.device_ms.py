"""MSMs and the spec-point algebra: the device time a traced proof of the
algebra (`spec_algebra`) and the affine conversion (`proof_buffer`),
from the program's timing events inside its graph (the tracer's phases
`algebra` and `affine`), milliseconds; the mean over the traced proofs,
the only proofs the program records."""

from proofbench.harness import port

PHASES = ("algebra", "affine")


def read(ctx):
    tracer = getattr(port.G, "tracer", None)
    rows = [ph for _, ph in tracer.phases()] if tracer is not None else []
    if not rows:
        return None
    return 1e3 * sum(ph[p] for ph in rows for p in PHASES) / len(rows)
