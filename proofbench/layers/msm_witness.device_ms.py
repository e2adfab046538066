"""MSMs and the spec-point algebra: the device time a traced proof of the
three G1 MSMs over the witness, A1, B1 and C1, from the program's timing
events inside its graph (the tracer's phases `msm_a1`, `msm_b1`,
`msm_c1`), milliseconds; the mean over the traced proofs."""

from proofbench.harness import port

PHASES = ("msm_a1", "msm_b1", "msm_c1")


def read(ctx):
    tracer = getattr(port.G, "tracer", None)
    rows = [ph for _, ph in tracer.phases()] if tracer is not None else []
    if not rows:
        return None
    return 1e3 * sum(ph[p] for ph in rows for p in PHASES) / len(rows)
