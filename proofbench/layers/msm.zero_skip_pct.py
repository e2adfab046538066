"""MSMs and the spec-point algebra: the share of the fold's slots that K2
skipped because their digit was 0 (the padding, a small scalar's zero
windows), from the program's counters `msm.zero_slots` over
`msm.fold_slots` (every slot of every fold level), %.  The fused proof adds
its device counters to them after each traced replay, so the share is over
the traced proofs; a program without the counters reports nothing."""

from proofbench.harness import port


def read(ctx):
    tracer = getattr(port.G, "tracer", None)
    got = tracer.counters() if tracer is not None else {}
    zeros, walked = got.get("msm.zero_slots"), got.get("msm.fold_slots")
    if zeros is None or not walked:
        return None
    return 100.0 * zeros / walked
