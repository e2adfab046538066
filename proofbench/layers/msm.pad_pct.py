"""MSMs and the spec-point algebra: the share of the folds' points that
are padding, from the program's counters `msm.pad_points` (m - n of each
fold: its n points padded to m, a power of two) over `msm.fold_points`
(the m), %.  Both count each fold once a capture on the fused path."""

from proofbench.harness import port


def read(ctx):
    tracer = getattr(port.G, "tracer", None)
    got = tracer.counters() if tracer is not None else {}
    pad, folded = got.get("msm.pad_points"), got.get("msm.fold_points")
    if pad is None or not folded:
        return None
    return 100.0 * pad / folded
