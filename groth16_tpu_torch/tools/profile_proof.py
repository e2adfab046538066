"""Where the time of one proof goes on the GPU.

    python3 -m groth16_tpu_torch.tools.profile_proof [--log2 16] [--flavour snarkjs]

Sets up synthetic_circuit(log2) on the card (the port's fake setup, fixed
toxic waste), proves once to warm up (which also caches the zkey on the
card), times three unprofiled proofs, then one more warms up and another
is profiled with torch.profiler (CPU and CUDA activity).  Prints the
profiled proof's wall time, the device's busy time in it (the union of the
traced kernel and copy intervals) and their ratio, then the device time,
launch count and share of each kernel name, largest first; apart from the
table: the `cummax` carry scans of the plain field arithmetic
(CUMMAX_KERNEL, the scan kernel torch.cummax runs), the SpMV's two
kernels' and the negation's launches and device time, the host-to-device
copies (a proof copies its witness), and, from one more proof with
torch.cummax wrapped, the functions of the package that called each scan
(the innermost three frames outside ops/field.py).  It uses only entry
points of the package and `measure.device_trace`, so it can profile
another checkout that has them (run it by path from that checkout's root
with `PYTHONPATH=.`).  Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import time
import traceback

TOP = 25   # kernel names listed
# the CUDA kernel behind torch.cummax along the last axis (its profiler name)
CUMMAX_KERNEL = "scan_innermost_dim_with_indices"
# kernels whose device time is printed whatever their rank: the SpMV's two
# passes and the tree's negation, each too short for the table
OWN_KERNELS = ("spmv_entries_kernel", "spmv_finish_kernel", "fp_neg_kernel")


@contextlib.contextmanager
def cummax_callers():
    """Inside the block every torch.cummax call (one scan kernel on the card)
    is counted under its callers in the package, the innermost three frames
    outside ops/field.py: yields that {callers: calls} dict."""
    import torch
    callers: dict = {}
    scan = torch.cummax

    def traced(*args, **kwargs):
        frames = [f"{f.filename.split('groth16_tpu_torch/')[-1]}:{f.lineno} {f.name}"
                  for f in reversed(traceback.extract_stack()[:-1])
                  if "groth16_tpu_torch" in f.filename and "ops/field.py" not in f.filename]
        key = " < ".join(frames[:3]) or "(no frame of the package)"
        callers[key] = callers.get(key, 0) + 1
        return scan(*args, **kwargs)

    torch.cummax = traced
    try:
        yield callers
    finally:
        torch.cummax = scan


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals, microseconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2", type=int, default=16, help="circuit size: 2^log2 - 3 constraints")
    ap.add_argument("--flavour", default="snarkjs", choices=["snarkjs", "jens-groth"])
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_proof: needs a CUDA device")
    import groth16_tpu_torch as G
    from groth16_tpu_torch.models.circuits import synthetic_circuit
    from groth16_tpu_torch.tools import measure

    dev = torch.device("cuda", 0)
    flavour = G.Flavour(args.flavour)
    r1cs, wtns = synthetic_circuit(args.log2)
    zkey = G.fake_circuit_setup(r1cs, G.ToxicWaste(0x1DEA, 0xBEEF, 0x6A33A, 0xDE17A, 0x7A0),
                                flavour, dev)
    mask = G.Mask(0x1234567890ABCDEF, 0xFEDCBA0987654321)

    def prove():
        t0 = time.perf_counter()
        prf = G.generate_proof_with_mask(zkey, wtns, mask, dev)
        torch.cuda.synchronize()
        return prf, time.perf_counter() - t0

    prf, _ = prove()                                         # warm-up: builds, caches
    if not G.verify_proof(G.extract_vkey(zkey), prf):
        raise SystemExit("profile_proof: the proof does not verify")
    walls = [prove()[1] for _ in range(3)]
    print(f"{torch.cuda.get_device_name(0)}, 2^{args.log2} {flavour.value}: unprofiled "
          "proofs " + ", ".join(f"{w:.3f}" for w in walls) + " s")

    dev_events, (_, wall) = measure.device_trace(prove)
    if not dev_events:
        raise SystemExit("profile_proof: the profiler traced no device activity")
    busy = busy_us((e.time_range.start, e.time_range.end) for e in dev_events) / 1e6
    print(f"profiled proof: wall {wall:.3f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f} % of the wall time), {len(dev_events)} device events")
    by_name: dict = {}
    for e in dev_events:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    total_ms = sum(t for t, _ in by_name.values())
    print(f"{'device ms':>10} {'launches':>9} {'share':>6}  kernel")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"{t:10.3f} {n:9d} {100 * t / total_ms:5.1f}%  {name[:110]}")
    scans = [v for name, v in by_name.items() if CUMMAX_KERNEL in name]
    print(f"cummax in the proof: {sum(n for _, n in scans)} launches, "
          f"{sum(t for t, _ in scans):.3f} ms device")
    for kernel in OWN_KERNELS:
        own = [v for name, v in by_name.items() if kernel in name]
        print(f"{kernel} in the proof: {sum(n for _, n in own)} launches, "
              f"{sum(t for t, _ in own):.4f} ms device")
    h2d = [v for name, v in by_name.items() if "HtoD" in name]
    print(f"host-to-device copies in the proof (zkey cached by the warm-up): "
          f"{sum(n for _, n in h2d)} launches, {sum(t for t, _ in h2d):.3f} ms device")

    with cummax_callers() as callers:
        prove()
    print("cummax callers (launches): " + "; ".join(f"{k} {n}" for k, n in callers.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
