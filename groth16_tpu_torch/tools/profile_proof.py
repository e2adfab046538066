"""Where the time of one proof goes on the GPU.

    python3 -m groth16_tpu_torch.tools.profile_proof [--log2 16] [--flavour snarkjs]

Sets up synthetic_circuit(log2) on the card (the port's fake setup, fixed
toxic waste), proves once to warm up, times three unprofiled proofs, then
profiles one more with torch.profiler (CPU and CUDA activity).  Prints the
profiled proof's wall time, the device's busy time in it (the union of the
traced kernel and copy intervals) and their ratio, then the device time,
launch count and share of each kernel name, largest first.  Needs one CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import time

TOP = 25   # kernel names listed


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("profile_proof: needs a CUDA device")
    import groth16_tpu_torch as G
    from groth16_tpu_torch.models.circuits import synthetic_circuit

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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = prove()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
