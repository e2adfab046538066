"""The card's Fp-product rate: kernel K9, k chained Montgomery products.

    python3 -m groth16_tpu_torch.tools.bench_mul_kernels [k]

Counterpart of tools/bench_mul_kernels.py.  Each of n elements (by default
2 x 132 x 2048, twice the threads all 132 SMs of an H100 hold) runs
x <- x * b * 2^-256 mod p k times inside one launch, so the time over k * n
is the throughput of the header's Fp product and not the latency of one
chain.  `run` checks the kernel against host ints on a sample of elements
and against its plain PyTorch version on all of them, times both, and
prints ns per product, products per second and the share of the multiply
peak (measure.py: the issue slots of the 128 widening and 8 low multiplies
one product needs, over 132 SMs x 64 a clock x the maximum SM clock), with
the opcode mix of one product as the compile issues it (K9's loop in the
SASS) and the multiply issue rates that peak rests on (`issue_rates`).  The TPU tool's
"ks" / "cios" variants were TPU multiply schedules; the port has one
product, so there is one variant.  Needs one CUDA card; imports nothing of
JAX.
"""

from __future__ import annotations

import json
import sys

N_DEFAULT = 2 * 132 * 2048
SAMPLE = 64          # elements checked against host ints
# csrc/mul_chain.cu issue_rate_kernel<KIND>: the multiply form of each KIND
RATE_KINDS = {0: "mad.lo.u32", 1: "mul.wide.u32", 2: "mad.lo.cc.u32/madc.hi.cc.u32",
              3: "mul.hi.u32"}
RATE_THREADS = 1024  # threads of its one block an SM
RATE_ITERS = 4096


def issue_rates(device="cuda", iters: int = RATE_ITERS) -> dict:
    """PTX multiply instructions of each form in RATE_KINDS that one SM
    issues a clock: every SM runs one block of RATE_THREADS threads, each
    with independent chains of that form; a block's instructions over the
    clock64 cycles it took, the median over the SMs (after a warm-up
    launch).  A widening 32 x 32 -> 64 product is one mul.wide.u32 or one
    mad.lo.cc / madc.hi.cc pair."""
    import torch
    from groth16_tpu_torch.ops import cuda
    dev = torch.device(device)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    L = cuda.lib()
    out = {}
    for kind, name in RATE_KINDS.items():
        o = torch.empty(blocks * RATE_THREADS, dtype=torch.uint32, device=dev)
        cyc = torch.empty(blocks, dtype=torch.int64, device=dev)
        for _ in range(2):
            cuda.check(L.g16_issue_rate(kind, o.data_ptr(), cyc.data_ptr(), blocks, iters,
                                        cuda.stream_ptr(dev)), f"issue-rate kernel {kind}")
        cycles = sorted(cyc.cpu().tolist())
        out[name] = RATE_THREADS * iters * L.g16_issue_rate_ops(kind) / cycles[len(cycles) // 2]
    return out


def wide_per_clock(rates: dict) -> float:
    """Widening products an SM issues a clock (`issue_rates`): the fastest
    of mul.wide.u32 (IMAD.WIDE.U32), the mad.lo.cc / madc.hi.cc pair, and
    mul.hi.u32 (IMAD.HI.U32, the high word of the same product, which the
    pipe issues alone, where the mul.wide loop carries moves beside it)."""
    return max(rates[RATE_KINDS[1]], rates[RATE_KINDS[2]] / 2, rates[RATE_KINDS[3]])


def run(k: int = 256, n: int = N_DEFAULT, device="cuda", reps: int = 3) -> dict:
    """Check and time K9 (its plain version on a CPU device) at k products
    on n elements; print the result and return it as a dict."""
    import numpy as np
    import torch
    from groth16_tpu_torch.ops import cuda, field as F, kernels as KN
    from groth16_tpu_torch.ops.field import FP
    from groth16_tpu_torch.ops.limbs import limbs_to_ints
    from groth16_tpu_torch.tools import measure

    dev = torch.device(device)
    rng = np.random.default_rng(3)
    limbs = rng.integers(0, 1 << 16, size=(2, 16, n), dtype=np.uint32)
    limbs[:, 15] &= 0x2FFF                               # canonical: < p
    a, b = (torch.from_numpy(x).to(dev) for x in limbs)

    out = KN.fp_mul_chain(a, b, k)
    plain = []      # one call, timed and checked: it takes seconds at the default n
    plain_ms = measure.time_ms(lambda: plain.append(KN.fp_mul_chain_plain(a, b, k)), dev, 1,
                               warmup=False)
    plain = plain[0]
    err = int((out.to(torch.int64) - plain.to(torch.int64)).abs().max())
    idx = np.linspace(0, n - 1, min(SAMPLE, n)).astype(np.int64)
    got = limbs_to_ints(F.as_i32(out)[:, idx].T.cpu().numpy())
    rinv = FP.mont_r_inv
    for i, g in zip(idx, got):
        x, y = limbs_to_ints(limbs[:, :, i])
        for _ in range(k):
            x = x * y * rinv % FP.modulus
        if g != x:
            raise AssertionError(f"K9 element {i} differs from host ints")
    if err:
        raise AssertionError(f"K9 differs from its plain version (max abs err {err})")

    ms = measure.time_ms(lambda: KN.fp_mul_chain(a, b, k), dev, reps)
    res = {"tool": "bench_mul_kernels", "card": measure.card_line(dev), "k": k, "n": n,
           "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
           "ns_per_product": ms * 1e6 / (k * n), "gproducts_per_s": k * n / ms / 1e6}
    if dev.type == "cuda":
        sass = measure.sass_text(cuda.lib_path())
        ops = measure.loop_opcodes(sass, "fp_mul_chain_kernel")
        rates = issue_rates(dev)
        res.update(issue_rates_per_sm_clock=rates, wide_per_sm_clock=wide_per_clock(rates),
                   issue_rate_opcodes={
                       name: measure.loop_opcodes(sass, f"issue_rate_kernelILi{kind}E")
                       for kind, name in RATE_KINDS.items()})
        clock = measure.sm_clock_max_mhz()
        peak = measure.peak_products_per_s(clock)
        res.update(issue_slots_per_product=measure.FP_MUL_MULTIPLIES,
                   sass_multiplies=measure.multiply_count(ops),
                   sass_imad_class=sum(v for o, v in ops.items() if o.startswith("IMAD")),
                   sass_instructions=sum(ops.values()), loop_opcodes=ops,
                   sm_clock_max_mhz=clock, peak_gproducts_per_s=peak / 1e9,
                   share_of_multiply_peak=res["gproducts_per_s"] * 1e9 / peak)
    print(f"K9 {res['card']}: {k} x {n} Fp products in {ms:.4f} ms "
          f"({res['ns_per_product']:.5f} ns a product, {res['gproducts_per_s']:.2f} G/s; "
          f"plain {plain_ms:.1f} ms), bit-exact against the plain version and host ints")
    if "sass_multiplies" in res:
        print(f"K9: {res['issue_slots_per_product']} multiply issue slots a product, peak "
              f"{res['peak_gproducts_per_s']:.2f} G/s at {res['sm_clock_max_mhz']:.0f} MHz, "
              f"share {100 * res['share_of_multiply_peak']:.1f} %; the compile's loop issues "
              f"{res['sass_multiplies']} multiplies among {res['sass_imad_class']} IMAD-class "
              f"and {res['sass_instructions']} instructions in all (SASS)")
        print("K9: multiply issues an SM a clock: " + ", ".join(
            f"{name} {r:.2f}" for name, r in res["issue_rates_per_sm_clock"].items())
            + f"; widening products {res['wide_per_sm_clock']:.2f}")
    print(json.dumps(res))
    return res


def main(argv=None) -> int:
    import torch
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("bench_mul_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    run(int(args[0]) if args else 256)
    return 0


if __name__ == "__main__":
    sys.exit(main())
