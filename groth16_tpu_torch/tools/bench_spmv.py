"""The SpMV kernel's schedule swept on the card, and its seeded sets.

    python3 -m groth16_tpu_torch.tools.bench_spmv             # the sweep
    python3 -m groth16_tpu_torch.tools.bench_spmv --default   # the kernel as it is

Three sets (`proof_set`, `dense_set`, `power_law_set`): the 2^16 proof's
rows (synthetic_circuit(16), the port's fake setup: at most one entry a
row), 4,096 rows with one row of 65,538 entries over the first 64 wires
(circom's rows on the constant-one wire), and 2^16 rows of Zipf lengths
from 1 to 2^15 (most of one to three entries, column 0 in a quarter of the
rows), about 2^19 entries: rows as circom's linear simplification leaves
them.  For each schedule of SCHEDULES (E entries a thread, threads an
entries block, rows a finish block; kernels.spmv_schedule) and each set it
checks the kernel bit-exact against the default schedule's output, and
prints the profiler's device time of one call (each pass and both) and the
CUDA-event time over REPS calls, beside the bound (tools/measure.py); then
one JSON line.  `--default` times the package's kernel as it stands on the
three sets instead (`default_schedule`: another checkout's too).  `chip_smoke.py` takes its SpMV sets from here.  Needs one
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import sys

REPS = 20
SEED = 20261017
# (E, block, finish block): every E at 128 threads, then the blocks at E = 1
# (kernels.SPMV_E) and at a few other E
SCHEDULES = ([(e, 128, 128) for e in (1, 2, 3, 4, 8)]
             + [(1, b, 128) for b in (64, 256)] + [(1, 128, f) for f in (64, 256)]
             + [(2, 256, 128), (4, 256, 128), (8, 64, 128)])
DENSE = dict(n_rows=1 << 12, nvars=1 << 12, nnz=1 << 14, dense=1 << 16)
POWER_LAW = dict(n_rows=1 << 16, nvars=1 << 16, a=2.18, longest=1 << 15, one_wire=0.25)


def random_fr(rng, n: int):
    """uint32 [n, 16] wire limbs of values below r (standard form, or any
    Montgomery value)."""
    import numpy as np
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    limbs[:, 15] &= 0x2FFF
    return limbs


def proof_set(dev, log2: int = 16):
    """(name, witness, matrix, row, col, coeff, n_rows) of the 2^log2
    proof's SpMV (synthetic_circuit, the port's fake setup on `dev`)."""
    import groth16_tpu_torch as G
    from groth16_tpu_torch.models.circuits import synthetic_circuit
    r1cs, wtns = synthetic_circuit(log2)
    zkey = G.fake_circuit_setup(r1cs, G.ToxicWaste(0x1DEA, 0xBEEF, 0x6A33A, 0xDE17A, 0x7A0),
                                G.Flavour.Snarkjs, dev)
    co = zkey.coeffs
    return (f"2^{log2} proof", wtns.values, co.matrix, co.row, co.col, co.coeff,
            zkey.header.domain_size)


def dense_set(rng, n_rows, nvars, nnz, dense):
    """`nnz` random entries over rows 0 .. n_rows - 2 (the last row of A
    and of B stays empty), `dense` more in A's row 1 reading only the first
    64 wires (repeated columns), the witness value and a coefficient r - 1
    among them."""
    import numpy as np
    from groth16_tpu_torch.ops.field import FR
    from groth16_tpu_torch.ops.limbs import int_to_limbs
    w = random_fr(rng, nvars)
    w[0] = int_to_limbs(FR.modulus - 1)
    matrix = np.concatenate([rng.integers(0, 2, nnz), np.zeros(dense, np.int64)])
    row = np.concatenate([rng.integers(0, n_rows - 1, nnz), np.ones(dense, np.int64)])
    col = np.concatenate([rng.integers(0, nvars, nnz), rng.integers(0, 64, dense)])
    coeff = random_fr(rng, nnz + dense)
    coeff[::1000] = int_to_limbs(FR.modulus - 1)
    return ("seeded, dense row", w, matrix, row, col, coeff, n_rows)


def power_law_set(rng, n_rows, nvars, a, longest, one_wire):
    """A's and B's rows of Zipf(a) lengths capped at `longest` (A's row 0
    exactly `longest`), entries in no particular order; a `one_wire` share
    of the rows reads column 0 first, the other columns are uniform; the
    witness value and a coefficient r - 1 among them."""
    import numpy as np
    from groth16_tpu_torch.ops.field import FR
    from groth16_tpu_torch.ops.limbs import int_to_limbs
    lengths = np.minimum(rng.zipf(a, size=2 * n_rows), longest)
    lengths[0] = longest
    key = np.repeat(np.arange(2 * n_rows), lengths)
    col = rng.integers(0, nvars, key.size)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    col[starts[rng.random(2 * n_rows) < one_wire]] = 0
    w = random_fr(rng, nvars)
    w[0] = int_to_limbs(FR.modulus - 1)
    coeff = random_fr(rng, key.size)
    coeff[::1000] = int_to_limbs(FR.modulus - 1)
    order = rng.permutation(key.size)
    return ("seeded, power law", w, (key // n_rows)[order], (key % n_rows)[order], col[order],
            coeff[order], n_rows)


def rows_on(dev, case, **schedule):
    """(name, witness tensor, SpmvRows) of a set on `dev`."""
    import torch
    from groth16_tpu_torch.ops import kernels as KN
    name, w, matrix, row, col, coeff, n_rows = case
    return (name, torch.from_numpy(w).to(dev),
            KN.spmv_rows(matrix, row, col, coeff, n_rows, dev, **schedule))


def set_stats(w, m) -> dict:
    """Rows, entries, witness length, longest row, empty rows of a set."""
    import numpy as np
    lengths = np.diff(m.row_ptr.cpu().numpy())
    return dict(n_rows=m.n_rows, nnz=int(lengths.sum()), nvars=int(w.shape[0]),
                longest=int(lengths.max()), empty=int((lengths == 0).sum()))


def device_ms(w, m) -> dict:
    """Device milliseconds of one SpMV call (profiler): each pass and both."""
    from groth16_tpu_torch.ops import kernels as KN
    from groth16_tpu_torch.tools import measure
    passes = {"spmv_entries_kernel": 1, "spmv_finish_kernel": 1}
    names = measure.device_kernels(lambda: KN.spmv_kernel(w, m), passes)
    out = {p: sum(us for k, (_, us) in names.items() if p in k) / 1e3 for p in passes}
    out["both"] = sum(out.values())
    return out


def sweep(dev, cases) -> list:
    """Every schedule of SCHEDULES on every set: bit-exact against the
    default schedule, device and CUDA-event times."""
    import torch
    from groth16_tpu_torch.ops import kernels as KN
    from groth16_tpu_torch.ops.field import as_i32
    from groth16_tpu_torch.tools import measure
    clock = measure.sm_clock_max_mhz()
    out = []
    for case in cases:
        name, w, m = rows_on(dev, case)
        want = KN.spmv_kernel(w, m)
        st = set_stats(w, m)
        bound, side = measure.bound_ms(*measure.work("spmv_kernel", n_rows=st["n_rows"],
                                                     nnz=st["nnz"], nvars=st["nvars"]), clock)
        keys = m.schedule.keys.cpu().numpy()
        for E, block, fin in SCHEDULES:
            mm = dataclasses.replace(m, schedule=KN.spmv_schedule(keys, m.n_rows, dev, E=E,
                                                                  block=block, finish_block=fin))
            got = KN.spmv_kernel(w, mm)
            if not all(torch.equal(as_i32(a), as_i32(b)) for a, b in zip(got, want)):
                raise AssertionError(f"SpMV {name}: schedule {(E, block, fin)} differs")
            dev_ms = device_ms(w, mm)
            ev_ms = measure.time_ms(lambda: KN.spmv_kernel(w, mm), dev, REPS)
            print(f"SpMV {name} E={E} block={block} finish={fin}: device {dev_ms['both']:.4f} "
                  f"ms (entries {dev_ms['spmv_entries_kernel']:.4f}, finish "
                  f"{dev_ms['spmv_finish_kernel']:.4f}), events {ev_ms:.4f} ms, bound "
                  f"{bound:.5f} ms ({side}), {100 * bound / dev_ms['both']:.1f} % of the bound by "
                  "device time", flush=True)
            out.append(dict(set=name, E=E, block=block, finish_block=fin,
                            device_ms=dev_ms["both"], entries_ms=dev_ms["spmv_entries_kernel"],
                            finish_ms=dev_ms["spmv_finish_kernel"], events_ms=ev_ms,
                            bound_ms=bound, bound_by=side, **st))
    return out


def default_schedule(dev, cases) -> list:
    """The package's SpMV as it is, on every set: the device time of one
    call (every profiled device event named like "spmv"), the CUDA-event
    time over REPS calls.  It uses only entry points that every checkout of
    the port has, so it can time another checkout's kernel (run this file by
    path from that checkout's root with PYTHONPATH=.)."""
    import groth16_tpu_torch
    from groth16_tpu_torch.ops import kernels as KN
    from groth16_tpu_torch.tools import measure
    out = []
    for case in cases:
        name, w, m = rows_on(dev, case)
        KN.spmv_kernel(w, m)
        events = [e for e in measure.device_trace(lambda: KN.spmv_kernel(w, m))[0]
                  if "spmv" in e.name]
        dev_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
        ev_ms = measure.time_ms(lambda: KN.spmv_kernel(w, m), dev, REPS)
        print(f"SpMV {name} ({groth16_tpu_torch.__file__}): device {dev_ms:.4f} ms in "
              f"{len(events)} launches, events {ev_ms:.4f} ms", flush=True)
        out.append(dict(set=name, device_ms=dev_ms, launches=len(events), events_ms=ev_ms))
    return out


def main(argv=None) -> int:
    import numpy as np
    import torch
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("bench_spmv: needs a CUDA device", file=sys.stderr)
        return 2
    from groth16_tpu_torch.tools import measure
    dev = torch.device("cuda", 0)
    print(measure.card_line(dev))
    rng = np.random.default_rng(SEED)
    cases = [proof_set(dev), dense_set(rng, **DENSE), power_law_set(rng, **POWER_LAW)]
    if "--default" in args:
        print(json.dumps({"spmv_default": default_schedule(dev, cases)}))
    else:
        print(json.dumps({"spmv_sweep": sweep(dev, cases)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
