"""Command-line interface (reference `cli/cli_main.nim`), on one device.

Counterpart of groth16_tpu/cli.py, with the same flags, messages and exit
codes (0; 1 for a missing file, `--setup` with `-z` or a missing input; 2
when verification fails), plus `--device`:

    python -m groth16_tpu_torch --prove --verify -z circuit.zkey -w circuit.wtns \\
        -o proof.json -i public.json
    python -m groth16_tpu_torch --setup --prove --verify -r circuit.r1cs -w circuit.wtns
    python -m groth16_tpu_torch ... --device cpu     # without a card

The setup and the proof run on `--device` (default `cuda`); without a card
the CLI stops with exit code 1 unless `--device cpu` is given.  The
`-j/--nthreads` flag is accepted for surface compatibility and does nothing.
`-t` turns the program's tracer on (`utils/timing.py`) and prints how long
each step took; with `-v` also the proof's timings, one set of keys on
either device, the seconds of each phase of the proof's core among them.
"""

from __future__ import annotations

import argparse
import os
import sys
from contextlib import contextmanager

from .utils import timing as T


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="groth16-tpu-torch",
        description="Groth16 prover/verifier on a CUDA card (circom/snarkjs compatible)",
    )
    ap.add_argument("-v", "--verbose", action="store_true", help="verbose output")
    ap.add_argument("-d", "--debug", action="store_true", help="debug output")
    ap.add_argument("-j", "--nthreads", type=int, default=0,
                    help="accepted for compatibility; does nothing")
    ap.add_argument("-t", "--time", dest="measure_time", action="store_true",
                    help="print time measurements")
    ap.add_argument("-p", "--prove", action="store_true", help="create a proof")
    ap.add_argument("-y", "--verify", action="store_true", help="verify a proof")
    ap.add_argument("-u", "--setup", action="store_true",
                    help="perform (fake) trusted setup")
    ap.add_argument("-n", "--nomask", action="store_true",
                    help="don't use random masking for full ZK")
    ap.add_argument("-z", "--zkey", default="", metavar="circuit.zkey")
    ap.add_argument("-w", "--wtns", default="", metavar="circuit.wtns")
    ap.add_argument("-r", "--r1cs", default="", metavar="circuit.r1cs")
    ap.add_argument("-o", "--output", default="", metavar="proof.json")
    ap.add_argument("-i", "--io", default="", metavar="public.json")
    ap.add_argument("--sage", default="", metavar="verify.sage",
                    help="export a SageMath re-verification script")
    ap.add_argument("--write-zkey", default="", metavar="out.zkey",
                    help="with --setup: write the fake zkey to a file")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the setup and the proof (default cuda)")
    return ap


@contextmanager
def _measured(enabled: bool, text: str):
    """The tracer's span `text`; prints "<text> took N.NNNN seconds"."""
    took: dict = {}
    with T.span(text, took):
        yield
    if enabled:
        print(f"{text} took {took[text]:.4f} seconds")


def main(argv=None) -> int:
    cfg = build_parser().parse_args(argv)
    if not cfg.measure_time:
        return _main(cfg)
    T.enable()
    try:
        return _main(cfg)
    finally:
        T.disable()


def _main(cfg) -> int:
    import torch

    from .files.witness import parse_witness
    from .files.zkey import parse_zkey, write_zkey
    from .files.r1cs import parse_r1cs
    from .files.export_json import export_proof, export_public_io
    from .files.export_sage import export_sage
    from .protocol.fake_setup import create_fake_circuit_setup
    from .protocol.prover import generate_proof, generate_proof_with_trivial_mask
    from .protocol.types import Flavour, extract_vkey
    from .protocol.verifier import verify_proof

    try:
        device = torch.device(cfg.device)
    except RuntimeError as e:
        print(f"error: bad --device `{cfg.device}`: {e}")
        return 1
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass `--device cpu` to run on the CPU")
        return 1

    wtns = zkey = r1cs = proof = None

    for path, label in ((cfg.wtns, "witness"), (cfg.zkey, "zkey"), (cfg.r1cs, "r1cs")):
        if path and not os.path.exists(path):
            print(f"error: {label} file `{path}` does not exist")
            return 1

    if cfg.wtns:
        print(f"\nparsing witness file `{cfg.wtns}`")
        with _measured(cfg.measure_time, "parsing the witness"):
            wtns = parse_witness(cfg.wtns)

    if cfg.zkey:
        print(f"\nparsing zkey file `{cfg.zkey}`")
        with _measured(cfg.measure_time, "parsing the zkey"):
            zkey = parse_zkey(cfg.zkey)

    if cfg.r1cs:
        print(f"\nparsing r1cs file `{cfg.r1cs}`")
        with _measured(cfg.measure_time, "parsing the r1cs"):
            r1cs = parse_r1cs(cfg.r1cs)

    if cfg.setup:
        if cfg.zkey:
            print("\nwe are doing a fake trusted setup, don't specify the zkey file!")
            return 1
        if not cfg.r1cs:
            print("\nerror: r1cs file is required for the fake setup!")
            return 1
        print("\nperforming fake trusted setup...")
        with _measured(cfg.measure_time, "fake setup"):
            zkey = create_fake_circuit_setup(r1cs, Flavour.Snarkjs, device)
        if cfg.write_zkey:
            print(f"writing fake zkey to `{cfg.write_zkey}`")
            write_zkey(cfg.write_zkey, zkey)

    if cfg.debug and zkey is not None:
        # full header + per-coeff dump (cli_main.nim:195-197 ->
        # zkey_types.nim:77-103); the listing is capped unless -v is given
        from .utils.debug import print_coeffs, print_groth_header
        print()
        print_groth_header(zkey.header)
        print(f"ncoeffs = {len(zkey.coeffs)}")
        print_coeffs(zkey.coeffs, limit=None if cfg.verbose else 64)

    if cfg.prove:
        if wtns is None or zkey is None:
            print("cannot prove: missing witness and/or zkey file!")
            return 1
        print("generating proof...")
        timings = {} if cfg.measure_time and cfg.verbose else None
        with _measured(cfg.measure_time, "proving"):
            if cfg.nomask:
                proof = generate_proof_with_trivial_mask(zkey, wtns, device, timings)
            else:
                proof = generate_proof(zkey, wtns, device, timings)
        if timings:
            for k, v in timings.items():
                print(f"  {k:18s} {v:.4f} s")
        if cfg.output:
            print(f"exporting the proof to `{cfg.output}`")
            export_proof(cfg.output, proof)
        if cfg.io:
            print(f"exporting the public IO to `{cfg.io}`")
            export_public_io(cfg.io, proof)
        if cfg.sage:
            print(f"exporting the Sage verifier to `{cfg.sage}`")
            export_sage(cfg.sage, extract_vkey(zkey), proof)

    if cfg.verify:
        if zkey is None:
            print("cannot verify: missing vkey (well, zkey)")
            return 1
        if proof is None:
            print("cannot verify: no proof was generated in this invocation")
            return 1
        vkey = extract_vkey(zkey)
        print("\nverifying the proof...")
        with _measured(cfg.measure_time, "verifying"):
            ok = verify_proof(vkey, proof)
        print(f"verification succeeded = {ok}")
        if not ok:
            return 2

    print("")
    return 0


if __name__ == "__main__":
    sys.exit(main())
