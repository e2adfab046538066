"""Starting the ranks of a sharded run.

`spawn(fn, world, backend, devices, *args)` runs fn(mesh, *args) in `world`
processes (torch.multiprocessing, spawn start) joined by a `file://` store
in a fresh temporary directory: rank r on devices[r % len(devices)].  The
tests run gloo ranks on the CPU this way; the chip smoke runs two gloo
ranks on one card and one NCCL rank a card.  A rank that raises makes
`spawn` raise (the others are stopped).  Results come back through files
the caller names: `spawn` returns nothing.

`dryrun_multichip(n, device)` proves a tiny circuit sharded over n ranks
and verifies the proof (the counterpart of `__graft_entry__.dryrun_multichip`).

Under torchrun, one NCCL rank a card, this module proves a zkey and a
witness from files:

    torchrun --nproc-per-node=N -m groth16_tpu_torch.parallel.launch \\
        --zkey c.zkey --wtns c.wtns [-o proof.json] [--verify]

Every rank computes the same proof; rank 0 writes it and verifies it.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import init_mesh


def _rank_main(rank: int, world: int, backend: str, devices, init_method: str, threads: int,
               fn, args):
    torch.set_num_threads(threads)
    mesh = init_mesh(backend, devices[rank % len(devices)], init_method, rank, world)
    try:
        fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str, devices, *args) -> None:
    """fn(mesh, *args) on `world` ranks (fn importable at module level),
    each with the caller's intra-op thread count."""
    tmp = tempfile.mkdtemp(prefix="g16mesh")
    try:
        mp.spawn(_rank_main, args=(world, backend, [str(d) for d in devices],
                                   f"file://{tmp}/store", torch.get_num_threads(), fn, args),
                 nprocs=world, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _dryrun_rank(mesh, zkey, wtns):
    from ..protocol.prover import Mask
    from ..protocol.types import extract_vkey
    from ..protocol.verifier import verify_proof
    from .prover_shard import generate_proof_sharded
    prf = generate_proof_sharded(zkey, wtns, Mask(r=5, s=9), mesh)
    if not verify_proof(extract_vkey(zkey), prf):
        raise AssertionError(f"rank {mesh.rank}: the sharded proof does not verify")


def dryrun_multichip(n: int, device) -> None:
    """A 2^6 circuit's fake setup on `device`, then its proof sharded over n
    ranks (gloo on the CPU, else NCCL one rank a card); every rank's proof
    must verify."""
    from ..models.circuits import synthetic_circuit
    from ..protocol.fake_setup import ToxicWaste, fake_circuit_setup
    from ..protocol.types import Flavour
    device = torch.device(device)
    backend = "gloo" if device.type == "cpu" else "nccl"
    t0 = time.perf_counter()
    r1cs, wtns = synthetic_circuit(6)
    zkey = fake_circuit_setup(r1cs, ToxicWaste(alpha=1235, beta=781, gamma=4243, delta=9999,
                                               tau=106), Flavour.Snarkjs, device)
    devices = [device] if backend == "gloo" else [torch.device("cuda", i) for i in range(n)]
    spawn(_dryrun_rank, n, backend, devices, zkey, wtns)
    print(f"dryrun_multichip({n}): the sharded proof on {n} {backend} ranks verifies "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def main(argv=None) -> int:
    from .. import extract_vkey, export_proof, parse_witness, parse_zkey, verify_proof
    from ..protocol.prover import random_mask
    from .prover_shard import generate_proof_sharded
    ap = argparse.ArgumentParser(prog="python -m groth16_tpu_torch.parallel.launch",
                                 description="sharded Groth16 proof, one NCCL rank a card "
                                             "(run under torchrun)")
    ap.add_argument("--zkey", required=True)
    ap.add_argument("--wtns", required=True)
    ap.add_argument("-o", "--output", help="proof JSON (rank 0)")
    ap.add_argument("--verify", action="store_true", help="verify the proof on rank 0")
    a = ap.parse_args(argv)
    for path in (a.zkey, a.wtns):
        if not os.path.exists(path):
            print(f"error: {path} does not exist", file=sys.stderr)
            return 1
    mesh = init_mesh("nccl", torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))))
    ok = True
    try:
        zkey, wtns = parse_zkey(a.zkey), parse_witness(a.wtns)
        box = [random_mask() if mesh.rank == 0 else None]
        dist.broadcast_object_list(box, src=0)            # one mask for every rank
        tm = {}
        prf = generate_proof_sharded(zkey, wtns, box[0], mesh, tm)
        print(f"rank {mesh.rank}/{mesh.size}: proof in {tm['total_s']:.4f} s")
        if mesh.rank == 0:
            if a.output:
                export_proof(a.output, prf)
            if a.verify:
                ok = verify_proof(extract_vkey(zkey), prf)
                print(f"verification succeeded = {ok}")
    finally:
        dist.destroy_process_group()
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
