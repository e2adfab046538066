"""The rank side of the sharded-prover tests (tests/test_torch_parallel*.py):
module-level functions that `groth16_tpu_torch.parallel.launch.spawn` runs
on gloo ranks on the CPU.  Each rank runs every case it is given and
pickles its results to <out>/<case>_rank<r>.pkl; the test process compares
them.  No JAX here: the ranks import only the port."""

import os
import pickle

import numpy as np
import torch

from groth16_tpu_torch.ops import curve as C
from groth16_tpu_torch.ops import ntt as NT
from groth16_tpu_torch.ops.field import FR
from groth16_tpu_torch.ops.limbs import ints_to_limbs_bulk
from groth16_tpu_torch.parallel import mesh as MS
from groth16_tpu_torch.parallel import msm_shard, ntt_shard, prover_shard
from groth16_tpu_torch.protocol.types import Flavour

R = FR.modulus
CPU = torch.device("cpu")


def rand_mont(n: int, seed: int) -> np.ndarray:
    """uint32 [n, 16]: canonical field elements from a numpy seed."""
    rng = np.random.default_rng(seed)
    return ints_to_limbs_bulk(int.from_bytes(rng.bytes(32), "little") % R for _ in range(n))


def ntt_input(log2n: int, seed: int) -> np.ndarray:
    """A seeded vector with 0 and r - 1 among its values."""
    x = rand_mont(1 << log2n, seed)
    x[1] = 0
    x[2] = ints_to_limbs_bulk([R - 1])[0]
    return x


def _save(out: str, name: str, rank: int, obj) -> None:
    with open(os.path.join(out, f"{name}_rank{rank}.pkl"), "wb") as fh:
        pickle.dump(obj, fh)


def load(out: str, name: str, world: int) -> list:
    res = []
    for r in range(world):
        with open(os.path.join(out, f"{name}_rank{r}.pkl"), "rb") as fh:
            res.append(pickle.load(fh))
    return res


def _ntt(mesh, out, log2n, seed):
    dom = NT.Domain(log2n)
    x = torch.from_numpy(ntt_input(log2n, seed))
    lo, hi = MS.shard_range(dom.size, mesh.rank, mesh.size)
    _save(out, f"ntt{log2n}", mesh.rank,
          (ntt_shard.four_step_ntt(dom, mesh, x[lo:hi]).numpy(),
           ntt_shard.four_step_intt(dom, mesh, x[lo:hi]).numpy()))


def _msm(mesh, out, name, curve, scalars, points, affine=False):
    cv = C.G1 if curve == "G1" else C.G2
    lo, hi = MS.shard_range(len(scalars), mesh.rank, mesh.size)
    sc = torch.from_numpy(ints_to_limbs_bulk(scalars[lo:hi]).reshape(-1, 16))
    P = C.points_from_host(cv, points[lo:hi], CPU)
    got = C.affine_to_host(cv, *msm_shard.msm_sharded(cv, mesh, sc, P, affine))[0]
    _save(out, name, mesh.rank, got)


def _quotient(mesh, out, log2n, seed):
    l1, _ = ntt_shard.factors(log2n, mesh.size, False)
    cols = ntt_shard.layout_indices(log2n, mesh.size, mesh.rank, l1)
    abc = [torch.from_numpy(rand_mont(1 << log2n, seed + j))[cols] for j in range(3)]
    res = {}
    for fl in Flavour:
        q = prover_shard.quotient_scalars_sharded(fl, mesh, *abc, log2n)
        res[fl.value] = (prover_shard.h1_indices(log2n, mesh.size, mesh.rank, fl), q.numpy())
    _save(out, f"quotient{log2n}", mesh.rank, res)


def _inputs(mesh, out, zkeys, wtns):
    """Each zkey's sharded proof inputs on this rank, over all the ranks:
    its SpMV output, its quotient scalars with their domain indices, its
    H1 points and the slabs of the witness-indexed point sets."""
    from groth16_tpu_torch.ops import kernels as KN
    w = torch.from_numpy(np.ascontiguousarray(wtns.values))
    res = []
    for zk in zkeys:
        hdr = zk.header
        st = prover_shard.zkey_shard_args(zk, mesh)
        abc = KN.spmv(w, st.rows)
        q = prover_shard.quotient_scalars_sharded(hdr.flavour, mesh, *abc, hdr.log_domain_size)
        res.append({"abc": torch.stack(list(abc)).numpy(), "q": q.numpy(),
                    "idx": prover_shard.h1_indices(hdr.log_domain_size, mesh.size, mesh.rank,
                                                   hdr.flavour),
                    "h1": [c.numpy() for c in st.h1], "a1": [c.numpy() for c in st.a1],
                    "c1": [c.numpy() for c in st.c1], "slabs": (st.witness_slab, st.c1_slab)})
    _save(out, "inputs", mesh.rank, res)


def cases_rank(mesh, out: str, cases: list) -> None:
    """Run each (kind, args) of `cases` on this rank."""
    for kind, args in cases:
        {"ntt": _ntt, "msm": _msm, "quotient": _quotient, "inputs": _inputs,
         "proofs": _proofs}[kind](mesh, out, *args)


def worlds_rank(mesh, outs: dict, world_cases: dict) -> None:
    """For each {world: cases} in turn, the ranks below `world` run the
    cases as a mesh of their own (results to outs[world]): one spawn
    serves every world size up to mesh.size."""
    import torch.distributed as dist
    for world, cases in world_cases.items():
        sub = mesh
        if world < mesh.size:                  # every rank takes part in new_group
            group = dist.new_group(list(range(world)))
            sub = MS.Mesh(rank=mesh.rank, size=world, device=mesh.device,
                          backend=mesh.backend, group=group)
        if mesh.rank < world:
            cases_rank(sub, outs[world], cases)


def _proofs(mesh, out, zkeys, wtns, mask, world):
    """Ranks below `world` prove each zkey sharded over a group of those
    ranks; rank world + i proves zkeys[i] on its own device alone
    (`generate_proof_with_mask`), for the comparison, at the same time."""
    import torch.distributed as dist
    from groth16_tpu_torch.parallel.prover_shard import generate_proof_sharded
    from groth16_tpu_torch.protocol.prover import Mask, generate_proof_with_mask
    group = dist.new_group(list(range(world)))         # every rank takes part in new_group
    m = Mask(*mask)
    if mesh.rank < world:
        sub = MS.Mesh(rank=mesh.rank, size=world, device=mesh.device, backend=mesh.backend,
                      group=group)
        res = [generate_proof_sharded(zk, wtns, m, sub) for zk in zkeys]
    else:
        res = [generate_proof_with_mask(zkeys[mesh.rank - world], wtns, m, CPU)]
    _save(out, "proofs", mesh.rank, [(p.pi_a, p.pi_b, p.pi_c) for p in res])
