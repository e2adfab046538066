"""The system under test, groth16_tpu_torch, as the harness drives it: the
only module of the benchmark that imports the program.

It hands the program the benchmark's own inputs in the program's types
(the circuit as an R1CS, each witness, the toxic waste, each mask), runs
its fake setup and its entry point, and reads back the proof's points and
its counters.  A one-card cell proves through `generate_proof_with_mask`
on the default path.  A cell of d cards runs d ranks, one process a card
(`spawn`: the program's `parallel.launch.spawn`, which joins each rank
through `parallel.mesh.init_mesh`; NCCL on the cards, gloo on the CPU);
every rank proves every request through the sharded entry
`parallel.prover_shard.generate_proof_sharded` (`prove_sharded`), and
the ranks agree on rank 0's clock and exchange their readings over the
mesh (`agree`, `gather`).  The parallel modules are imported only where a
rank needs them, so a one-card run loads nothing more than before.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

import groth16_tpu_torch as G
from groth16_tpu_torch.protocol import prover as PV
from groth16_tpu_torch.protocol.types import WitnessConfig

from ..circuits.circuit import R


def r1cs(circuit) -> G.R1CS:
    """The circuit as the program's R1CS: one (A, B, C) triple of
    [(wire, coefficient mod r)] lists a constraint."""
    rows = [([], [], []) for _ in range(circuit.n_constr)]
    for m, mat in enumerate((circuit.a, circuit.b, circuit.c)):
        for r, c, v in zip(mat.row.tolist(), mat.col.tolist(), mat.val.tolist()):
            rows[r][m].append((c, v % R))
    cfg = WitnessConfig(n_wires=circuit.n_wires, n_pub_out=circuit.n_pub_out,
                        n_pub_in=circuit.n_pub_in, n_priv_in=0, n_labels=0)
    return G.R1CS(r=R, cfg=cfg, n_constr=circuit.n_constr, constraints=rows, wire_to_label=[])


def witness(values) -> G.Witness:
    """Witness ints as the program's Witness: uint32 [n, 16], 16-bit limbs,
    standard form."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    limbs = np.frombuffer(buf, "<u2").reshape(-1, 16).astype(np.uint32)
    return G.Witness(curve="bn128", r=R, nvars=len(values), values=limbs)


def setup(circuit, toxic, flavour: str, device) -> G.ZKey:
    """The program's fake setup of the circuit from the toxic waste, on
    `device`, kept in memory."""
    tw = G.ToxicWaste(alpha=toxic.alpha, beta=toxic.beta, gamma=toxic.gamma, delta=toxic.delta,
                      tau=toxic.tau)
    return G.fake_circuit_setup(r1cs(circuit), tw, G.Flavour(flavour), torch.device(device))


def prove(zkey, wtns, r: int, s: int, device, timings: dict | None = None) -> tuple:
    """One proof on the program's default path: (pi_a, pi_b, pi_c,
    public_io), host affine ints, None at infinity."""
    prf = G.generate_proof_with_mask(zkey, wtns, G.Mask(r=r, s=s), torch.device(device), timings)
    return prf.pi_a, prf.pi_b, prf.pi_c, [int(v) for v in prf.public_io]


def prove_sharded(zkey, wtns, r: int, s: int, mesh, timings: dict | None = None) -> tuple:
    """One proof on the program's sharded path, this rank's part of it:
    every rank of `mesh` calls it with the same zkey, witness and masks and
    gets the same (pi_a, pi_b, pi_c, public_io)."""
    from groth16_tpu_torch.parallel.prover_shard import generate_proof_sharded
    prf = generate_proof_sharded(zkey, wtns, G.Mask(r=r, s=s), mesh, timings)
    return prf.pi_a, prf.pi_b, prf.pi_c, [int(v) for v in prf.public_io]


COUNTERS = {"uploads": ("zkey_device_args", "builds"), "captures": ("fused_graph", "captures")}


def counters(mesh=None) -> dict:
    """The program's counters of zkey uploads and graph captures (those it
    has); on a rank of `mesh`, the uploads add the rank's part of the zkey
    (`zkey_shard_args.builds`)."""
    out = {name: int(getattr(getattr(PV, fn), attr)) for name, (fn, attr) in COUNTERS.items()
           if hasattr(getattr(PV, fn, None), attr)}
    if mesh is not None:
        from groth16_tpu_torch.parallel.prover_shard import zkey_shard_args
        out["uploads"] = out.get("uploads", 0) + int(zkey_shard_args.builds)
    return out


def spawn(fn, ranks: int, device, *args) -> None:
    """fn(mesh, *args) in `ranks` processes (fn importable at module level,
    args picklable) through the program's `parallel.launch.spawn`: NCCL
    ranks on cuda:0 .. cuda:ranks-1 where `device` is a card, gloo ranks on
    the CPU where it is the CPU.  A rank that raises stops the others and
    makes this raise; a collective that waits past the program's
    `mesh.TIMEOUT` raises on its rank."""
    from groth16_tpu_torch.parallel import launch
    device = torch.device(device)
    if device.type == "cuda":
        launch.spawn(fn, ranks, "nccl", [torch.device("cuda", i) for i in range(ranks)], *args)
    else:
        launch.spawn(fn, ranks, "gloo", [device], *args)


def agree(mesh, go: bool) -> bool:
    """Rank 0's `go` on every rank of `mesh` (a one-element broadcast over
    the mesh); `go` itself without one."""
    if mesh is None:
        return go
    import torch.distributed as dist
    flag = torch.tensor([int(go)], dtype=torch.int32,
                        device=mesh.device if mesh.backend == "nccl" else "cpu")
    dist.broadcast(flag, src=0, group=mesh.group)
    return bool(flag.item())


def gather(mesh, obj) -> list:
    """Every rank's `obj` (picklable), in rank order, on every rank of
    `mesh`; a barrier besides."""
    import torch.distributed as dist
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


@contextlib.contextmanager
def timed(mesh):
    """Inside the block the mesh's collectives wait for the device before
    and after each and add their seconds to the proof's `comm_s`; nothing
    without a mesh."""
    if mesh is None:
        yield
        return
    was, mesh.timed = mesh.timed, True
    try:
        yield
    finally:
        mesh.timed = was


class _GraphSpan:
    """A CUDA graph whose replay() runs inside the span `replay`."""

    def __init__(self, graph):
        self._graph = graph

    def replay(self):
        with torch.profiler.record_function("replay"):
            self._graph.replay()

    def __getattr__(self, name):
        return getattr(self._graph, name)


@contextlib.contextmanager
def spans(zkey):
    """Inside the block, the benchmark's spans around the program's steps
    of a fused proof: `load` (witness and mask into the graph's buffers),
    `copy_back` (FusedProof.replay: the graph's launch, then the proof
    buffer to the host), `replay` inside it (the launch itself) and
    `proof_points` (the buffer to affine ints).  Steps the program no
    longer has are left without a span."""
    undo = []

    def wrap(owner, attr, span):
        fn = getattr(owner, attr, None)
        if fn is None:
            return

        def traced(*args, **kwargs):
            with torch.profiler.record_function(span):
                return fn(*args, **kwargs)

        setattr(owner, attr, traced)
        undo.append(lambda: setattr(owner, attr, fn))

    fused = getattr(PV, "FusedProof", None)
    if fused is not None:
        wrap(fused, "load", "load")
        wrap(fused, "replay", "copy_back")
        for fp in list(zkey.device_cache.values()):
            if isinstance(fp, fused) and getattr(fp, "graph", None) is not None:
                graph = fp.graph
                fp.graph = _GraphSpan(graph)
                undo.append(lambda fp=fp, graph=graph: setattr(fp, "graph", graph))
    wrap(PV, "proof_points", "proof_points")
    try:
        yield
    finally:
        for fn in reversed(undo):
            fn()
