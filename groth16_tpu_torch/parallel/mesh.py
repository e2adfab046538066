"""Process groups for the sharded prover, on torch.distributed.

Counterpart of groth16_tpu/parallel/mesh.py.  The JAX package builds a 1-D
device mesh and lets XLA route its collectives; here a `Mesh` is one
process's place in a process group: its rank, the group's size, the device
its shards live on and the backend.  One rank a card under NCCL; under gloo
any number of ranks share a device (the tests run them on the CPU, the
chip smoke runs two on one card).

The two collectives the prover needs move int32 views of the uint32 wire
arrays (gloo rejects uint32):

  all_gather_rows   every rank's tensor, stacked in rank order;
  all_to_all_rows   dim 0 cut into `size` equal blocks, block j to rank j;
                    the result holds rank a's block at position a.

Under NCCL the payload stays on the card.  Under gloo a card's payload is
staged through host memory, one explicit .cpu() / .to(device) pair a call:
gloo moves host buffers.  A failure raises; nothing falls back to another
backend or device.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from ..ops import field as F

BACKENDS = ("gloo", "nccl")
TIMEOUT = timedelta(minutes=10)   # a collective that waits longer raises


@dataclass
class Mesh:
    """One rank's view of the process group.  `comm_s` accumulates the host
    seconds spent in the collectives when `timed` is set (each then waits
    for the device before and after it)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = None
    timed: bool = False
    comm_s: float = 0.0

    @property
    def host_staged(self) -> bool:
        return self.backend == "gloo" and self.device.type != "cpu"


def init_mesh(backend: str, device, init_method: str | None = None, rank: int | None = None,
              world_size: int | None = None) -> Mesh:
    """Join the process group (the counterpart of `make_multihost_mesh`).
    Without `init_method` the torchrun variables name the group: RANK,
    WORLD_SIZE and MASTER_ADDR / MASTER_PORT (`env://`); a `file://` or
    `tcp://` method takes `rank` and `world_size` from the caller, or from
    the same variables.  Under NCCL `device` must be a card, one a rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL ranks live on cards: give a cuda device")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size(), device=device,
                backend=backend)


def shard_range(n: int, rank: int, size: int) -> tuple:
    """[lo, hi) of rank's contiguous slab of n items; the first n % size
    ranks take one more (slabs may be uneven, and empty when n < size)."""
    q, m = divmod(n, size)
    lo = rank * q + min(rank, m)
    return lo, lo + q + (rank < m)


def _wire(x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in (torch.uint32, torch.int32):
        raise ValueError(f"collectives move uint32 / int32 arrays, got {x.dtype}")
    return F.as_i32(x.contiguous())


class _Timed:
    """Adds the collective's host seconds to mesh.comm_s when mesh.timed."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def _sync(self):
        if self.mesh.timed and self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self._sync()
        self.mesh.comm_s += time.perf_counter() - self.t0


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """[size, *x.shape]: every rank's x in rank order, x's dtype, on x's device."""
    xi = _wire(x)
    with _Timed(mesh):
        src = xi.cpu() if mesh.host_staged else xi
        outs = [torch.empty_like(src) for _ in range(mesh.size)]
        dist.all_gather(outs, src, group=mesh.group)
        out = torch.stack(outs).to(xi.device)
    return F.as_u32(out) if x.dtype == torch.uint32 else out


def all_to_all_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x's dim 0 cut into `size` equal blocks, block j sent to rank j; the
    result (x's shape and dtype, on x's device) holds rank a's block at
    position a."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"dim 0 ({x.shape[0]}) must split into {mesh.size} equal blocks")
    xi = _wire(x)
    with _Timed(mesh):
        src = xi.cpu() if mesh.host_staged else xi
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=mesh.group)
        out = out.to(xi.device)
    return F.as_u32(out) if x.dtype == torch.uint32 else out
