"""K9, k chained Fp Montgomery products (groth16_tpu_torch.ops.kernels
`fp_mul_chain_*`): the plain PyTorch version against the JAX package's
`field.mont_mul` chained and against host ints, and the kernel's lane body
built with g++ (csrc/bn254_host_shim.cpp) against the plain version.
Tolerance 0: exact integer arithmetic."""

import ctypes

import numpy as np
import pytest
import torch

from groth16_tpu_torch.ops import cuda, kernels as KN
from groth16_tpu_torch.ops.field import FP
from groth16_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

K = 8


def _operands(n, seed):
    """Two limb-major uint32[16, n] rows of canonical Fp elements, with 0, 1
    and p - 1 among them."""
    rng = np.random.default_rng(seed)
    xs = [0, 1, FP.modulus - 1] + [int.from_bytes(rng.bytes(32), "little") % FP.modulus
                                   for _ in range(n - 3)]
    ys = [int.from_bytes(rng.bytes(32), "little") % FP.modulus for _ in range(n)]
    return xs, ys, (torch.from_numpy(ints_to_limbs(v).T.copy()) for v in (xs, ys))


def test_plain_matches_jax_and_host():
    import jax.numpy as jnp
    from groth16_tpu.ops import field as JF
    xs, ys, (a, b) = _operands(40, 1)
    got = KN.fp_mul_chain_plain(a, b, K)
    x, y = jnp.asarray(a.numpy().T), jnp.asarray(b.numpy().T)
    for _ in range(K):
        x = JF.mont_mul(JF.FP, x, y)
    assert np.array_equal(got.numpy().T, np.asarray(x))
    want = []
    for v, w in zip(xs, ys):
        for _ in range(K):
            v = v * w * FP.mont_r_inv % FP.modulus
        want.append(v)
    assert limbs_to_ints(got.numpy().T) == want
    assert torch.equal(KN.fp_mul_chain(a, b, 0), a)          # dispatch on the CPU


def test_lane_header_chain_from_edges():
    """K9's lane body (the header's product) at k = 256 from 0, 1, p - 1,
    R mod p and an operand with p's top word, against host ints."""
    lib = cuda.host_shim()
    if lib is None:
        pytest.skip("g++ not available")
    p, k = FP.modulus, 256
    xs = [0, 1, p - 1, (1 << 256) % p, p >> 224 << 224, p - 1, 2]
    ys = [p - 1, p - 1, p - 1, p - 1, p - 1, (1 << 256) % p, p - 2]
    a, b = (torch.from_numpy(ints_to_limbs(v).T.copy()) for v in (xs, ys))
    out = torch.zeros_like(a)
    lib.shim_fp_mul_chain(*(ctypes.c_void_p(t.data_ptr()) for t in (a, b, out)), k, len(xs))
    want = []
    for v, w in zip(xs, ys):
        for _ in range(k):
            v = v * w * FP.mont_r_inv % p
        want.append(v)
    assert limbs_to_ints(out.numpy().T) == want


def test_lane_header_matches_plain():
    lib = cuda.host_shim()
    if lib is None:
        pytest.skip("g++ not available")
    _, _, (a, b) = _operands(33, 2)
    for k in (0, 1, K):
        out = torch.zeros_like(a)
        lib.shim_fp_mul_chain(*(ctypes.c_void_p(t.data_ptr()) for t in (a, b, out)), k, 33)
        assert torch.equal(out, KN.fp_mul_chain_plain(a, b, k))
