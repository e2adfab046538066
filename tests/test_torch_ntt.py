"""Port NTT (four-step orchestration + inner transform) vs the JAX package's
`forward_ntt` / `inverse_ntt` / `shift_eval_domain` (its jnp `_dif_stages`
on the CPU), bit-exact, and vs a host-int FFT at 2^15, where the inner
transform length reaches 256 (the size class that broke on the TPU)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from groth16_tpu.ops import ntt as JN
from groth16_tpu_torch.ops import ntt as NT
from groth16_tpu_torch.ops.field import FR
from groth16_tpu_torch.ops.limbs import ints_to_limbs_bulk, limbs_to_ints

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

R = FR.modulus


def _rand_mont(n, seed):
    rng = np.random.default_rng(seed)
    return ints_to_limbs_bulk(int.from_bytes(rng.bytes(32), "little") % R for _ in range(n))


def test_domain_constants_match_jax():
    assert NT.GEN28 == JN.GEN28
    for lg in (0, 1, 5, 16, 28):
        a, b = NT.Domain(lg), JN.Domain(lg)
        assert (a.size, a.gen, a.gen_inv, a.size_inv) == (b.size, b.gen, b.gen_inv, b.size_inv)


@pytest.mark.parametrize("log2n", [4, 12])
def test_forward_inverse_bit_exact_with_jax(log2n):
    x = _rand_mont(1 << log2n, log2n)
    dom, jdom = NT.Domain(log2n), JN.Domain(log2n)
    fwd = NT.forward_ntt(dom, torch.from_numpy(x))
    assert np.array_equal(fwd.numpy(), np.asarray(JN.forward_ntt(jdom, jnp.asarray(x))))
    inv = NT.inverse_ntt(dom, torch.from_numpy(x))
    assert np.array_equal(inv.numpy(), np.asarray(JN.inverse_ntt(jdom, jnp.asarray(x))))
    assert np.array_equal(NT.inverse_ntt(dom, fwd).numpy(), x)


def test_shift_eval_domain_bit_exact_with_jax():
    log2n = 4
    x = _rand_mont(1 << log2n, 99)
    eta = np.asarray(FR.to_mont_limbs(NT.Domain(log2n + 1).gen))
    got = NT.shift_eval_domain(NT.Domain(log2n), torch.from_numpy(x), torch.from_numpy(eta))
    want = JN.shift_eval_domain(JN.Domain(log2n), jnp.asarray(x), jnp.asarray(eta))
    assert np.array_equal(got.numpy(), np.asarray(want))


def _host_dft(vals, root):
    """Recursive radix-2 DFT over host ints: out[k] = sum_j vals[j] root^(jk)."""
    n = len(vals)
    if n == 1:
        return list(vals)
    even = _host_dft(vals[0::2], root * root % R)
    odd = _host_dft(vals[1::2], root * root % R)
    out = [0] * n
    w = 1
    for k in range(n // 2):
        t = w * odd[k] % R
        out[k] = (even[k] + t) % R
        out[k + n // 2] = (even[k] - t) % R
        w = w * root % R
    return out


@pytest.mark.parametrize("log2n", [1, 7, 15])
def test_four_step_matches_host(log2n):
    """Down to N = 2 (T = 2 x 1), and N = 2^15 = 256 x 128, where the inner
    transforms run at T = 256 and 128."""
    dom = NT.Domain(log2n)
    x = _rand_mont(dom.size, log2n)
    plain = [FR.from_mont_int(v) for v in limbs_to_ints(x)]
    fwd = NT.forward_ntt(dom, torch.from_numpy(x))
    want = _host_dft(plain, dom.gen)
    assert [FR.from_mont_int(v) for v in limbs_to_ints(fwd.numpy())] == want
    back = NT.inverse_ntt(dom, fwd)
    assert np.array_equal(back.numpy(), x)
