"""Port field arithmetic (groth16_tpu_torch.ops.field) vs the JAX package's
field ops and host ints, bit-exact, on adversarial limb patterns."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from groth16_tpu.ops import field as JF
from groth16_tpu_torch.ops import field as TF
from groth16_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

R = 1 << 256


def _values(mod, n=96, seed=7):
    rng = np.random.default_rng(seed)
    allf = ((1 << 16) - 1) * sum(1 << (16 * i) for i in range(16))
    xs = [mod - 1, mod - 2, 0, 1, (1 << 254) % mod, allf % mod, (1 << 128) - 1, mod // 2]
    ys = [mod - 1, 1, mod - 1, 0, (1 << 253) % mod, allf % mod, (1 << 128) - 1, mod // 2 + 1]
    while len(xs) < n:
        xs.append(int.from_bytes(rng.bytes(32), "little") % mod)
        ys.append(int.from_bytes(rng.bytes(32), "little") % mod)
    return xs, ys


@pytest.mark.parametrize("name", ["FP", "FR"])
def test_ops_match_jax_and_host(name):
    tfp, jfp = getattr(TF, name), getattr(JF, name)
    mod = tfp.modulus
    assert (tfp.modulus, tfp.mont_r, tfp.mont_r2) == (jfp.modulus, jfp.mont_r, jfp.mont_r2)
    xs, ys = _values(mod)
    a_np, b_np = ints_to_limbs(xs), ints_to_limbs(ys)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    rinv = pow(R, -1, mod)
    cases = [
        (TF.mont_mul(tfp, a, b), JF.mont_mul(jfp, ja, jb), [x * y * rinv % mod for x, y in zip(xs, ys)]),
        (TF.add_mod(tfp, a, b), JF.add_mod(jfp, ja, jb), [(x + y) % mod for x, y in zip(xs, ys)]),
        (TF.sub_mod(tfp, a, b), JF.sub_mod(jfp, ja, jb), [(x - y) % mod for x, y in zip(xs, ys)]),
        (TF.neg_mod(tfp, a), JF.neg_mod(jfp, ja), [(-x) % mod for x in xs]),
        (TF.to_mont(tfp, a), JF.to_mont(jfp, ja), [x * R % mod for x in xs]),
        (TF.from_mont(tfp, a), JF.from_mont(jfp, ja), [x * rinv % mod for x in xs]),
    ]
    for got, want_jax, want in cases:
        assert got.dtype == torch.uint32
        assert np.array_equal(got.numpy(), np.asarray(want_jax))
        assert limbs_to_ints(got.numpy()) == want


def test_int64_limbs_in_int64_out():
    xs, ys = _values(TF.FP.modulus, n=8)
    a = torch.from_numpy(ints_to_limbs(xs)).to(torch.int64)
    b = torch.from_numpy(ints_to_limbs(ys)).to(torch.int64)
    got = TF.mont_mul(TF.FP, a, b)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), TF.mont_mul(TF.FP, a.to(torch.uint32), b.to(torch.uint32)).numpy())


@pytest.mark.parametrize("name", ["FP", "FR"])
def test_inverse_powers_and_wide_reduce(name):
    tfp, jfp = getattr(TF, name), getattr(JF, name)
    mod = tfp.modulus
    xs, _ = _values(mod, n=24)
    a_np = ints_to_limbs(xs)
    inv = TF.inv_mod(tfp, torch.from_numpy(a_np))
    assert np.array_equal(inv.numpy(), np.asarray(JF.inv_mod(jfp, jnp.asarray(a_np))))
    base = jnp.asarray(tfp.to_mont_limbs(123456789))
    pw = TF.powers(tfp, torch.from_numpy(np.array(base)), 37)
    assert np.array_equal(pw.numpy(), np.asarray(JF.powers(jfp, base, 37)))
    rng = np.random.default_rng(3)
    wide = [int.from_bytes(rng.bytes(64), "little") % (mod * R) for _ in range(24)] + [mod * R - 1]
    w_np = ints_to_limbs(wide, 32)
    got = TF.mont_reduce_wide(tfp, torch.from_numpy(w_np))
    assert np.array_equal(got.numpy(), np.asarray(JF.mont_reduce_wide(jfp, jnp.asarray(w_np))))


def test_reduce_columns_matches_segment_sum():
    """The int64 segment sum of the port's SpMV: many canonical values per
    segment (more than the 2^16 the JAX uint32 accumulator allows)."""
    fr = TF.FR
    rng = np.random.default_rng(11)
    n_terms, n_seg = 70_000, 3
    vals = rng.integers(0, 1 << 16, size=(n_terms, 16), dtype=np.int64)
    vals[:, 15] &= 0x2FFF
    seg = rng.integers(0, n_seg, size=n_terms)
    acc = torch.zeros((n_seg, 16), dtype=torch.int64).index_add_(
        0, torch.from_numpy(seg), torch.from_numpy(vals))
    got = limbs_to_ints(TF.reduce_columns(fr, acc).numpy())
    ints = limbs_to_ints(vals.astype(np.uint64))
    want = [sum(v for v, s in zip(ints, seg) if s == k) % fr.modulus for k in range(n_seg)]
    assert got == want
