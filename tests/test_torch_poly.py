"""The port's dense polynomials (`ops/poly.py`) against the JAX package's
`ops/poly.py` on the same seeded polynomials: equal Montgomery words
(tolerance 0, exact integer arithmetic), and equal host ints for the
Lagrange helpers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from groth16_tpu.ops import ntt as JNT
from groth16_tpu.ops import poly as JP

from groth16_tpu_torch.ops import ntt as NT
from groth16_tpu_torch.ops import poly as P
from groth16_tpu_torch.ops.field import FR

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

R = FR.modulus


def _ints(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


def _both(xs):
    """The same coefficients as a port tensor and a JAX array."""
    t = P.poly_from_ints(xs, "cpu")
    return t, jnp.asarray(t.numpy())


def _eq(t, j) -> bool:
    return np.array_equal(t.numpy(), np.asarray(j))


def test_from_to_ints_match_jax():
    xs = _ints(1, 9) + [0, R - 1]
    t, _ = _both(xs)
    assert _eq(t, JP.poly_from_ints(xs))
    assert P.poly_to_ints(t) == JP.poly_to_ints(JP.poly_from_ints(xs)) == xs


@pytest.mark.parametrize("n,m", [(7, 4), (3, 3), (1, 5)])
def test_add_sub_neg_match_jax(n, m):
    (ta, ja), (tb, jb) = _both(_ints(n, n)), _both(_ints(10 + m, m))
    assert _eq(P.poly_add(ta, tb), JP.poly_add(ja, jb))
    assert _eq(P.poly_sub(ta, tb), JP.poly_sub(ja, jb))
    assert _eq(P.poly_neg(ta), JP.poly_neg(ja))


def test_scale_and_eval_match_jax():
    ta, ja = _both(_ints(3, 6))
    s, x = FR.to_mont_limbs(_ints(4, 1)[0]), FR.to_mont_limbs(_ints(5, 1)[0])
    assert _eq(P.poly_scale(torch.from_numpy(s), ta), JP.poly_scale(jnp.asarray(s), ja))
    assert _eq(P.poly_eval_at(ta, torch.from_numpy(x)), JP.poly_eval_at(ja, jnp.asarray(x)))


@pytest.mark.parametrize("n,m", [(5, 4), (40, 120)])
def test_products_match_jax(n, m):
    """The naive and the FFT product, and the dispatch between them (naive
    at 20 coefficient pairs, FFT at 4800)."""
    (ta, ja), (tb, jb) = _both(_ints(20 + n, n)), _both(_ints(30 + m, m))
    want = np.asarray(JP.poly_mul(ja, jb))
    assert _eq(P.poly_mul(ta, tb), want)
    assert _eq(P.poly_mul_fft(ta, tb), want)
    if n * m <= 1 << 12:
        assert _eq(P.poly_mul_naive(ta, tb), want)


@pytest.mark.parametrize("n", [6, 8, 21])
def test_vanishing_division_matches_jax(n):
    N = 8
    ta, ja = _both(_ints(40 + n, n))
    assert _eq(P.vanishing_poly(N, "cpu", 3, 5), JP.vanishing_poly(N, 3, 5))
    q, r = P.poly_divmod_vanishing(ta, N)
    jq, jr = JP.poly_divmod_vanishing(ja, N)
    assert _eq(q, jq) and _eq(r, jr)


def test_lagrange_match_jax():
    zeta = _ints(50, 1)[0]
    dom, jdom = NT.Domain(4), JNT.Domain(4)
    assert P.lagrange_evals_at(dom, zeta) == JP.lagrange_evals_at(jdom, zeta)
    assert [P.lagrange_eval_off_domain(dom, k, zeta) for k in (0, 5, 15)] == [
        JP.lagrange_eval_off_domain(jdom, k, zeta) for k in (0, 5, 15)]
