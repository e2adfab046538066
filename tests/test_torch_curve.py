"""Port curve arithmetic (groth16_tpu_torch.ops.curve) vs the JAX package and
the host-int oracle.  G1 add/double are held against JAX's jnp formulas
(bit-exact: both run the same RCB15 sequence); G2 against host ints here and
against JAX in the slow lane; scalar multiplication and conversions after
affine normalization."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from groth16_tpu.ops import curve as JC
from groth16_tpu_torch.ops import curve as C
from groth16_tpu_torch.ops.limbs import ints_to_limbs
from groth16_tpu_torch.utils import hostmath as H

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

R = H.R


def _host_points(cv, n, seed, with_inf=True):
    fo = H.G1_FIELD if cv.name == "G1" else H.G2_FIELD
    g = H.G1_GEN if cv.name == "G1" else H.G2_GEN
    rng = np.random.default_rng(seed)
    pts = [H.ec_scalar_mul(fo, int(k), g) for k in rng.integers(1, 1 << 62, size=n)]
    if with_inf:
        pts[1] = None
    return pts, fo


def _proj(cv, n, seed):
    """Projective batch with Z != 1 (sums of host points)."""
    a, fo = _host_points(cv, n, seed)
    b, _ = _host_points(cv, n, seed + 100)
    A, B = C.points_from_host(cv, a), C.points_from_host(cv, b)
    return C.point_add(cv, A, B), [H.ec_add(fo, x, y) for x, y in zip(a, b)], fo


def _jax(P):
    return tuple(jnp.asarray(c.numpy()) for c in P)


def test_g1_add_double_bit_exact_with_jax():
    P, hp, fo = _proj(C.G1, 16, 1)
    Q, hq, _ = _proj(C.G1, 16, 2)
    Q = tuple(torch.cat([q[:3], p[3:4], q[4:]]) for p, q in zip(P, Q))     # P = Q lane
    got = C.point_add(C.G1, P, Q)
    want = JC.point_add(JC.G1, _jax(P), _jax(Q))
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))
    got = C.point_double(C.G1, P)
    want = JC.point_double(JC.G1, _jax(P))
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))
    hq[3] = hp[3]
    assert C.points_to_host(C.G1, C.point_add(C.G1, P, Q)) == [
        H.ec_add(fo, x, y) for x, y in zip(hp, hq)]


def test_g2_add_double_match_host():
    P, hp, fo = _proj(C.G2, 10, 3)
    Q, hq, _ = _proj(C.G2, 10, 4)
    neg = C.point_neg(C.G2, P)
    Q = tuple(torch.cat([q[:2], m[2:3], q[3:]]) for m, q in zip(neg, Q))   # P = -Q lane
    hq[2] = H.ec_neg(fo, hp[2])
    assert C.points_to_host(C.G2, C.point_add(C.G2, P, Q)) == [
        H.ec_add(fo, x, y) for x, y in zip(hp, hq)]
    assert C.points_to_host(C.G2, C.point_double(C.G2, P)) == [H.ec_add(fo, x, x) for x in hp]


@pytest.mark.parametrize("cv,jcv", [(C.G1, JC.G1), (C.G2, JC.G2)], ids=["G1", "G2"])
def test_affine_conversions_match_jax(cv, jcv):
    pts, _ = _host_points(cv, 6, 5)
    P = C.points_from_host(cv, pts)
    JP = JC.points_from_host(jcv, pts)
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(P, JP))
    D = C.point_double(cv, P)
    x, y = C.to_affine(cv, D)
    jx, jy = JC.to_affine(jcv, _jax(D))
    assert np.array_equal(x.numpy(), np.asarray(jx)) and np.array_equal(y.numpy(), np.asarray(jy))
    assert C.points_to_host(cv, P) == pts


@pytest.mark.parametrize("cv", [C.G1, C.G2], ids=["G1", "G2"])
def test_scalar_mul_and_tree_sum_match_host(cv):
    pts, fo = _host_points(cv, 5, 6)
    ks = [0, 1, R - 1, 2**200 + 12345, 77]
    S = C.scalar_mul(cv, torch.from_numpy(ints_to_limbs(ks)), C.points_from_host(cv, pts))
    want = [H.ec_scalar_mul(fo, k, p) for k, p in zip(ks, pts)]
    assert C.points_to_host(cv, S) == want
    total = None
    for w in want:
        total = H.ec_add(fo, total, w)
    assert C.points_to_host(cv, tuple(c[None] for c in C.tree_sum(cv, S))) == [total]


@pytest.mark.slow
def test_g2_add_double_bit_exact_with_jax():
    P, _, _ = _proj(C.G2, 4, 7)
    Q, _, _ = _proj(C.G2, 4, 8)
    got = C.point_add(C.G2, P, Q)
    want = JC.point_add(JC.G2, _jax(P), _jax(Q))
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))
    got = C.point_double(C.G2, P)
    want = JC.point_double(JC.G2, _jax(P))
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))
