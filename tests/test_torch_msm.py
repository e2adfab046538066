"""Port MSM (fold path, groth16_tpu_torch.ops.msm) vs a host-int oracle.

The points are P_i = a_i * G with known discrete logs a_i, so the expected
sum_i k_i P_i is one host scalar multiplication by sum_i k_i a_i.  Results
compare after conversion to affine: the bucket schedule changes the
projective representative.  The port vs JAX `msm` runs in the slow lane."""

import numpy as np
import pytest
import torch

from groth16_tpu_torch.ops import curve as C, msm as M
from groth16_tpu_torch.ops.limbs import ints_to_limbs
from groth16_tpu_torch.utils import hostmath as H

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

R = H.R


def _multiples(cv, n):
    """[(i+1) G for i < n] by repeated host addition, (i+1) as the log."""
    fo = H.G1_FIELD if cv.name == "G1" else H.G2_FIELD
    g = H.G1_GEN if cv.name == "G1" else H.G2_GEN
    pts, acc = [], None
    for _ in range(n):
        acc = H.ec_add(fo, acc, g)
        pts.append(acc)
    return pts, fo, g


def _scalars(case, n, rng):
    if case == "zero":
        return [0] * n
    if case == "same":                                  # one bucket per window
        return [0x1F2E3D4C5B6A79880123456789ABCDEF] * n
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


def _check(cv, n, case, affine=True, seed=0):
    rng = np.random.default_rng(seed)
    pts, fo, g = _multiples(cv, n)
    pts[n // 3] = None                                  # an infinity in the stream
    logs = [0 if p is None else i + 1 for i, p in enumerate(pts)]
    ks = _scalars(case, n, rng)
    P = C.points_from_host(cv, pts)
    if not affine:                                      # Z != 1 points
        P = C.point_add(cv, P, C.inf_like(cv, (n,)))
    got = M.msm(cv, torch.from_numpy(ints_to_limbs(ks)), P, affine)
    want = H.ec_scalar_mul(fo, sum(k * a for k, a in zip(ks, logs)) % R, g)
    assert C.points_to_host(cv, tuple(c[None] for c in got)) == [want]


@pytest.mark.parametrize("n,case", [(512, "random"), (1021, "random"), (1024, "zero"),
                                    (600, "same")])
def test_g1_fold_msm_matches_host(n, case):
    _check(C.G1, n, case, seed=n)


@pytest.mark.parametrize("n,case", [(512, "random"), (1000, "same")])
def test_g2_fold_msm_matches_host(n, case):
    _check(C.G2, n, case, seed=n)


def test_projective_input_and_naive_path():
    _check(C.G1, 200, "random", affine=False, seed=1)   # fold, projective level 0
    _check(C.G1, 50, "random", seed=2)                  # < 128 points: naive ladder


def test_digits_and_window_heuristic_match_jax():
    import jax.numpy as jnp
    from groth16_tpu.ops import msm as JM
    rng = np.random.default_rng(4)
    ks = [R - 1, 0, 1, 2**253] + [int.from_bytes(rng.bytes(32), "little") % R for _ in range(60)]
    limbs = ints_to_limbs(ks)
    for c in (4, 7, 13, 14, 16):
        got = M.signed_window_digits(torch.from_numpy(limbs), c).numpy()
        want = np.asarray(JM.signed_window_digits(jnp.asarray(limbs), c))
        assert np.array_equal(got, want)
        assert all(sum(int(d) << (c * w) for w, d in enumerate(got[:, j])) == k
                   for j, k in enumerate(ks))
    for n in (1, 127, 128, 511, 512, 65535, 65536, 1 << 22):
        assert M.pick_window_bits(n) == JM.pick_window_bits(n)


@pytest.mark.slow
@pytest.mark.parametrize("cv_name", ["G1", "G2"])
def test_fold_msm_matches_jax_msm(cv_name):
    import jax.numpy as jnp
    from groth16_tpu.ops import curve as JC, msm as JM
    cv, jcv = getattr(C, cv_name), getattr(JC, cv_name)
    n = 512
    rng = np.random.default_rng(5)
    pts, _, _ = _multiples(cv, n)
    ks = ints_to_limbs(_scalars("random", n, rng))
    got = M.msm(cv, torch.from_numpy(ks), C.points_from_host(cv, pts), affine=True)
    want = JM.msm(jcv, jnp.asarray(ks), JC.points_from_host(jcv, pts), 0, True)
    x, y = C.to_affine(cv, got)
    jx, jy = JC.to_affine(jcv, want)
    assert np.array_equal(x.numpy(), np.asarray(jx)) and np.array_equal(y.numpy(), np.asarray(jy))
