"""The port's quotient (the batched coset transforms and the pointwise step)
against the JAX package's `quotient_scalars` at 2^4 and 2^5 and a host-int
oracle at 2^9 and 2^12, both flavours; the new K3 plan against the parent's
four-step composition (transposes, a bit-reversal gather, eta^i by
`powers`) at 2^9, 2^12 and 2^15, batch of three; and the kernels' block
bodies (csrc/bn254_ntt.cuh through the g++ shim) against the plain versions
at every step of every plan.  Tolerance 0: exact integer arithmetic on
canonical inputs made from a numpy seed."""

import ctypes

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_ntt import _host_dft

from groth16_tpu_torch.ops import cuda, field as F, ntt as NT
from groth16_tpu_torch.ops.field import FR
from groth16_tpu_torch.ops.limbs import ints_to_limbs_bulk, limbs_to_ints
from groth16_tpu_torch.protocol.prover import quotient_scalars
from groth16_tpu_torch.protocol.types import Flavour

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

R = FR.modulus
FLAVOURS = ("Snarkjs", "JensGroth")


def _rand_mont(n, seed):
    rng = np.random.default_rng(seed)
    return ints_to_limbs_bulk(int.from_bytes(rng.bytes(32), "little") % R for _ in range(n))


def _abc(log2n, seed):
    """Az, Bz, Cz as the SpMV leaves them: int64 Montgomery [N, 16]."""
    return [torch.from_numpy(_rand_mont(1 << log2n, seed + j).astype(np.int64)) for j in range(3)]


def _std(t) -> list:
    return limbs_to_ints(np.asarray(t))


@pytest.fixture(scope="module")
def jax_quotients():
    """The JAX package's quotient scalars, out of Montgomery form, per
    (flavour, log2n); computed once for the module (each size compiles)."""
    from groth16_tpu.ops import field as JF
    from groth16_tpu.protocol.prover import quotient_scalars as jax_quotient
    from groth16_tpu.protocol.types import Flavour as JFlavour
    out = {}
    for log2n in (4, 5):
        abc = [jnp.asarray(x.numpy().astype(np.uint32)) for x in _abc(log2n, 10 * log2n)]
        for name in FLAVOURS:
            q = jax_quotient(getattr(JFlavour, name), *abc, log2n)
            out[name, log2n] = np.asarray(JF.from_mont(JF.FR, q))
    return out


@pytest.mark.parametrize("log2n", [4, 5])
@pytest.mark.parametrize("flavour", FLAVOURS)
def test_quotient_bit_exact_with_jax(jax_quotients, flavour, log2n):
    got = quotient_scalars(getattr(Flavour, flavour), *_abc(log2n, 10 * log2n), log2n)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (1 << log2n, 16)
    assert np.array_equal(got.numpy(), jax_quotients[flavour, log2n])


def _oracle(flavour, abc, log2n):
    """Host ints: the coset values of A, B, C (coefficients by the inverse
    DFT, times eta^j, the forward DFT), A * B - C, and for JensGroth / Z,
    the inverse DFT and eta^-j; standard form."""
    n = 1 << log2n
    dom = NT.Domain(log2n)
    eta = NT.Domain(log2n + 1).gen
    ninv = pow(n, -1, R)

    def coeffs(vals):
        return [v * ninv % R for v in _host_dft(vals, dom.gen_inv)]

    evs = []
    for x in abc:
        c = coeffs([FR.from_mont_int(v) for v in _std(x)])
        evs.append(_host_dft([v * pow(eta, j, R) % R for j, v in enumerate(c)], dom.gen))
    ys = [(a * b - c) % R for a, b, c in zip(*evs)]
    if flavour == "Snarkjs":
        return ys
    inv_z = pow(pow(eta, n, R) - 1, -1, R)
    q = coeffs([y * inv_z % R for y in ys])
    eta_inv = pow(eta, -1, R)
    return [v * pow(eta_inv, j, R) % R for j, v in enumerate(q)]


@pytest.mark.parametrize("log2n", [9, 12])
@pytest.mark.parametrize("flavour", FLAVOURS)
def test_quotient_matches_host_oracle(flavour, log2n):
    abc = _abc(log2n, log2n)
    got = quotient_scalars(getattr(Flavour, flavour), *abc, log2n)
    assert _std(got) == _oracle(flavour, abc, log2n)


# ---------------------------------------------------------------------------
# the parent's four-step composition, as the reference for the new plan
# ---------------------------------------------------------------------------

def _mont_limbs(vals) -> torch.Tensor:
    return torch.from_numpy(ints_to_limbs_bulk(v * F.R_MONT % R for v in vals).astype(np.int64))


def _old_inner(a, tw, root, dit):
    """The parent's K3 plain version on int64 [NB, T, 16]: DIF (natural in,
    bit-reversed out) with `tw` after, or DIT (bit-reversed in) with `tw`
    before."""
    NB, T, _ = a.shape
    w_all = _mont_limbs([pow(root, k, R) for k in range(max(T // 2, 1))])
    if tw is not None and dit:
        a = F.mont_mul(FR, a, tw)
    hs = []
    h = T // 2
    while h >= 1:
        hs.append(h)
        h //= 2
    for h in (reversed(hs) if dit else hs):
        v = a.reshape(NB, T // (2 * h), 2, h, 16)
        u, b = v[:, :, 0], v[:, :, 1]
        w = w_all[torch.arange(h) * (T // (2 * h))]
        if dit:
            wb = F.mont_mul(FR, b, w)
            top, bot = F.add_mod(FR, u, wb), F.sub_mod(FR, u, wb)
        else:
            top, bot = F.add_mod(FR, u, b), F.mont_mul(FR, F.sub_mod(FR, u, b), w)
        a = torch.stack([top, bot], 2).reshape(NB, T, 16)
    if tw is not None and not dit:
        a = F.mont_mul(FR, a, tw)
    return a


def _old_transform(x, log2n, inverse):
    """The parent's four-step on int64 [N, 16], natural order in and out:
    transposes between the two inner calls, one bit-reversal gather."""
    n = 1 << log2n
    N1, N2 = NT._split(log2n)
    dom = NT.Domain(log2n)
    g = dom.gen_inv if inverse else dom.gen
    scale = dom.size_inv if inverse else 1
    exps = (np.arange(N2)[:, None] * NT._bitrev_indices(N1)[None, :]) % n
    pw = [1] * n
    for k in range(1, n):
        pw[k] = pw[k - 1] * g % R
    W = _mont_limbs([pw[e] * scale % R for e in exps.reshape(-1).tolist()]).reshape(N2, N1, 16)
    rev = torch.from_numpy(NT._bitrev_indices(n))
    r1, r2 = pow(g, N2, R), pow(g, N1, R)
    if not inverse:
        y = _old_inner(x.reshape(N1, N2, 16).transpose(0, 1), W, r1, False)   # [N2, N1br]
        z = _old_inner(y.transpose(0, 1), None, r2, False)                    # [N1br, N2br]
        return z.reshape(n, 16)[rev]
    y = _old_inner(x[rev].reshape(N1, N2, 16), None, r2, True)
    return _old_inner(y.transpose(0, 1), W, r1, True).transpose(0, 1).reshape(n, 16)


@pytest.mark.parametrize("log2n", [9, 12, 15])
def test_plan_equals_old_four_step(log2n):
    """The to_coset plan (four strided steps, batch of three, packed in
    between) and the from_coset_std plan against the parent's composition."""
    eta = NT.Domain(log2n + 1).gen
    abc = _abc(log2n, 3 * log2n)
    got = NT.transform(torch.stack(abc).to(torch.uint32), log2n, "to_coset", eta)
    eta_m = F.const(FR.to_mont_limbs(eta), "cpu")
    pw = F.powers(FR, eta_m, 1 << log2n)
    for x, g in zip(abc, got):
        want = _old_transform(F.mont_mul(FR, _old_transform(x, log2n, True), pw), log2n, False)
        assert torch.equal(g.to(torch.int64), want)
    back = NT.transform(NT.pack(got[:1]), log2n, "from_coset_std", eta)[0]
    pw_inv = F.powers(FR, F.const(FR.to_mont_limbs(pow(eta, -1, R)), "cpu"), 1 << log2n)
    want = F.from_mont(FR, F.mont_mul(FR, _old_transform(got[0].to(torch.int64), log2n, True),
                                      pw_inv))
    assert torch.equal(back.to(torch.int64), want)
    # un-shifting the coset values gives A's coefficients back
    assert torch.equal(F.to_mont(FR, back.to(torch.int64)), _old_transform(abc[0], log2n, True))


def test_plans_launch_four_and_two_steps():
    """The shapes of the quotient's launches: a coset shift is four steps
    (DIT, DIT with both tables, DIF with the outer twiddle, DIF), the
    un-shift two; only the steps between launches are packed."""
    log2n, eta = 16, NT.Domain(17).gen
    fwd = NT.inner_calls(log2n, "to_coset", "cpu", eta)
    assert [(s.T, s.NB, s.dit, s.pre is not None, s.post is not None) for s in fwd] == [
        (256, 256, True, False, False), (256, 256, True, True, True),
        (256, 256, False, False, True), (256, 256, False, False, False)]
    back = NT.inner_calls(log2n, "from_coset_std", "cpu", eta)
    assert [(s.dit, s.pre is not None, s.post is not None) for s in back] == [
        (True, False, False), (True, True, True)]
    assert NT.inner_calls(17, "forward", "cpu")[0].T == 512


# ---------------------------------------------------------------------------
# the kernels' block bodies through the g++ shim
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shim():
    lib = cuda.host_shim()
    if lib is None:
        pytest.skip("g++ not available")
    return lib


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _shim_step(lib, x, s, wire_out):
    B, n = x.shape[0], s.NB * s.T
    out = torch.zeros((B, n, 16 if wire_out else 8), dtype=torch.uint32)
    strides = (ctypes.c_long * 6)(s.si, s.sq, s.oi, s.ok, n, n)
    lib.shim_ntt_step(_p(x), _p(out), _p(s.pre), _p(s.post), _p(s.roots), strides, s.T, s.NB,
                      B, int(s.dit), int(x.shape[2] == 16), int(wire_out))
    return out


@pytest.mark.parametrize("log2n", [0, 1, 2, 5, 9, 10])
def test_shim_step_matches_plain(shim, log2n):
    """Every step of every plan, both output formats, wire or packed input."""
    eta = NT.Domain(log2n + 1).gen
    for kind in NT.KINDS:
        B = 3 if kind == "to_coset" else 1
        x = torch.from_numpy(np.stack([_rand_mont(1 << log2n, 7 * log2n + j) for j in range(B)]))
        for j, s in enumerate(NT.inner_calls(log2n, kind, "cpu", eta)):
            xin = x if j == 0 else NT.pack(x)
            for wire_out in (False, True):
                assert torch.equal(_shim_step(shim, xin, s, wire_out),
                                   NT.ntt_inner_plain(xin, s, wire_out)), (kind, j, wire_out)


def test_shim_pointwise_matches_plain(shim):
    n = 300
    ev = NT.pack(torch.from_numpy(np.stack([_rand_mont(n, 40 + j) for j in range(3)])))
    for scale, standard in ((None, True), (0x1234567, False)):
        out = torch.zeros((n, 16) if standard else (1, n, 8), dtype=torch.uint32)
        sc = None if scale is None else NT._mont_scale(scale, "cpu")
        shim.shim_quotient_pointwise(_p(ev), n, _p(sc), int(standard), _p(out))
        assert torch.equal(out, NT.quotient_pointwise_plain(ev, scale, standard))
    a, b, c = (limbs_to_ints(NT.unpack(e).numpy()) for e in ev)
    rinv = pow(1 << 256, -1, R)
    assert limbs_to_ints(NT.unpack(out[0]).numpy()) == [      # the scaled Montgomery values
        (x * y * rinv - z) * 0x1234567 % R for x, y, z in zip(a, b, c)]
