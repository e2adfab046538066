"""Radix-2 NTT over the BN254 scalar field and the quotient's coset
transforms, as launches of kernel K3 (csrc/ntt.cu).

Counterpart of groth16_tpu/ops/ntt.py (domains, forward / inverse NTT,
coset shifts) and of the four-step orchestration of
groth16_tpu/ops/ntt_pallas.py (`_transform`).  N = N1 * N2, and a transform
is a plan of K3 steps (`inner_calls`): each step runs B batches of NB
T-point transforms and reads and writes its elements through strides, so
the four-step's transposes and bit reversals are addresses inside the
kernel and no torch op runs between the steps.  Forward = DIF over n1 with
the outer twiddle post-multiplied, then DIF over n2; inverse = DIT over k2,
then DIT over k1 with the outer twiddle (1/N folded in) pre-multiplied.  A
coset shift (iNTT, scale by eta^i, NTT) is four steps: the eta^i scaling is
the second step's post-multiply, and that step writes the [N2, N1] layout
that the forward's first step reads.

Element formats (the last axis): wire uint32[..., 16] (16-bit limbs, the
port's boundary layout) and packed uint32[..., 8] (the eight 32-bit words):
inputs and final outputs are wire, the steps in between and every table are
packed.  Tables (outer twiddles, eta powers, stage roots) are computed once
per domain on the host and cached on the device.

Domain semantics are the reference's (`groth16/math/domain.nim:26-46`): the
2^k root of unity comes from gen28 = 5^((r-1)/2^28).  Outputs are canonical
Montgomery values (standard form where a name says so), bit-identical to the
JAX package at every size.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import cuda
from . import field as F
from .field import FR
from .limbs import LIMB_BITS, LIMB_MASK, N_LIMBS

GEN28 = pow(5, (FR.modulus - 1) >> 28, FR.modulus)
MAX_LOG2 = 28
MAX_T = 4096  # per-factor transform length (N <= 2^24), 128 KB of shared memory
PACKED = 8    # words of a packed element


@dataclass(frozen=True)
class Domain:
    """Power-of-two evaluation domain (host constants)."""

    log2_size: int

    def __post_init__(self):
        assert 0 <= self.log2_size <= MAX_LOG2
        r = FR.modulus
        g = pow(GEN28, 1 << (MAX_LOG2 - self.log2_size), r)
        object.__setattr__(self, "size", 1 << self.log2_size)
        object.__setattr__(self, "gen", g)
        object.__setattr__(self, "gen_inv", pow(g, -1, r))
        object.__setattr__(self, "size_inv", pow(self.size, -1, r))


def _bitrev_indices(n: int) -> np.ndarray:
    lg = max(0, n.bit_length() - 1)
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, np.int64)
    for b in range(lg):
        rev |= ((idx >> b) & 1) << (lg - 1 - b)
    return rev


_TABLES: dict = {}


def _cached(key, make):
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = make()
    return t


def bitrev_perm(n: int, device) -> torch.Tensor:
    return _cached(("bitrev", n, str(device)),
                   lambda: torch.from_numpy(_bitrev_indices(n)).to(device))


def _split(t: int):
    """N = N1 * N2 with the larger factor first."""
    t1 = (t + 1) // 2
    return 1 << t1, 1 << (t - t1)


# ---------------------------------------------------------------------------
# element formats and tables
# ---------------------------------------------------------------------------

def unpack(x: torch.Tensor) -> torch.Tensor:
    """uint32 wire [..., 16] or packed [..., 8] -> int64 16-bit limbs [..., 16]."""
    w = x.to(torch.int64)
    if x.shape[-1] == N_LIMBS:
        return w
    return torch.stack([w & LIMB_MASK, w >> LIMB_BITS], -1).reshape(*x.shape[:-1], N_LIMBS)


def pack(limbs: torch.Tensor) -> torch.Tensor:
    """16-bit limbs [..., 16] (any integer dtype) -> packed uint32 [..., 8]."""
    w = limbs.to(torch.int64)
    return (w[..., 0::2] | (w[..., 1::2] << LIMB_BITS)).to(torch.uint32)


def _packed(vals, device) -> torch.Tensor:
    """Python ints < 2^256 -> packed uint32 [len, 8] on `device`."""
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return torch.from_numpy(np.frombuffer(buf, dtype="<u4").astype(np.uint32)
                            .reshape(-1, PACKED)).to(device)


def _powers(base: int, n: int, start: int) -> list:
    """[start * base^k mod r for k < n]."""
    out, acc = [0] * n, start % FR.modulus
    for k in range(n):
        out[k] = acc
        acc = acc * base % FR.modulus
    return out


def stage_roots(T: int, root: int, device) -> torch.Tensor:
    """packed [T]: entry h + j is root^(j T / 2h) in Montgomery form (the
    twiddle of offset j at span h; entry 0 unused), for a T-th root."""
    def make():
        pw = _powers(root, max(T // 2, 1), F.R_MONT)
        vals = [0] * T
        h = 1
        while h < T:
            for j in range(h):
                vals[h + j] = pw[j * (T // (2 * h))]
            h *= 2
        return _packed(vals, device)
    return _cached(("roots", T, root, str(device)), make)


def _twiddles(log2n: int, inverse: bool, device) -> torch.Tensor:
    """packed [N2 * N1]: W[n2, p] = root^(n2 * rev(p)), Montgomery, with 1/N
    folded in for the inverse (the four-step outer twiddle, indexed by the
    transform n2 and the position p of the N1-point step that applies it)."""
    def make():
        dom = Domain(log2n)
        N1, N2 = _split(log2n)
        root = dom.gen_inv if inverse else dom.gen
        start = F.R_MONT * (dom.size_inv if inverse else 1)
        pw = _powers(root, dom.size, start)
        exps = (np.arange(N2)[:, None] * _bitrev_indices(N1)[None, :]) % dom.size
        return _packed([pw[e] for e in exps.reshape(-1).tolist()], device)
    return _cached(("twiddles", log2n, inverse, str(device)), make)


def _coset_powers(log2n: int, eta: int, standard: bool, device) -> torch.Tensor:
    """packed [N2 * N1]: E[j2, j1] = eta^(j1 * N2 + j2), Montgomery unless
    `standard` (the post-multiply of the inverse's N1-point step, whose
    transform j2 leaves coefficient j1 * N2 + j2 at position j1)."""
    def make():
        N1, N2 = _split(log2n)
        pw = _powers(eta, N1 * N2, 1 if standard else F.R_MONT)
        exps = np.arange(N1)[None, :] * N2 + np.arange(N2)[:, None]
        return _packed([pw[e] for e in exps.reshape(-1).tolist()], device)
    return _cached(("coset", log2n, eta, standard, str(device)), make)


# ---------------------------------------------------------------------------
# K3: one step, B batches of NB T-point transforms through strides
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class Step:
    """One K3 launch (csrc/bn254_ntt.cuh `NttStep`).  Element q (natural
    order) of transform i is read at i * si + q * sq of its batch; it sits at
    position p (q for DIF, bit-reversed q for DIT) and is multiplied by
    pre[i * T + p]; after the stages position p holds output k (p for DIT,
    bit-reversed p for DIF), is multiplied by post[i * T + p] and written at
    i * oi + k * ok.  Strides count elements."""

    T: int
    NB: int
    dit: bool
    si: int
    sq: int
    oi: int
    ok: int
    roots: torch.Tensor
    pre: torch.Tensor | None = None
    post: torch.Tensor | None = None


def ntt_inner_plain(x: torch.Tensor, s: Step, wire_out: bool) -> torch.Tensor:
    """Plain PyTorch version of K3 (any device): x is uint32 [B, NB * T, 16]
    (wire) or [B, NB * T, 8] (packed); the output is [B, NB * T] in the wire
    format if `wire_out`, else packed."""
    T, NB = s.T, s.NB
    dev = x.device
    i = torch.arange(NB, device=dev)[:, None]
    q = torch.arange(T, device=dev)[None, :]
    rev = bitrev_perm(T, dev)
    src = (i * s.si + q * s.sq).reshape(-1)
    dst = (i * s.oi + (q if s.dit else rev[None, :]) * s.ok).reshape(-1)
    roots = unpack(s.roots)
    pre = None if s.pre is None else unpack(s.pre).reshape(NB, T, N_LIMBS)
    post = None if s.post is None else unpack(s.post).reshape(NB, T, N_LIMBS)
    hs = []
    h = T // 2
    while h >= 1:
        hs.append(h)
        h //= 2
    outs = []
    for xb in x:                                       # one batch at a time: less memory
        a = unpack(xb)[src].reshape(NB, T, N_LIMBS)
        if s.dit:
            a = a[:, rev]
        if pre is not None:
            a = F.mont_mul(FR, a, pre)
        for h in (reversed(hs) if s.dit else hs):
            v = a.reshape(NB, T // (2 * h), 2, h, N_LIMBS)
            u, b = v[:, :, 0], v[:, :, 1]
            w = roots[h + torch.arange(h, device=dev)]
            if s.dit:
                wb = F.mont_mul(FR, b, w)
                top, bot = F.add_mod(FR, u, wb), F.sub_mod(FR, u, wb)
            else:
                top, bot = F.add_mod(FR, u, b), F.mont_mul(FR, F.sub_mod(FR, u, b), w)
            a = torch.stack([top, bot], 2).reshape(NB, T, N_LIMBS)
        if post is not None:
            a = F.mont_mul(FR, a, post)
        out = torch.empty((NB * T, N_LIMBS), dtype=torch.int64, device=dev)
        out[dst] = a.reshape(NB * T, N_LIMBS)
        outs.append(out)
    out = torch.stack(outs)
    return out.to(torch.uint32) if wire_out else pack(out)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_aligned(*ts) -> None:
    for t in ts:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("K3 reads and writes 128 bits at a time: 16-byte aligned tensors only")


def ntt_inner_kernel(x: torch.Tensor, s: Step, wire_out: bool) -> torch.Tensor:
    """K3 on CUDA tensors (see `ntt_inner_plain`)."""
    if (x.device.type != "cuda" or x.dtype != torch.uint32 or x.dim() != 3
            or x.shape[2] not in (PACKED, N_LIMBS)):
        raise ValueError("K3 takes a uint32[B, N, 16] or [B, N, 8] CUDA tensor")
    T, NB = s.T, s.NB
    if T > MAX_T or T & (T - 1):
        raise ValueError(f"transform length {T} must be a power of two <= {MAX_T}")
    n = NB * T
    if x.shape[1] != n:
        raise ValueError(f"a step of {NB} x {T} points takes {n} elements, not {x.shape[1]}")
    if max((NB - 1) * s.si + (T - 1) * s.sq, (NB - 1) * s.oi + (T - 1) * s.ok) >= n:
        raise ValueError("step strides reach past the array")
    for t in (s.roots, s.pre, s.post):
        if t is not None and (t.device != x.device or t.dtype != torch.uint32
                              or t.shape[-1] != PACKED or not t.is_contiguous()):
            raise ValueError("K3 tables must be packed uint32 on the input's device")
    x = x.contiguous()
    B = x.shape[0]
    out = torch.empty((B, n, N_LIMBS if wire_out else PACKED), dtype=torch.uint32,
                      device=x.device)
    _check_aligned(x, out, s.roots, s.pre, s.post)
    strides = (ctypes.c_long * 6)(s.si, s.sq, s.oi, s.ok, n, n)
    rc = cuda.lib().g16_ntt_step(x.data_ptr(), out.data_ptr(), _ptr(s.pre), _ptr(s.post),
                                 s.roots.data_ptr(), strides, T, NB, B, int(s.dit),
                                 int(x.shape[2] == N_LIMBS), int(wire_out),
                                 cuda.stream_ptr(x.device))
    cuda.check(rc, "ntt kernel")
    ntt_inner_kernel.launches += 1
    return out


ntt_inner_kernel.launches = 0


def ntt_inner(x: torch.Tensor, s: Step, wire_out: bool) -> torch.Tensor:
    """K3 on CUDA tensors, the plain version on CPU."""
    if x.device.type == "cpu":
        return ntt_inner_plain(x, s, wire_out)
    return ntt_inner_kernel(x, s, wire_out)


KINDS = ("forward", "inverse", "to_coset", "from_coset_std")


def inner_calls(log2n: int, kind: str, device, eta: int | None = None) -> list:
    """The K3 steps of one 2^log2n transform, in order (natural order in and
    out): "forward", "inverse", "to_coset" (values on the domain -> values on
    the eta coset: the inverse, eta^i, the forward) and "from_coset_std"
    (values on the eta coset -> coefficients, in standard form: the inverse
    with eta^-i in standard form as its last post-multiply)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}")

    def make():
        dom = Domain(log2n)
        r = FR.modulus
        N1, N2 = _split(log2n)
        steps = []
        if kind != "forward":
            g = dom.gen_inv
            # DIT over k2 for each k1 (input index k2 * N1 + k1); writes [N2, N1]
            steps.append(Step(N2, N1, True, 1, N1, 1, N1, stage_roots(N2, pow(g, N1, r), device)))
            post, (oi, ok) = None, (1, N2)                  # natural j = j1 * N2 + j2
            if kind == "to_coset":
                post, (oi, ok) = _coset_powers(log2n, eta, False, device), (N1, 1)
            elif kind == "from_coset_std":
                post = _coset_powers(log2n, pow(eta, -1, r), True, device)
            # DIT over k1 for each j2, outer twiddle (1/N) before, eta^j after
            steps.append(Step(N1, N2, True, N1, 1, oi, ok, stage_roots(N1, pow(g, N2, r), device),
                              pre=_twiddles(log2n, True, device), post=post))
        if kind in ("forward", "to_coset"):
            w = dom.gen
            si, sq = (N1, 1) if kind == "to_coset" else (1, N2)
            # DIF over n1 for each n2, outer twiddle after; writes [N1, N2]
            steps.append(Step(N1, N2, False, si, sq, N1, 1, stage_roots(N1, pow(w, N2, r), device),
                              post=_twiddles(log2n, False, device)))
            # DIF over n2 for each k1: output k1 + N1 * k2 in natural order
            steps.append(Step(N2, N1, False, 1, N1, 1, N1, stage_roots(N2, pow(w, N1, r), device)))
        return steps
    return _cached(("plan", log2n, kind, eta, str(device)), make)


def transform(x: torch.Tensor, log2n: int, kind: str, eta: int | None = None,
              wire_out: bool = True, inner=ntt_inner) -> torch.Tensor:
    """Run the steps of `inner_calls` on x (uint32 [B, 2^log2n, 16] wire or
    [B, 2^log2n, 8] packed, natural order); the last step writes the wire
    format if `wire_out`, else packed.  `inner` runs one step (the plain
    version, to hold the kernels against it)."""
    steps = inner_calls(log2n, kind, x.device, eta)
    for j, s in enumerate(steps):
        x = inner(x, s, wire_out and j == len(steps) - 1)
    return x


def forward_ntt(dom: Domain, coeffs: torch.Tensor) -> torch.Tensor:
    """Coefficients -> evaluations on the domain (reference ntt.nim:55-77);
    uint32[N, 16] Montgomery in and out."""
    assert tuple(coeffs.shape) == (dom.size, N_LIMBS)
    return transform(coeffs[None], dom.log2_size, "forward")[0]


def inverse_ntt(dom: Domain, values: torch.Tensor) -> torch.Tensor:
    """Evaluations on the domain -> coefficients (reference ntt.nim:139-161)."""
    assert tuple(values.shape) == (dom.size, N_LIMBS)
    return transform(values[None], dom.log2_size, "inverse")[0]


def shift_eval_domain(dom: Domain, values: torch.Tensor, eta_mont: torch.Tensor) -> torch.Tensor:
    """Values on the domain -> values on the eta-shifted coset
    (iNTT, scale by eta^i, NTT); reference prover.nim:109-113."""
    assert tuple(values.shape) == (dom.size, N_LIMBS)
    eta = FR.from_mont_limbs(eta_mont.cpu().numpy())
    return transform(values[None], dom.log2_size, "to_coset", eta)[0]


# ---------------------------------------------------------------------------
# the quotient's pointwise step (csrc/ntt.cu g16_quotient_pointwise)
# ---------------------------------------------------------------------------

def _mont_scale(scale: int, device) -> torch.Tensor:
    return _cached(("scale", scale, str(device)),
                   lambda: _packed([scale * F.R_MONT % FR.modulus], device))


def quotient_pointwise_plain(ev: torch.Tensor, scale: int | None, standard: bool) -> torch.Tensor:
    """Plain PyTorch version of the pointwise step (any device): from the
    coset values ev (packed [3, N, 8]: A, B, C) A * B - C, times `scale` (a
    field element, standard form) where given; out of Montgomery form into
    the wire layout [N, 16] if `standard`, else Montgomery, packed [1, N, 8]."""
    a, b, c = unpack(ev)
    y = F.sub_mod(FR, F.mont_mul(FR, a, b), c)
    if scale is not None:
        y = F.mont_mul(FR, y, unpack(_mont_scale(scale, ev.device))[0])
    return F.from_mont(FR, y).to(torch.uint32) if standard else pack(y)[None]


def quotient_pointwise_kernel(ev: torch.Tensor, scale: int | None, standard: bool) -> torch.Tensor:
    """The pointwise step on CUDA tensors (see `quotient_pointwise_plain`)."""
    if (ev.device.type != "cuda" or ev.dtype != torch.uint32 or ev.dim() != 3
            or ev.shape[0] != 3 or ev.shape[2] != PACKED):
        raise ValueError("the pointwise step takes a packed uint32[3, N, 8] CUDA tensor")
    ev = ev.contiguous()
    n = ev.shape[1]
    sc = None if scale is None else _mont_scale(scale, ev.device)
    out = torch.empty((n, N_LIMBS) if standard else (1, n, PACKED), dtype=torch.uint32,
                      device=ev.device)
    _check_aligned(ev, sc, out)
    rc = cuda.lib().g16_quotient_pointwise(ev.data_ptr(), n, _ptr(sc), int(standard),
                                           out.data_ptr(), cuda.stream_ptr(ev.device))
    cuda.check(rc, "quotient pointwise kernel")
    quotient_pointwise_kernel.launches += 1
    return out


quotient_pointwise_kernel.launches = 0


def quotient_pointwise(ev: torch.Tensor, scale: int | None, standard: bool) -> torch.Tensor:
    """The pointwise step's kernel on CUDA tensors, the plain version on CPU."""
    if ev.device.type == "cpu":
        return quotient_pointwise_plain(ev, scale, standard)
    return quotient_pointwise_kernel(ev, scale, standard)
