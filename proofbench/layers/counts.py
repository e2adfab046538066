"""The yardstick of the roofline metrics: the card's peaks and the least
work of each layer of a proof, counted from the circuit and the scalars
alone, whatever implements them.

Peaks (NVIDIA H100 SXM): 3.35 TB/s of HBM, and 132 SMs x 64 32-bit
multiply-adds an SM a clock (CUDA C++ Programming Guide, compute
capability 9.0) x the card's maximum SM clock, over 264 multiply issue
slots an 8-limb Montgomery product (128 widening multiplies at two slots,
8 low ones at one): the constants of the port's tools/measure.py, copied
so that the program may change and this may not.  An Fp2 product counts
as 3 Fp products; an Fr product as an Fp product.

An MSM's least work is the least, over every window width c, of the
signed-digit Pippenger count for its very scalars (`pippenger`), each
addition and doubling priced at the 6 Fp products of a batched affine
addition (18 in G2).
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
SMS = 132
MUL_PER_SM_PER_CLOCK = 64
FP_MUL_SLOTS = 2 * 8 * 8 * 2 + 8            # 128 widening at two slots, 8 low: 264
ADD_PRODUCTS = {"G1": 6, "G2": 18}          # one batched affine addition
POINT_BYTES = {"G1": 64, "G2": 128}         # an affine point
FR_BYTES = 32
SCALAR_BITS = 254


def peak_products_per_s(clock_mhz: float) -> float:
    return SMS * MUL_PER_SM_PER_CLOCK * clock_mhz * 1e6 / FP_MUL_SLOTS


def least_seconds(nbytes: float, products: float, clock_mhz: float) -> float:
    """The larger of the bytes at the HBM peak and the products at the
    multiply peak."""
    return max(nbytes / HBM_BYTES_PER_S, products / peak_products_per_s(clock_mhz))


def words(values) -> np.ndarray:
    """Field elements (ints in [0, r)) -> uint64 [n, 4], little endian."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, "<u8").reshape(-1, 4)


def digit_stats(w: np.ndarray, c: int, mult: np.ndarray | None = None) -> list:
    """(nonzero digits, largest |digit|) of each window of the signed
    width-c recoding of the scalars w (uint64 [n, 4]), each scalar's digits
    counted `mult` times where given: digits in [-2^(c-1), 2^(c-1)), a
    carry into the next window, one window more than the bits need for
    the last carry."""
    n = w.shape[0]
    half, full, mask = 1 << (c - 1), 1 << c, np.uint64((1 << c) - 1)
    carry = np.zeros(n, np.int64)
    out = []
    for win in range(-(-SCALAR_BITS // c) + 1):
        q, sh = divmod(win * c, 64)
        v = np.zeros(n, np.uint64)
        if q < 4:
            v = w[:, q] >> np.uint64(sh)
            if sh + c > 64 and q + 1 < 4:
                v = v | (w[:, q + 1] << np.uint64(64 - sh))
        d = (v & mask).astype(np.int64) + carry
        neg = d >= half
        d[neg] -= full
        carry = neg.astype(np.int64)
        nzm = d != 0
        nz = int(np.count_nonzero(nzm)) if mult is None else int(mult[nzm].sum())
        out.append((nz, int(np.abs(d).max()) if nz else 0))
    return out


def pippenger(stats: list, c: int) -> tuple:
    """(additions, doublings) of the bucket method at width c from the
    windows' `digit_stats`: each nonzero digit is one addition into its
    bucket, less one a window (a bucket's first point is a copy) and
    counted per bucket below; the running-sum reduction of a window whose
    largest |digit| is m takes m - 1 additions besides its buckets' own
    first points; the windows combine by Horner from the highest window
    with a digit, c doublings and one addition a window below it.
    Net: nnz + sum (m_w - 1) - 1 additions and c * top doublings."""
    nnz = sum(nz for nz, _ in stats)
    if nnz == 0:
        return 0, 0
    reduce = sum(m - 1 for nz, m in stats if nz)
    top = max(i for i, (nz, _) in enumerate(stats) if nz)
    return nnz + reduce - 1, c * top


def widths(n: int) -> range:
    """Window widths the least count ranges over: 2 up to log2(n) + 4,
    past which one window's reduction alone outweighs what wider windows
    save."""
    return range(2, max(3, int(n).bit_length() + 5))


def merge_stats(a: list, b: list) -> list:
    """Per-window stats of the union of two scalar sets."""
    return [(x[0] + y[0], max(x[1], y[1])) for x, y in zip(a, b)]


class MsmCount:
    """One scalar set's window stats, width by width as asked for.  Equal
    scalars recode alike, so each distinct value is recoded once and its
    digits counted as often as it occurs (a 0/1 witness has two)."""

    def __init__(self, values):
        seen: dict = {}
        for v in values:
            v = int(v)
            seen[v] = seen.get(v, 0) + 1
        self.n, self.distinct = len(values), len(seen)
        self.nonzero = self.n - seen.get(0, 0)
        self._mult = None if len(seen) == self.n else np.fromiter(seen.values(), np.int64, len(seen))
        self._w = words(seen.keys())
        self._stats: dict = {}

    def stats(self, c: int) -> list:
        if c not in self._stats:
            self._stats[c] = digit_stats(self._w, c, self._mult)
        return self._stats[c]


FULL_SCAN = 1 << 12    # distinct scalars up to which every width is counted


def least_msm(parts, curve: str) -> tuple:
    """(additions + doublings, c, bytes, products) of an MSM over the union
    of the scalar sets `parts` (MsmCount objects), least over the widths.
    Where the parts hold more than FULL_SCAN distinct scalars the count is
    walked from c = log2(n) - 3 up and down until two widths in a row do
    no better (the count falls and then rises with c: more windows below,
    more buckets above); otherwise every width of `widths` is counted.
    Bytes: the points of nonzero scalars and every scalar read once."""
    n = sum(x.n for x in parts)
    cs = widths(n)
    cost: dict = {}

    def at(c):
        if c not in cost:
            stats = parts[0].stats(c)
            for extra in parts[1:]:
                stats = merge_stats(stats, extra.stats(c))
            cost[c] = sum(pippenger(stats, c))
        return cost[c]

    if sum(x.distinct for x in parts) <= FULL_SCAN:
        for c in cs:
            at(c)
    else:
        c0 = min(max(cs.start, n.bit_length() - 3), cs.stop - 1)
        best = at(c0)
        for step in (1, -1):
            c, worse = c0, 0
            while cs.start <= c + step < cs.stop and worse < 2:
                c += step
                if at(c) < best:
                    best, worse = at(c), 0
                else:
                    worse += 1
    c = min(cost, key=lambda k: (cost[k], k))
    nbytes = sum(x.nonzero for x in parts) * POINT_BYTES[curve] + n * FR_BYTES
    return cost[c], c, nbytes, cost[c] * ADD_PRODUCTS[curve]


def spmv_work(circuit) -> tuple:
    """(bytes, products) of Az, Bz, Cz = Az Bz over the domain: each entry
    of A (with snarkjs's dummy rows) and B read once (a 32-byte
    coefficient, a 4-byte column) with a row offset a row of each, the
    witness read once, the three vectors written; one product an entry
    and one a row where both A and B have one."""
    n = 1 << circuit.log2_domain
    nnz = len(circuit.a) + circuit.n_pub + 1 + len(circuit.b)
    both = len(np.intersect1d(circuit.a.row, circuit.b.row))
    nbytes = 36 * nnz + 2 * 4 * (n + 1) + FR_BYTES * circuit.n_wires + 3 * FR_BYTES * n
    return nbytes, nnz + both


def quotient_work(log2n: int) -> tuple:
    """(bytes, products) of the snarkjs quotient: A, B and C each through
    an inverse and a forward transform (N/2 log2 N butterflies, one
    product each) and the eta^i scale (N products, 1/N folded in), then
    A B - C (N products); Az, Bz, Cz read once, the N scalars written."""
    n = 1 << log2n
    return 4 * FR_BYTES * n, 3 * (n * log2n + n) + n


# ---------------------------------------------------------------------------
# a proof's layers, as the metric readers take them from a run's context
# ---------------------------------------------------------------------------

SPMV_KERNELS = ("spmv",)
QUOTIENT_KERNELS = ("ntt_step_kernel", "quotient_pointwise_kernel")
HOST_COPIES = ("HtoD", "DtoH")


def msm_seconds(ctx) -> float | None:
    """Device seconds a traced proof outside the SpMV, the quotient and the
    copies to and from the host: the five MSMs, the spec-point algebra and
    their glue."""
    tr = ctx.trace
    if tr is None or not tr.proofs or not tr.ops:
        return None
    on_card = sum(t for n, (_, t) in tr.ops.items() if not any(h in n for h in HOST_COPIES))
    other = sum(t for n, (_, t) in tr.ops.items()
                if any(k in n for k in SPMV_KERNELS + QUOTIENT_KERNELS))
    s = (on_card - other) / tr.proofs
    return s if s > 0 else None


def msm_works(ctx, i: int) -> list:
    """(ops, c, bytes, products) of the MSMs over A1, B1, B2 and C1 for pool
    witness i: A1, B1 and B2 take every wire's value, C1 the private ones."""
    def make():
        vals, npub = ctx.pool[i], ctx.circuit.n_pub
        pub, priv = MsmCount(vals[:npub + 1]), MsmCount(vals[npub + 1:])
        ab = least_msm([pub, priv], "G1")
        return [ab, ab, least_msm([pub, priv], "G2"), least_msm([priv], "G1")]
    return ctx.once(("msm", i), make)


def h_work(ctx) -> tuple:
    """(ops, c, bytes, products) of the MSM over H1.  Its scalars, the
    quotient's values on the coset, are full-width field elements that the
    yardstick does not compute (a transform of 2^20 in plain Python takes
    seconds); the count takes as many uniform scalars drawn from the seed
    in their place."""
    from proofbench.harness import draw
    n = 1 << ctx.circuit.log2_domain
    return ctx.once("h", lambda: least_msm([MsmCount(draw.uniform(ctx.seed, "h-standin", n))],
                                           "G1"))


def _per_traced_proof(ctx, fn) -> float | None:
    tr = ctx.trace
    if tr is None or not tr.witnesses:
        return None
    return sum(fn(msm_works(ctx, i) + [h_work(ctx)]) for i in tr.witnesses) / len(tr.witnesses)


def msm_least_seconds(ctx) -> float | None:
    """The five MSMs' least seconds, the mean over the traced proofs."""
    if ctx.clock_mhz is None:
        return None
    return _per_traced_proof(ctx, lambda ws: sum(least_seconds(w[2], w[3], ctx.clock_mhz)
                                                 for w in ws))


def proof_products(ctx) -> float | None:
    """The least products of a traced proof: SpMV, quotient, five MSMs."""
    msm = _per_traced_proof(ctx, lambda ws: sum(w[3] for w in ws))
    if msm is None:
        return None
    return spmv_work(ctx.circuit)[1] + quotient_work(ctx.circuit.log2_domain)[1] + msm
