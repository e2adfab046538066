// BN254 G1 / G2 complete projective formulas, the segmented-fold lane body
// and the merge-tree thread bodies.
//
// The group law is Renes-Costello-Batina 2015 (a = 0), the same operation
// sequence as groth16_tpu/ops/curve.py::rcb_add / rcb_add_mixed / rcb_double,
// so projective outputs are bit-identical to the plain PyTorch versions
// (groth16_tpu_torch/ops/curve.py).  The fold lane body is what
// groth16_tpu/ops/kernels.py::_fold_call computes for one lane, closed
// segments added straight into their buckets; the tree bodies are the
// affine additions of groth16_tpu/ops/kernels_tree.py.  All are
// __host__ __device__ so the CPU tests run them through a g++ build.

#pragma once

#include "bn254_field.cuh"

namespace bn254 {

// Curve constants in Montgomery form: 3b and 1 (G1 over Fp, G2 over Fp2).
struct G1 {
  typedef Fp F;
  static constexpr int NC = 16;  // wire words per coordinate
  BN_HD static F b3() {
    return F{{0x410d7ff7u, 0xf60647ceu, 0xd31bd011u, 0x2f3d6f4du,
              0x3940c6d1u, 0x2943337eu, 0xa7e39857u, 0x1d9598e8u}};
  }
  BN_HD static F one() {
    return F{{0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
              0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}};
  }
};

struct G2 {
  typedef Fp2 F;
  static constexpr int NC = 32;
  BN_HD static F b3() {
    return F{Fp{{0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
                 0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u}},
             Fp{{0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
                 0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au}}};
  }
  BN_HD static F one() { return F{G1::one(), Fp::zero()}; }
};

template <class F>
struct Proj {
  F X, Y, Z;
};

template <class F>
struct Aff {
  F x, y;
};

// RCB15 algorithm 7: complete projective addition, 12M + 2 (3b) products.
template <class C>
BN_HD Proj<typename C::F> rcb_add(const Proj<typename C::F>& P,
                                  const Proj<typename C::F>& Q) {
  typedef typename C::F F;
  const F b3 = C::b3();
  F t0 = P.X * Q.X;
  F t1 = P.Y * Q.Y;
  F t2 = P.Z * Q.Z;
  F t3 = (P.X + P.Y) * (Q.X + Q.Y);
  t3 = t3 - (t0 + t1);
  F t4 = (P.Y + P.Z) * (Q.Y + Q.Z);
  t4 = t4 - (t1 + t2);
  F X3 = (P.X + P.Z) * (Q.X + Q.Z);
  F Y3 = X3 - (t0 + t2);
  X3 = t0 + t0;
  t0 = X3 + t0;
  t2 = b3 * t2;
  F Z3 = t1 + t2;
  t1 = t1 - t2;
  Y3 = b3 * Y3;
  X3 = t4 * Y3;
  t2 = t3 * t1;
  X3 = t2 - X3;
  Y3 = Y3 * t0;
  t1 = t1 * Z3;
  Y3 = t1 + Y3;
  t0 = t0 * t3;
  Z3 = Z3 * t4;
  Z3 = Z3 + t0;
  return Proj<F>{X3, Y3, Z3};
}

// RCB15 algorithm 8: projective + affine (Z2 = 1).  The affine operand must
// not be the point at infinity; callers select around (0, 0).
template <class C>
BN_HD Proj<typename C::F> rcb_add_mixed(const Proj<typename C::F>& P,
                                        const Aff<typename C::F>& Q) {
  typedef typename C::F F;
  const F b3 = C::b3();
  F t0 = P.X * Q.x;
  F t1 = P.Y * Q.y;
  F t3 = (Q.x + Q.y) * (P.X + P.Y);
  t3 = t3 - (t0 + t1);
  F t4 = (Q.y * P.Z) + P.Y;
  F Y3 = (Q.x * P.Z) + P.X;
  F X3 = t0 + t0;
  t0 = X3 + t0;
  F t2 = b3 * P.Z;
  F Z3 = t1 + t2;
  t1 = t1 - t2;
  Y3 = b3 * Y3;
  X3 = t4 * Y3;
  t2 = t3 * t1;
  X3 = t2 - X3;
  Y3 = Y3 * t0;
  t1 = t1 * Z3;
  Y3 = t1 + Y3;
  t0 = t0 * t3;
  Z3 = Z3 * t4;
  Z3 = Z3 + t0;
  return Proj<F>{X3, Y3, Z3};
}

// RCB15 algorithm 9: complete projective doubling.
template <class C>
BN_HD Proj<typename C::F> rcb_double(const Proj<typename C::F>& P) {
  typedef typename C::F F;
  const F b3 = C::b3();
  F t0 = P.Y.sqr();
  F Z3 = t0 + t0;
  Z3 = Z3 + Z3;
  Z3 = Z3 + Z3;
  F t1 = P.Y * P.Z;
  F t2 = P.Z.sqr();
  t2 = b3 * t2;
  F X3 = t2 * Z3;
  F Y3 = t0 + t2;
  Z3 = t1 * Z3;
  t1 = t2 + t2;
  t2 = t1 + t2;
  t0 = t0 - t2;
  Y3 = t0 * Y3;
  Y3 = X3 + Y3;
  t1 = P.X * P.Y;
  X3 = t0 * t1;
  X3 = X3 + X3;
  return Proj<F>{X3, Y3, Z3};
}

template <class F>
BN_HD Proj<F> select(bool c, const Proj<F>& a, const Proj<F>& b) {
  return Proj<F>{F::select(c, a.X, b.X), F::select(c, a.Y, b.Y),
                 F::select(c, a.Z, b.Z)};
}

template <class C>
BN_HD Proj<typename C::F> infinity() {
  typedef typename C::F F;
  return Proj<F>{F::zero(), C::one(), F::zero()};
}

// ------------------------------------------------------------ K1 chains ---
//
// One thread's work in the chain kernels of K1 (csrc/point.cu), on the
// point-major wire layout uint32[n, NC] a coordinate.

template <class C>
BN_HD Proj<typename C::F> load_proj_vec(const uint32_t* x, const uint32_t* y,
                                        const uint32_t* z, long o) {
  typedef typename C::F F;
  return Proj<F>{F::load_vec(x + o), F::load_vec(y + o), F::load_vec(z + o)};
}

template <class C>
BN_HD void store_proj_vec(uint32_t* x, uint32_t* y, uint32_t* z, long o,
                          const Proj<typename C::F>& P) {
  P.X.store_vec(x + o);
  P.Y.store_vec(y + o);
  P.Z.store_vec(z + o);
}

// 2^k P: k doublings in registers (the loop stays rolled: one body).
template <class C>
BN_HD Proj<typename C::F> double_n(Proj<typename C::F> P, int k) {
#pragma unroll 1
  for (int j = 0; j < k; ++j) P = rcb_double<C>(P);
  return P;
}

// Horner over W window sums S[0..W) of one MSM (coordinates at x, y, z, NC
// words a window): acc = S[W-1]; for w = W-2 .. 0: c doublings, + S[w].
template <class C>
BN_HD Proj<typename C::F> horner_lane(const uint32_t* x, const uint32_t* y,
                                      const uint32_t* z, int W, int c) {
  Proj<typename C::F> acc = load_proj_vec<C>(x, y, z, (long)(W - 1) * C::NC);
#pragma unroll 1
  for (int w = W - 2; w >= 0; --w)
    acc = rcb_add<C>(double_n<C>(acc, c), load_proj_vec<C>(x, y, z, (long)w * C::NC));
  return acc;
}

// ------------------------------------------------------------ fold lane ---
//
// One lane of the segmented fold over a digit-sorted stream (what
// groth16_tpu/ops/kernels.py::_fold_call computes for one lane, with the
// routing of closed segments done in the lane itself).  Point-major layouts,
// every row 16-byte aligned (four 128-bit accesses a coordinate):
//   rows   uint32[*, Rin]     the level's points: Rin = 2*NC (affine x|y,
//                             (0, 0) = infinity) or 3*NC (x|y|z)
//   order  int32 [W, m]       the row of sorted position j of window w; null
//                             at later levels, where the row is w*m + j
//   keys   int32 [W, m]       the sorted signed digits; bucket identity |key|,
//                             a negative key negates y
//   table  uint32[W, nb, R]   bucket sums, R = 3*NC, updated in place
//   trail  uint32[W*lanes, R] the lane's open segment after its last element,
//   tkey   int32 [W*lanes]    and its |key| (both unused at the last level)
// Lane l of window w walks sorted positions l*T .. l*T+T-1.  A slot whose
// key is 0 does no work: it reads its key and nothing else.  Bucket 0 has
// weight 0 in the bucket reduce, so nothing reads the table's bucket 0, and
// it keeps what it held.  The lane's first nonzero slot opens its segment at
// its point.  When |key| changes at a later nonzero slot, the segment that
// ran up to the nonzero slot before it has closed: it is added into that
// slot's bucket table[w, |key|].  No other lane of the launch touches that
// bucket: a key's run ends at one position of the stream.  At the last level
// (one lane a window) the open segment is added into its bucket the same
// way; otherwise it is the next level's row, and a lane of zero keys alone
// leaves infinity under key 0, which the next level skips in turn.  The
// rule holds for keys in any order; on the proof's sorted streams a
// window's zero keys lead it, so whole warps of zero lanes skip together.
// Every other slot runs ONE complete add: (running segment + point), or,
// where a segment closes, (bucket + segment), so the warp never diverges
// over the formula.

template <class C>
BN_HD Proj<typename C::F> load_proj_row(const uint32_t* row) {
  typedef typename C::F F;
  return Proj<F>{F::load_vec(row), F::load_vec(row + C::NC), F::load_vec(row + 2 * C::NC)};
}

template <class C>
BN_HD void store_proj_row(uint32_t* row, const Proj<typename C::F>& P) {
  P.X.store_vec(row);
  P.Y.store_vec(row + C::NC);
  P.Z.store_vec(row + 2 * C::NC);
}

// Sorted position's point: the row at src, y negated for a negative key k;
// an affine (0, 0) row is infinity.
template <class C, bool AFFINE>
BN_HD Proj<typename C::F> fold_point(const uint32_t* src, int32_t k) {
  typedef typename C::F F;
  const F x = F::load_vec(src);
  F y = F::load_vec(src + C::NC);
  y = F::select(k < 0, y.neg(), y);
  if (AFFINE) {
    const bool inf = x.is_zero() && y.is_zero();
    return select(inf, infinity<C>(), Proj<F>{x, y, C::one()});
  }
  return Proj<F>{x, y, F::load_vec(src + 2 * C::NC)};
}

// p, opaque to the optimiser: a load through it is not merged with an
// earlier load of the same address.
BN_HD const uint32_t* opaque(const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  asm volatile("" : "+l"(p));
#endif
  return p;
}

// The zero keys among a lane's T slots, what K2 counts as skipped.
BN_HD int lane_zeros(const int32_t* keys, int T) {
  int zeros = 0;
  for (int t = 0; t < T; ++t) zeros += keys[t] == 0;
  return zeros;
}

template <class C, bool AFFINE>
BN_HD void fold_lane(const uint32_t* rows, const int32_t* order, const int32_t* keys,
                     uint32_t* table, uint32_t* trail, int32_t* tkey, int T, long m,
                     int nb, bool last, long w, long l, long lane) {
  typedef typename C::F F;
  const int Rin = AFFINE ? 2 * C::NC : 3 * C::NC;
  const int R = 3 * C::NC;
  const long base = w * m + l * T;
  uint32_t* buckets = table + w * nb * R;

  int32_t ap = 0;  // |key| of the open segment; 0 while none is open
  Proj<F> run = infinity<C>();
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const int32_t k = keys[base + t];
    if (k == 0) continue;
    const long row = order ? (long)order[base + t] : base + t;
    const uint32_t* src = rows + row * Rin;
    const Proj<F> fresh = fold_point<C, AFFINE>(src, k);
    const int32_t ak = k < 0 ? -k : k;
    if (ap == 0) {
      run = fresh;
    } else {
      const bool close = ak != ap;
      Proj<F> a = run, b = fresh;
      if (close) {
        a = load_proj_row<C>(buckets + (long)ap * R);
        b = run;
      }
      const Proj<F> s = rcb_add<C>(a, b);
      if (close) store_proj_row<C>(buckets + (long)ap * R, s);
      // a close starts the next segment at this slot's point, read again
      // rather than kept live across the add (which spilled in G2)
      run = close ? fold_point<C, AFFINE>(opaque(src), k) : s;
    }
    ap = ak;
  }
  if (last) {
    if (ap != 0) {
      uint32_t* bucket = buckets + (long)ap * R;
      store_proj_row<C>(bucket, rcb_add<C>(load_proj_row<C>(bucket), run));
    }
  } else {
    store_proj_row<C>(trail + lane * R, run);
    tkey[lane] = ap;
  }
}

// ----------------------------------------------------------- merge tree ---
//
// Thread bodies of the batched-affine merge-tree kernels (the bodies of
// groth16_tpu/ops/kernels_tree.py::_phase_a_call, ::_mul_rows_call,
// ::_invert_call, ::_phase_b_call and ::_phase_b_level_call).  One tree
// level is a batch of affine additions mid = A.pR + B.pL whose slope
// denominators share one batch inversion.  Layouts of K4 and K7, with the
// lane axis M minor:
//   points  uint32[2*NC, T, M]  limb-major fused x|y, (0, 0) = infinity;
//                               element (t, m) is addition t*M + m of the level
//   totals  uint32[NC, M]       per-lane denominator products (and inverses)
// The fused level (K8) reads its operands as columns instead (`LevelIO`).

constexpr int TREE_T = 16;       // sequential additions per lane
constexpr int INV_THREADS = 128;  // threads of a batch-inversion block (a power of two)
constexpr int INV_CHUNK = 4;      // totals each of them chains

// R^3 mod p: the Montgomery product by it takes (aR)^-1 = a^-1 R^-1 to a^-1 R.
BN_HD Fp fp_r3() {
  return Fp{{0xda1530dfu, 0xb1cd6dafu, 0xa7283db6u, 0x62f210e6u,
             0x0ada0afbu, 0xef7f0b0cu, 0x2d592544u, 0x20fd6e90u}};
}

// x / 2 mod p for a canonical x: (x + p) / 2 when x is odd (x + p < 2^255).
BN_HD Fp fp_half(const Fp& x) {
  const uint32_t mask = 0u - (x.v[0] & 1u);
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t s = (uint64_t)x.v[i] + (FpParams::p(i) & mask) + c;
    t[i] = (uint32_t)s;
    c = s >> 32;
  }
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = (t[i] >> 1) | ((i < 7 ? t[i + 1] : 0u) << 31);
  return r;
}

// Inverse in Fp of a Montgomery value (the inverse of 0 is 0), by the binary
// extended Euclid with right shifts: u = x1 A and v = x2 A (mod p) hold
// throughout for the input residue A, v stays odd, u only shrinks, and u = 0
// leaves v = gcd = 1, so x2 = A^-1.  At most about 2 x 254 steps of a few
// limb-wide shifts and subtractions: about a tenth of the serial
// instructions of a Fermat ladder a^(p-2) (some 380 products).  The number
// of steps depends on the value: this code makes no constant-time promise
// (the MSM's sort and bucket schedule depend on the scalars already).  The
// result is the canonical residue.
BN_HD Fp field_inv(const Fp& a) {
  Fp u = a, v, x1 = Fp::zero(), x2 = Fp::zero();
  x1.v[0] = 1u;
#pragma unroll
  for (int i = 0; i < 8; ++i) v.v[i] = FpParams::p(i);
#pragma unroll 1
  while (!u.is_zero()) {
    if (u.v[0] & 1u) {
      // both odd: put the larger in u, subtract, and the difference is even
      bool lt = false;
#pragma unroll
      for (int i = 0; i < 8; ++i) lt = u.v[i] != v.v[i] ? u.v[i] < v.v[i] : lt;
      if (lt) {
        const Fp tu = u, tx = x1;
        u = v; v = tu;
        x1 = x2; x2 = tx;
      }
      uint32_t borrow = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint64_t d = (uint64_t)u.v[i] - v.v[i] - borrow;
        u.v[i] = (uint32_t)d;
        borrow = (uint32_t)(d >> 63);
      }
      x1 = x1 - x2;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) u.v[i] = (u.v[i] >> 1) | ((i < 7 ? u.v[i + 1] : 0u) << 31);
    x1 = fp_half(x1);
  }
  return x2 * fp_r3();   // the input is aR: (aR)^-1 R^3 R^-1 = a^-1 R
}

// Fp2 inverse through the norm: (c0 - c1 u) / (c0^2 + c1^2).
BN_HD Fp2 field_inv(const Fp2& a) {
  const Fp ni = field_inv(a.c0 * a.c0 + a.c1 * a.c1);
  return Fp2{a.c0 * ni, (a.c1 * ni).neg()};
}

// One merge slot: A.pR = (x1, y1), B.pL = (x2, y2) and the group-law cases.
template <class F>
struct TreeSlot {
  F x1, y1, x2, y2;
  bool i1, i2, eqx, eqy, dbl;
};

template <class C>
BN_HD TreeSlot<typename C::F> tree_slot(const uint32_t* a, const uint32_t* b, long stride) {
  typedef typename C::F F;
  TreeSlot<F> s;
  s.x1 = F::load(a, stride);
  s.y1 = F::load(a + C::NC * stride, stride);
  s.x2 = F::load(b, stride);
  s.y2 = F::load(b + C::NC * stride, stride);
  s.i1 = s.x1.is_zero() && s.y1.is_zero();
  s.i2 = s.x2.is_zero() && s.y2.is_zero();
  s.eqx = s.x1 == s.x2;
  s.eqy = s.y1 == s.y2;
  s.dbl = s.eqx && s.eqy && !s.i1;
  return s;
}

// Masked slope denominator: 2 y1 when doubling, x2 - x1 otherwise, and 1 on
// the cancellation and infinity lanes, so it is never zero.
template <class C>
BN_HD typename C::F tree_den(const TreeSlot<typename C::F>& s) {
  typedef typename C::F F;
  const F den = F::select(s.dbl, s.y1 + s.y1, s.x2 - s.x1);
  const bool dummy = (s.eqx && !s.eqy) || s.i1 || s.i2;
  return F::select(dummy, C::one(), den);
}

// mid = A + B given 1/den: chord or tangent, P + (-P) = (0, 0), and an
// infinite operand returns the other one.
template <class C>
BN_HD Aff<typename C::F> tree_mid(const TreeSlot<typename C::F>& s,
                                  const typename C::F& inv) {
  typedef typename C::F F;
  const F x1sq = s.x1.sqr();
  const F num = F::select(s.dbl, (x1sq + x1sq) + x1sq, s.y2 - s.y1);
  const F lam = num * inv;
  F x3 = (lam.sqr() - s.x1) - s.x2;
  F y3 = lam * (s.x1 - x3) - s.y1;
  const bool cancel = s.eqx && !s.eqy;
  x3 = F::select(cancel, F::zero(), x3);
  y3 = F::select(cancel, F::zero(), y3);
  x3 = F::select(s.i2, s.x1, F::select(s.i1, s.x2, x3));
  y3 = F::select(s.i2, s.y1, F::select(s.i1, s.y2, y3));
  return Aff<F>{x3, y3};
}

// K5, element w: out[w] = a[w] * b[w mod bw].  Each of a, b and out lies
// where the caller keeps it: element w at p + w * cs, its wire words ls
// apart (limb-major rows and column slices of them: ls = the row stride,
// cs = 1; point-major arrays [W, NC]: ls = 1, cs = NC).  `vec` (bit 0 a,
// 1 b, 2 out) marks an operand read or written with 128-bit accesses: ls =
// 1 and every element 16-byte aligned.
struct MulRowsIO {
  const uint32_t *a, *b;
  uint32_t* out;
  long als, acs, bls, bcs, ols, ocs;
  long W, bw;
  int vec;
};

// 128-bit accesses for an operand of n elements: limb stride 1, every
// element on a 16-byte boundary
BN_HD bool mul_rows_vec(const void* p, long ls, long cs, long n) {
  return ls == 1 && (n == 1 || cs % 4 == 0) && (uintptr_t)p % 16 == 0;
}

BN_HD MulRowsIO mul_rows_io(const uint32_t* a, long als, long acs, const uint32_t* b, long bls,
                            long bcs, long bw, uint32_t* out, long ols, long ocs, long W) {
  const int vec = mul_rows_vec(a, als, acs, W) | mul_rows_vec(b, bls, bcs, bw) << 1 |
                  mul_rows_vec(out, ols, ocs, W) << 2;
  return MulRowsIO{a, b, out, als, acs, bls, bcs, ols, ocs, W, bw, vec};
}

template <class C>
BN_HD void mul_rows_elem(const MulRowsIO& io, long w) {
  typedef typename C::F F;
  const uint32_t* pa = io.a + w * io.acs;
  const uint32_t* pb = io.b + (io.bw == io.W ? w : w % io.bw) * io.bcs;
  uint32_t* po = io.out + w * io.ocs;
  const F x = (io.vec & 1) ? F::load_vec(pa) : F::load(pa, io.als);
  const F y = (io.vec & 2) ? F::load_vec(pb) : F::load(pb, io.bls);
  const F r = x * y;
  if (io.vec & 4) r.store_vec(po);
  else r.store(po, io.ols);
}

// K6, the batch inversion of tot[:, 0..M): every block of INV_THREADS
// threads takes INV_THREADS * INV_CHUNK totals and shares nothing with the
// others.  Thread t of the block whose first total is e0 chains the totals
// e0 + t + i * INV_THREADS (`inv_chain`); the block multiplies the thread
// products together in a binary tree in shared scratch (`inv_tree_up`, node i
// = node 2i * node 2i+1, leaves at INV_THREADS + t, root at 1); one thread
// inverts the root (`field_inv`); the way back mirrors the way down
// (`inv_tree_down`, then `inv_walk_back`).  The scratch is packed and
// node-minor: word w of node i at [w * 2 * INV_THREADS + i].  Totals past M
// count as one; a total of 0 counts as one on the way down and gives 0.

// Thread's first total is e: the exclusive prefix products of its chunk ->
// pre, and the chunk's product.
template <class C>
BN_HD typename C::F inv_chain(const uint32_t* tot, long M, long e,
                              typename C::F pre[INV_CHUNK]) {
  typedef typename C::F F;
  F run = C::one();
#pragma unroll
  for (int i = 0; i < INV_CHUNK; ++i) {
    const long idx = e + (long)i * INV_THREADS;
    pre[i] = run;
    if (idx < M) {
      const F v = F::load(tot + idx, M);
      run = run * F::select(v.is_zero(), C::one(), v);
    }
  }
  return run;
}

// node i = node 2i * node 2i+1.  Word w of node i lies at node[w * s + i * q]:
// K6 and K8 keep one tree a block (s = 2 * INV_THREADS, q = 1), K4 and K7
// one a lane, interleaved (s = 2 * TREE_T * lanes, q = lanes).
template <class F>
BN_HD void inv_tree_up(uint32_t* node, int i, long s = 2 * INV_THREADS, long q = 1) {
  (F::load_packed(node + 2 * i * q, s) * F::load_packed(node + (2 * i + 1) * q, s))
      .store_packed(node + i * q, s);
}

// the inverse of child c from its parent's inverse and its sibling's product
template <class F>
BN_HD void inv_tree_down(const uint32_t* node, uint32_t* invn, int c, long s = 2 * INV_THREADS,
                         long q = 1) {
  (F::load_packed(invn + (c >> 1) * q, s) * F::load_packed(node + (c ^ 1) * q, s))
      .store_packed(invn + c * q, s);
}

// rinv = 1 / (the chunk's product): the inverse of each total -> inv.
template <class C>
BN_HD void inv_walk_back(const uint32_t* tot, uint32_t* inv, long M, long e,
                         const typename C::F pre[INV_CHUNK], typename C::F rinv) {
  typedef typename C::F F;
#pragma unroll
  for (int i = INV_CHUNK - 1; i >= 0; --i) {
    const long idx = e + (long)i * INV_THREADS;
    if (idx >= M) continue;
    const F v = F::load(tot + idx, M);
    const bool z = v.is_zero();
    F::select(z, F::zero(), rinv * pre[i]).store(inv + idx, M);
    rinv = rinv * F::select(z, C::one(), v);
  }
}

// dst <- cond ? mid : src, one fused x|y point; limb strides dstride, sstride.
template <class C>
BN_HD void tree_store_sel(uint32_t* dst, long dstride, bool cond,
                          const Aff<typename C::F>& mid, const uint32_t* src, long sstride) {
  if (cond) {
    mid.x.store(dst, dstride);
    mid.y.store(dst + C::NC * dstride, dstride);
  } else {
    for (int r = 0; r < 2 * C::NC; ++r) dst[r * dstride] = src[r * sstride];
  }
}

// ------------------------------------ lane trees: totals (K4), mids (K7) ---
//
// K4 and K7 run in blocks of L lanes x TREE_T slots, one thread a slot:
// thread (t, l) = threadIdx t * L + l owns slot t of lane m = block * L + l,
// so a warp reads L consecutive lanes' words of 32 / L slots, L * 4 bytes a
// limb row.  Each thread loads its slot's two points once and puts its
// masked denominator at leaf TREE_T + t of its lane's product tree in
// shared memory (`lane_leaf`, one tree a lane, interleaved: word w of node
// i at [w * 2 * TREE_T * L + i * L]).
//
// K4 (L = K4_LANES, 32 in G1: a warp reads whole 128-byte rows): the
// up-sweep (K6's `inv_tree_up`) multiplies the leaves into the lane's inner
// nodes down to the root, node 1, the lane's total: 15 products a lane at a
// serial depth of 4, where one thread chaining its lane's 16 denominators
// had a depth of 16 and a sixteenth of the threads.
//
// K7 (L = MID_LANES): the thread keeps its slot's points in registers until
// it writes the slot's mid (`mid_leaf`, `mid_store`).  Lane m's inverses
// come from its lane inverse tinv[m] = 1 / (its TREE_T denominators'
// product) through the lane's tree: the up-sweep stops at the inner nodes
// 2..15 (the root's product is tinv's inverse, which nothing reads); the
// down-sweep hands every node, from the root (tinv) down, the inverse of
// its product, which is tinv times the product of every denominator outside
// it (K6's `inv_tree_down`).  At leaf t that is tinv times the exclusive
// prefix and suffix products of slot t, the inverse of its own denominator:
// 44 products a lane at a serial depth of 7, where one thread sweeping its
// lane forward and back took 48 at a depth of 32.
//
// Lanes past M are (0, 0) + (0, 0) slots, whose denominator is one.

constexpr int MID_LANES = 8;                        // lanes of a K7 block
constexpr int MID_STRIDE = 2 * TREE_T * MID_LANES;  // words between a node's packed words

// Lanes of a K4 block: 32 in G1, so a warp's loads are whole 128-byte limb
// rows (PERF.md, K4's finding: at G1 M = 2^17 on the H100, 32 lanes ran
// 0.193 ms, 16 and 8 lanes 0.251 and 0.256); 16 in G2, whose tree of 32
// lanes would need 64 KB of shared memory.
template <class C>
constexpr int K4_LANES = C::NC == 16 ? 32 : 16;

// Thread (t, lane m) of a block of L lanes over planes uint32[2*NC, TREE_T,
// M]: its slot, loaded once; its masked denominator -> leaf TREE_T + t of
// the lane's tree (`node`: the lane's first word).
template <class C, int L>
BN_HD TreeSlot<typename C::F> lane_leaf(const uint32_t* apr, const uint32_t* bpl, long M,
                                        long m, int t, uint32_t* node) {
  typedef typename C::F F;
  TreeSlot<F> s;
  if (m < M) {
    const long o = t * M + m;
    s = tree_slot<C>(apr + o, bpl + o, (long)TREE_T * M);
  } else {
    s.x1 = s.y1 = s.x2 = s.y2 = F::zero();
    s.i1 = s.i2 = s.eqx = s.eqy = true;
    s.dbl = false;
  }
  tree_den<C>(s).store_packed(node + (TREE_T + t) * L, 2 * TREE_T * L);
  return s;
}

// K4, after the up-sweep: lane m's total (node 1 of its tree) -> tot[:, m].
template <class C, int L>
BN_HD void lane_total_store(const uint32_t* node, uint32_t* tot, long M, long m) {
  if (m < M) C::F::load_packed(node + L, 2 * TREE_T * L).store(tot + m, M);
}

struct MidIO {
  const uint32_t *apr, *bpl, *tinv;  // planes uint32[2*NC, T, M]; tinv [NC, M]
  uint32_t* mid;                     // [2*NC, T, M]
  long M;
};

// K7's leaf (`lane_leaf`); thread t = 0 also puts the lane inverse at the
// root of `invn`.
template <class C>
BN_HD TreeSlot<typename C::F> mid_leaf(const MidIO& io, long m, int t, uint32_t* node,
                                       uint32_t* invn) {
  typedef typename C::F F;
  const TreeSlot<F> s = lane_leaf<C, MID_LANES>(io.apr, io.bpl, io.M, m, t, node);
  if (t == 0)
    (m < io.M ? F::load(io.tinv + m, io.M) : C::one()).store_packed(invn + MID_LANES, MID_STRIDE);
  return s;
}

// Slot t's mid from the inverse of its denominator (leaf TREE_T + t of
// `invn`) -> mid[:, t, m].
template <class C>
BN_HD void mid_store(const MidIO& io, long m, int t, const TreeSlot<typename C::F>& s,
                     const uint32_t* invn) {
  typedef typename C::F F;
  if (m >= io.M) return;
  const Aff<F> p =
      tree_mid<C>(s, F::load_packed(invn + (TREE_T + t) * MID_LANES, MID_STRIDE));
  const long o = t * io.M + m, plane = (long)TREE_T * io.M;
  p.x.store(io.mid + o, plane);
  p.y.store(io.mid + o + C::NC * plane, plane);
}

// ------------------------------------------------- fused tree level (K8) ---
//
// One whole merge-tree level in one launch, in K6's block shape: block b
// takes additions b * INV_THREADS * INV_CHUNK onwards, and thread t of it
// the additions e + i * INV_THREADS (e = its first, i < INV_CHUNK), so that
// neighbouring threads read neighbouring columns.  Per thread:
// `level_chain` (load the slot, its masked denominator, the exclusive
// prefix products of the thread's chain), the block's product tree and one
// inversion (csrc/tree.cu, with K6's `inv_tree_up` / `field_inv` /
// `inv_tree_down`), then `level_finish` (the chain walked back to each
// addition's own inverse, `tree_mid` and the node-update selects).
// Additions past K count as a denominator of one.

// A level's operands as they lie in the tree's arrays: the point columns
// uint32[2*NC, K] of A.pL, A.pR, B.pL, B.pR at limb stride ld (views of the
// previous level's outputs), flags uint8[K] (bit 0 keys match, 1 A pure, 2
// B pure), and the outputs PL', PR' and EM0 (null: no emission) as
// contiguous [2*NC, K].
struct LevelIO {
  const uint32_t *apl, *apr, *bpl, *bpr;
  const uint8_t* flg;
  uint32_t *opl, *opr, *oem;
  long K, ld;
};

template <class C>
BN_HD typename C::F level_chain(const LevelIO& io, long e, typename C::F pre[INV_CHUNK]) {
  typedef typename C::F F;
  F run = C::one();
#pragma unroll
  for (int i = 0; i < INV_CHUNK; ++i) {
    const long idx = e + (long)i * INV_THREADS;
    pre[i] = run;
    if (idx < io.K) run = run * tree_den<C>(tree_slot<C>(io.apr + idx, io.bpl + idx, io.ld));
  }
  return run;
}

// rinv = 1 / (the chain's product): each addition's inverse, its mid and
//   PL' = match & aP ? mid : A.pL,  PR' = match & bP ? mid : B.pR,
//   EM0 = match ? mid : A.pR  (when io.oem is not null).
template <class C>
BN_HD void level_finish(const LevelIO& io, long e, const typename C::F pre[INV_CHUNK],
                        typename C::F rinv) {
  typedef typename C::F F;
#pragma unroll
  for (int i = INV_CHUNK - 1; i >= 0; --i) {
    const long idx = e + (long)i * INV_THREADS;
    if (idx >= io.K) continue;
    const TreeSlot<F> s = tree_slot<C>(io.apr + idx, io.bpl + idx, io.ld);
    const F inv = rinv * pre[i];
    rinv = rinv * tree_den<C>(s);
    const Aff<F> mid = tree_mid<C>(s, inv);
    const int fl = io.flg[idx];
    const bool match = fl & 1;
    tree_store_sel<C>(io.opl + idx, io.K, match && (fl & 2), mid, io.apl + idx, io.ld);
    tree_store_sel<C>(io.opr + idx, io.K, match && (fl & 4), mid, io.bpr + idx, io.ld);
    if (io.oem) tree_store_sel<C>(io.oem + idx, io.K, match, mid, io.apr + idx, io.ld);
  }
}

}  // namespace bn254
