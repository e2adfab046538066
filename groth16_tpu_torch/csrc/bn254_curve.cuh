// BN254 G1 / G2 complete projective formulas, the segmented-fold lane body
// and the merge-tree lane bodies.
//
// The group law is Renes-Costello-Batina 2015 (a = 0), the same operation
// sequence as groth16_tpu/ops/curve.py::rcb_add / rcb_add_mixed / rcb_double,
// so projective outputs are bit-identical to the plain PyTorch versions
// (groth16_tpu_torch/ops/curve.py).  The fold lane body is what
// groth16_tpu/ops/kernels.py::_fold_call computes for one lane; the tree
// lane bodies are the affine additions of groth16_tpu/ops/kernels_tree.py.
// All are __host__ __device__ so the CPU tests run them through a g++ build.

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

// ------------------------------------------------------------ fold lane ---
//
// One lane of the segmented fold over a digit-sorted stream (the body of
// groth16_tpu/ops/kernels.py::_fold_call).  Layouts, with `lanes` minor so
// that neighbouring lanes read neighbouring words:
//   kT    int32 [T, lanes]        signed digits; bucket identity is |digit|
//   pT    uint32[T, Rin, lanes]   Rin = 2*NC (affine x|y) or 3*NC (x|y|z)
//   emit  uint32[T, 3*NC, lanes]  emit[t] = running segment before element t
//                                 (emit[0] = infinity)
//   trail uint32[3*NC, lanes]     the running segment after the last element
// A negative digit negates y.  In the affine variant (0, 0) is infinity and
// the add is the mixed one.

template <class C>
BN_HD void store_proj(uint32_t* base, long stride, const Proj<typename C::F>& P) {
  P.X.store(base, stride);
  P.Y.store(base + C::NC * stride, stride);
  P.Z.store(base + 2 * C::NC * stride, stride);
}

template <class C, bool AFFINE>
BN_HD void fold_lane(const int32_t* kT, const uint32_t* pT, uint32_t* emit,
                     uint32_t* trail, int T, long lanes, long lane) {
  typedef typename C::F F;
  const int Rin = AFFINE ? 2 * C::NC : 3 * C::NC;
  const int R = 3 * C::NC;

  int32_t prev = 0;
  Proj<F> run = infinity<C>();
  for (int t = 0; t < T; ++t) {
    store_proj<C>(emit + (long)t * R * lanes + lane, lanes, run);
    const int32_t k = kT[(long)t * lanes + lane];
    const uint32_t* src = pT + (long)t * Rin * lanes + lane;
    F x = F::load(src, lanes);
    F y = F::load(src + C::NC * lanes, lanes);
    y = F::select(k < 0, y.neg(), y);
    Proj<F> fresh, added;
    if (AFFINE) {
      bool inf = x.is_zero() && y.is_zero();
      Aff<F> q{x, y};
      added = select(inf, run, rcb_add_mixed<C>(run, q));
      fresh = select(inf, infinity<C>(), Proj<F>{x, y, C::one()});
    } else {
      fresh = Proj<F>{x, y, F::load(src + 2 * C::NC * lanes, lanes)};
      added = rcb_add<C>(run, fresh);
    }
    const int32_t ak = k < 0 ? -k : k;
    const int32_t ap = prev < 0 ? -prev : prev;
    run = select(t == 0 || ak != ap, fresh, added);
    prev = k;
  }
  store_proj<C>(trail + lane, lanes, run);
}

// ----------------------------------------------------------- merge tree ---
//
// Lane bodies of the batched-affine merge-tree kernels (the bodies of
// groth16_tpu/ops/kernels_tree.py::_phase_a_call, ::_invert_call and
// ::_phase_b_level_call).  One tree level is a batch of affine additions
// mid = A.pR + B.pL whose slope denominators share one batch inversion.
// Layouts, with the lane axis M minor:
//   points  uint32[2*NC, T, M]  limb-major fused x|y, (0, 0) = infinity;
//                               element (t, m) is addition t*M + m of the level
//   flags   int32 [T, M]        bit 0 keys match, 1 A pure, 2 B pure
//   totals  uint32[NC, M]       per-lane denominator products (and inverses)

constexpr int TREE_T = 16;       // sequential additions per lane
constexpr int INV_W = 128;       // lanes of the batch-inversion kernel
constexpr int INV_MAX_CHUNKS = 16;

// Fermat inverse a^(p-2) in Fp (the inverse of 0 is 0).
BN_HD Fp field_inv(const Fp& a) {
  Fp acc = G1::one(), base = a;
#pragma unroll 1
  for (int w = 0; w < 8; ++w) {
    const uint32_t e = FpParams::p(w) - (w == 0 ? 2u : 0u);
#pragma unroll 1
    for (int b = 0; b < 32; ++b) {
      if ((e >> b) & 1u) acc = acc * base;
      base = base.sqr();
    }
  }
  return acc;
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

// K4 lane m: the product of its T masked denominators -> tot[:, m].
template <class C>
BN_HD void tree_phase_a_lane(const uint32_t* apr, const uint32_t* bpl, uint32_t* tot,
                             long M, long m) {
  typedef typename C::F F;
  const long plane = (long)TREE_T * M;
  F run = C::one();
#pragma unroll 1
  for (int t = 0; t < TREE_T; ++t) {
    const long o = t * M + m;
    run = run * tree_den<C>(tree_slot<C>(apr + o, bpl + o, plane));
  }
  run.store(tot + m, M);
}

// K6 lane j < INV_W: Montgomery's trick over the chunks tot[:, i*INV_W + j]
// (M / INV_W <= INV_MAX_CHUNKS of them), one Fermat inverse, and the walk back.
template <class C>
BN_HD void tree_invert_lane(const uint32_t* tot, uint32_t* inv, long M, int j) {
  typedef typename C::F F;
  const int nch = (int)(M / INV_W);
  F pre[INV_MAX_CHUNKS];
  F run = C::one();
#pragma unroll 1
  for (int i = 0; i < nch; ++i) {
    pre[i] = run;
    run = run * F::load(tot + (long)i * INV_W + j, M);
  }
  F rinv = field_inv(run);
#pragma unroll 1
  for (int i = nch - 1; i >= 0; --i) {
    (rinv * pre[i]).store(inv + (long)i * INV_W + j, M);
    rinv = rinv * F::load(tot + (long)i * INV_W + j, M);
  }
}

// dst <- cond ? mid : src, one fused x|y point at stride `stride`.
template <class C>
BN_HD void tree_store_sel(uint32_t* dst, long stride, bool cond,
                          const Aff<typename C::F>& mid, const uint32_t* src) {
  if (cond) {
    mid.x.store(dst, stride);
    mid.y.store(dst + C::NC * stride, stride);
  } else {
    for (int r = 0; r < 2 * C::NC; ++r) dst[r * stride] = src[r * stride];
  }
}

// K8 lane m: a forward sweep keeps the exclusive prefix products of the
// denominators, a reverse sweep expands the lane inverse tinv[:, m] to
// per-slot inverses, finishes each addition and writes the node updates
//   PL' = match & aP ? mid : A.pL,  PR' = match & bP ? mid : B.pR,
//   EM0 = match ? mid : A.pR  (only when em != nullptr).
template <class C>
BN_HD void tree_phase_b_lane(const uint32_t* apl, const uint32_t* apr,
                             const uint32_t* bpl, const uint32_t* bpr,
                             const int32_t* flg, const uint32_t* tinv,
                             uint32_t* opl, uint32_t* opr, uint32_t* oem,
                             long M, long m) {
  typedef typename C::F F;
  const long plane = (long)TREE_T * M;
  F pre[TREE_T];
  F run = C::one();
#pragma unroll 1
  for (int t = 0; t < TREE_T; ++t) {
    const long o = t * M + m;
    pre[t] = run;
    run = run * tree_den<C>(tree_slot<C>(apr + o, bpl + o, plane));
  }
  F rinv = F::load(tinv + m, M);
#pragma unroll 1
  for (int t = TREE_T - 1; t >= 0; --t) {
    const long o = t * M + m;
    const TreeSlot<F> s = tree_slot<C>(apr + o, bpl + o, plane);
    const F inv = rinv * pre[t];
    rinv = rinv * tree_den<C>(s);
    const Aff<F> mid = tree_mid<C>(s, inv);
    const int32_t fl = flg[o];
    const bool match = fl & 1;
    tree_store_sel<C>(opl + o, plane, match && (fl & 2), mid, apl + o);
    tree_store_sel<C>(opr + o, plane, match && (fl & 4), mid, bpr + o);
    if (oem) tree_store_sel<C>(oem + o, plane, match, mid, apr + o);
  }
}

}  // namespace bn254
