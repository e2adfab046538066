// BN254 Montgomery field arithmetic for the hand-written kernels.
//
// Replaces the in-kernel field classes of the Pallas package:
// groth16_tpu/ops/kernels.py::_KFp / ::_KFp2 (Fp, Fp2) and
// groth16_tpu/ops/ntt_pallas.py::_NFr (Fr).  The TPU versions work on
// sixteen 16-bit limbs because the TPU has no widening multiply; Hopper has a
// 32x32->64 multiply and carry chains through its condition-code flag, so an
// element here is eight 32-bit limbs and the product is a Montgomery product
// written as PTX carry chains (`mont_mul`).  R = 2^256 in both layouts, so
// the Montgomery forms are the same numbers and the wire layout
// (uint32[..., 16], one 16-bit limb per word) converts by pairing words.
//
// Every result is canonical (< modulus), exactly as the TPU `_cond_sub`
// leaves it, so the kernels are bit-identical to the plain PyTorch versions.
// Inputs must be canonical too.
//
// All functions are __host__ __device__ so that g++ compiles this header for
// the CPU tests (csrc/bn254_host_shim.cpp) as well as nvcc for the kernels.
// The carry-chain primitives have a C++ body beside their PTX, which keeps
// the carry flag in a variable, so g++ runs the product's schedule word for
// word.

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define BN_HD __host__ __device__ __forceinline__
#else
#define BN_HD inline
#endif

// The Fp product is inlined unless a translation unit defines
// BN254_NOINLINE_MUL before this header: then it is one function,
// `field_mul`, that every caller branches to with its operands and result
// in registers (csrc/point.cu, fold.cu and tree.cu do;
// tools/bench_point_variants.py times both builds of their kernels).
#if defined(__CUDACC__) && defined(BN254_NOINLINE_MUL)
#define BN_MUL __host__ __device__ __noinline__
#else
#define BN_MUL BN_HD
#endif

namespace bn254 {

// ---------------------------------------------------------------- moduli ---

struct FpParams {
  static constexpr uint32_t N0 = 0xe4866389u;  // -p^-1 mod 2^32
  BN_HD static uint32_t p(int i) {
    const uint32_t v[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
};

struct FrParams {
  static constexpr uint32_t N0 = 0xefffffffu;  // -r^-1 mod 2^32
  BN_HD static uint32_t p(int i) {
    const uint32_t v[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
};

// ------------------------------------------------ carry-chain primitives ---
//
// Each primitive is ONE carry chain: on the card one asm statement, so the
// condition-code flag never has to survive between statements; on the host
// the same sequence with the flag in `cf`.  PTX semantics:
//   mad.lo.cc  d = lo(a*b) + c,      cf out     madc.lo.cc  d = lo(a*b) + c + cf
//   madc.hi.cc d = hi(a*b) + c + cf, cf out     madc.hi     (no cf out)
//   add.cc / addc.cc / addc, sub.cc / subc.cc / subc: the same with a borrow.
// The "even" words of a product row are a_0 b, a_2 b, a_4 b, a_6 b, which
// fill words 0..7 without overlapping (lo at 2k, hi at 2k+1); the "odd" ones
// a_1 b .. a_7 b fill words 1..8.  So each half-row is one chain of (lo, hi)
// pairs of the same 32x32 product.

#if defined(__CUDA_ARCH__)
#define BN_CHAIN(...) asm(__VA_ARGS__)
#endif

BN_HD uint32_t lo32(uint64_t x) { return (uint32_t)x; }
BN_HD uint32_t hi32(uint64_t x) { return (uint32_t)(x >> 32); }

// r[2k], r[2k+1] = lo, hi of a[2k+s] * b (s = 0: even words, 1: odd)
template <int S>
BN_HD void mul_row(uint32_t (&r)[8], const uint32_t (&a)[8], uint32_t b) {
#if defined(__CUDA_ARCH__)
  BN_CHAIN("mul.lo.u32 %0, %8, %12;\n\tmul.hi.u32 %1, %8, %12;\n\t"
           "mul.lo.u32 %2, %9, %12;\n\tmul.hi.u32 %3, %9, %12;\n\t"
           "mul.lo.u32 %4, %10, %12;\n\tmul.hi.u32 %5, %10, %12;\n\t"
           "mul.lo.u32 %6, %11, %12;\n\tmul.hi.u32 %7, %11, %12;"
           : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]),
             "=r"(r[6]), "=r"(r[7])
           : "r"(a[S]), "r"(a[S + 2]), "r"(a[S + 4]), "r"(a[S + 6]), "r"(b));
#else
  for (int k = 0; k < 4; ++k) {
    const uint64_t w = (uint64_t)a[2 * k + S] * b;
    r[2 * k] = lo32(w);
    r[2 * k + 1] = hi32(w);
  }
#endif
}

// r += (the S words of a) * b; the chain's carry out of word 7 goes into
// `top` when TOP, else there is none (the caller's bound rules it out)
template <int S, bool TOP>
BN_HD void mad_row(uint32_t (&r)[8], const uint32_t (&a)[8], uint32_t b, uint32_t& top) {
#if defined(__CUDA_ARCH__)
  if (TOP)
    BN_CHAIN("mad.lo.cc.u32 %0, %9, %13, %0;\n\tmadc.hi.cc.u32 %1, %9, %13, %1;\n\t"
             "madc.lo.cc.u32 %2, %10, %13, %2;\n\tmadc.hi.cc.u32 %3, %10, %13, %3;\n\t"
             "madc.lo.cc.u32 %4, %11, %13, %4;\n\tmadc.hi.cc.u32 %5, %11, %13, %5;\n\t"
             "madc.lo.cc.u32 %6, %12, %13, %6;\n\tmadc.hi.cc.u32 %7, %12, %13, %7;\n\t"
             "addc.u32 %8, %8, 0;"
             : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]),
               "+r"(r[6]), "+r"(r[7]), "+r"(top)
             : "r"(a[S]), "r"(a[S + 2]), "r"(a[S + 4]), "r"(a[S + 6]), "r"(b));
  else
    BN_CHAIN("mad.lo.cc.u32 %0, %8, %12, %0;\n\tmadc.hi.cc.u32 %1, %8, %12, %1;\n\t"
             "madc.lo.cc.u32 %2, %9, %12, %2;\n\tmadc.hi.cc.u32 %3, %9, %12, %3;\n\t"
             "madc.lo.cc.u32 %4, %10, %12, %4;\n\tmadc.hi.cc.u32 %5, %10, %12, %5;\n\t"
             "madc.lo.cc.u32 %6, %11, %12, %6;\n\tmadc.hi.u32 %7, %11, %12, %7;"
             : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]),
               "+r"(r[6]), "+r"(r[7])
             : "r"(a[S]), "r"(a[S + 2]), "r"(a[S + 4]), "r"(a[S + 6]), "r"(b));
#else
  uint32_t cf = 0;
  for (int k = 0; k < 4; ++k) {
    const uint64_t w = (uint64_t)a[2 * k + S] * b;
    uint64_t s = (uint64_t)r[2 * k] + lo32(w) + cf;
    r[2 * k] = lo32(s);
    cf = hi32(s);
    s = (uint64_t)r[2 * k + 1] + hi32(w) + cf;
    r[2 * k + 1] = lo32(s);
    cf = hi32(s);
  }
  if (TOP) top += cf;
#endif
}

// The step between two rows: x0 += y[1], its carry running on into
// r = y[2..7], 0, 0 + (the odd words of a) * b, one chain (no carry out).
BN_HD void mad_row_shift(uint32_t& x0, uint32_t (&r)[8], const uint32_t (&y)[8],
                         const uint32_t (&a)[8], uint32_t b) {
#if defined(__CUDA_ARCH__)
  BN_CHAIN("add.cc.u32 %0, %0, %9;\n\t"
           "madc.lo.cc.u32 %1, %16, %20, %10;\n\tmadc.hi.cc.u32 %2, %16, %20, %11;\n\t"
           "madc.lo.cc.u32 %3, %17, %20, %12;\n\tmadc.hi.cc.u32 %4, %17, %20, %13;\n\t"
           "madc.lo.cc.u32 %5, %18, %20, %14;\n\tmadc.hi.cc.u32 %6, %18, %20, %15;\n\t"
           "madc.lo.cc.u32 %7, %19, %20, 0;\n\tmadc.hi.u32 %8, %19, %20, 0;"
           : "+r"(x0), "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
             "=r"(r[5]), "=r"(r[6]), "=r"(r[7])
           : "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]), "r"(y[6]), "r"(y[7]),
             "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b));
#else
  uint64_t s = (uint64_t)x0 + y[1];
  x0 = lo32(s);
  uint32_t cf = hi32(s);
  for (int k = 0; k < 4; ++k) {
    const uint64_t w = (uint64_t)a[2 * k + 1] * b;
    s = (uint64_t)(k < 3 ? y[2 * k + 2] : 0u) + lo32(w) + cf;
    r[2 * k] = lo32(s);
    cf = hi32(s);
    s = (uint64_t)(k < 3 ? y[2 * k + 3] : 0u) + hi32(w) + cf;
    r[2 * k + 1] = lo32(s);
    cf = hi32(s);
  }
#endif
}

// r = x + (y >> 32): x[0..7] plus y[1..7], one chain (no carry out)
BN_HD void add_shift(uint32_t (&r)[8], const uint32_t (&x)[8], const uint32_t (&y)[8]) {
#if defined(__CUDA_ARCH__)
  BN_CHAIN("add.cc.u32 %0, %8, %16;\n\taddc.cc.u32 %1, %9, %17;\n\t"
           "addc.cc.u32 %2, %10, %18;\n\taddc.cc.u32 %3, %11, %19;\n\t"
           "addc.cc.u32 %4, %12, %20;\n\taddc.cc.u32 %5, %13, %21;\n\t"
           "addc.cc.u32 %6, %14, %22;\n\taddc.u32 %7, %15, 0;"
           : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]),
             "=r"(r[6]), "=r"(r[7])
           : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]), "r"(x[6]),
             "r"(x[7]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]), "r"(y[6]),
             "r"(y[7]));
#else
  uint32_t cf = 0;
  for (int k = 0; k < 8; ++k) {
    const uint64_t s = (uint64_t)x[k] + (k < 7 ? y[k + 1] : 0u) + cf;
    r[k] = lo32(s);
    cf = hi32(s);
  }
#endif
}

// d = x - m; returns 0xffffffff when that borrows (x < m), else 0
BN_HD uint32_t sub_row(uint32_t (&d)[8], const uint32_t (&x)[8], const uint32_t (&m)[8]) {
  uint32_t bw;
#if defined(__CUDA_ARCH__)
  BN_CHAIN("sub.cc.u32 %0, %9, %17;\n\tsubc.cc.u32 %1, %10, %18;\n\t"
           "subc.cc.u32 %2, %11, %19;\n\tsubc.cc.u32 %3, %12, %20;\n\t"
           "subc.cc.u32 %4, %13, %21;\n\tsubc.cc.u32 %5, %14, %22;\n\t"
           "subc.cc.u32 %6, %15, %23;\n\tsubc.cc.u32 %7, %16, %24;\n\t"
           "subc.u32 %8, 0, 0;"
           : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]),
             "=r"(d[6]), "=r"(d[7]), "=r"(bw)
           : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]), "r"(x[6]),
             "r"(x[7]), "r"(m[0]), "r"(m[1]), "r"(m[2]), "r"(m[3]), "r"(m[4]), "r"(m[5]),
             "r"(m[6]), "r"(m[7]));
#else
  uint32_t cf = 0;
  for (int k = 0; k < 8; ++k) {
    const uint64_t s = (uint64_t)x[k] - m[k] - cf;
    d[k] = lo32(s);
    cf = (uint32_t)(s >> 63);
  }
  bw = 0u - cf;
#endif
  return bw;
}

// Montgomery product a * b * 2^-256 mod m, canonical, for a, b < m and a
// modulus m < 2^254 (BN254's p and r: top word 0x30644e72).  The schedule
// is CIOS over the eight words of b, each row kept as two half-rows `e`
// (even words, at 0..7) and `o` (odd words, at 1..8) that are two
// independent carry chains.  Row i:
//   e += a_even b_i, its carry into o[7];   o += a_odd b_i;
//   q = e[0] n0;  e += m_even q (carry into o[7]);  o += m_odd q;
// then e[0] = 0 and the value / 2^32 is o (now at words 0..7) plus e[1..7]
// (at 0..6): the next row's even half-row is o with e[1] added into its
// word 0, whose carry runs on into the next odd half-row, e[2..7] shifted
// down by two words (`mad_row_shift`).
// No-carry condition: the modulus's top word 0x30644e72 is below
// (2^32 - 1) / 2 - 1, so the running value t < 2m stays below 2^255 and
// t + a b_i + q m < 2^288: a row never carries past word 8, so neither the
// t[8] / t[9] words of textbook CIOS nor their additions exist, and the odd
// half-row's chain never carries out of its word 7.  One conditional
// subtraction of m leaves the result canonical.
template <class P>
BN_HD void mont_mul(uint32_t (&out)[8], const uint32_t (&a)[8], const uint32_t (&b)[8]) {
  uint32_t m[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = P::p(i);
  uint32_t e[8], o[8], top = 0;
  mul_row<0>(e, a, b[0]);
  mul_row<1>(o, a, b[0]);
  uint32_t q = e[0] * P::N0;
  mad_row<1, false>(o, m, q, top);
  mad_row<0, true>(e, m, q, o[7]);
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    uint32_t n[8];
    mad_row_shift(o[0], n, e, a, b[i]);   // the even half-row is o now, the odd n
    mad_row<0, true>(o, a, b[i], n[7]);
    q = o[0] * P::N0;
    mad_row<1, false>(n, m, q, top);
    mad_row<0, true>(o, m, q, n[7]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      e[k] = o[k];
      o[k] = n[k];
    }
  }
  uint32_t t[8], d[8];
  add_shift(t, o, e);
  const uint32_t lt = sub_row(d, t, m);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = lt ? t[k] : d[k];
}

// ------------------------------------------------------- prime field ------

template <class P>
struct Field;

// The product as a function of two values: out of line (BN254_NOINLINE_MUL)
// its operands and result pass in registers, where a member operator taking
// references made every caller keep them in a stack frame.
template <class P>
BN_MUL Field<P> field_mul(Field<P> a, Field<P> b);

template <class P>
struct Field {
  uint32_t v[8];

  BN_HD static Field zero() {
    Field r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = 0;
    return r;
  }

  BN_HD bool is_zero() const {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc |= v[i];
    return acc == 0;
  }

  // wire layout: 16 words, one 16-bit limb each, little-endian; `stride` is
  // the distance in words between consecutive limbs
  BN_HD static Field load(const uint32_t* w, long stride = 1) {
    Field r;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r.v[i] = (w[(2 * i) * stride] & 0xffffu) | (w[(2 * i + 1) * stride] << 16);
    return r;
  }

  BN_HD void store(uint32_t* w, long stride = 1) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w[(2 * i) * stride] = v[i] & 0xffffu;
      w[(2 * i + 1) * stride] = v[i] >> 16;
    }
  }

  // The same wire layout for one element whose sixteen words are contiguous
  // and 16-byte aligned (the point-major layout uint32[n, 16] of K1): four
  // 128-bit loads or stores on the card.
  BN_HD static Field load_vec(const uint32_t* w) {
#if defined(__CUDA_ARCH__)
    Field r;
    const uint4* q = reinterpret_cast<const uint4*>(w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 u = q[i];
      r.v[2 * i] = (u.x & 0xffffu) | (u.y << 16);
      r.v[2 * i + 1] = (u.z & 0xffffu) | (u.w << 16);
    }
    return r;
#else
    return load(w);
#endif
  }

  BN_HD void store_vec(uint32_t* w) const {
#if defined(__CUDA_ARCH__)
    uint4* q = reinterpret_cast<uint4*>(w);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = make_uint4(v[2 * i] & 0xffffu, v[2 * i] >> 16, v[2 * i + 1] & 0xffffu,
                        v[2 * i + 1] >> 16);
#else
    store(w);
#endif
  }

  // packed layout: the eight 32-bit words themselves, `stride` words apart
  // (shared-memory scratch inside a kernel, never the wire)
  static constexpr int PACKED = 8;
  BN_HD static Field load_packed(const uint32_t* w, long stride) {
    Field r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = w[i * stride];
    return r;
  }
  BN_HD void store_packed(uint32_t* w, long stride) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i * stride] = v[i];
  }

  // t (9 words, value < 2p) -> t mod p
  BN_HD static Field reduce_once(const uint32_t t[9]) {
    Field d;
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t diff = (uint64_t)t[i] - P::p(i) - borrow;
      d.v[i] = (uint32_t)diff;
      borrow = (uint32_t)(diff >> 63);
    }
    bool ge = (t[8] != 0) || (borrow == 0);
    Field r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = ge ? d.v[i] : t[i];
    return r;
  }

  BN_HD Field operator+(const Field& b) const {
    uint32_t t[9];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t s = (uint64_t)v[i] + b.v[i] + c;
      t[i] = (uint32_t)s;
      c = s >> 32;
    }
    t[8] = (uint32_t)c;
    return reduce_once(t);
  }

  BN_HD Field operator-(const Field& b) const {
    Field d;
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t diff = (uint64_t)v[i] - b.v[i] - borrow;
      d.v[i] = (uint32_t)diff;
      borrow = (uint32_t)(diff >> 63);
    }
    // a - b < 0: add p back (mask instead of a branch)
    uint32_t mask = 0u - borrow;
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t s = (uint64_t)d.v[i] + (P::p(i) & mask) + c;
      d.v[i] = (uint32_t)s;
      c = s >> 32;
    }
    return d;
  }

  BN_HD Field neg() const { return zero() - *this; }

  // Montgomery product a*b*2^-256 mod p (`mont_mul`, through `field_mul`)
  BN_HD Field operator*(const Field& b) const { return field_mul<P>(*this, b); }

  BN_HD Field sqr() const { return (*this) * (*this); }

  BN_HD bool operator==(const Field& b) const {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc |= v[i] ^ b.v[i];
    return acc == 0;
  }

  BN_HD static Field select(bool c, const Field& a, const Field& b) {
    Field r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = c ? a.v[i] : b.v[i];
    return r;
  }
};

template <class P>
BN_MUL Field<P> field_mul(Field<P> a, Field<P> b) {
  Field<P> r;
  mont_mul<P>(r.v, a.v, b.v);
  return r;
}

typedef Field<FpParams> Fp;
typedef Field<FrParams> Fr;

// --------------------------------------------- Fp2 = Fp[u]/(u^2 + 1) ------

struct Fp2 {
  Fp c0, c1;

  BN_HD static Fp2 zero() { return Fp2{Fp::zero(), Fp::zero()}; }
  BN_HD bool is_zero() const { return c0.is_zero() && c1.is_zero(); }

  // wire layout [2, 16]: c0's sixteen limbs, then c1's
  BN_HD static Fp2 load(const uint32_t* w, long stride = 1) {
    return Fp2{Fp::load(w, stride), Fp::load(w + 16 * stride, stride)};
  }
  BN_HD void store(uint32_t* w, long stride = 1) const {
    c0.store(w, stride);
    c1.store(w + 16 * stride, stride);
  }
  BN_HD static Fp2 load_vec(const uint32_t* w) {
    return Fp2{Fp::load_vec(w), Fp::load_vec(w + 16)};
  }
  BN_HD void store_vec(uint32_t* w) const {
    c0.store_vec(w);
    c1.store_vec(w + 16);
  }
  static constexpr int PACKED = 16;
  BN_HD static Fp2 load_packed(const uint32_t* w, long stride) {
    return Fp2{Fp::load_packed(w, stride), Fp::load_packed(w + 8 * stride, stride)};
  }
  BN_HD void store_packed(uint32_t* w, long stride) const {
    c0.store_packed(w, stride);
    c1.store_packed(w + 8 * stride, stride);
  }

  BN_HD Fp2 operator+(const Fp2& b) const { return Fp2{c0 + b.c0, c1 + b.c1}; }
  BN_HD Fp2 operator-(const Fp2& b) const { return Fp2{c0 - b.c0, c1 - b.c1}; }
  BN_HD Fp2 neg() const { return Fp2{c0.neg(), c1.neg()}; }

  // Karatsuba, 3 Fp products (same formula as _KFp2.mul)
  BN_HD Fp2 operator*(const Fp2& b) const {
    Fp v0 = c0 * b.c0;
    Fp v1 = c1 * b.c1;
    Fp t = (c0 + c1) * (b.c0 + b.c1);
    return Fp2{v0 - v1, (t - v0) - v1};
  }
  BN_HD Fp2 sqr() const { return (*this) * (*this); }
  BN_HD bool operator==(const Fp2& b) const { return c0 == b.c0 && c1 == b.c1; }

  BN_HD static Fp2 select(bool c, const Fp2& a, const Fp2& b) {
    return Fp2{Fp::select(c, a.c0, b.c0), Fp::select(c, a.c1, b.c1)};
  }
};

// K9 lane i: k chained products x <- x * y of the Fp elements a[:, i] and
// b[:, i] (wire layout, limb stride n) -> out[:, i].  The loop stays rolled,
// so its body is exactly one product (the SASS instruction count per product
// is read from it).
BN_HD void fp_mul_chain_lane(const uint32_t* a, const uint32_t* b, uint32_t* out,
                             int k, long n, long i) {
  Fp x = Fp::load(a + i, n);
  const Fp y = Fp::load(b + i, n);
#pragma unroll 1
  for (int j = 0; j < k; ++j) x = x * y;
  x.store(out + i, n);
}

}  // namespace bn254
