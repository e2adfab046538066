// BN254 Montgomery field arithmetic for the hand-written kernels.
//
// Replaces the in-kernel field classes of the Pallas package:
// groth16_tpu/ops/kernels.py::_KFp / ::_KFp2 (Fp, Fp2) and
// groth16_tpu/ops/ntt_pallas.py::_NFr (Fr).  The TPU versions work on
// sixteen 16-bit limbs because the TPU has no widening multiply; Hopper has a
// 32x32->64 multiply, so an element here is eight 32-bit limbs and the
// product is CIOS Montgomery multiplication.  R = 2^256 in both layouts, so
// the Montgomery forms are the same numbers and the wire layout
// (uint32[..., 16], one 16-bit limb per word) converts by pairing words.
//
// Every result is canonical (< modulus), exactly as the TPU `_cond_sub`
// leaves it, so the kernels are bit-identical to the plain PyTorch versions.
// Inputs must be canonical too.
//
// All functions are __host__ __device__ so that g++ compiles this header for
// the CPU tests (csrc/bn254_host_shim.cpp) as well as nvcc for the kernels.

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define BN_HD __host__ __device__ __forceinline__
#else
#define BN_HD inline
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

// ------------------------------------------------------- prime field ------

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

  // CIOS Montgomery product a*b*2^-256 mod p (eight 32-bit words)
  BN_HD Field operator*(const Field& b) const {
    uint32_t t[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t c = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint64_t uv = (uint64_t)v[j] * b.v[i] + t[j] + c;
        t[j] = (uint32_t)uv;
        c = uv >> 32;
      }
      uint64_t uv = (uint64_t)t[8] + c;
      t[8] = (uint32_t)uv;
      t[9] = (uint32_t)(uv >> 32);
      uint32_t m = t[0] * P::N0;
      uv = (uint64_t)m * P::p(0) + t[0];
      c = uv >> 32;
#pragma unroll
      for (int j = 1; j < 8; ++j) {
        uv = (uint64_t)m * P::p(j) + t[j] + c;
        t[j - 1] = (uint32_t)uv;
        c = uv >> 32;
      }
      uv = (uint64_t)t[8] + c;
      t[7] = (uint32_t)uv;
      t[8] = t[9] + (uint32_t)(uv >> 32);
    }
    return reduce_once(t);
  }

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

}  // namespace bn254
