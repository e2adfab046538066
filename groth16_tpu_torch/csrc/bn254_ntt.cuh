// K3's block body and the quotient's pointwise step, as __host__ __device__
// functions: csrc/ntt.cu runs them in its kernels, csrc/bn254_host_shim.cpp
// runs them on the CPU (one block after the other, each phase over the
// block's threads in turn), so the tests hold the kernels' addressing and
// arithmetic against the plain versions without a GPU.
//
// Element formats (the last axis of every array):
//   wire    16 words, one 16-bit limb each, little-endian (uint32[..., 16]);
//   packed  the element's eight 32-bit words (uint32[..., 8]), for the
//           quotient's intermediates and the tables.
// Both are 16-byte aligned per element, so the kernels read and write them
// with 128-bit accesses.

#pragma once

#include "bn254_field.cuh"

namespace bn254 {

BN_HD Fr load_packed8(const uint32_t* w) {
#if defined(__CUDA_ARCH__)
  const uint4* q = reinterpret_cast<const uint4*>(w);
  const uint4 a = q[0], b = q[1];
  Fr r;
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  return r;
#else
  return Fr::load_packed(w, 1);
#endif
}

BN_HD void store_packed8(uint32_t* w, const Fr& x) {
#if defined(__CUDA_ARCH__)
  uint4* q = reinterpret_cast<uint4*>(w);
  q[0] = make_uint4(x.v[0], x.v[1], x.v[2], x.v[3]);
  q[1] = make_uint4(x.v[4], x.v[5], x.v[6], x.v[7]);
#else
  x.store_packed(w, 1);
#endif
}

// element e of an array in either format
BN_HD Fr load_elem(const uint32_t* base, long e, int wire) {
  return wire ? Fr::load_vec(base + e * 16) : load_packed8(base + e * 8);
}

BN_HD void store_elem(uint32_t* base, long e, const Fr& x, int wire) {
  if (wire)
    x.store_vec(base + e * 16);
  else
    store_packed8(base + e * 8, x);
}

// q with its low `bits` bits reversed (q < 2^bits)
BN_HD int bit_reverse(int q, int bits) {
#if defined(__CUDA_ARCH__)
  return bits ? (int)(__brev((unsigned)q) >> (32 - bits)) : 0;
#else
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((q >> b) & 1) << (bits - 1 - b);
  return r;
#endif
}

// One launch of K3: B batches of NB transforms of T points.  Element q
// (natural order) of transform i in batch b is read at x[b * xb + i * si +
// q * sq + (q >> gbits) * gx]; it goes to position p of the block's
// transform (p = q for DIF, bit-reversed q for DIT) and is multiplied by
// pre[i, p].  After the stages position p holds output k (k = p for DIT,
// bit-reversed p for DIF); it is multiplied by post[i, p] and written to
// out[b * ob + i * oi + k * ok + (k >> hbits) * hx].  Strides count
// elements.  The split terms (gx, hx; zero when a step has none) put the
// blocks of 2^gbits inputs or 2^hbits outputs at their own stride: the
// sharded NTT's blocks from and to each rank of an all_to_all.  roots[h +
// j] = w^(j T / 2h), w the T-th root of unity: the twiddle of offset j at
// span h.
struct NttStep {
  const uint32_t* x;
  uint32_t* out;
  const uint32_t* pre;    // packed [NB, T], or null
  const uint32_t* post;   // packed [NB, T], or null
  const uint32_t* roots;  // packed [T]
  long si, sq, oi, ok, xb, ob;
  int T, log_t, dit, wire_in, wire_out;
  long gx, hx;
  int gbits, hbits;
};

// The transform lives in shared memory as eight 32-bit limb planes ([8][T]
// words), so neighbouring positions sit in neighbouring banks.
BN_HD Fr sm_get(const uint32_t* sm, int T, int j) {
  Fr r;
#pragma unroll
  for (int l = 0; l < 8; ++l) r.v[l] = sm[l * T + j];
  return r;
}

BN_HD void sm_put(uint32_t* sm, int T, int j, const Fr& a) {
#pragma unroll
  for (int l = 0; l < 8; ++l) sm[l * T + j] = a.v[l];
}

BN_HD void ntt_load(const NttStep& s, long b, long i, int q, uint32_t* sm) {
  const uint32_t* x = s.x + b * s.xb * (s.wire_in ? 16 : 8);
  Fr v = load_elem(x, i * s.si + q * s.sq + (long)(q >> s.gbits) * s.gx, s.wire_in);
  const int p = s.dit ? bit_reverse(q, s.log_t) : q;
  if (s.pre) v = v * load_packed8(s.pre + (i * s.T + p) * 8);
  sm_put(sm, s.T, p, v);
}

// butterfly t (< T/2) of the stage at span h
BN_HD void ntt_butterfly(const NttStep& s, int h, int t, uint32_t* sm) {
  const int off = t & (h - 1);
  const int i = ((t - off) << 1) + off;
  const Fr a = sm_get(sm, s.T, i), b = sm_get(sm, s.T, i + h);
  const Fr w = load_packed8(s.roots + (h + off) * 8);
  if (s.dit) {
    const Fr wb = b * w;
    sm_put(sm, s.T, i, a + wb);
    sm_put(sm, s.T, i + h, a - wb);
  } else {
    sm_put(sm, s.T, i, a + b);
    sm_put(sm, s.T, i + h, (a - b) * w);
  }
}

BN_HD void ntt_store(const NttStep& s, long b, long i, int p, const uint32_t* sm) {
  Fr v = sm_get(sm, s.T, p);
  if (s.post) v = v * load_packed8(s.post + (i * s.T + p) * 8);
  const int k = s.dit ? p : bit_reverse(p, s.log_t);
  uint32_t* out = s.out + b * s.ob * (s.wire_out ? 16 : 8);
  store_elem(out, i * s.oi + (long)k * s.ok + (long)(k >> s.hbits) * s.hx, v, s.wire_out);
}

// The quotient's pointwise step at element e of the coset values ev
// (packed [3, n]: A, B, C): A * B - C, times `scale` (a packed Montgomery
// element) where given; where `standard`, out of Montgomery form (a product
// with the standard 1) into the wire format (the MSM's scalars), else
// packed (the next K3 step's input).
BN_HD void quotient_point(const uint32_t* ev, long n, long e, const uint32_t* scale,
                          int standard, uint32_t* out) {
  Fr r = load_packed8(ev + e * 8) * load_packed8(ev + (n + e) * 8) -
         load_packed8(ev + (2 * n + e) * 8);
  if (scale) r = r * load_packed8(scale);
  if (standard) {
    Fr one = Fr::zero();
    one.v[0] = 1;
    r = r * one;
  }
  store_elem(out, e, r, standard);
}

}  // namespace bn254
