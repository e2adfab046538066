// The prover's SpMV row body and the Fp negation, as __host__ __device__
// functions: csrc/spmv.cu runs them one thread a row (an element), and
// csrc/bn254_host_shim.cpp runs them row after row on the CPU, so the tests
// hold the kernels' arithmetic against the plain versions without a GPU.
//
// The SpMV reads the zkey's A and B entries sorted by (matrix, row) with row
// offsets (CSR over 2n rows: A's row r is row r, B's row r is row n + r).
// The witness enters in standard form: coeff_mont * w * 2^-256 = coeff * w,
// so a row's sum is the standard-form dot product, and one product by
// R^2 = 2^512 mod r takes it into Montgomery form, the form JAX's `abc_core`
// leaves Az and Bz in (groth16_tpu/protocol/prover.py:89).  Every value is
// canonical, so any order of the modular additions gives the same words.

#pragma once

#include "bn254_field.cuh"

namespace bn254 {

// 2^512 mod r, the factor that takes a standard-form Fr value into
// Montgomery form under one Montgomery product
BN_HD Fr fr_r2() {
  const uint32_t v[8] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
                         0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};
  Fr r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = v[i];
  return r;
}

// sum over entries t in [lo, hi) of coeff[t] * w[cols[t]], standard form
// (coeff Montgomery, w standard; both wire layout, 16-byte aligned)
BN_HD Fr spmv_dot(const uint32_t* w, const uint32_t* coeff, const int32_t* cols, long lo,
                  long hi) {
  Fr acc = Fr::zero();
  for (long t = lo; t < hi; ++t)
    acc = acc + Fr::load_vec(coeff + t * 16) * Fr::load_vec(w + (long)cols[t] * 16);
  return acc;
}

// Row r < n: Az[r], Bz[r] and Cz[r] = Az[r] * Bz[r], Montgomery, into
// out = uint32[3, n, 16] (Az | Bz | Cz)
BN_HD void spmv_row(const uint32_t* w, const uint32_t* coeff, const int32_t* cols,
                    const long* row_ptr, long n, long r, uint32_t* out) {
  const Fr r2 = fr_r2();
  const Fr a = spmv_dot(w, coeff, cols, row_ptr[r], row_ptr[r + 1]) * r2;
  const Fr b = spmv_dot(w, coeff, cols, row_ptr[n + r], row_ptr[n + r + 1]) * r2;
  a.store_vec(out + r * 16);
  b.store_vec(out + (n + r) * 16);
  (a * b).store_vec(out + (2 * n + r) * 16);
}

// out[e] = -x[e] mod p (wire layout); 0 stays 0, so the (0, 0) affine
// infinity stays (0, 0)
BN_HD void fp_neg_elem(const uint32_t* x, uint32_t* out, long e) {
  Fp::load_vec(x + e * 16).neg().store_vec(out + e * 16);
}

}  // namespace bn254
