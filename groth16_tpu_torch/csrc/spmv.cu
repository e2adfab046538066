// The prover's SpMV (Az, Bz, Cz = Az * Bz) and the merge tree's y negation.
//
// Neither replaces a Pallas kernel: the JAX package computes both in XLA,
// `abc_core` (groth16_tpu/protocol/prover.py:89: gather, one Montgomery
// product, a segment sum, a pointwise product) and `F.neg_mod` in
// `window_sums_tree` (groth16_tpu/ops/msm_tree.py).  Here they are one
// launch each, so a proof runs no plain field arithmetic on the card.
//
// g16_spmv: one thread a row (bn254_spmv.cuh `spmv_row`): it walks A's and
// B's entries of its row, gathers the witness values by column, multiplies,
// adds, takes both sums into Montgomery form and writes Az, Bz and their
// product.  Bound on this card by bytes: a 64-byte coefficient, a 4-byte
// column and a 64-byte gathered witness value an entry, 3 x 64 bytes written
// a row, against one Fr product an entry and three a row.  A row is serial
// in its thread, so one dense row (circom's rows on the constant-one wire)
// takes as long as its length; there is no limit on a row's length.
//
// g16_fp_neg: one thread an Fp element, wire layout in and out, 128-bit
// accesses; memory-bound.

#include <cuda_runtime.h>

#include "bn254_spmv.cuh"

using namespace bn254;

__global__ void spmv_kernel(const uint32_t* w, const uint32_t* coeff, const int32_t* cols,
                            const long* row_ptr, long n, uint32_t* out) {
  const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r < n) spmv_row(w, coeff, cols, row_ptr, n, r, out);
}

__global__ void fp_neg_kernel(const uint32_t* x, uint32_t* out, long n) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) fp_neg_elem(x, out, e);
}

extern "C" int g16_spmv(const void* w, const void* coeff, const void* cols, const void* row_ptr,
                        long n, void* out, void* stream) {
  const int threads = 128;
  if (n > 0) {
    spmv_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)w, (const uint32_t*)coeff, (const int32_t*)cols, (const long*)row_ptr,
        n, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int g16_fp_neg(const void* x, void* out, long n, void* stream) {
  const int threads = 256;
  if (n > 0) {
    fp_neg_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
